"""Tokenizer: HF tokenizer.json + chat template + incremental detokenization
(a copy of localai_tpu/engine/tokenizer.py; `tokenizers` is imported only
where a tokenizer is loaded, so the backend imports without it).

LocalAI delegates tokenization to each backend (llama.cpp's vocab; vLLM's
HF tokenizer with chat template). This standardizes on the `tokenizers`
runtime (no transformers import in the serving path) with the chat
template rendered by jinja2 from tokenizer_config.json.

Incremental detokenization: byte-level BPE emits partial UTF-8 sequences at
token boundaries; the stream decoder holds bytes back until they form
complete characters — the role of the rune-reassembly loop in LocalAI's Go
core.
"""
from __future__ import annotations

import json
import os
from typing import Any

# Fallback when tokenizer_config.json carries no chat template: the ubiquitous
# [INST]-style template (functionally the reference's hardcoded llama2 default).
_FALLBACK_TEMPLATE = (
    "{% for message in messages %}"
    "{% if message['role'] == 'system' %}<<SYS>>{{ message['content'] }}<</SYS>>\n"
    "{% elif message['role'] == 'user' %}[INST] {{ message['content'] }} [/INST]"
    "{% else %}{{ message['content'] }}{% endif %}"
    "{% endfor %}"
)


class Tokenizer:
    """Thin wrapper: encode/decode, special ids, chat template."""

    def __init__(
        self,
        tok,
        *,
        bos_id: int | None = None,
        eos_ids: set[int] | None = None,
        add_bos: bool = True,
        chat_template: str | None = None,
        eos_token: str | None = None,
    ):
        self._tok = tok
        self.bos_id = bos_id
        self.eos_ids = eos_ids or set()
        self.eos_token = eos_token
        self.add_bos = add_bos
        self.chat_template = chat_template or _FALLBACK_TEMPLATE
        self._jinja = None

    # ------------------------------------------------------------ loading

    @classmethod
    def from_dir(cls, model_dir: str) -> "Tokenizer":
        from tokenizers import Tokenizer as _HFTokenizer

        path = os.path.join(model_dir, "tokenizer.json")
        if not os.path.isfile(path):
            # the rust tokenizers lib raises a bare Exception for a missing
            # file; callers need a catchable FileNotFoundError
            raise FileNotFoundError(path)
        tok = _HFTokenizer.from_file(path)
        cfg: dict[str, Any] = {}
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)

        def _tok_str(v):
            if isinstance(v, dict):
                return v.get("content")
            return v

        bos = _tok_str(cfg.get("bos_token"))
        eos = _tok_str(cfg.get("eos_token"))
        bos_id = tok.token_to_id(bos) if bos else None
        eos_ids = set()
        if eos and tok.token_to_id(eos) is not None:
            eos_ids.add(tok.token_to_id(eos))
        # generation_config.json may add extra stop ids (llama3 <|eot_id|>)
        gen_path = os.path.join(model_dir, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                g = json.load(f)
            e = g.get("eos_token_id")
            for i in e if isinstance(e, list) else ([e] if e is not None else []):
                eos_ids.add(int(i))
        return cls(
            tok,
            bos_id=bos_id,
            eos_ids=eos_ids,
            add_bos=bool(cfg.get("add_bos_token", bos_id is not None)),
            chat_template=cfg.get("chat_template"),
            eos_token=eos,
        )

    # ------------------------------------------------------------ encode/decode

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, *, add_bos: bool | None = None) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        add_bos = self.add_bos if add_bos is None else add_bos
        if add_bos and self.bos_id is not None:
            if not ids or ids[0] != self.bos_id:
                ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int], *, skip_special: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special)

    def id_to_token(self, i: int) -> str | None:
        return self._tok.id_to_token(i)

    # ------------------------------------------------------------ chat template

    def apply_chat_template(
        self,
        messages: list[dict[str, Any]],
        *,
        add_generation_prompt: bool = True,
        tools: list | None = None,
    ) -> str:
        if self._jinja is None:
            import jinja2

            env = jinja2.Environment(
                trim_blocks=True, lstrip_blocks=True,
                extensions=["jinja2.ext.loopcontrols"],
            )
            env.globals["raise_exception"] = _raise_exception
            env.filters["tojson"] = json.dumps
            self._jinja = env.from_string(self.chat_template)
        bos = self.id_to_token(self.bos_id) if self.bos_id is not None else ""
        return self._jinja.render(
            messages=messages,
            tools=tools,
            add_generation_prompt=add_generation_prompt,
            bos_token=bos or "",
            eos_token=self.eos_token or "",
        )

    def encode_chat(self, messages, **kw) -> list[int]:
        text = self.apply_chat_template(messages, **kw)
        # chat templates typically embed the BOS token themselves
        explicit_bos = self.bos_id is not None and text.startswith(
            self.id_to_token(self.bos_id) or "\x00"
        )
        return self.encode(text, add_bos=not explicit_bos)

    def stream_decoder(self) -> "_IncrementalDecoder":
        return _IncrementalDecoder(self)


class _IncrementalDecoder:
    """Stateful decode: emits only newly-completed text per pushed token.

    Sliding two-offset window (the vLLM detokenize_incrementally scheme): the
    delta is `decode(ids[prefix:]) - decode(ids[prefix:read])`, so tokenizers
    whose decoders strip a leading word-boundary space per call (SentencePiece
    Metaspace — Llama-2/Mistral) still produce correct inter-word spaces; a
    suffix ending in an incomplete UTF-8 sequence is held back until complete.
    """

    def __init__(self, tok: Tokenizer):
        self._tok = tok
        self._ids: list[int] = []
        self._prefix = 0      # token index where the decode window starts
        self._read = 0        # tokens fully represented in _text
        self._text = ""

    def _window(self) -> tuple[str, str]:
        prefix_text = self._tok.decode(self._ids[self._prefix:self._read])
        full_text = self._tok.decode(self._ids[self._prefix:])
        return prefix_text, full_text

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        prefix_text, full_text = self._window()
        if full_text.endswith("�"):
            return ""  # incomplete multi-byte char; wait for more tokens
        delta = full_text[len(prefix_text):]
        self._prefix = self._read
        self._read = len(self._ids)
        self._text += delta
        return delta

    def flush(self) -> str:
        """Emit whatever is still held back (incomplete sequences included) —
        called when a request finishes so no trailing text is lost."""
        if self._read == len(self._ids):
            return ""
        prefix_text, full_text = self._window()
        delta = full_text[len(prefix_text):]
        self._prefix = self._read = len(self._ids)
        self._text += delta
        return delta

    @property
    def text(self) -> str:
        return self._text

    @property
    def ids(self) -> list[int]:
        return list(self._ids)


def _raise_exception(msg):
    raise ValueError(msg)
