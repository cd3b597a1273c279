"""Grammar matcher binding: GBNF → native PDA → per-step token bitmasks
(counterpart of localai_tpu/functions/matcher.py).

Host/device split: the native library (localai_tpu_torch/native/grammar.cpp)
tracks the parse state and produces a [ceil(V/8)]-byte allowed-token bitmask;
the engine uploads masks for host-masked slots each step and the sampler
applies them on the device before top-k/top-p (ops/sampling.sample). For
grammars whose automaton fits the engine's table, `CompiledGrammar.table`
enumerates every token-reachable state once, and the fused decode loops
gather each step's mask row and advance the state on the device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import threading

import numpy as np

from localai_tpu_torch.native import build_and_load


@functools.lru_cache(maxsize=8)
def _lib():
    lib = build_and_load("grammar")
    lib.gm_compile.restype = ctypes.c_void_p
    lib.gm_compile.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.gm_set_vocab.restype = ctypes.c_int
    lib.gm_set_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.gm_state_new.restype = ctypes.c_void_p
    lib.gm_state_new.argtypes = [ctypes.c_void_p]
    lib.gm_state_accept_token.restype = ctypes.c_int
    lib.gm_state_accept_token.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gm_state_mask.restype = ctypes.c_int
    lib.gm_state_mask.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.gm_state_done.restype = ctypes.c_int
    lib.gm_state_done.argtypes = [ctypes.c_void_p]
    lib.gm_state_can_continue.restype = ctypes.c_int
    lib.gm_state_can_continue.argtypes = [ctypes.c_void_p]
    lib.gm_state_free.argtypes = [ctypes.c_void_p]
    lib.gm_free.argtypes = [ctypes.c_void_p]
    lib.gm_table_build.restype = ctypes.c_int
    lib.gm_table_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
    return lib


# ------------------------------------------------------------ token texts

_BYTELEVEL_DECODER: dict[str, int] | None = None


def _bytelevel_table() -> dict[str, int]:
    """GPT-2 bytes↔unicode mapping (chars used by ByteLevel tokenizers)."""
    global _BYTELEVEL_DECODER
    if _BYTELEVEL_DECODER is None:
        bs = (list(range(ord("!"), ord("~") + 1))
              + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        _BYTELEVEL_DECODER = {chr(c): b for b, c in zip(bs, cs)}
    return _BYTELEVEL_DECODER


def token_texts(tok) -> list[str]:
    """Raw text each vocab id contributes mid-sequence. Handles ByteLevel
    (byte-alphabet remap; tokens with partial UTF-8 → ''), Metaspace (▁→space)
    and WordPiece (## continuation)."""
    hf = tok._tok
    try:
        spec = json.loads(hf.to_str())
        dec = (spec.get("decoder") or {})
        dtypes = [dec.get("type")] + [
            d.get("type") for d in dec.get("decoders", []) or []
        ]
    except Exception:
        dtypes = [None]

    vocab_size = hf.get_vocab_size()
    out = [""] * vocab_size
    table = _bytelevel_table()
    for i in range(vocab_size):
        t = hf.id_to_token(i)
        if t is None:
            continue
        if "ByteLevel" in dtypes:
            try:
                raw = bytes(table[c] for c in t)
            except KeyError:
                out[i] = ""  # special token — never allowed by a grammar
                continue
            try:
                out[i] = raw.decode("utf-8")
            except UnicodeDecodeError:
                out[i] = ""  # partial multi-byte sequence
        elif "Metaspace" in dtypes:
            out[i] = t.replace("▁", " ")
        elif "WordPiece" in dtypes:
            out[i] = t[2:] if t.startswith("##") else t
        else:
            out[i] = t
    return out


@dataclasses.dataclass(frozen=True)
class GrammarTable:
    """Dense automaton tables for device-side constrained decoding: the
    whole token-reachable state set of one grammar, enumerated once off the
    hot path (gm_table_build). State 0 is the initial state.

    masks     [n_states, (V+31)//32] u32 — LSB-first allowed-token bitmask,
              bit-compatible with MatcherState.mask_bits(()) (no EOS bits:
              EOS policy is the engine's, injected per-tokenizer at install)
    trans     [n_states, V] i32 — next state per token, -1 where masked off
    accepting [n_states] u8 — a completed parse exists in this state
    """
    n_states: int
    masks: np.ndarray
    trans: np.ndarray
    accepting: np.ndarray


class CompiledGrammar:
    """A grammar compiled against a tokenizer's vocabulary."""

    def __init__(self, gbnf: str, token_strings: list[str]):
        lib = _lib()
        err = ctypes.create_string_buffer(256)
        self._g = lib.gm_compile(gbnf.encode(), err, 256)
        if not self._g:
            raise ValueError(f"grammar parse error: {err.value.decode()}")
        self.vocab_size = len(token_strings)
        self.nbytes = (self.vocab_size + 7) // 8
        self.nwords = (self.vocab_size + 31) // 32
        blob = b"".join(s.encode() for s in token_strings)
        offsets = np.zeros(self.vocab_size + 1, np.int64)
        o = 0
        for i, s in enumerate(token_strings):
            offsets[i] = o
            o += len(s.encode())
        offsets[self.vocab_size] = o
        lib.gm_set_vocab(
            self._g, blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.vocab_size)
        self._lib = lib
        self._tables: dict[int, GrammarTable | None] = {}
        self._tables_lock = threading.Lock()

    def state(self) -> "MatcherState":
        return MatcherState(self)

    def table(self, cap: int) -> GrammarTable | None:
        """The grammar's dense device tables, or None when the reachable
        state set exceeds `cap` (unbounded-nesting grammars never close —
        those keep the per-token host matcher path). Memoized per cap; the
        BFS enumeration runs OUTSIDE the lock (it trials every vocab token
        from every state — slow is fine off the hot path, holding a lock
        across it is not) with a double-checked insert."""
        with self._tables_lock:
            if cap in self._tables:
                return self._tables[cap]
        tbl = self._build_table(cap)
        with self._tables_lock:
            return self._tables.setdefault(cap, tbl)

    def _build_table(self, cap: int) -> GrammarTable | None:
        if cap <= 0:
            return None
        masks = np.zeros((cap, self.nwords), np.uint32)
        trans = np.full((cap, self.vocab_size), -1, np.int32)
        accepting = np.zeros(cap, np.uint8)
        n = self._lib.gm_table_build(
            self._g, cap,
            masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self.nwords,
            trans.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            accepting.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if n < 0:
            return None
        return GrammarTable(n, masks[:n].copy(), trans[:n].copy(),
                            accepting[:n].copy())

    def __del__(self):
        if getattr(self, "_g", None):
            self._lib.gm_free(self._g)
            self._g = None


class GrammarCache:
    """Per-tokenizer cache of compiled grammars (token_texts is computed
    once; grammar compiles are memoized by text). Thread-safe: request
    handler threads and the engine loop both call get(); the compile runs
    outside the lock with a double-checked insert, so a slow grammar
    compile (or table precompilation behind it) never blocks other
    threads' cache hits."""

    def __init__(self, tok):
        self._texts = token_texts(tok)
        self._cache: dict[str, CompiledGrammar] = {}
        self._lock = threading.Lock()

    def get(self, gbnf: str) -> CompiledGrammar:
        with self._lock:
            g = self._cache.get(gbnf)
        if g is not None:
            return g
        g = CompiledGrammar(gbnf, self._texts)   # slow: outside the lock
        with self._lock:
            if len(self._cache) > 32:
                self._cache.clear()
            return self._cache.setdefault(gbnf, g)


class MatcherState:
    def __init__(self, grammar: CompiledGrammar):
        self.g = grammar
        self._s = grammar._lib.gm_state_new(grammar._g)

    def accept(self, token_id: int) -> bool:
        return bool(self.g._lib.gm_state_accept_token(self._s, token_id))

    def mask_bits(self, eos_ids=()) -> np.ndarray:
        """Allowed-token bitmask [nbytes] u8; EOS bits set iff the grammar
        can complete here."""
        bits = np.zeros(self.g.nbytes, np.uint8)
        self.g._lib.gm_state_mask(
            self._s, bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.g.nbytes)
        if self.done:
            for e in eos_ids:
                if 0 <= e < self.g.vocab_size:
                    bits[e >> 3] |= 1 << (e & 7)
        return bits

    @property
    def done(self) -> bool:
        return bool(self.g._lib.gm_state_done(self._s))

    @property
    def can_continue(self) -> bool:
        return bool(self.g._lib.gm_state_can_continue(self._s))

    def __del__(self):
        if getattr(self, "_s", None):
            self.g._lib.gm_state_free(self._s)
            self._s = None
