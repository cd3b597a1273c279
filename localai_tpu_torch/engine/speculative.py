"""Single-stream speculative decoding, driven from the host (counterpart of
localai_tpu/engine/speculative.py): the draft proposes gamma tokens one
decode step at a time, the target scores all gamma+1 window positions in
one `extend`, and rejection sampling (Leviathan et al. 2023) accepts a
prefix and resamples once, so the output follows the target's
distribution. Temperature sampling uses the full softmax of both models;
temperature 0 is exact greedy-match acceptance. The serving engine's
batched, device-side form is engine/spec.py; this class reads every
proposal and test on the host, as its reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.llama import (
    LlamaConfig, decode_step, extend, init_kv_cache, prefill,
)
from localai_tpu_torch.ops.rope import rope_table


@dataclasses.dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


class SpeculativeDecoder:
    """Single-stream speculative generation over (target, draft) models, on
    the CUDA device unless `device="cpu"` is passed."""

    def __init__(self, cfg_t: LlamaConfig, params_t, cfg_d: LlamaConfig,
                 params_d, *, gamma: int = 4, max_context: int = 1024,
                 device=None):
        if cfg_t.vocab_size != cfg_d.vocab_size:
            raise ValueError("draft/target vocabularies differ")
        self.device = resolve_device(device)
        self.cfg_t, self.params_t = cfg_t, params_t.to(self.device)
        self.cfg_d, self.params_d = cfg_d, params_d.to(self.device)
        self.gamma = gamma
        self.T = min(max_context, cfg_t.max_position, cfg_d.max_position)
        self.stats = SpecStats()
        self._cos_t, self._sin_t = rope_table(cfg_t.rope, self.T,
                                              device=self.device)
        self._cos_d, self._sin_d = rope_table(cfg_d.rope, self.T,
                                              device=self.device)

    def _i32(self, values):
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    @torch.no_grad()
    def generate(self, prompt_ids: list[int], max_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos_ids: set[int] | None = None) -> list[int]:
        eos_ids = eos_ids or set()
        rng = np.random.default_rng(seed)
        n = len(prompt_ids)
        if n + max_tokens + self.gamma + 1 > self.T:
            raise ValueError("prompt + max_tokens exceeds speculative context")
        ct, cd, dev = self.cfg_t, self.cfg_d, self.device
        kc_t, vc_t = init_kv_cache(ct, 1, self.T, device=dev)
        kc_d, vc_d = init_kv_cache(cd, 1, self.T, device=dev)
        ids, lengths, slot = self._i32([prompt_ids]), self._i32([n]), \
            self._i32([0])
        last_logits_t = prefill(self.params_t, ct, ids, lengths, self._cos_t,
                                self._sin_t, kc_t, vc_t, slot)[0]
        prefill(self.params_d, cd, ids, lengths, self._cos_d, self._sin_d,
                kc_d, vc_d, slot)

        out: list[int] = []
        all_ids = list(prompt_ids)       # every committed token, by position
        pos = n                          # committed length
        draft_done = n                   # committed positions in draft cache

        def sample_from(logits):
            if temperature <= 0:
                return int(torch.argmax(logits))
            p = torch.softmax(logits / temperature, dim=-1).cpu().numpy()
            return int(rng.choice(len(p), p=p / p.sum()))

        def probs(logits):
            return torch.softmax(logits / temperature, dim=-1).cpu().numpy()

        while len(out) < max_tokens:
            gamma = min(self.gamma, max_tokens - len(out))
            prev = sample_from(last_logits_t)
            out.append(prev)
            all_ids.append(prev)
            if prev in eos_ids or len(out) >= max_tokens:
                break

            # draft: catch up on the committed tokens it has not seen
            # (prev included), then propose gamma tokens one by one
            catch_up = all_ids[draft_done:pos + 1]
            dl = extend(self.params_d, cd, self._i32([catch_up]),
                        self._i32([draft_done]), self._cos_d, self._sin_d,
                        kc_d, vc_d)
            draft_done = pos + 1
            dlogits_all = [dl[0, -1]]
            draft_tokens = [sample_from(dl[0, -1])]
            for g in range(1, gamma):
                dstep = decode_step(self.params_d, cd,
                                    self._i32([draft_tokens[-1]]),
                                    self._i32([pos + g]), self._cos_d,
                                    self._sin_d, kc_d, vc_d)
                dlogits_all.append(dstep[0])
                draft_tokens.append(sample_from(dstep[0]))

            # the target scores the whole window in one extend
            window = [prev] + draft_tokens
            tlogits = extend(self.params_t, ct, self._i32([window]),
                             self._i32([pos]), self._cos_t, self._sin_t,
                             kc_t, vc_t)[0]   # row g: the token after g

            n_accept = 0
            resampled = None
            for g, d_tok in enumerate(draft_tokens):
                if len(out) >= max_tokens or out[-1] in eos_ids:
                    break
                self.stats.proposed += 1
                if temperature <= 0:
                    t_tok = int(torch.argmax(tlogits[g]))
                    if t_tok == d_tok:
                        out.append(d_tok)
                        all_ids.append(d_tok)
                        n_accept += 1
                        continue
                    resampled = t_tok
                    break
                pt, pd = probs(tlogits[g]), probs(dlogits_all[g])
                if rng.random() < min(1.0, pt[d_tok] / max(pd[d_tok], 1e-20)):
                    out.append(d_tok)
                    all_ids.append(d_tok)
                    n_accept += 1
                    continue
                resid = np.maximum(pt - pd, 0.0)
                s = resid.sum()
                resampled = (int(rng.choice(len(resid), p=resid / s))
                             if s > 0 else int(np.argmax(pt)))
                break
            self.stats.accepted += n_accept

            old_pos = pos
            pos += 1 + n_accept           # prev + accepted draft tokens
            # the draft cache holds prev (old_pos) and d_1..d_{gamma-1};
            # only positions < pos are committed, the rest are overwritten
            # by the next catch-up
            draft_done = min(old_pos + gamma, pos)
            if resampled is not None and len(out) < max_tokens:
                # `resampled` is the next iteration's forced `prev`
                last_logits_t = torch.full((ct.vocab_size,), -1e9,
                                           dtype=torch.float32, device=dev)
                last_logits_t[resampled] = 0.0
            else:
                last_logits_t = tlogits[n_accept]
            if out[-1] in eos_ids:
                break

        return out[:max_tokens]
