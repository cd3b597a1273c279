"""Batched token sampling on the device (counterpart of
localai_tpu/ops/sampling.py):

  penalties (repeat/presence/frequency over a per-slot token-count table)
  → logit bias → temperature → top-k → top-p → min-p → typical-p → sample

Every per-slot knob is a [B] tensor, so any request mix shares one step.

Random numbers: a bit-exact threefry-2x32 (the JAX default PRNG, in its
`jax_threefry_partitionable` variant) gives the same key data for
PRNGKey(seed), the same key split and the same f32 uniform as the
reference, so one seed yields one token stream in both packages. Keys are
held as int64 tensors carrying uint32 values (torch has no general uint32
arithmetic on the card); every add is masked back to 32 bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass
class SamplingParams:
    """Host-side per-request sampling configuration (proto PredictOptions names)."""
    temperature: float = 0.8
    top_k: int = 40            # <=0 disables
    top_p: float = 0.95        # >=1 disables
    min_p: float = 0.0         # <=0 disables
    typical_p: float = 1.0     # >=1 disables
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: int = -1             # <0 → draw from entropy
    logit_bias: dict[int, float] | None = None
    greedy: bool = False       # temperature<=0 → greedy

    def normalized(self) -> "SamplingParams":
        p = dataclasses.replace(self)
        if p.temperature is None or p.temperature <= 0:
            p.greedy = True
            p.temperature = 1.0
        if not p.top_k or p.top_k <= 0:
            p.top_k = 0
        if p.top_p is None or p.top_p <= 0:
            p.top_p = 1.0
        return p


# ------------------------------------------------------------ threefry-2x32

def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 tensors (or numpy uint64
    arrays) holding uint32 values; all four broadcast together. Returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def threefry_seed(seed: int) -> np.ndarray:
    """Key data of jax.random.PRNGKey(seed) (32-bit seeds pad the high
    word with zeros). Returns uint32 [2]."""
    seed = int(seed)
    hi = (seed >> 32) & _M32 if seed >= 0 else 0
    return np.asarray([hi, seed & _M32], np.uint32)


def split_keys(keys):
    """jax.random.split(key, 2) for a batch of keys [B, 2] (int64 tensor).
    Returns (first [B, 2], second [B, 2])."""
    k1, k2 = keys[:, 0:1], keys[:, 1:2]
    cnt = torch.arange(2, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)   # [B, 2]
    return (torch.stack([b1[:, 0], b2[:, 0]], dim=1),
            torch.stack([b1[:, 1], b2[:, 1]], dim=1))


def _unit_floats(bits):
    """f32 in [0, 1) from 32 random bits: the mantissa of a float in
    [1, 2), minus 1 (jax.random's construction)."""
    bits = (bits >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def random_bits(keys, n: int):
    """The 32-bit words of jax.random's draw of shape (n,) from each key
    [B, 2] ([B, n] int64): under jax_threefry_partitionable the counters
    are the flat indices (high word 0), and a word is the xor of the two
    outputs."""
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(cnt),
                          cnt)
    return b1 ^ b2


def uniform_scalar(keys):
    """jax.random.uniform(key, ()) (f32 in [0, 1)) for a batch of keys."""
    return torch.clamp_min(_unit_floats(random_bits(keys, 1)[:, 0]), 0.0)


def uniform(keys, n: int):
    """jax.random.uniform(key, (n,)) for a batch of keys: [B, n] f32."""
    return torch.clamp_min(_unit_floats(random_bits(keys, n)), 0.0)


def fold_in(keys, data: int):
    """jax.random.fold_in(key, data) for a batch of keys [B, 2]: the
    threefry hash of the counter pair (0, data) under each key."""
    z = torch.zeros_like(keys[:, 0])
    b1, b2 = threefry2x32(keys[:, 0], keys[:, 1], z,
                          torch.full_like(z, int(data) & _M32))
    return torch.stack([b1, b2], dim=1)


_TINY32 = float(torch.finfo(torch.float32).tiny)


def gumbel(keys, n: int):
    """jax.random.gumbel(key, (n,)) in its default mode "low" (JAX 0.9.0:
    jax_high_dynamic_range_gumbel is off) for a batch of keys: [B, n] f32,
    -log(-log(u)) of a uniform on [tiny, 1)."""
    u = _unit_floats(random_bits(keys, n)) + _TINY32
    return -torch.log(-torch.log(torch.clamp_min(u, _TINY32)))


def categorical(keys, logp):
    """jax.random.categorical(key, logp) row by row: the Gumbel-max draw
    argmax(gumbel + logp) over each row of logp [B, V] (ties to the first
    index, as jnp.argmax). Returns [B] int32."""
    g = gumbel(keys, logp.shape[-1])
    return torch.argmax(g + logp.float(), dim=-1).to(torch.int32)


# ------------------------------------------------------------ sampler state

@dataclasses.dataclass
class SamplerState:
    """Device-side batched sampler state, one row per engine slot."""
    temperature: torch.Tensor   # [B] f32
    top_k: torch.Tensor         # [B] i32 (0 = off)
    top_p: torch.Tensor         # [B] f32
    min_p: torch.Tensor         # [B] f32
    typical_p: torch.Tensor     # [B] f32
    repeat_penalty: torch.Tensor    # [B] f32
    presence_penalty: torch.Tensor  # [B] f32
    frequency_penalty: torch.Tensor # [B] f32
    greedy: torch.Tensor        # [B] bool
    key: torch.Tensor           # [B, 2] int64 holding uint32 key words
    token_counts: torch.Tensor  # [B, V] i32 — occurrences in prompt+generation
    logit_bias: torch.Tensor    # [B, V] f32

    @staticmethod
    def init(batch: int, vocab: int, device=None) -> "SamplerState":
        def z(d):
            return torch.zeros((batch,), dtype=d, device=device)

        def one():
            return torch.ones((batch,), dtype=torch.float32, device=device)

        return SamplerState(
            temperature=one(), top_k=z(torch.int32), top_p=one(),
            min_p=z(torch.float32), typical_p=one(), repeat_penalty=one(),
            presence_penalty=z(torch.float32),
            frequency_penalty=z(torch.float32), greedy=z(torch.bool),
            key=torch.zeros((batch, 2), dtype=torch.int64, device=device),
            token_counts=torch.zeros((batch, vocab), dtype=torch.int32,
                                     device=device),
            logit_bias=torch.zeros((batch, vocab), dtype=torch.float32,
                                   device=device),
        )


def draft_state(sampler: SamplerState) -> SamplerState:
    """A speculative draft's proposal settings: temperature only (greedy
    follows the slot), every truncation, penalty and bias off."""
    ones = torch.ones_like(sampler.top_p)
    zeros = torch.zeros_like(sampler.min_p)
    return dataclasses.replace(
        sampler, top_k=torch.zeros_like(sampler.top_k), top_p=ones,
        min_p=zeros, typical_p=ones,
        repeat_penalty=torch.ones_like(sampler.repeat_penalty),
        presence_penalty=zeros, frequency_penalty=zeros,
        token_counts=torch.zeros_like(sampler.token_counts),
        logit_bias=torch.zeros_like(sampler.logit_bias))


FIELD_DTYPES = {
    "temperature": torch.float32, "top_k": torch.int32,
    "top_p": torch.float32, "min_p": torch.float32,
    "typical_p": torch.float32, "repeat_penalty": torch.float32,
    "presence_penalty": torch.float32, "frequency_penalty": torch.float32,
    "greedy": torch.bool, "key": torch.int64, "logit_bias": torch.float32,
}


def sampler_row(params: SamplingParams, vocab: int, fallback_seed: int,
                include_bias: bool = True) -> dict:
    """Host-side per-slot row values (numpy), everything except
    token_counts. `fallback_seed` is used when the request pins no seed;
    include_bias=False omits the [V]-sized logit_bias."""
    p = params.normalized()
    seed = p.seed if (p.seed is not None and p.seed >= 0) else fallback_seed
    row = dict(
        temperature=np.float32(p.temperature),
        top_k=np.int32(min(p.top_k, vocab)),
        top_p=np.float32(p.top_p),
        min_p=np.float32(p.min_p),
        typical_p=np.float32(p.typical_p),
        repeat_penalty=np.float32(p.repeat_penalty),
        presence_penalty=np.float32(p.presence_penalty),
        frequency_penalty=np.float32(p.frequency_penalty),
        greedy=np.bool_(p.greedy),
        key=threefry_seed(seed),
    )
    if include_bias:
        bias = np.zeros((vocab,), np.float32)
        if p.logit_bias:
            for k, v in p.logit_bias.items():
                if 0 <= int(k) < vocab:
                    bias[int(k)] = v
        row["logit_bias"] = bias
    return row


# ------------------------------------------------------------ the chain

def apply_penalties(logits, state: SamplerState):
    """llama.cpp-semantics penalties: repeat penalty divides positive logits /
    multiplies negative ones for seen tokens; presence/frequency subtract."""
    counts = state.token_counts
    seen = counts > 0
    rp = state.repeat_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen, penalized, logits)
    logits = logits - seen.float() * state.presence_penalty[:, None]
    logits = logits - counts.float() * state.frequency_penalty[:, None]
    return logits


def mask_allowed(mask_bits, v: int):
    """The allowed-token set [B, v] bool of an LSB-first bitmask in either
    wire format: u8 rows [B, ceil(V/8)] (the host matcher's per-step
    upload) or 32-bit words [B, ceil(V/32)] gathered from the device
    grammar table (uint32, or int32 holding the same bit patterns). The
    bit order is the same, so both give the same set."""
    b = mask_bits.shape[0]
    if mask_bits.dtype == torch.uint8:
        width, words = 8, mask_bits.to(torch.int32)
    else:
        # an arithmetic shift of a negative word fills with ones, and & 1
        # keeps the bit shifted down: int32 unpacks as uint32 does
        width, words = 32, mask_bits.view(torch.int32)
    shifts = torch.arange(width, device=mask_bits.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(b, -1)[:, :v].bool()


def pipeline_logits(logits, state: SamplerState, mask_bits=None):
    """Penalties → bias → temperature. mask_bits: an optional LSB-first
    allowed-token bitmask, u8 [B, ceil(V/8)] or 32-bit words
    [B, ceil(V/32)] (mask_allowed)."""
    b, v = logits.shape
    logits = logits.float()
    if mask_bits is not None:
        logits = torch.where(mask_allowed(mask_bits, v), logits, NEG_INF)
    logits = apply_penalties(logits, state)
    logits = logits + state.logit_bias
    return logits / torch.clamp_min(state.temperature[:, None], 1e-6)


def _filtered_sorted(logits, state: SamplerState, mask_bits=None):
    """Pipeline + truncation chain over one shared descending sort.
    Returns (masked sorted logits [B, V], sorted logits, order [B, V])."""
    b, v = logits.shape
    logits = pipeline_logits(logits, state, mask_bits)
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True,
                                      stable=True)
    rank = torch.arange(v, device=logits.device)[None, :]
    k = torch.where(state.top_k > 0, state.top_k,
                    torch.full_like(state.top_k, v))[:, None]
    keep = rank < k
    probs = torch.softmax(torch.where(keep, sorted_logits, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & ((cum - probs) < state.top_p[:, None])
    keep = keep & (probs >= state.min_p[:, None] * probs[:, :1])
    ent = -torch.sum(probs * torch.log(probs + 1e-10), dim=-1, keepdim=True)
    dev = torch.abs(-torch.log(probs + 1e-10) - ent)
    dev_order = torch.sort(dev, dim=-1, stable=True).indices
    p_dev = torch.gather(probs, 1, dev_order)
    typ_cum = torch.cumsum(p_dev, dim=-1)
    typ_sorted = (typ_cum - p_dev) < state.typical_p[:, None]
    typ_keep = torch.zeros((b, v), dtype=torch.bool, device=logits.device)
    typ_keep.scatter_(1, dev_order, typ_sorted)
    keep = keep & torch.where(state.typical_p[:, None] >= 1.0,
                              torch.ones_like(typ_keep), typ_keep)
    keep[:, 0] = True
    masked = torch.where(keep, sorted_logits, NEG_INF)
    return masked, sorted_logits, order


def sampling_probs(logits, state: SamplerState, mask_bits=None):
    """The post-pipeline categorical distribution [B, V] in TOKEN order —
    what sample() draws from (greedy rows → one-hot argmax)."""
    b, v = logits.shape
    masked, _, order = _filtered_sorted(logits, state, mask_bits)
    p_sorted = torch.softmax(masked, dim=-1)
    rank0 = (torch.arange(v, device=logits.device)[None, :] == 0).float()
    p_sorted = torch.where(state.greedy[:, None], rank0, p_sorted)
    out = torch.zeros((b, v), dtype=torch.float32, device=logits.device)
    return out.scatter_(1, order, p_sorted)


def _draw(state: SamplerState, masked):
    """Split the per-slot keys, invert the masked categorical's CDF at ONE
    scalar uniform per slot (width-independent), greedy rows take rank 0.
    Returns (sampled_rank [B] int64, carry_keys [B, 2])."""
    carry, step = split_keys(state.key)
    u = uniform_scalar(step)
    w = torch.exp(masked - masked[:, :1])
    cum = torch.cumsum(w, dim=-1)
    r = u[:, None] * cum[:, -1:]
    rank = torch.sum((cum < r).to(torch.int64), dim=-1)
    rank = torch.where(state.greedy, torch.zeros_like(rank), rank)
    return rank, carry


def sample(logits, state: SamplerState, mask_bits=None, topk_width=None):
    """One sampling step. logits: [B, V]. topk_width (decode fast path):
    a top-`width` window replaces the full sorts when every slot's top_k
    fits it. Returns (tokens [B] i32, new_keys [B, 2], logprobs [B] f32 of
    the chosen token under the pre-truncation distribution)."""
    if topk_width is not None:
        if mask_bits is not None:
            raise ValueError("grammar masks require the full sampling path "
                             "(topk_width must be None)")
        return _sample_topk(logits, state, topk_width)
    masked, sorted_logits, order = _filtered_sorted(logits, state, mask_bits)
    rank, carry = _draw(state, masked)
    tokens = torch.gather(order, 1, rank[:, None])[:, 0]
    logprobs_sorted = torch.log_softmax(sorted_logits, dim=-1)
    tok_logprob = torch.gather(logprobs_sorted, 1, rank[:, None])[:, 0]
    return tokens.to(torch.int32), carry, tok_logprob


def _sample_topk(logits, state: SamplerState, width: int):
    """Sort-free sampling over the top-`width` logits; same sequential
    chain as _filtered_sorted for any slot with 0 < top_k <= width and
    typical_p disabled."""
    logits = pipeline_logits(logits, state, None)
    vals, order = torch.topk(logits, width, dim=-1)
    rank = torch.arange(width, device=logits.device)[None, :]
    k = torch.where(state.top_k > 0, state.top_k,
                    torch.full_like(state.top_k, width))[:, None]
    keep = rank < k
    probs = torch.softmax(torch.where(keep, vals, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & ((cum - probs) < state.top_p[:, None])
    keep = keep & (probs >= state.min_p[:, None] * probs[:, :1])
    keep[:, 0] = True
    masked = torch.where(keep, vals, NEG_INF)
    rank_s, carry = _draw(state, masked)
    tokens = torch.gather(order, 1, rank_s[:, None])[:, 0]
    lse = torch.logsumexp(logits, dim=-1)
    tok_logprob = torch.gather(vals, 1, rank_s[:, None])[:, 0] - lse
    return tokens.to(torch.int32), carry, tok_logprob
