"""Quantized KV cache — int8 storage with per-token scales (counterpart of
localai_tpu/ops/kvcache.py).

K/V live as int8 with one f32 scale per (token, kv-head), symmetric over
head_dim. The scales of a cache [..., T, D] are stored as [..., T // 128,
128] (token t ↦ element [t // 128, t % 128]), so T must be a multiple of
128; callers round up with `padded_len` (extra rows are never read —
attention masks by length).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

SCALE_TILE = 128
_QMAX = 127.0
_EPS = 1e-8


def is_quant_kind(kind: str | None) -> bool:
    """True for the cache-type strings that select int8 storage."""
    return (kind or "").lower() in ("int8", "q8_0", "q8")


@dataclasses.dataclass
class QuantKV:
    """One int8 cache tensor: `q` [..., T, D] int8, `s` [..., T//128, 128] f32."""
    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, idx):
        # leading-axis indexing only (layer / slot); token and head_dim axes
        # stay whole because `s` mirrors only the lead dims
        return QuantKV(self.q[idx], self.s[idx])


def padded_len(t: int) -> int:
    """Round a cache length up to the scale-tile multiple the layout needs."""
    return -(-t // SCALE_TILE) * SCALE_TILE


def init_quant(shape, *, device=None) -> QuantKV:
    """Zero cache of logical shape [..., T, D] (T already tile-padded)."""
    *lead, t, d = shape
    if t % SCALE_TILE:
        raise ValueError(f"quantized cache length {t} not a multiple of "
                         f"{SCALE_TILE} (use padded_len)")
    return QuantKV(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros((*lead, t // SCALE_TILE, SCALE_TILE), dtype=torch.float32,
                    device=device))


@functools.lru_cache(maxsize=None)
def _qmax_on(device):
    """_QMAX as a 0-dim f32 tensor on a CUDA device. PyTorch divides a CUDA
    tensor by a Python number as a product with the number's rounded
    reciprocal, which moves some scales by an ulp; by a device tensor it
    divides (IEEE, as on the CPU, in the reference and in the card's
    quantizing scatter kernel)."""
    return torch.tensor(_QMAX, dtype=torch.float32, device=device)


def quantize_tokens(x):
    """Per-token symmetric int8 over the trailing head_dim axis.
    x: [..., D] → (q int8 same shape, scale f32 lead shape). Both divisions
    are IEEE divisions on every device: scale = max(amax, 1e-8) / 127 and q
    = round-half-even(x / scale) clamped to ±127."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    qmax = _qmax_on(xf.device) if xf.device.type == "cuda" else _QMAX
    scale = torch.clamp_min(amax, _EPS) / qmax
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def token_scales(cache: QuantKV):
    """Scales as [..., T] (the tile layout flattened back to token order)."""
    *lead, rows, tile = cache.s.shape
    return cache.s.reshape(*lead, rows * tile)


def dequant(cache, dtype=torch.bfloat16):
    """QuantKV → dense [..., T, D]; dense tensors pass through untouched."""
    if not isinstance(cache, QuantKV):
        return cache
    s = token_scales(cache)[..., None]
    return (cache.q.float() * s).to(dtype)


def cache_scatter(cache: QuantKV, idx, values) -> QuantKV:
    """Quantize dense token vectors and write them into the cache IN PLACE
    (the reference returns a new array; the port updates the buffers it
    owns). idx: advanced-index tuple over the cache's lead+token axes;
    values: matching [..., D] rows. Returns `cache` for chaining."""
    q, scale = quantize_tokens(values)
    *lead_idx, tok_idx = idx
    s_idx = (*lead_idx, tok_idx // SCALE_TILE, tok_idx % SCALE_TILE)
    cache.q[idx] = q
    cache.s[s_idx] = scale.to(cache.s.dtype)
    return cache


def requantize(cache: QuantKV, dense) -> QuantKV:
    """Dense [..., T, D] → a fresh QuantKV in `cache`'s scale layout ([..,
    T // 128, 128]; a paged block's [.., 1, 128]): the context shift's
    rewrites go through here after working in f32."""
    q, scale = quantize_tokens(dense)
    *lead, t = scale.shape
    return QuantKV(q, scale.reshape(*lead, t // SCALE_TILE, SCALE_TILE)
                   .to(cache.s.dtype))
