"""Rotary position embeddings with the long-context scaling family
(counterpart of localai_tpu/ops/rope.py): precomputed cos/sin tables applied
in the "split halves" (GPT-NeoX / HF Llama) layout.

Scaling modes: none | linear | yarn | llama3 (HF rope_scaling parity)."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    head_dim: int = 128
    base: float = 10000.0           # rope_freq_base
    scaling: str = "none"           # none | linear | yarn | llama3
    scale_factor: float = 1.0       # 1/rope_freq_scale (HF "factor")
    original_max_position: int = 4096
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attn_factor: float | None = None   # HF attention_factor; None → computed
    # llama3
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0


def _yarn_find_dim(num_rot: float, dim: int, base: float, max_pos: int) -> float:
    return (dim * math.log(max_pos / (num_rot * 2 * math.pi))) / (2 * math.log(base))


def rope_freqs(cfg: RopeConfig):
    """Per-channel inverse frequencies [head_dim//2] (float32, on the CPU)
    and the attention magnitude scale (mscale, used by yarn)."""
    half = cfg.head_dim // 2
    f32 = torch.float32
    inv_freq = 1.0 / (torch.tensor(cfg.base, dtype=f32)
                      ** (torch.arange(0, half, dtype=f32) / half))
    mscale = 1.0

    if cfg.scaling == "linear":
        inv_freq = inv_freq / cfg.scale_factor
    elif cfg.scaling == "llama3":
        low_wavelen = cfg.original_max_position / cfg.low_freq_factor
        high_wavelen = cfg.original_max_position / cfg.high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        smooth = (cfg.original_max_position / wavelen - cfg.low_freq_factor) / (
            cfg.high_freq_factor - cfg.low_freq_factor)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        scaled = inv_freq / cfg.scale_factor
        blended = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wavelen, scaled,
            torch.where(wavelen < high_wavelen, inv_freq, blended))
    elif cfg.scaling == "yarn":
        lo = max(math.floor(_yarn_find_dim(cfg.beta_fast, cfg.head_dim,
                                           cfg.base,
                                           cfg.original_max_position)), 0)
        hi = min(math.ceil(_yarn_find_dim(cfg.beta_slow, cfg.head_dim,
                                          cfg.base,
                                          cfg.original_max_position)),
                 cfg.head_dim - 1)
        if hi == lo:
            hi += 0.001
        ramp = torch.clamp((torch.arange(half, dtype=f32) - lo) / (hi - lo),
                           0.0, 1.0)
        inv_freq = inv_freq / cfg.scale_factor * ramp + inv_freq * (1.0 - ramp)
        if cfg.attn_factor is not None:
            mscale = cfg.attn_factor
        elif cfg.scale_factor > 1:
            mscale = 0.1 * math.log(cfg.scale_factor) + 1.0
    elif cfg.scaling != "none":
        raise ValueError(f"unknown rope scaling mode {cfg.scaling!r}")

    return inv_freq, mscale


def rope_table(cfg: RopeConfig, max_len: int, device=None):
    """(cos, sin) tables of shape [max_len, head_dim//2] (float32)."""
    inv_freq, mscale = rope_freqs(cfg)
    t = torch.arange(max_len, dtype=torch.float32)
    angles = t[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(angles) * mscale, torch.sin(angles) * mscale
    if device is not None:
        cos, sin = cos.to(device), sin.to(device)
    return cos, sin


def apply_rope(x, cos, sin, positions):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] integer indices
    into the tables. Channel i rotates with channel i + head_dim//2."""
    dtype = x.dtype
    positions = positions.long()
    c = cos[positions].unsqueeze(-2)  # [..., seq, 1, half]
    s = sin[positions].unsqueeze(-2)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)
