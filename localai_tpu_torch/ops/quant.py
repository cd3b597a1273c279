"""Weight quantization: per-channel symmetric int8 and int4 (counterpart of
localai_tpu/ops/quant.py).

A quantized weight holds `q` and `s` f32 [.., 1, out] (one scale per
output channel; an expert stack [E, in, out] has one per expert and
output channel). The width is read from q's dtype: int8 [.., in, out]
(bits=8), or packed int4 uint8 [.., in/2, out] (bits=4; the reference
stores jnp.int4): byte (j, n) holds input row 2j in its low nibble and
2j + 1 in its high nibble, each a two's-complement value in [-7, 7]
(ops/kernels.pack_int4 / unpack_int4 know the layout; `in` must be even).
`qmatmul` computes the reference's x @ q.astype(x.dtype), then * s in
x's dtype, through ops/kernels.w8a16_matmul or w4a16_matmul: on the card
one kernel reads the weight as stored (no per-call cast or unpacking),
on the CPU its plain version unpacks, casts and multiplies.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from localai_tpu_torch.ops.kernels import (
    pack_int4, unpack_int4, w4a16_matmul, w8a16_matmul,
)

# the largest magnitude a width stores (the reference's qmax)
QMAX = {8: 127, 4: 7}


class QuantWeight(nn.Module):
    """{"q": int8 [.., in, out] or packed int4 uint8 [.., in/2, out], "s":
    f32 [.., 1, out]} as a module, so the pair moves with `.to(device)`
    like any other buffer."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


def _qmax(bits: int) -> int:
    if bits not in QMAX:
        raise ValueError(f"unsupported quantization width {bits}")
    return QMAX[bits]


def quantize(w, bits: int = 8) -> QuantWeight:
    """f32/bf16 weight [..., in, out] → QuantWeight. Scales reduce over the
    INPUT axis only; rounding is half to even, with the 1e-8 scale floor
    (the reference's values bit for bit; bits=4 then packs them, which
    needs an even `in`)."""
    qmax = _qmax(bits)
    w32 = torch.as_tensor(w).float()
    amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    return QuantWeight(pack_int4(q) if bits == 4 else q, scale.float())


def quantize_np(w, bits: int = 8):
    """Host-side numpy mirror of `quantize` (bit-identical: IEEE max/div,
    round half to even). Returns {"q": int8, "s": f32} numpy arrays; int4
    values stay unpacked in the int8 container, as the reference's do."""
    qmax = _qmax(bits)
    w32 = np.asarray(w, np.float32)
    amax = np.max(np.abs(w32), axis=-2, keepdims=True)
    scale = np.maximum(amax, 1e-8) / qmax
    q = np.clip(np.rint(w32 / scale), -qmax, qmax).astype(np.int8)
    return {"q": q, "s": scale.astype(np.float32)}


def is_quantized(p) -> bool:
    if isinstance(p, QuantWeight):
        return True
    return isinstance(p, dict) and set(p.keys()) == {"q", "s"}


def _qs(p):
    return (p.q, p.s) if isinstance(p, QuantWeight) else (p["q"], p["s"])


def dequantize(p, dtype=torch.bfloat16):
    q, s = _qs(p)
    if q.dtype == torch.uint8:
        q = unpack_int4(q)
    return (q.float() * s).to(dtype)


def qmatmul(x, p):
    """x @ W for a (possibly) quantized W; activations keep their dtype."""
    if not is_quantized(p):
        return x @ p
    q, s = _qs(p)
    if q.dtype == torch.uint8:
        return w4a16_matmul(x, q, s)
    return w8a16_matmul(x, q, s)


def quantize_params(model, *, bits: int = 8):
    """Quantize every projection matrix of a models.llama.Llama in place —
    Mixtral's expert stacks per expert and output channel, never its
    router gate (norms, biases and embeddings stay high-precision, as the
    reference's quantize_params keeps them); returns the model."""
    _qmax(bits)
    for layer in model.layers:
        for name in layer.weight_names():
            w = getattr(layer, name)
            if not is_quantized(w):
                layer.set_weight(name, quantize(w, bits))
    if model.lm_head is not None and not is_quantized(model.lm_head):
        model.set_head(quantize(model.lm_head, bits))
    return model
