"""Weight quantization: per-channel symmetric int8 (counterpart of
localai_tpu/ops/quant.py).

A quantized weight holds `q` int8 [.., in, out] and `s` f32 [.., 1, out]
(one scale per output channel; an expert stack [E, in, out] has one per
expert and output channel). `qmatmul` computes the reference's
x @ q.astype(x.dtype), then * s in x's dtype, through
ops/kernels.w8a16_matmul: on the card one kernel reads the int8 weight as
stored (no per-call cast), on the CPU its plain version casts and
multiplies. int4 waits for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from localai_tpu_torch import not_ported
from localai_tpu_torch.ops.kernels import w8a16_matmul


class QuantWeight(nn.Module):
    """{"q": int8 [.., in, out], "s": f32 [.., 1, out]} as a module, so the
    pair moves with `.to(device)` like any other buffer."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)



def _check_bits(bits: int):
    if bits == 4:
        raise not_ported("int4 weights", "int4")
    if bits != 8:
        raise ValueError(f"unsupported quantization width {bits}")


def quantize(w, bits: int = 8) -> QuantWeight:
    """f32/bf16 weight [..., in, out] → QuantWeight. Scales reduce over the
    INPUT axis only; rounding is half to even, with the 1e-8 scale floor."""
    _check_bits(bits)
    w32 = torch.as_tensor(w).float()
    amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantWeight(q, scale.float())


def quantize_np(w, bits: int = 8):
    """Host-side numpy mirror of `quantize` (bit-identical: IEEE max/div,
    round half to even). Returns {"q": int8, "s": f32} numpy arrays."""
    _check_bits(bits)
    w32 = np.asarray(w, np.float32)
    amax = np.max(np.abs(w32), axis=-2, keepdims=True)
    scale = np.maximum(amax, 1e-8) / 127
    q = np.clip(np.rint(w32 / scale), -127, 127).astype(np.int8)
    return {"q": q, "s": scale.astype(np.float32)}


def is_quantized(p) -> bool:
    if isinstance(p, QuantWeight):
        return True
    return isinstance(p, dict) and set(p.keys()) == {"q", "s"}


def dequantize(p, dtype=torch.bfloat16):
    q, s = (p.q, p.s) if isinstance(p, QuantWeight) else (p["q"], p["s"])
    return (q.float() * s).to(dtype)


def qmatmul(x, p):
    """x @ W for a (possibly) quantized W; activations keep their dtype."""
    if not is_quantized(p):
        return x @ p
    q, s = (p.q, p.s) if isinstance(p, QuantWeight) else (p["q"], p["s"])
    return w8a16_matmul(x, q, s)


def quantize_params(model, *, bits: int = 8):
    """Quantize every projection matrix of a models.llama.Llama in place —
    Mixtral's expert stacks per expert and output channel, never its
    router gate (norms, biases and embeddings stay high-precision, as the
    reference's quantize_params keeps them); returns the model."""
    _check_bits(bits)
    for layer in model.layers:
        for name in layer.weight_names():
            w = getattr(layer, name)
            if not is_quantized(w):
                layer.set_weight(name, quantize(w, bits))
    if model.lm_head is not None and not is_quantized(model.lm_head):
        model.set_head(quantize(model.lm_head, bits))
    return model
