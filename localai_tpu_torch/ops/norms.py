"""Normalization ops (counterpart of localai_tpu/ops/norms.py).

Computed in float32 whatever the input dtype, then cast back to it, as the
reference does."""
import torch


def rms_norm(x, weight, eps: float = 1e-6, *, offset: float = 0.0):
    """RMSNorm. `offset=1.0` gives the Gemma convention (weight stored as w-1)."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + eps))
    w = weight.float() + offset
    return (y * w).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) / torch.sqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)
