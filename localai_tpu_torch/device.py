"""Device selection: the port runs on the card unless the caller asks for
the CPU. There is no silent fallback — with no CUDA device and no explicit
"cpu", `resolve_device` raises."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None`/"cuda" → the current CUDA device (raises when CUDA is absent);
    "cpu" (or any explicit device) → that device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port on "
            "the CPU (plain PyTorch versions of every kernel)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name) -> torch.dtype:
    """Model dtype name (config strings such as "bfloat16") → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    table = {"float32": torch.float32, "f32": torch.float32,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "float16": torch.float16, "f16": torch.float16}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}")
    return table[name]
