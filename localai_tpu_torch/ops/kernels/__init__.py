"""Hand-written CUDA kernels of the port (counterparts of
localai_tpu/ops/pallas). Importing this package builds nothing: each
kernel's shared library is compiled with nvcc at its first launch
(_build.py)."""
from localai_tpu_torch.ops.kernels.flash_attention import (  # noqa: F401
    LAUNCHES,
    flash_prefill,
    flash_prefill_plain,
    launch_counts,
    ragged_decode,
    ragged_decode_plain,
    ragged_decode_q8,
    ragged_decode_q8_plain,
    reset_launch_counts,
)
