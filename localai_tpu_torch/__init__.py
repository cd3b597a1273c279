"""PyTorch/CUDA port of localai_tpu — the Llama serving path on one NVIDIA
H100, with the attention kernels hand-written in CUDA C++ for sm_90a.

The package mirrors localai_tpu's layout module for module, so each port
module's counterpart sits at the same relative path. It imports `torch`,
never `jax`, and nothing of `localai_tpu`. Every entry point runs on the
CUDA device unless the caller asks for the CPU (see device.py).
"""
__version__ = "0.1.0"


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    """The error for a feature of the reference that a later slice of the
    port brings; raised, never silently ignored."""
    return NotImplementedError(
        f"{what} waits for the {slice_name} slice of the PyTorch port")
