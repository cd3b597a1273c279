"""Hand-written CUDA kernels of the port (counterparts of
localai_tpu/ops/pallas, and — weight_gemm — of the XLA-fused weight
products of localai_tpu/ops/quant.py and models/llama.py, int8 and
packed int4, Mixtral's experts included). Importing this package builds
nothing: each kernel's shared library is compiled with nvcc at its first
launch (_build.py).

Every wrapper adds one to its own count where it launches its kernel, and
nowhere else; `launch_counts()` reads all the counts, `reset_launch_counts()`
sets them to 0. A CUDA graph replays its kernels without a Python call, so
its runner (engine/graphs.py) adds a replay's launches with
`add_launch_counts()`."""
from localai_tpu_torch.ops.kernels import flash_attention as _fa
from localai_tpu_torch.ops.kernels import paged_scatter as _ps
from localai_tpu_torch.ops.kernels import ragged_attention as _ra
from localai_tpu_torch.ops.kernels import weight_gemm as _wg
from localai_tpu_torch.ops.kernels.flash_attention import (  # noqa: F401
    COLD_SPAN_TILES,
    DECODE_TILE,
    decode_split,
    flash_prefill,
    flash_prefill_plain,
    ragged_decode,
    ragged_decode_plain,
    ragged_decode_q8,
    ragged_decode_q8_plain,
    tier_plan,
    tier_span_tiles,
    tier_split,
)
from localai_tpu_torch.ops.kernels.paged_scatter import (  # noqa: F401
    demote_targets,
    paged_demote_q8,
    paged_demote_q8_plain,
    paged_scatter_append,
    paged_scatter_append_plain,
    paged_scatter_append_q8,
    paged_scatter_append_q8_plain,
    paged_scatter_append_q8_sharded,
    paged_scatter_append_sharded,
    paged_targets,
)
from localai_tpu_torch.ops.kernels.ragged_attention import (  # noqa: F401
    QBLK,
    RAGGED_TILE,
    ragged_paged_attention,
    ragged_paged_attention_plain,
    ragged_paged_attention_q8,
    ragged_paged_attention_q8_plain,
    ragged_paged_attention_q8_sharded,
    ragged_paged_attention_sharded,
    ragged_scatter_append,
    ragged_scatter_append_plain,
    ragged_scatter_append_q8,
    ragged_scatter_append_q8_plain,
    ragged_scatter_append_q8_sharded,
    ragged_scatter_append_sharded,
    ragged_split,
    ragged_tiling,
)
from localai_tpu_torch.ops.kernels.weight_gemm import (  # noqa: F401
    gemm_split,
    head_matmul,
    head_matmul_plain,
    moe_w4_matmul,
    moe_w4_matmul_plain,
    moe_w8_matmul,
    moe_w8_matmul_plain,
    pack_int4,
    split_bf16_terms,
    split_bf16_terms_plain,
    unpack_int4,
    w4a16_matmul,
    w4a16_matmul_plain,
    w8a16_matmul,
    w8a16_matmul_plain,
)

_COUNTS = (_fa.LAUNCHES, _ps.LAUNCHES, _ra.LAUNCHES, _wg.LAUNCHES)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


def add_launch_counts(delta: dict) -> None:
    """Add {kernel name: launches} to the counts."""
    for k, v in delta.items():
        for counts in _COUNTS:
            if k in counts:
                counts[k] += v
