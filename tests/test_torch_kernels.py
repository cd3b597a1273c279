"""The PyTorch port's attention kernels (localai_tpu_torch.ops.kernels).

On the CPU: each kernel's plain PyTorch version against the Pallas kernel
it replaces, run as tests/test_pallas_attention.py runs it (interpret
mode), on the same numpy inputs; and the wrappers' CPU dispatch. On an
NVIDIA card (marker `cuda`, skipped without one): each CUDA kernel against
its plain version.

Tolerances: 2e-5 in f32 (same math, sums in another order). With bf16
inputs/outputs, plain vs Pallas: 2e-2, the bf16 bar of
test_pallas_attention.py; CUDA kernel vs plain: atol 1e-3 + rtol 2**-7
(one bf16 ulp, relative) — both compute in f32 and round once, so they
differ by at most one rounding step of the output (chip_smoke.py holds
the same bar; the bf16 prefill kernel's tensor-core P V takes p as two
bf16 terms, hi + lo, about 2**-17 relative). Only query rows below each row's length are compared for
prefill: padding rows are don't-care by the kernels' contract.

JAX is imported inside the CPU tests only, so the card's machine (which
has no JAX) runs the CUDA-gated tests with
`python -m pytest --noconftest tests/test_torch_kernels.py -m cuda`.
"""
import numpy as np
import pytest
import torch

from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops.kvcache import quantize_tokens
from localai_tpu_torch.parallel.mesh import Mesh
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_CARD = dict(rtol=2 ** -7, atol=1e-3)


def _rng(seed):
    return np.random.default_rng(seed)


def _pallas():
    """The reference kernels (interpret mode on the CPU) and jax.numpy."""
    import jax.numpy as jnp

    from localai_tpu.ops.pallas import flash_attention as pfa

    return pfa, jnp


def _prefill_inputs(seed, B, S, H, KVH, D):
    r = _rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]


def _valid(x, lens):
    return np.concatenate([x[b, :n] for b, n in enumerate(lens) if n > 0])


# G = 7 (Qwen2-7B's group) and head_dim 256 beside the first three cases
@pytest.mark.parametrize("H,KVH,D", [
    pytest.param(4, 4, 16, id="4-4"), pytest.param(4, 2, 16, id="4-2"),
    pytest.param(8, 1, 16, id="8-1"), pytest.param(7, 1, 16, id="G7"),
    pytest.param(14, 2, 256, id="G7-D256")])
def test_flash_prefill_plain_vs_pallas_gqa(H, KVH, D):
    pfa, jnp = _pallas()
    q, k, v = _prefill_inputs(0, 3, 32, H, KVH, D)
    lens = [32, 19, 1]
    ref = pfa.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens, jnp.int32), block_q=16,
                            block_k=16)
    out = tk.flash_prefill_plain(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), torch.tensor(lens))
    np.testing.assert_allclose(_valid(out.numpy(), lens),
                               _valid(np.asarray(ref), lens), **F32)


def test_flash_prefill_plain_vs_pallas_window():
    pfa, jnp = _pallas()
    q, k, v = _prefill_inputs(1, 2, 48, 4, 2, 16)
    lens = [48, 30]
    ref = pfa.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens, jnp.int32), sliding_window=7,
                            block_q=16, block_k=16)
    out = tk.flash_prefill_plain(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), torch.tensor(lens),
                                 sliding_window=7)
    np.testing.assert_allclose(_valid(out.numpy(), lens),
                               _valid(np.asarray(ref), lens), **F32)


def test_flash_prefill_plain_vs_pallas_bf16():
    pfa, jnp = _pallas()
    q, k, v = _prefill_inputs(2, 1, 32, 2, 2, 16)
    lens = [32]
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = pfa.flash_prefill(*jb, jnp.asarray(lens, jnp.int32), block_q=16,
                            block_k=16)
    tb = [torch.tensor(x).bfloat16() for x in (q, k, v)]
    out = tk.flash_prefill_plain(*tb, torch.tensor(lens))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16)


def _decode_inputs(seed, B, H, KVH, T, D):
    r = _rng(seed)
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = r.standard_normal((B, KVH, T, D)).astype(np.float32)
    vc = r.standard_normal((B, KVH, T, D)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("window,H,KVH,D", [
    pytest.param(None, 8, 2, 16, id="None"),
    pytest.param(20, 8, 2, 16, id="20"),
    pytest.param(None, 7, 1, 16, id="G7"),
    pytest.param(20, 14, 2, 256, id="G7-D256-20")])
def test_ragged_decode_plain_vs_pallas(window, H, KVH, D):
    pfa, jnp = _pallas()
    q, kc, vc = _decode_inputs(3, 3, H, KVH, 64, D)
    lens = [1, 37, 64]
    ref = pfa.ragged_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(lens, jnp.int32),
                            sliding_window=window, block_k=16)
    out = tk.ragged_decode_plain(torch.tensor(q), torch.tensor(kc),
                                 torch.tensor(vc), torch.tensor(lens),
                                 sliding_window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def _q8(kc):
    B, KVH, T, _ = kc.shape
    q, s = quantize_tokens(torch.tensor(kc))
    return q, s.reshape(B, KVH, T // 128, 128)


@pytest.mark.parametrize("window,H,KVH,D", [
    pytest.param(None, 8, 2, 16, id="None"),
    pytest.param(50, 8, 2, 16, id="50"),
    pytest.param(None, 7, 1, 16, id="G7"),
    pytest.param(50, 14, 2, 256, id="G7-D256-50")])
def test_ragged_decode_q8_plain_vs_pallas(window, H, KVH, D):
    pfa, jnp = _pallas()
    q, kc, vc = _decode_inputs(4, 3, H, KVH, 256, D)
    lens = [1, 130, 256]
    kq, ks = _q8(kc)
    vq, vs = _q8(vc)
    ref = pfa.ragged_decode_q8(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()),
        jnp.asarray(lens, jnp.int32), sliding_window=window)
    out = tk.ragged_decode_q8_plain(torch.tensor(q), kq, ks, vq, vs,
                                    torch.tensor(lens),
                                    sliding_window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_wrappers_run_plain_on_cpu_without_counting():
    tk.reset_launch_counts()
    q, k, v = _prefill_inputs(5, 1, 8, 2, 1, 16)
    lens = torch.tensor([8])
    a = tk.flash_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         lens)
    b = tk.flash_prefill_plain(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), lens)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    qd, kc, vc = _decode_inputs(6, 1, 2, 1, 128, 16)
    a = tk.ragged_decode(torch.tensor(qd), torch.tensor(kc),
                         torch.tensor(vc), torch.tensor([5]))
    torch.testing.assert_close(a, tk.ragged_decode_plain(
        torch.tensor(qd), torch.tensor(kc), torch.tensor(vc),
        torch.tensor([5])), rtol=0, atol=0)
    kq, ks = _q8(kc)
    tk.ragged_decode_q8(torch.tensor(qd), kq, ks, kq, ks, torch.tensor([5]))
    # the paged modes and the scatter-append wrappers on CPU tensors
    pool, table = torch.tensor(kc[0])[None], torch.tensor([[0]])
    tk.ragged_decode(torch.tensor(qd), pool, pool, torch.tensor([5]),
                     table=table)
    pq, ps = kq[0][None], ks[0].reshape(1, 1, 1, 128)
    tk.ragged_decode_q8(torch.tensor(qd), pq, ps, pq, ps, torch.tensor([5]),
                        table=table)
    row = torch.tensor(qd[:, 0, :1])                          # [1, KVH, D]
    tk.paged_scatter_append(pool, pool.clone(), row, row, torch.tensor([7]),
                            table)
    tk.paged_scatter_append_q8(pq, ps, pq.clone(), ps.clone(), row, row,
                               torch.tensor([7]), table)
    # the ragged attention and flat-row scatter wrappers (a one-sequence
    # stream of 8 rows, one live)
    qr = torch.tensor(np.repeat(qd[:, 0], 8, axis=0))          # [8, H, D]
    meta = [torch.tensor(x) for x in ([0], [0], [1], [5], [[0]])]
    tk.ragged_paged_attention(qr, pool, pool, *meta)
    tk.ragged_paged_attention_q8(qr, pq, ps, pq, ps, *meta)
    rows8 = row.repeat(8, 1, 1)
    pb8, off8 = torch.zeros(8, dtype=torch.int32), torch.arange(8)
    tk.ragged_scatter_append(pool, pool.clone(), rows8, rows8, pb8, off8)
    tk.ragged_scatter_append_q8(pq, ps, pq.clone(), ps.clone(), rows8, rows8,
                                pb8, off8)
    # the KV tier's reads (identity ring, retention past every position)
    # and the demotion
    one = torch.ones(1, dtype=torch.int32)
    kvt = {"sb": one, "rw": one, "sinks": one * 128, "window": one * 128}
    tk.ragged_decode(torch.tensor(qd), pool, pool, torch.tensor([5]),
                     table=table, kvt=kvt)
    tk.ragged_decode_q8(torch.tensor(qd), pq, ps, pq, ps, torch.tensor([5]),
                        table=table, kvt=kvt)
    tk.ragged_paged_attention(qr, pool, pool, *meta, kvt=kvt)
    tk.ragged_paged_attention_q8(qr, pq, ps, pq, ps, *meta, kvt=kvt)
    tk.paged_demote_q8(pq, ps, pq.clone(), ps.clone(), pool[0], pool[0],
                       tk.demote_targets(0, 1))
    # the weight GEMMs, Mixtral's expert GEMM among them
    xw = torch.ones(2, 16)
    qw, sw = torch.ones(16, 32, dtype=torch.int8), torch.ones(1, 32)
    tk.w8a16_matmul(xw, qw, sw)
    tk.head_matmul(xw, qw, sw)
    tk.moe_w8_matmul(xw, qw.repeat(3, 1, 1), sw.repeat(3, 1, 1))
    # their int4 twins, on a packed weight
    q4 = tk.pack_int4(qw)
    tk.w4a16_matmul(xw, q4, sw)
    tk.head_matmul(xw, q4, sw)
    tk.moe_w4_matmul(xw, q4.repeat(3, 1, 1), sw.repeat(3, 1, 1))
    # the tensor-parallel wrappers, on a one-rank mesh
    one_rank = Mesh(rank=0, model=1, device=torch.device("cpu"))
    tk.paged_scatter_append_sharded(one_rank, pool, pool.clone(), row, row,
                                    torch.tensor([7]), table)
    tk.paged_scatter_append_q8_sharded(one_rank, pq, ps, pq.clone(),
                                       ps.clone(), row, row,
                                       torch.tensor([7]), table)
    tk.ragged_paged_attention_sharded(one_rank, qr, pool, pool, *meta)
    tk.ragged_paged_attention_q8_sharded(one_rank, qr, pq, ps, pq, ps, *meta)
    tk.ragged_scatter_append_sharded(one_rank, pool, pool.clone(), rows8,
                                     rows8, pb8, off8)
    tk.ragged_scatter_append_q8_sharded(one_rank, pq, ps, pq.clone(),
                                        ps.clone(), rows8, rows8, pb8, off8)
    tk.split_bf16_terms(torch.randn(3, 16))
    counts = tk.launch_counts()
    assert set(counts) == {"flash_prefill", "ragged_decode",
                           "ragged_decode_q8", "ragged_decode_paged",
                           "ragged_decode_q8_paged",
                           "ragged_decode_paged_tier",
                           "ragged_decode_q8_paged_tier",
                           "paged_scatter_append",
                           "paged_scatter_append_q8", "paged_demote_q8",
                           "ragged_paged_attention",
                           "ragged_paged_attention_q8",
                           "ragged_paged_attention_tier",
                           "ragged_paged_attention_q8_tier",
                           "ragged_scatter_append",
                           "ragged_scatter_append_q8", "w8a16_matmul",
                           "head_matmul", "moe_w8_matmul", "w4a16_matmul",
                           "head_matmul_int4", "moe_w4_matmul",
                           "paged_scatter_append_sharded",
                           "paged_scatter_append_q8_sharded",
                           "ragged_paged_attention_sharded",
                           "ragged_paged_attention_q8_sharded",
                           "ragged_scatter_append_sharded",
                           "ragged_scatter_append_q8_sharded",
                           "split_bf16_terms"}
    assert not any(counts.values())


@pytest.mark.parametrize("T", [128, 2048, 4096, 131072])
@pytest.mark.parametrize("rows", [1, 32, 128])
def test_decode_split_from_shapes(T, rows):
    """Split-KV decode's spans: whole tiles, at least two where the cache
    has two, that cover the T-token cache; enough (slot, KV head, span)
    blocks to fill the card's 132 SMs where the cache has that many
    two-tile spans; nothing but shapes as input (the lengths would cost a
    device sync every decode step)."""
    import inspect

    assert list(inspect.signature(tk.decode_split).parameters) == [
        "T", "rows", "sms"]
    nsplit, split = tk.decode_split(T, rows, 132)
    assert split > 0 and split % tk.DECODE_TILE == 0
    assert nsplit * split >= T > (nsplit - 1) * split
    tiles = -(-T // tk.DECODE_TILE)
    assert split >= min(2, tiles) * tk.DECODE_TILE
    assert nsplit * rows >= min(132, -(-tiles // 2) * rows)
    assert tk.decode_split(T, rows, 132) == (nsplit, split)


def test_decode_split_computed_once_per_shape():
    """A decode step calls the split-KV wrappers once per layer with the
    same shapes: decode_split computes each shape once."""
    tk.decode_split.cache_clear()
    first = tk.decode_split(4096, 64, 132)
    for _ in range(31):
        assert tk.decode_split(4096, 64, 132) == first
    info = tk.decode_split.cache_info()
    assert (info.misses, info.hits) == (1, 31)


# Qwen2-7B (G = 7), Llama-3.1-405B (G = 16) and head_dim 256 (G = 16 too)
WIDE = [(28, 4, 128), (128, 8, 128), (32, 8, 256), (16, 1, 256)]


@pytest.mark.parametrize("H,KVH,D", WIDE)
def test_wrapper_shape_checks_accept_wide_geometry(H, KVH, D):
    """The card's wrappers take every GQA group size and head_dim up to
    256: prefill, dense and paged decode, ragged attention (shapes only, on
    the meta device: nothing is allocated or launched)."""
    from localai_tpu_torch.ops.kernels.flash_attention import (
        _decode_checks, _prefill_checks,
    )
    from localai_tpu_torch.ops.kernels.ragged_attention import _attn_checks

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    kv = meta(2, 64, KVH, D)
    assert _prefill_checks(meta(2, 64, H, D), kv, kv) == (2, 64, H, KVH, D)
    qd = meta(2, 1, H, D)
    assert _decode_checks("ragged_decode", qd, (2, KVH, 512, D), 512) == (
        2, H, KVH, 512, D)
    assert _decode_checks("ragged_decode", qd, (2, KVH, 128, D), 4 * 128) \
        == (2, H, KVH, 512, D)                        # paged: T = MAXB*128
    tables = torch.zeros(3, 4, dtype=torch.int32)
    assert _attn_checks("ragged_paged_attention", meta(24, H, D),
                        (9, KVH, 128, D), tables) == (24, H, KVH, D, 4)


@pytest.mark.parametrize("D,ragged_ok", [(24, False), (272, True),
                                         (512, True), (528, False)])
def test_wrapper_shape_checks_name_the_head_dim_limit(D, ragged_ok):
    """What the kernels cannot take raises with the limit: head_dim a
    multiple of 16, up to 256 for prefill and decode and 512 for ragged
    attention."""
    from localai_tpu_torch.ops.kernels import ragged_attention as ra
    from localai_tpu_torch.ops.kernels.flash_attention import (
        _decode_checks, _prefill_checks,
    )

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    kv = meta(1, 8, 1, D)
    with pytest.raises(ValueError, match="multiple of 16 and at most 256"):
        _prefill_checks(meta(1, 8, 16, D), kv, kv)
    with pytest.raises(ValueError, match="multiple of 16 and at most 256"):
        _decode_checks("ragged_decode", meta(1, 1, 16, D), (1, 1, 128, D),
                       128)
    tables = torch.zeros(1, 1, dtype=torch.int32)
    args = ("ragged_paged_attention", meta(8, 16, D), (2, 1, 128, D), tables)
    if ragged_ok:
        assert ra._attn_checks(*args)[3] == D
    else:
        with pytest.raises(ValueError, match="multiple of 16 and at most 512"):
            ra._attn_checks(*args)


@pytest.mark.parametrize("case", ["as-is", "int64", "strided", "float"])
def test_wrapper_conversion_only_where_needed(case):
    """The wrappers' int32 lengths, tables and scatter targets, and the
    scatter's rows in the pool dtype: a tensor that already has the dtype,
    is contiguous and is on the device comes back as it is (no conversion
    call on the host); any other is converted to one that has all three."""
    from localai_tpu_torch.ops.kernels.flash_attention import _on

    base = torch.arange(12, dtype=torch.int32)
    x = {"as-is": base, "int64": base.long(),
         "strided": base.reshape(3, 4).t(), "float": base.float()}[case]
    y = _on(x, torch.int32, base.device)
    assert (y is x) == (case == "as-is")
    assert y.dtype == torch.int32 and y.is_contiguous()
    assert torch.equal(y, x.to(torch.int32))


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dev(xs, device, dtype):
    return [torch.tensor(x, device=device).to(dtype) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KVH,window", [(4, 4, None), (8, 2, None),
                                          (8, 1, 9)])
def test_cuda_flash_prefill_vs_plain(cuda, dtype, H, KVH, window):
    td = getattr(torch, dtype)
    q, k, v = _dev(_prefill_inputs(8, 3, 80, H, KVH, 64), cuda, td)
    lens = [80, 33, 1]
    before = tk.launch_counts()["flash_prefill"]
    out = tk.flash_prefill(q, k, v, torch.tensor(lens, device=cuda),
                           sliding_window=window)
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_prefill"] == before + 1
    ref = tk.flash_prefill_plain(q, k, v, torch.tensor(lens, device=cuda),
                                 sliding_window=window)
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(_valid(out.float().cpu().numpy(), lens),
                               _valid(ref.float().cpu().numpy(), lens),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128, 144, 160,
                               176, 192, 208, 224, 240, 256])
@pytest.mark.parametrize("S,lens,window", [
    (80, [80, 0, 1, 65], None),        # S not a multiple of 64, lengths 0, 1
    (200, [200, 130, 64], 70),         # the window's start crosses K/V tiles
])
def test_cuda_flash_prefill_bf16_tensor_cores(cuda, D, S, lens, window):
    """The bf16 tensor-core kernel at every head_dim it is built for (one
    warpgroup up to 128, two above): the rows below each length against the
    plain version (bf16 bar), and every output row finite, padding rows and
    a length-0 row included (the next layer writes their K/V into the
    cache)."""
    B, H, KVH = len(lens), 8, 2
    q, k, v = _dev(_prefill_inputs(17, B, S, H, KVH, D), cuda,
                   torch.bfloat16)
    lt = torch.tensor(lens, device=cuda)
    before = tk.launch_counts()["flash_prefill"]
    out = tk.flash_prefill(q, k, v, lt, sliding_window=window)
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_prefill"] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    ref = tk.flash_prefill_plain(q, k, v, lt, sliding_window=window)
    np.testing.assert_allclose(_valid(out.float().cpu().numpy(), lens),
                               _valid(ref.float().cpu().numpy(), lens),
                               **BF16_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,window", [(4, False), (4, True), (16, False)])
def test_cuda_decode_split_vs_plain(cuda, dtype, B, window):
    """Split-KV dense decode at the span edges: lengths 1, one span, one
    span plus a token and the whole cache; with `window`, a window whose
    start crosses a span boundary; B=16 beside B=4."""
    td = getattr(torch, dtype)
    H, KVH, T, D = 8, 2, 512, 64
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nsplit, split = tk.decode_split(T, B * KVH, sms)
    assert nsplit > 1
    lens = [1, split, split + 1, T] + [int(x) for x in
                                       _rng(18).integers(1, T + 1, B - 4)]
    win = None
    if window:
        lens[1], win = 3 * split + 5, split + 7  # window from 2*split - 2
    q, kc, vc = _decode_inputs(19, B, H, KVH, T, D)
    qd, k, v = _dev((q, kc, vc), cuda, td)
    lt = torch.tensor(lens, device=cuda)
    before = tk.launch_counts()["ragged_decode"]
    out = tk.ragged_decode(qd, k, v, lt, sliding_window=win)
    torch.cuda.synchronize()
    assert tk.launch_counts()["ragged_decode"] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    ref = tk.ragged_decode_plain(qd, k, v, lt, sliding_window=win)
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [False, True])
def test_cuda_decode_vs_plain(cuda, dtype, q8):
    td = getattr(torch, dtype)
    q, kc, vc = _decode_inputs(9, 3, 8, 2, 256, 64)
    lens = torch.tensor([1, 130, 256], device=cuda)
    qd = torch.tensor(q, device=cuda).to(td)
    if q8:
        kq, ks = _q8(kc)
        vq, vs = _q8(vc)
        args = [t.to(cuda) for t in (kq, ks, vq, vs)]
        out = tk.ragged_decode_q8(qd, *args, lens)
        ref = tk.ragged_decode_q8_plain(qd, *args, lens)
    else:
        k, v = _dev((kc, vc), cuda, td)
        out = tk.ragged_decode(qd, k, v, lens, sliding_window=100)
        ref = tk.ragged_decode_plain(qd, k, v, lens, sliding_window=100)
    torch.cuda.synchronize()
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


def _paged_case(seed, B, KVH, D, NB, MAXB, lens):
    """Pools [NB, KVH, 128, D] and a shuffled, non-contiguous table whose
    entries past each slot's allocation are 0."""
    r = _rng(seed)
    pool_k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    pool_v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    perm = r.permutation(np.arange(1, NB))
    table = np.zeros((B, MAXB), np.int32)
    used = 0
    for b, n in enumerate(lens):
        k = -(-n // 128)
        table[b, :k] = perm[used:used + k]
        used += k
    return pool_k, pool_v, table


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [False, True])
def test_cuda_paged_decode_vs_plain(cuda, dtype, q8):
    td = getattr(torch, dtype)
    lens = [1, 130, 384, 257]
    pool_k, pool_v, table = _paged_case(10, 4, 2, 64, 16, 3, lens)
    q = torch.tensor(_rng(11).standard_normal((4, 1, 8, 64)), device=cuda,
                     dtype=torch.float32).to(td)
    tab = torch.tensor(table, device=cuda)
    lt = torch.tensor(lens, device=cuda)
    name = "ragged_decode_q8_paged" if q8 else "ragged_decode_paged"
    before = tk.launch_counts()[name]
    if q8:
        kq, ks = _q8(pool_k.reshape(1, -1, 128, 64))
        vq, vs = _q8(pool_v.reshape(1, -1, 128, 64))
        args = [kq.reshape(16, 2, 128, 64).to(cuda),
                ks.reshape(16, 2, 1, 128).to(cuda),
                vq.reshape(16, 2, 128, 64).to(cuda),
                vs.reshape(16, 2, 1, 128).to(cuda)]
        out = tk.ragged_decode_q8(q, *args, lt, table=tab)
        ref = tk.ragged_decode_q8_plain(q, *args, lt, table=tab)
    else:
        k, v = _dev((pool_k, pool_v), cuda, td)
        out = tk.ragged_decode(q, k, v, lt, sliding_window=100, table=tab)
        ref = tk.ragged_decode_plain(q, k, v, lt, sliding_window=100,
                                     table=tab)
    torch.cuda.synchronize()
    assert tk.launch_counts()[name] == before + 1
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("B,window", [(4, False), (4, True), (16, False),
                                      (16, True)])
def test_cuda_paged_decode_split_vs_plain(cuda, dtype, q8, B, window):
    """Split-KV paged decode at the edges the split creates — lengths 1, a
    block, a block + 1, a span, a span + 1 and the full table (B=4: four of
    them; B=16: all six, the rest random) — over a shuffled table whose
    entries past each slot's allocation are 0; with `window`, a window
    whose start falls inside a block and a span, and one from a span
    boundary less 2 on the row of 3 spans + 5."""
    td = getattr(torch, dtype)
    H, KVH, D, MAXB = 8, 2, 64, 8
    T = MAXB * 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nsplit, split = tk.decode_split(T, B * KVH, sms)
    assert nsplit > 1
    edges = [1, 128, 129, split, split + 1, T]
    lens = ([1, 129, split + 1, T] if B == 4 else edges + [
        int(x) for x in _rng(20).integers(1, T + 1, B - 6)])
    win = None
    if window:
        lens[1], win = 3 * split + 5, split + 7
    NB = sum(-(-n // 128) for n in lens) + 3
    pool_k, pool_v, table = _paged_case(21, B, KVH, D, NB, MAXB, lens)
    q = torch.tensor(_rng(22).standard_normal((B, 1, H, D)), device=cuda,
                     dtype=torch.float32).to(td)
    tab = torch.tensor(table, device=cuda)
    lt = torch.tensor(lens, device=cuda)
    name = "ragged_decode_q8_paged" if q8 else "ragged_decode_paged"
    before = tk.launch_counts()[name]
    if q8:
        kq, ks = _q8(pool_k.reshape(1, -1, 128, D))
        vq, vs = _q8(pool_v.reshape(1, -1, 128, D))
        args = [kq.reshape(NB, KVH, 128, D).to(cuda),
                ks.reshape(NB, KVH, 1, 128).to(cuda),
                vq.reshape(NB, KVH, 128, D).to(cuda),
                vs.reshape(NB, KVH, 1, 128).to(cuda)]
        out = tk.ragged_decode_q8(q, *args, lt, sliding_window=win,
                                  table=tab)
        torch.cuda.synchronize()
        ref = tk.ragged_decode_q8_plain(q, *args, lt, sliding_window=win,
                                        table=tab)
    else:
        k, v = _dev((pool_k, pool_v), cuda, td)
        out = tk.ragged_decode(q, k, v, lt, sliding_window=win, table=tab)
        torch.cuda.synchronize()
        ref = tk.ragged_decode_plain(q, k, v, lt, sliding_window=win,
                                     table=tab)
    assert tk.launch_counts()[name] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_paged_scatter_vs_plain(cuda, dtype):
    """Bit-exact over the whole pool, trash block included; inactive slots
    go to the trash block."""
    B, KVH, D, NB = 5, 2, 64, 12
    pool_k, pool_v, table = _paged_case(12, B, KVH, D, NB, 4,
                                        [1, 129, 300, 512, 40])
    r = _rng(13)
    k_new = torch.tensor(r.standard_normal((B, KVH, D)), dtype=torch.float32,
                         device=cuda)
    v_new = torch.tensor(r.standard_normal((B, KVH, D)), dtype=torch.float32,
                         device=cuda)
    pos = torch.tensor([0, 128, 299, 511, 39], device=cuda)
    tab = torch.tensor(table, device=cuda)
    act = torch.tensor([True, True, False, True, False], device=cuda)
    if dtype == "int8":
        kq, ks = _q8(pool_k.reshape(1, -1, 128, D))
        vq, vs = _q8(pool_v.reshape(1, -1, 128, D))
        pools = [kq.reshape(NB, KVH, 128, D), ks.reshape(NB, KVH, 1, 128),
                 vq.reshape(NB, KVH, 128, D), vs.reshape(NB, KVH, 1, 128)]
        pools = [t.to(cuda) for t in pools]
        ref = [t.clone() for t in pools]
        tk.paged_scatter_append_q8(*pools, k_new, v_new, pos, tab, act)
        tk.paged_scatter_append_q8_plain(*ref, k_new, v_new, pos, tab, act)
    else:
        td = getattr(torch, dtype)
        pools = _dev((pool_k, pool_v), cuda, td)
        ref = [t.clone() for t in pools]
        kn, vn = k_new.to(td), v_new.to(td)
        tk.paged_scatter_append(*pools, kn, vn, pos, tab, act)
        tk.paged_scatter_append_plain(*ref, kn, vn, pos, tab, act)
    torch.cuda.synchronize()
    for got, want in zip(pools, ref):
        assert torch.equal(got, want)


def _ragged_case(seed, H, KVH, D, NB, kvlens, qlens, pad_blocks=1):
    """A flat stream over a shuffled pool: sequence s has qlen[s] rows at
    a QBLK-aligned start and attends to kvlen[s] tokens; `pad_blocks` dead
    q blocks at the end. Returns (q, k, v, meta dict, live rows)."""
    r = _rng(seed)
    k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    perm = r.permutation(np.arange(1, NB))
    maxb = max(-(-n // 128) for n in kvlens)
    tables = np.zeros((len(kvlens), maxb), np.int32)
    block_seq, qstart, live, used, row = [], [], [], 0, 0
    for s, (n, ql) in enumerate(zip(kvlens, qlens)):
        nb = -(-n // 128)
        tables[s, :nb] = perm[used:used + nb]
        used += nb
        qstart.append(row)
        live += list(range(row, row + ql))
        block_seq += [s] * -(-ql // 8)
        row += -(-ql // 8) * 8
    block_seq += [-1] * pad_blocks
    T = len(block_seq) * 8
    q = r.standard_normal((T, H, D)).astype(np.float32)
    meta = dict(block_seq=np.asarray(block_seq, np.int32),
                qstart=np.asarray(qstart, np.int32),
                qlen=np.asarray(qlens, np.int32),
                kvlen=np.asarray(kvlens, np.int32), tables=tables)
    return q, k, v, meta, live


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8,window", [(False, None), (False, 100),
                                       (True, None)])
def test_cuda_ragged_attention_vs_plain(cuda, dtype, q8, window):
    """Kernels 8/9: decode rows (qlen 1) beside prefill chunks, one of
    them at an offset past a block boundary; live rows compared."""
    td = getattr(torch, dtype)
    q, k, v, meta, live = _ragged_case(14, 8, 2, 64, 24,
                                       [1, 300, 140, 700, 33],
                                       [1, 1, 12, 40, 33])
    qd = torch.tensor(q, device=cuda).to(td)
    m = {n: torch.tensor(a, device=cuda) for n, a in meta.items()}
    name = "ragged_paged_attention_q8" if q8 else "ragged_paged_attention"
    before = tk.launch_counts()[name]
    if q8:
        kq, ks = _q8(k.reshape(1, -1, 128, 64))
        vq, vs = _q8(v.reshape(1, -1, 128, 64))
        args = [kq.reshape(24, 2, 128, 64).to(cuda),
                ks.reshape(24, 2, 1, 128).to(cuda),
                vq.reshape(24, 2, 128, 64).to(cuda),
                vs.reshape(24, 2, 1, 128).to(cuda)]
        out = tk.ragged_paged_attention_q8(qd, *args, **m)
        ref = tk.ragged_paged_attention_q8_plain(qd, *args, **m)
    else:
        kv = _dev((k, v), cuda, td)
        out = tk.ragged_paged_attention(qd, *kv, **m, sliding_window=window)
        ref = tk.ragged_paged_attention_plain(qd, *kv, **m,
                                              sliding_window=window)
    torch.cuda.synchronize()
    assert tk.launch_counts()[name] == before + 1
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(out.float().cpu().numpy()[live],
                               ref.float().cpu().numpy()[live], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_ragged_scatter_vs_plain(cuda, dtype):
    """Kernels 10/11: bit-exact outside the trash block 0, where the
    padding rows of a T > 128 stream collide (a race nothing reads)."""
    T, KVH, D, NB = 200, 2, 64, 12
    r = _rng(15)
    pool_k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    pool_v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    k_new = torch.tensor(r.standard_normal((T, KVH, D)), dtype=torch.float32,
                         device=cuda)
    v_new = torch.tensor(r.standard_normal((T, KVH, D)), dtype=torch.float32,
                         device=cuda)
    live = r.random(T) < 0.6
    slots = r.permutation((NB - 1) * 128)[:T]
    pb = torch.tensor(np.where(live, 1 + slots // 128, 0), dtype=torch.int32,
                      device=cuda)
    off = torch.tensor(np.where(live, slots % 128, np.arange(T) % 128),
                       dtype=torch.int32, device=cuda)
    if dtype == "int8":
        kq, ks = _q8(pool_k.reshape(1, -1, 128, D))
        vq, vs = _q8(pool_v.reshape(1, -1, 128, D))
        pools = [kq.reshape(NB, KVH, 128, D), ks.reshape(NB, KVH, 1, 128),
                 vq.reshape(NB, KVH, 128, D), vs.reshape(NB, KVH, 1, 128)]
        pools = [t.to(cuda) for t in pools]
        ref = [t.clone() for t in pools]
        tk.ragged_scatter_append_q8(*pools, k_new, v_new, pb, off)
        tk.ragged_scatter_append_q8_plain(*ref, k_new, v_new, pb, off)
    else:
        td = getattr(torch, dtype)
        pools = _dev((pool_k, pool_v), cuda, td)
        ref = [t.clone() for t in pools]
        kn, vn = k_new.to(td), v_new.to(td)
        tk.ragged_scatter_append(*pools, kn, vn, pb, off)
        tk.ragged_scatter_append_plain(*ref, kn, vn, pb, off)
    torch.cuda.synchronize()
    for got, want in zip(pools, ref):
        assert torch.equal(got[1:], want[1:])


# ------------------------------------- every group size and head_dim 256

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KVH,window", [(8, 2, None), (16, 1, 70)])
def test_cuda_flash_prefill_head_dim_256(cuda, dtype, H, KVH, window):
    """head_dim 256: f32 on the SIMT kernel's wide variant, bf16 on two
    warpgroups; G = 4 and G = 16 with a window across K/V tiles."""
    td = getattr(torch, dtype)
    lens = [200, 130, 1]
    q, k, v = _dev(_prefill_inputs(24, 3, 200, H, KVH, 256), cuda, td)
    lt = torch.tensor(lens, device=cuda)
    before = tk.launch_counts()["flash_prefill"]
    out = tk.flash_prefill(q, k, v, lt, sliding_window=window)
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_prefill"] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    ref = tk.flash_prefill_plain(q, k, v, lt, sliding_window=window)
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(_valid(out.float().cpu().numpy(), lens),
                               _valid(ref.float().cpu().numpy(), lens), **tol)


# (H, KVH, D): Llama-3.1-405B's G = 16 at D = 128 (two head groups of 8),
# Qwen2-7B's G = 7 (one group), G = 8 at D = 256 (two groups of 4, the
# combine's two columns a thread)
DECODE_WIDE = [(32, 2, 128), (28, 4, 128), (16, 2, 256)]


def _decode_lens(B, T, split):
    return [1, split, split + 1, T] + [
        int(x) for x in _rng(25).integers(1, T + 1, B - 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("H,KVH,D", DECODE_WIDE)
def test_cuda_decode_wide_group_vs_plain(cuda, dtype, q8, H, KVH, D):
    """Dense split-KV decode, bf16/f32 and int8, at G = 16, 7 and D = 256:
    lengths at the span edges, a window from inside a span."""
    td = getattr(torch, dtype)
    B, T = 6, 512
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, split = tk.decode_split(T, B * KVH, sms)
    lens = _decode_lens(B, T, split)
    lt = torch.tensor(lens, device=cuda)
    q, kc, vc = _decode_inputs(26, B, H, KVH, T, D)
    qd = torch.tensor(q, device=cuda).to(td)
    name = "ragged_decode_q8" if q8 else "ragged_decode"
    for win in (None, split + 7):
        before = tk.launch_counts()[name]
        if q8:
            kq, ks = _q8(kc)
            vq, vs = _q8(vc)
            args = [t.to(cuda) for t in (kq, ks, vq, vs)]
            out = tk.ragged_decode_q8(qd, *args, lt, sliding_window=win)
            torch.cuda.synchronize()
            ref = tk.ragged_decode_q8_plain(qd, *args, lt, sliding_window=win)
        else:
            k, v = _dev((kc, vc), cuda, td)
            out = tk.ragged_decode(qd, k, v, lt, sliding_window=win)
            torch.cuda.synchronize()
            ref = tk.ragged_decode_plain(qd, k, v, lt, sliding_window=win)
        assert tk.launch_counts()[name] == before + 1
        assert bool(torch.isfinite(out.float()).all())
        tol = F32 if dtype == "float32" else BF16_CARD
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("H,KVH,D", DECODE_WIDE)
def test_cuda_paged_decode_wide_group_vs_plain(cuda, dtype, q8, H, KVH, D):
    """Paged split-KV decode at the same geometries over a shuffled table,
    a window from inside a span."""
    td = getattr(torch, dtype)
    B, MAXB = 6, 4
    T = MAXB * 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, split = tk.decode_split(T, B * KVH, sms)
    lens = _decode_lens(B, T, split)
    NB = sum(-(-n // 128) for n in lens) + 2
    pool_k, pool_v, table = _paged_case(27, B, KVH, D, NB, MAXB, lens)
    q = torch.tensor(_rng(28).standard_normal((B, 1, H, D)), device=cuda,
                     dtype=torch.float32).to(td)
    tab, lt = torch.tensor(table, device=cuda), torch.tensor(lens,
                                                             device=cuda)
    name = "ragged_decode_q8_paged" if q8 else "ragged_decode_paged"
    for win in (None, split + 7):
        before = tk.launch_counts()[name]
        if q8:
            kq, ks = _q8(pool_k.reshape(1, -1, 128, D))
            vq, vs = _q8(pool_v.reshape(1, -1, 128, D))
            args = [kq.reshape(NB, KVH, 128, D).to(cuda),
                    ks.reshape(NB, KVH, 1, 128).to(cuda),
                    vq.reshape(NB, KVH, 128, D).to(cuda),
                    vs.reshape(NB, KVH, 1, 128).to(cuda)]
            out = tk.ragged_decode_q8(q, *args, lt, sliding_window=win,
                                      table=tab)
            torch.cuda.synchronize()
            ref = tk.ragged_decode_q8_plain(q, *args, lt, sliding_window=win,
                                            table=tab)
        else:
            k, v = _dev((pool_k, pool_v), cuda, td)
            out = tk.ragged_decode(q, k, v, lt, sliding_window=win,
                                   table=tab)
            torch.cuda.synchronize()
            ref = tk.ragged_decode_plain(q, k, v, lt, sliding_window=win,
                                         table=tab)
        assert tk.launch_counts()[name] == before + 1
        tol = F32 if dtype == "float32" else BF16_CARD
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,q8", [("bfloat16", False),
                                      ("bfloat16", True),
                                      ("float32", False)])
@pytest.mark.parametrize("H,KVH,D", [(28, 4, 128), (32, 2, 128),
                                     (16, 1, 256)])
def test_cuda_ragged_attention_wide_group_vs_plain(cuda, dtype, q8, H, KVH,
                                                   D):
    """Kernels 8/9 over the head-group axis: G = 7 at D = 128 (groups of 4
    and 3), G = 16 (four groups of 4) and G = 16 at D = 256 (eight of 2),
    decode rows beside prefill chunks, one with a window."""
    td = getattr(torch, dtype)
    q, k, v, meta, live = _ragged_case(29, H, KVH, D, 24,
                                       [1, 300, 140, 700, 33],
                                       [1, 1, 12, 40, 33])
    qd = torch.tensor(q, device=cuda).to(td)
    m = {n: torch.tensor(a, device=cuda) for n, a in meta.items()}
    name = "ragged_paged_attention_q8" if q8 else "ragged_paged_attention"
    for win in (None, 100):
        before = tk.launch_counts()[name]
        if q8:
            kq, ks = _q8(k.reshape(1, -1, 128, D))
            vq, vs = _q8(v.reshape(1, -1, 128, D))
            args = [kq.reshape(24, KVH, 128, D).to(cuda),
                    ks.reshape(24, KVH, 1, 128).to(cuda),
                    vq.reshape(24, KVH, 128, D).to(cuda),
                    vs.reshape(24, KVH, 1, 128).to(cuda)]
            out = tk.ragged_paged_attention_q8(qd, *args, **m,
                                               sliding_window=win)
            torch.cuda.synchronize()
            ref = tk.ragged_paged_attention_q8_plain(qd, *args, **m,
                                                     sliding_window=win)
        else:
            kv = _dev((k, v), cuda, td)
            out = tk.ragged_paged_attention(qd, *kv, **m, sliding_window=win)
            torch.cuda.synchronize()
            ref = tk.ragged_paged_attention_plain(qd, *kv, **m,
                                                  sliding_window=win)
        assert tk.launch_counts()[name] == before + 1
        tol = F32 if dtype == "float32" else BF16_CARD
        np.testing.assert_allclose(out.float().cpu().numpy()[live],
                                   ref.float().cpu().numpy()[live], **tol)


@pytest.mark.cuda
def test_cuda_quantize_tokens_equals_cpu(cuda):
    """quantize_tokens on the card gives the CPU's int8 rows and scales bit
    for bit (IEEE division on both; a CUDA division by the Python number
    127 would multiply by its rounded reciprocal and move some scales)."""
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    x = torch.tensor(_rng(32).standard_normal((64, 8, 128)) * 3,
                     dtype=torch.float32)
    q_cpu, s_cpu = quantize_tokens(x)
    q_card, s_card = quantize_tokens(x.to(cuda))
    assert torch.equal(s_card.cpu(), s_cpu)
    assert torch.equal(q_card.cpu(), q_cpu)


def _half_rows(B, KVH, D):
    """[B, KVH, D] rows whose quotients x / scale land on .5 (scale 1 and
    2: a row's largest |x| is 127 or 254, the others k + 0.5 times the
    scale), one row of zeros (the 1e-8 floor), the rest random."""
    r = _rng(30)
    x = r.standard_normal((B, KVH, D)).astype(np.float32) * 3
    halves = np.array([2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5, -126.5],
                      np.float32)
    for b, s in ((0, 1.0), (1, 2.0)):
        x[b] = np.resize(halves, (KVH, D)) * s
        x[b, :, 0] = 127 * s
    x[2] = 0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_scatter_q8_fused_bit_exact(cuda, dtype, monkeypatch):
    """The quantizing scatter kernel against quantize_tokens and the index
    writes, bit for bit over the whole pool, on the card and on the CPU:
    rows whose quotient lands on .5 round half to even (2.5 -> 2, -3.5 ->
    -4, 126.5 -> 126), a zero row takes the 1e-8 floor, inactive slots go
    to the trash block. The wrapper quantizes nothing in PyTorch: with
    quantize_tokens made to raise, it still writes the same pools."""
    from localai_tpu_torch.ops.kernels import paged_scatter as ps

    td = getattr(torch, dtype)
    B, KVH, D, NB = 6, 2, 128, 16
    pool_k, pool_v, table = _paged_case(31, B, KVH, D, NB, 4,
                                        [1, 129, 300, 512, 40, 77])
    k_new = torch.tensor(_half_rows(B, KVH, D), device=cuda).to(td)
    v_new = torch.tensor(_half_rows(B, KVH, D)[::-1].copy(),
                         device=cuda).to(td)
    pos = torch.tensor([0, 128, 299, 511, 39, 76], device=cuda)
    tab = torch.tensor(table, device=cuda)
    act = torch.tensor([True, True, True, True, False, True], device=cuda)
    kq, ks = _q8(pool_k.reshape(1, -1, 128, D))
    vq, vs = _q8(pool_v.reshape(1, -1, 128, D))
    pools = [kq.reshape(NB, KVH, 128, D), ks.reshape(NB, KVH, 1, 128),
             vq.reshape(NB, KVH, 128, D), vs.reshape(NB, KVH, 1, 128)]
    ref_cpu = [t.clone() for t in pools]
    pools = [t.to(cuda) for t in pools]
    ref = [t.clone() for t in pools]
    tk.paged_scatter_append_q8_plain(*ref, k_new, v_new, pos, tab, act)
    tk.paged_scatter_append_q8_plain(*ref_cpu, k_new.cpu(), v_new.cpu(),
                                     pos.cpu(), tab.cpu(), act.cpu())
    targets = tk.paged_targets(pos, tab, act)

    def no_quantize(x):
        raise AssertionError("the wrapper quantized in PyTorch")
    monkeypatch.setattr(ps, "quantize_tokens", no_quantize)
    before = tk.launch_counts()["paged_scatter_append_q8"]
    tk.paged_scatter_append_q8(*pools, k_new, v_new, pos, tab, act,
                               targets=targets)
    torch.cuda.synchronize()
    assert tk.launch_counts()["paged_scatter_append_q8"] == before + 1
    for got, want, want_cpu in zip(pools, ref, ref_cpu):
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), want_cpu)
    pb, off = (int(t[0]) for t in targets)
    assert pools[1][pb, 0, 0, off].item() == 1.0
    assert pools[0][pb, 0, off, :8].tolist() == [127, -4, 0, 0, 2, -2, 126,
                                                 -126]


# ------------------------------------ split-KV ragged attention (kernels 8/9)

@pytest.mark.parametrize("T", [8, 192, 1024])
@pytest.mark.parametrize("maxb", [1, 4, 32])
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_ragged_split_from_shapes(T, maxb, rows):
    """Split-KV ragged attention's spans: whole 32-token tiles, at least two
    where the table holds two, covering MAXB*128 tokens; nothing but shapes
    as input (kvlen would cost a device sync every tick); the same answer
    every time."""
    import inspect

    assert list(inspect.signature(tk.ragged_split).parameters) == [
        "T", "maxb", "rows", "sms"]
    nsplit, split = tk.ragged_split(T, maxb, rows, 132)
    tokens = maxb * 128
    assert split > 0 and split % tk.RAGGED_TILE == 0
    assert nsplit * split >= tokens > (nsplit - 1) * split
    assert split >= 2 * tk.RAGGED_TILE
    assert T * nsplit <= 4096 or nsplit == 1  # the workspace stays bounded
    # one decode row's KV heads spread over many SMs
    if T == 8 and maxb == 32:
        assert nsplit * rows >= 64
    assert tk.ragged_split(T, maxb, rows, 132) == (nsplit, split)


def test_ragged_split_computed_once_per_shape():
    """A ragged tick calls the wrapper once per layer with the same shapes:
    ragged_split computes each shape once."""
    tk.ragged_split.cache_clear()
    first = tk.ragged_split(192, 32, 8, 132)
    for _ in range(31):
        assert tk.ragged_split(192, 32, 8, 132) == first
    info = tk.ragged_split.cache_info()
    assert (info.misses, info.hits) == (1, 31)


@pytest.mark.parametrize("G,D,tc,want", [
    (4, 128, True, (4, 4)), (7, 128, True, (7, 2)), (16, 128, True, (16, 1)),
    (32, 128, True, (16, 1)), (1, 16, True, (1, 16)),
    (4, 128, False, (4, 1)), (1, 128, False, (1, 4)),
    (16, 512, False, (1, 1)), (4, 256, False, (2, 1))])
def test_ragged_tiling(G, D, tc, want):
    """(GC, QT): a block's compact rows, QT q blocks of GC heads, fit its
    capacity (128 on the tensor cores, 4096 // D in the SIMT variant), and
    every head of a group of up to 16 shares a tensor-core block."""
    gc, qt = tk.ragged_tiling(G, D, tc)
    assert (gc, qt) == want
    cap = 128 if tc else max(4096 // D, 8)
    assert qt * 8 * gc <= cap


def _split_pack(seed, H, KVH, D, seqs, NB=None):
    """A flat stream over a shuffled pool. `seqs`: (kvlen, qlen) of each
    sequence in stream order, or None for a dead q block there. Returns (q,
    k, v, meta of torch int32 tensors, live rows)."""
    r = _rng(seed)
    live_seqs = [x for x in seqs if x is not None]
    need = sum(-(-n // 128) for n, _ in live_seqs)
    NB = NB or need + 2
    k = torch.tensor(r.standard_normal((NB, KVH, 128, D)), dtype=torch.float32)
    v = torch.tensor(r.standard_normal((NB, KVH, 128, D)), dtype=torch.float32)
    perm = r.permutation(np.arange(1, NB))
    maxb = max(-(-n // 128) for n, _ in live_seqs)
    tables = np.zeros((len(live_seqs), maxb), np.int32)
    block_seq, qstart, qlens, kvlens, live = [], [], [], [], []
    used = row = 0
    for x in seqs:
        if x is None:
            block_seq.append(-1)
            row += 8
            continue
        n, ql = x
        s = len(qstart)
        nb = -(-n // 128)
        tables[s, :nb] = perm[used:used + nb]
        used += nb
        qstart.append(row)
        qlens.append(ql)
        kvlens.append(n)
        live += list(range(row, row + ql))
        block_seq += [s] * -(-ql // 8)
        row += -(-ql // 8) * 8
    q = torch.tensor(r.standard_normal((row, H, D)), dtype=torch.float32)
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32)  # noqa
    meta = dict(block_seq=i32(block_seq), qstart=i32(qstart),
                qlen=i32(qlens), kvlen=i32(kvlens), tables=i32(tables))
    return q, k, v, meta, live


def _split_model(q, kf, vf, ks, vs, meta, window, tensor_cores):
    """A PyTorch model of the kernel's work split: q tiles by leader (the q
    block whose offset from its sequence's first block is a multiple of
    QT), GC heads a block, spans of ragged_split; a span the tile's keys do
    not reach writes nothing, a row the span hides wholly gets (NEG_INF,
    0, 0); the combine merges each row's own splits. kf/vf [NB, KVH, 128,
    D] f32 pools, ks/vs [NB, KVH, 128] scales or None."""
    from localai_tpu_torch.ops.attention import NEG_INF

    T, H, D = q.shape
    KVH = kf.shape[1]
    G = H // KVH
    bseq, qst, qln, kvl, tab = (meta[n].tolist() for n in (
        "block_seq", "qstart", "qlen", "kvlen", "tables"))
    maxb = len(tab[0])
    nsplit, split = tk.ragged_split(T, maxb, KVH, 132)
    gc, qt = tk.ragged_tiling(G, D, tensor_cores)
    m = torch.full((T, H, nsplit), NEG_INF)
    l = torch.zeros(T, H, nsplit)
    acc = torch.zeros(T, H, nsplit, D)
    written = torch.zeros(T, H, nsplit, dtype=torch.bool)
    qf = q.float() * D ** -0.5
    for qb in range(T // 8):
        s = bseq[qb]
        if s < 0:
            continue
        qs, ql, kl = qst[s], qln[s], kvl[s]
        fb = qs // 8
        if qb < fb or (qb - fb) % qt:
            continue
        nqb = min(qt, -(-(qs + ql) // 8) - qb)
        row0 = qb * 8
        t_lo, t_hi = max(qs - row0, 0), min(qs + ql - row0, nqb * 8)
        if t_hi <= t_lo:
            continue
        qpos0 = kl - ql + row0 - qs
        tend = min(kl, qpos0 + t_hi, maxb * 128)
        tbeg = max(qpos0 + t_lo - window + 1, 0) if window else 0
        rows = torch.arange(row0 + t_lo, row0 + t_hi)
        qpos = qpos0 + torch.arange(t_lo, t_hi)
        blocks = torch.tensor(tab[s]).long()
        kseq = kf[blocks].permute(1, 0, 2, 3).reshape(KVH, -1, D)
        vseq = vf[blocks].permute(1, 0, 2, 3).reshape(KVH, -1, D)
        if ks is not None:
            kss = ks[blocks].permute(1, 0, 2).reshape(KVH, -1)
            vss = vs[blocks].permute(1, 0, 2).reshape(KVH, -1)
        for y in range(KVH * -(-G // gc)):
            kh, g0 = divmod(y, -(-G // gc))
            heads = kh * G + g0 * gc + torch.arange(min(gc, G - g0 * gc))
            for sp in range(nsplit):
                lo = sp * split
                hi = min(lo + split, tend)
                if hi <= lo or lo + split <= tbeg:
                    continue
                kpos = torch.arange(lo, hi)
                sc = torch.einsum("thd,kd->thk", qf[rows][:, heads],
                                  kseq[kh, lo:hi])
                if ks is not None:
                    sc = sc * kss[kh, lo:hi]
                mask = kpos[None, :] <= qpos[:, None]
                if window:
                    mask &= kpos[None, :] > qpos[:, None] - window
                mask = mask[:, None, :]
                sc = torch.where(mask, sc, NEG_INF)
                mx = sc.amax(-1)
                p = torch.where(mask, torch.exp(sc - mx[..., None]), 0.0)
                pv = p * vss[kh, lo:hi] if ks is not None else p
                ri, hi_ = rows[:, None], heads[None, :]
                m[ri, hi_, sp] = mx
                l[ri, hi_, sp] = p.sum(-1)
                acc[ri, hi_, sp] = torch.einsum("thk,kd->thd", pv,
                                                vseq[kh, lo:hi])
                written[ri, hi_, sp] = True
    out = torch.zeros(T, H, D)
    for t in range(T):
        s = bseq[t // 8]
        if s < 0 or not qst[s] <= t < qst[s] + qln[s]:
            continue
        qpos = kvl[s] - qln[s] + t - qst[s]
        end = min(qpos + 1, maxb * 128)
        beg = max(qpos - window + 1, 0) if window else 0
        first, last = beg // split, min(nsplit, -(-end // split))
        if last <= first:
            continue  # no key: the combine writes 0
        assert bool(written[t, :, first:last].all())  # only written partials
        mi = m[t, :, first:last]
        w = torch.exp(mi - mi.amax(-1, keepdim=True))
        den = torch.clamp_min((w * l[t, :, first:last]).sum(-1), 1e-30)
        out[t] = (w[..., None] * acc[t, :, first:last]).sum(1) / den[:, None]
    return out


# (kvlen, qlen) packs: decode rows at and beside the split boundary (64
# here: T=48..72 rows, MAXB 4, 2 KV heads) and at MAXB*128 = 512, prefill
# chunks across q tiles, and dead q blocks between live sequences
SPLIT_PACKS = {
    "boundaries": [(64, 1), (65, 1), (512, 1), (128, 1), (300, 40)],
    "dead-between": [(200, 1), None, (448, 30), None, (33, 1)],
    "chunk-at-end": [(512, 57), (1, 1)],
}


@pytest.mark.parametrize("pack", sorted(SPLIT_PACKS))
@pytest.mark.parametrize("H,KVH", [(8, 2), (14, 2), (32, 2)],
                         ids=["G4", "G7", "G16"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("tc", [True, False], ids=["tc", "simt"])
def test_ragged_split_model_vs_plain(pack, H, KVH, window, tc):
    """The kernel's work split (q tiles by leader, spans by ragged_split,
    empty spans, the combine) gives the plain version's live rows within
    f32 2e-5, at G = 4, 7 and 16, with a window whose start falls inside a
    span, dead blocks, and lengths at the span and table boundaries."""
    q, k, v, meta, live = _split_pack(40, H, KVH, 16, SPLIT_PACKS[pack])
    T = q.shape[0]
    _, split = tk.ragged_split(T, meta["tables"].shape[1], KVH, 132)
    assert split == 64
    out = _split_model(q, k, v, None, None, meta, window, tc)
    ref = tk.ragged_paged_attention_plain(q, k, v, **meta,
                                          sliding_window=window)
    np.testing.assert_allclose(out[live].numpy(), ref[live].numpy(), **F32)


@pytest.mark.parametrize("H,KVH", [(8, 2), (14, 2), (32, 2)],
                         ids=["G4", "G7", "G16"])
@pytest.mark.parametrize("window", [None, 100])
def test_ragged_split_model_vs_plain_q8(H, KVH, window):
    """The same split over int8 pools: the K scale on the score columns, the
    V scale on p, l summing the unscaled p."""
    q, k, v, meta, live = _split_pack(41, H, KVH, 16,
                                      SPLIT_PACKS["dead-between"])
    NB = k.shape[0]
    kq, ks = _q8(k.reshape(1, -1, 128, 16).numpy())
    vq, vs = _q8(v.reshape(1, -1, 128, 16).numpy())
    kq, vq = kq.reshape(NB, KVH, 128, 16), vq.reshape(NB, KVH, 128, 16)
    ks, vs = ks.reshape(NB, KVH, 1, 128), vs.reshape(NB, KVH, 1, 128)
    out = _split_model(q, kq.float(), vq.float(), ks[:, :, 0], vs[:, :, 0],
                       meta, window, True)
    ref = tk.ragged_paged_attention_q8_plain(q, kq, ks, vq, vs, **meta,
                                             sliding_window=window)
    np.testing.assert_allclose(out[live].numpy(), ref[live].numpy(), **F32)


def test_ragged_split_model_rejects_a_dropped_split():
    """The bar has teeth: the model with each sequence's last split dropped
    (kvlen cut back to that split's start) misses the plain version."""
    q, k, v, meta, live = _split_pack(42, 8, 2, 16, SPLIT_PACKS["boundaries"])
    ref = tk.ragged_paged_attention_plain(q, k, v, **meta)
    cut = dict(meta, kvlen=(meta["kvlen"] - 1) // 64 * 64)
    bad = _split_model(q, k, v, None, None, cut, None, True)
    err = (bad[live] - ref[live]).abs().max().item()
    assert err > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("pack", sorted(SPLIT_PACKS))
@pytest.mark.parametrize("dtype,q8", [("bfloat16", False), ("bfloat16", True),
                                      ("float32", False), ("float32", True)])
@pytest.mark.parametrize("H,KVH,D", [(8, 2, 128), (14, 2, 128),
                                     (32, 2, 128), (8, 2, 16)])
@pytest.mark.parametrize("window", [None, 100])
def test_cuda_ragged_split_vs_plain(cuda, pack, dtype, q8, H, KVH, D,
                                    window):
    """Kernels 8/9, split-KV, at the model's packs: G = 4, 7, 16 on the
    tensor cores (bf16) and the SIMT variant (f32), int8 pools, windows,
    dead blocks, span and table boundaries; one count a call."""
    td = getattr(torch, dtype)
    q, k, v, meta, live = _split_pack(43, H, KVH, D, SPLIT_PACKS[pack])
    qd = q.to(cuda, td)
    m = {n: t.to(cuda) for n, t in meta.items()}
    name = "ragged_paged_attention_q8" if q8 else "ragged_paged_attention"
    before = tk.launch_counts()[name]
    if q8:
        NB = k.shape[0]
        kq, ks = _q8(k.reshape(1, -1, 128, D).numpy())
        vq, vs = _q8(v.reshape(1, -1, 128, D).numpy())
        args = [kq.reshape(NB, KVH, 128, D).to(cuda),
                ks.reshape(NB, KVH, 1, 128).to(cuda),
                vq.reshape(NB, KVH, 128, D).to(cuda),
                vs.reshape(NB, KVH, 1, 128).to(cuda)]
        out = tk.ragged_paged_attention_q8(qd, *args, **m,
                                           sliding_window=window)
        torch.cuda.synchronize()
        ref = tk.ragged_paged_attention_q8_plain(qd, *args, **m,
                                                 sliding_window=window)
    else:
        kv = [k.to(cuda, td), v.to(cuda, td)]
        out = tk.ragged_paged_attention(qd, *kv, **m, sliding_window=window)
        torch.cuda.synchronize()
        ref = tk.ragged_paged_attention_plain(qd, *kv, **m,
                                              sliding_window=window)
    assert tk.launch_counts()[name] == before + 1
    o = out.float().cpu()
    assert bool(torch.isfinite(o).all())
    dead = sorted(set(range(q.shape[0])) - set(live))
    assert not o[dead].any()  # rows outside a span and dead blocks are 0
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(o.numpy()[live],
                               ref.float().cpu().numpy()[live], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [256, 512])
def test_cuda_ragged_split_wide_head_dim(cuda, dtype, D):
    """head_dim 256 (bf16 on the tensor cores' wide instantiation, f32 on
    SIMT) and 512 (the SIMT variant for both), decode rows beside a chunk,
    with a window."""
    td = getattr(torch, dtype)
    q, k, v, meta, live = _split_pack(44, 8, 2, D,
                                      SPLIT_PACKS["boundaries"])
    qd = q.to(cuda, td)
    m = {n: t.to(cuda) for n, t in meta.items()}
    kv = [k.to(cuda, td), v.to(cuda, td)]
    out = tk.ragged_paged_attention(qd, *kv, **m, sliding_window=100)
    torch.cuda.synchronize()
    ref = tk.ragged_paged_attention_plain(qd, *kv, **m, sliding_window=100)
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(out.float().cpu().numpy()[live],
                               ref.float().cpu().numpy()[live], **tol)


@pytest.mark.cuda
def test_cuda_ragged_tiling_matches_python(cuda):
    """The .cu's tiling (ragged_attention_tiling) is ragged_tiling's."""
    from localai_tpu_torch.ops.kernels import _build

    lib = _build.load("ragged_attention")
    for dtype, code in (("bfloat16", 1), ("float32", 0)):
        for G in (1, 4, 7, 16, 32):
            for D in (16, 128, 256, 512):
                tc = dtype == "bfloat16" and D <= 256
                gc, qt = tk.ragged_tiling(G, D, tc)
                assert lib.ragged_attention_tiling(code, G, D) == \
                    gc * 65536 + qt


# ------------------------------------------------- speculative decoding

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_draft_decode_head_dim_64(cuda, dtype):
    """Row 2 (dense ragged_decode) at the Llama-3.2-1B draft's geometry,
    which the speculative draft's decode steps run: H=32 on KVH=8,
    head_dim 64, B=8 over a 4096-token cache."""
    td = getattr(torch, dtype)
    lens = [1, 5, 129, 700, 1500, 2048, 4000, 4096]
    q, kc, vc = _decode_inputs(23, 8, 32, 8, 4096, 64)
    qd, k, v = _dev((q, kc, vc), cuda, td)
    lt = torch.tensor(lens, device=cuda)
    before = tk.launch_counts()["ragged_decode"]
    out = tk.ragged_decode(qd, k, v, lt)
    torch.cuda.synchronize()
    assert tk.launch_counts()["ragged_decode"] == before + 1
    ref = tk.ragged_decode_plain(qd, k, v, lt)
    tol = F32 if dtype == "float32" else BF16_CARD
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_cuda_spec_step_equals_cpu(cuda):
    """One dense speculative step (engine/spec.py) of a tiny f32 target
    and draft on the card against the same step on the CPU: equal tokens
    and lengths, logprobs within 2e-5; the draft's gamma+1 decode steps
    launch row 2 once a layer each."""
    from localai_tpu_torch.engine.spec import build_spec_decode
    from localai_tpu_torch.models.llama import (
        LlamaConfig, init_kv_cache, init_params,
    )
    from localai_tpu_torch.ops.rope import rope_table
    from localai_tpu_torch.ops.sampling import SamplerState

    kw = dict(vocab_size=128, max_position=256, dtype="float32")
    tcfg = LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=16, **kw)
    dcfg = LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=1,
                       num_heads=4, num_kv_heads=2, head_dim=16, **kw)
    G, B, T = 3, 4, 64

    def run(dev):
        # made on the CPU (a generator's stream depends on its device)
        tp = init_params(tcfg, seed=0, device="cpu").to(dev)
        dp = init_params(dcfg, seed=1, device="cpu").to(dev)
        caches = []
        for c, seed in ((tcfg, 2), (dcfg, 3)):
            g = torch.Generator().manual_seed(seed)
            for x in init_kv_cache(c, B, T, device="cpu"):
                caches.append((torch.randn(x.shape, generator=g) * 0.5)
                              .to(dev))
        sm = SamplerState.init(B, 128, device=dev)
        sm.greedy[:2] = True
        sm.key[:, 1] = torch.arange(B, device=dev) + 7
        fn = build_spec_decode(tcfg, dcfg, G)
        i32 = dict(dtype=torch.int32, device=dev)
        return fn(tp, dp, *rope_table(tcfg.rope, T, device=dev),
                  *rope_table(dcfg.rope, T, device=dev), *caches, sm,
                  torch.tensor([9, 20, 0, 33], **i32),
                  torch.tensor([7, 3, 0, 100], **i32),
                  torch.tensor([True, True, False, True], device=dev))

    before = tk.launch_counts()["ragged_decode"]
    card = run(cuda)
    torch.cuda.synchronize()
    assert tk.launch_counts()["ragged_decode"] - before == (
        (G + 1) * dcfg.num_layers)
    host = run(torch.device("cpu"))
    for i in (0, 1, 3, 5, 6):        # tokens, n_out, next, lengths, n_extra
        assert torch.equal(card[i].cpu(), host[i])
    np.testing.assert_allclose(card[2].cpu().numpy()[[0, 1, 3]],
                               host[2].numpy()[[0, 1, 3]], rtol=0, atol=2e-5)


# ------------------------------------------------------- the KV tier (card)

def _tier_decode_inputs(device, dtype, q8, cold, lens, sinks, window,
                        H=32, KVH=8, D=128, seed=0):
    """Tiered paged decode inputs: compact ring tables (sb sink blocks and
    a ring of rw blocks a slot, distinct blocks of a shuffled pool), the
    kvt geometry and, with `cold`, the middle blocks the engine would have
    demoted (raw sb .. (L - window)/128 - 1) in a cold pool through the
    cold table."""
    from localai_tpu_torch.engine import kvtier

    pol = kvtier.parse_policy(f"sink_window(sinks={sinks}, window={window})")
    sb, rw = pol.sink_blocks, kvtier.ring_blocks(window, 256)
    B, maxb = len(lens), pol.sink_blocks + kvtier.ring_blocks(window, 256)
    nb = B * maxb + 1
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(nb, KVH, 128, D, generator=g)
    v = torch.randn(nb, KVH, 128, D, generator=g)
    table = (torch.randperm(nb - 1, generator=g)[:B * maxb] + 1).reshape(
        B, maxb).to(torch.int32)
    q = torch.randn(B, 1, H, D, generator=g)
    i32 = lambda x: torch.full((B,), x, dtype=torch.int32)  # noqa: E731
    kvt = dict(sb=i32(sb), rw=i32(rw), sinks=i32(sinks), window=i32(window))
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [kq, ks[:, :, None, :], vq, vs[:, :, None, :]]
    else:
        pools = [k.to(dtype), v.to(dtype)]
    cold_kv = None
    if cold:
        from localai_tpu_torch.ops.kvcache import QuantKV

        mbc = -(-max(lens) // 128)
        ctab = torch.zeros(B, mbc, dtype=torch.int32)
        ci = 1
        for b, n in enumerate(lens):
            for raw in range(sb, max((n - window) // 128, sb)):
                ctab[b, raw] = ci
                ci += 1
        kvt["cold_tab"] = ctab
        cq, cs = quantize_tokens(torch.randn(ci, KVH, 128, D, generator=g))
        vq2, vs2 = quantize_tokens(torch.randn(ci, KVH, 128, D, generator=g))
        cold_kv = [QuantKV(cq.to(device), cs[:, :, None, :].to(device)),
                   QuantKV(vq2.to(device), vs2[:, :, None, :].to(device))]
    to = lambda x: x.to(device)  # noqa: E731
    return (to(q.to(dtype)), [to(p) for p in pools],
            to(torch.tensor(lens, dtype=torch.int32)), to(table),
            {n: to(t) for n, t in kvt.items()}, cold_kv, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,q8,cold", [
    ("bfloat16", False, False), ("bfloat16", True, False),
    ("bfloat16", False, True), ("float32", False, False),
    ("float32", False, True), ("float32", True, False)])
@pytest.mark.parametrize("H,KVH", [(32, 8), (28, 4), (128, 8)])
def test_cuda_tier_decode_vs_plain(cuda, dtype, q8, cold, H, KVH):
    """The tiered paged decode kernel (rows 3/5 over the ring, the
    retention mask, the cold tier's own splits) against its plain version:
    slots past many ring wraps, inside the first window and at one token;
    a ring map off by one column, and (cold) the cold scales dropped, fail
    the bar."""
    from localai_tpu_torch.ops.kvcache import QuantKV

    dt = getattr(torch, dtype)
    lens = [8192, 7001, 4097, 1100, 300, 1]
    q, pools, lens_t, table, kvt, cold_kv, sb = _tier_decode_inputs(
        cuda, dt, q8, cold, lens, 256, 1024, H=H, KVH=KVH)
    kernel = tk.ragged_decode_q8 if q8 else tk.ragged_decode
    plain = tk.ragged_decode_q8_plain if q8 else tk.ragged_decode_plain
    kw = dict(cold_kv=cold_kv) if cold else {}
    name = "ragged_decode_q8_paged_tier" if q8 else "ragged_decode_paged_tier"
    before = tk.launch_counts()[name]
    out = kernel(q, *pools, lens_t, table=table, kvt=kvt, **kw)
    torch.cuda.synchronize()
    assert tk.launch_counts()[name] == before + 1
    ref = plain(q, *pools, lens_t, table=table, kvt=kvt, **kw)
    tol = BF16_CARD if dt == torch.bfloat16 else F32
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)
    shifted = table.clone()
    shifted[:, sb:] = table[:, sb:].roll(-1, dims=1)
    bad = plain(q, *pools, lens_t, table=shifted, kvt=kvt, **kw)
    assert (bad.float() - out.float()).abs().max().item() > 1e-2
    if cold:
        ones = [QuantKV(c.q, torch.ones_like(c.s)) for c in cold_kv]
        bad = plain(q, *pools, lens_t, table=table, kvt=kvt, cold_kv=ones)
        assert (bad.float() - out.float()).abs().max().item() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(1, 1), (8, 4), (32, 32), (64, 64)],
                         ids=["t1", "t8", "t32", "t64"])
@pytest.mark.parametrize("q8,cold", [(False, False), (True, False),
                                     (False, True)],
                         ids=["bf16", "int8", "cold"])
def test_cuda_tier_decode_plans_vs_plain(cuda, monkeypatch, q8, cold,
                                         tiles):
    """The tiered decode at odd lengths on any span plan (hot and cold
    tiles a span, set through flash_attention's span constants): against
    its plain version, with a full-policy slot in the batch whose row
    equals the untiered kernel's bit for bit, and a cold table with a sink
    block and scattered blocks demoted."""
    from localai_tpu_torch.ops.kernels import flash_attention as fa
    from localai_tpu_torch.ops.kvcache import QuantKV

    lens = [32767, 9001, 4500, 1537, 129, 33, 2]
    q, pools, lens_t, table, kvt, cold_kv, sb = _tier_decode_inputs(
        cuda, torch.bfloat16, q8, cold, lens, 256, 1024, seed=5)
    maxb = table.shape[1]
    full = 4  # slot 4 (129 tokens) under the full policy's sentinels
    for n, x in (("sb", maxb), ("rw", 1), ("sinks", 1 << 20),
                 ("window", 1 << 20)):
        kvt[n][full] = x
    if cold:
        ctab = kvt["cold_tab"]
        ctab[full] = 0
        ctab[1, 0] = ctab.max() + 1  # a sink block demoted
        ctab[1, 7:9] = 0             # a gap in slot 1's demoted run
        n = int(ctab.max()) + 1
        g = torch.Generator(device=cuda).manual_seed(6)
        cold_kv = [QuantKV(*(lambda qs: (qs[0], qs[1][:, :, None, :]))(
            quantize_tokens(torch.randn(n, 8, 128, 128, device=cuda,
                                        generator=g)))) for _ in range(2)]
    for name, value in (("TIER_BLOCKS_SM", 1e9), ("TIER_BLOCKS_SM_Q8", 1e9),
                        ("TIER_MIN_TILES", tiles[0]),
                        ("COLD_SPAN_TILES", tiles[1])):
        monkeypatch.setattr(fa, name, value)
    kernel = tk.ragged_decode_q8 if q8 else tk.ragged_decode
    plain = tk.ragged_decode_q8_plain if q8 else tk.ragged_decode_plain
    kw = dict(cold_kv=cold_kv) if cold else {}
    out = kernel(q, *pools, lens_t, table=table, kvt=kvt, **kw)
    torch.cuda.synchronize()
    assert fa.tier_plan(maxb, kvt["cold_tab"].shape[1] if cold else 0,
                        len(lens) * 8, 132, q8)["split"] == min(
        tiles[0] * fa.DECODE_TILE, -(-maxb * 128 // fa.DECODE_TILE)
        * fa.DECODE_TILE)
    ref = plain(q, *pools, lens_t, table=table, kvt=kvt, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **BF16_CARD)
    if not cold:
        untiered = kernel(q, *pools, lens_t, table=table)
        assert torch.equal(out[full], untiered[full])
    if cold:
        ones = [QuantKV(c.q, torch.ones_like(c.s)) for c in cold_kv]
        bad = plain(q, *pools, lens_t, table=table, kvt=kvt, cold_kv=ones)
        assert (bad.float() - out.float()).abs().max().item() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True])
def test_cuda_tier_full_sentinels_equal_untiered(cuda, q8):
    """Full-policy sentinels (sb = the table width, rw = 1, sinks = window =
    the context) give the untiered paged kernel's output bit for bit."""
    B, H, KVH, D, maxb = 6, 32, 8, 128, 64
    lens = [8192, 7001, 4097, 1100, 300, 1]
    g = torch.Generator().manual_seed(3)
    nb = B * maxb + 1
    k = torch.randn(nb, KVH, 128, D, generator=g)
    v = torch.randn(nb, KVH, 128, D, generator=g)
    table = (torch.randperm(nb - 1, generator=g)[:B * maxb] + 1).reshape(
        B, maxb).to(torch.int32).to(cuda)
    q = torch.randn(B, 1, H, D, generator=g).to(torch.bfloat16).to(cuda)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [x.to(cuda) for x in (kq, ks[:, :, None, :], vq,
                                      vs[:, :, None, :])]
        kernel = tk.ragged_decode_q8
    else:
        pools = [x.to(torch.bfloat16).to(cuda) for x in (k, v)]
        kernel = tk.ragged_decode
    lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
    full = lambda x: torch.full((B,), x, dtype=torch.int32,  # noqa: E731
                                device=cuda)
    kvt = dict(sb=full(maxb), rw=full(1), sinks=full(maxb * 128),
               window=full(maxb * 128))
    a = kernel(q, *pools, lt, table=table, kvt=kvt)
    b = kernel(q, *pools, lt, table=table)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,q8", [("bfloat16", False), ("bfloat16", True),
                                      ("float32", False), ("float32", True)])
@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (28, 4, 128),
                                     (8, 2, 256)])
def test_cuda_tier_ragged_vs_plain(cuda, dtype, q8, H, KVH, D):
    """The tiered ragged kernel (two spans a q tile through the ring map,
    the row mask) against its plain version over compact ring tables:
    decode rows past the ring's wraps, a 128-row chunk, a full-policy
    sequence, a dead q block; a ring map off by one column fails the
    bar."""
    from localai_tpu_torch.engine import kvtier

    dt = getattr(torch, dtype)
    sb = 1
    rw = kvtier.ring_blocks(1024, 256)
    maxb = sb + rw
    seqs = [(33, 1), (4095, 1), (1532, 1), (3000, 1), None, (2048, 128),
            (700, 1)]
    live_seqs = [x for x in seqs if x is not None]
    n = len(live_seqs)
    g = torch.Generator().manual_seed(5)
    nb = n * maxb + 1
    k = torch.randn(nb, KVH, 128, D, generator=g)
    v = torch.randn(nb, KVH, 128, D, generator=g)
    tables = (torch.randperm(nb - 1, generator=g)[:n * maxb] + 1).reshape(
        n, maxb).to(torch.int32)
    block_seq, qstart, live, row = [], [], [], 0
    for x in seqs:
        if x is None:
            block_seq.append(-1)
            row += 8
            continue
        qstart.append(row)
        block_seq += [len(qstart) - 1] * -(-x[1] // 8)
        live += list(range(row, row + x[1]))
        row += -(-x[1] // 8) * 8
    q = torch.randn(row, H, D, generator=g).to(dt)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    meta = dict(block_seq=i32(block_seq), qstart=i32(qstart),
                qlen=i32([x[1] for x in live_seqs]),
                kvlen=i32([x[0] for x in live_seqs]), tables=tables)
    # sequence 0 (33 tokens) carries the full-policy sentinels
    kvt = dict(sb=i32([maxb] + [sb] * (n - 1)), rw=i32([1] + [rw] * (n - 1)),
               sinks=i32([8192] + [128] * (n - 1)),
               window=i32([8192] + [1024] * (n - 1)))
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [kq, ks[:, :, None, :], vq, vs[:, :, None, :]]
        kernel, plain = (tk.ragged_paged_attention_q8,
                         tk.ragged_paged_attention_q8_plain)
    else:
        pools = [k.to(dt), v.to(dt)]
        kernel, plain = (tk.ragged_paged_attention,
                         tk.ragged_paged_attention_plain)
    q, pools = q.to(cuda), [p.to(cuda) for p in pools]
    meta = {n_: t.to(cuda) for n_, t in meta.items()}
    kvt = {n_: t.to(cuda) for n_, t in kvt.items()}
    out = kernel(q, *pools, **meta, kvt=kvt)
    torch.cuda.synchronize()
    ref = plain(q, *pools, **meta, kvt=kvt)
    rows = torch.tensor(live, device=cuda)
    tol = BF16_CARD if dt == torch.bfloat16 else F32
    np.testing.assert_allclose(out[rows].float().cpu().numpy(),
                               ref[rows].float().cpu().numpy(), **tol)
    shifted = meta["tables"].clone()
    shifted[:, sb:] = meta["tables"][:, sb:].roll(-1, dims=1)
    bad = plain(q, *pools, **dict(meta, tables=shifted), kvt=kvt)
    assert (bad[rows].float() - out[rows].float()).abs().max().item() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_demote_bit_exact(cuda, dtype):
    """The demotion (paged_demote_q8, row 7's quantizing kernel over a
    block's KVH*128 rows) writes what quantize_tokens gives, bit for bit,
    into the cold block and nowhere else."""
    dt = getattr(torch, dtype)
    KVH, D, NBC = 8, 128, 6
    g = torch.Generator().manual_seed(2)
    hot = torch.randn(5, KVH, 128, D, generator=g).to(dt).to(cuda)
    pools = [torch.randint(-127, 128, (NBC, KVH, 128, D), generator=g,
                           dtype=torch.int8),
             torch.rand(NBC, KVH, 1, 128, generator=g)] * 2
    pools = [p.clone().to(cuda) for p in pools]
    plain_pools = [p.clone() for p in pools]
    rows = torch.arange(KVH * 128, dtype=torch.int32, device=cuda)
    targets = tk.demote_targets(3, KVH, rows)
    before = tk.launch_counts()["paged_demote_q8"]
    tk.paged_demote_q8(*pools, hot[2], hot[4], targets)
    torch.cuda.synchronize()
    assert tk.launch_counts()["paged_demote_q8"] == before + 1
    tk.paged_demote_q8_plain(*plain_pools, hot[2], hot[4], targets)
    for a, b in zip(pools, plain_pools):
        assert torch.equal(a, b)
    q, s = quantize_tokens(hot[2])
    assert torch.equal(pools[0][3], q) and torch.equal(pools[1][3, :, 0], s)
