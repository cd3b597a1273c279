"""The port's weight GEMMs (localai_tpu_torch.ops.kernels.weight_gemm):
w8a16_matmul, the int8 projections of ops/quant.qmatmul, head_matmul,
the f32 vocabulary projection of models/llama._lm_head, and
moe_w8_matmul, Mixtral's int8 experts in models/llama._moe_mlp (its
plain version against the JAX package: tests/test_torch_moe.py).

On the CPU: each plain version against the JAX function it stands for
(localai_tpu.ops.quant.qmatmul, localai_tpu.models.llama._lm_head) on the
same numpy inputs; the wrappers' CPU dispatch and shape checks; and the
tiny checkpoint's int8 recipe through both engines. On an NVIDIA card
(marker `cuda`, skipped without one): each kernel against its plain
version, a kernel call captured in a CUDA graph against the same call run
eagerly, and repeated calls, bit for bit.

Tolerances:
- f32: 2e-5 (same products, summed in another order);
- bf16 plain vs JAX: atol 1e-3 + rtol 2**-6. Both sum in f32 and round
  twice — the sum to bf16 and the scaled product to bf16 — so an output
  may sit one bf16 step (2**-7 relative at most) off for each rounding
  whose input differs by the f32 summation order: two steps, 2**-6;
- kernel vs plain on the card, bf16 (w8a16_matmul): the same 2-step bound
  per element, and at most 1% of the outputs differ at all. Another
  summation order flips the bf16 rounding of about one output in 10^4; a
  scale applied before the rounding (a wrong epilogue) moves about a third
  of them, each by at most the same two steps, so only the share tells it
  from a right one;
- head_matmul on the card: atol 1e-4 on logits of magnitude ~1 — f32 sums
  of 4096 terms in another order (rounding x32 to bf16 on a bf16 head
  moves them by ~1e-3).

JAX is imported inside the CPU tests only, so the card's machine (which
has no JAX) runs the CUDA-gated tests with
`python -m pytest --noconftest tests/test_torch_weight_gemm.py -m cuda`.
"""
import numpy as np
import pytest
import torch

from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops.kernels import weight_gemm as wg
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2 ** -6, atol=1e-3)
MISMATCH_SHARE = 0.01
HEAD_CARD = dict(rtol=0.0, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _jax():
    import jax.numpy as jnp

    from localai_tpu.models import llama as jllama
    from localai_tpu.ops import quant as jquant

    return jnp, jquant, jllama


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _weight(seed, K, N):
    """An int8 weight and its scales as numpy, quantized by the reference
    from N(0, 1/K) values (the checkpoints' init)."""
    jnp, jquant, _ = _jax()
    w = _rng(seed).standard_normal((K, N)).astype(np.float32) * K ** -0.5
    p = jquant.quantize(jnp.asarray(w))
    return np.asarray(p["q"]), np.asarray(p["s"])


def _x_shape(M, ndim):
    if ndim == 2:
        return (M,)
    return {1: (1, 1), 8: (2, 4), 192: (2, 96), 300: (3, 100)}[M]


# ------------------------------------------------ plain vs the reference

@pytest.mark.parametrize("K,N", [(24, 40), (256, 384)],
                         ids=["ragged", "aligned"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("M", [1, 8, 192, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a16_plain_vs_reference_qmatmul(dtype, M, ndim, K, N):
    jnp, jquant, _ = _jax()
    q, s = _weight(M + K, K, N)
    x = _rng(M).standard_normal(_x_shape(M, ndim) + (K,)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jquant.qmatmul(jnp.asarray(x, jd),
                         {"q": jnp.asarray(q), "s": jnp.asarray(s)})
    out = wg.w8a16_matmul_plain(torch.tensor(x).to(td), torch.tensor(q),
                                torch.tensor(s))
    assert out.dtype == td and out.shape == ref.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def _head_params(kind, K, V, seed):
    """The reference's params for _lm_head, and the port's head_matmul
    arguments for the same head."""
    jnp, jquant, _ = _jax()
    r = _rng(seed)
    w = (r.standard_normal((K, V)) * K ** -0.5).astype(np.float32)
    embed = (r.standard_normal((V, K)) * K ** -0.5).astype(np.float32)
    if kind == "bf16":
        h = jnp.asarray(w, jnp.bfloat16)
        return {"embed": jnp.asarray(embed), "lm_head": h}, (
            torch.tensor(np.asarray(h, np.float32)).to(torch.bfloat16),)
    if kind == "tied":
        e = jnp.asarray(embed, jnp.bfloat16)
        te = torch.tensor(np.asarray(e, np.float32)).to(torch.bfloat16)
        return {"embed": e}, (te.T,)
    p = jquant.quantize(jnp.asarray(w))
    return {"embed": jnp.asarray(embed), "lm_head": p}, (
        torch.tensor(np.asarray(p["q"])), torch.tensor(np.asarray(p["s"])))


@pytest.mark.parametrize("shape", [(1,), (8,), (2, 5)],
                         ids=["M1", "M8", "3d"])
@pytest.mark.parametrize("kind", ["bf16", "tied", "int8"])
def test_head_plain_vs_reference_lm_head(kind, shape):
    jnp, _, jllama = _jax()
    K, V = 64, 200
    params, args = _head_params(kind, K, V, seed=len(shape) + shape[0])
    x = _rng(3).standard_normal(shape + (K,)).astype(np.float32)
    ref = jllama._lm_head(jnp.asarray(x), params)
    out = wg.head_matmul_plain(torch.tensor(x), *args)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_port_lm_head_takes_the_three_head_kinds():
    """models/llama._lm_head hands each head kind to head_matmul as stored:
    the tied embedding as embed.T, the int8 head as (q, s)."""
    jnp, _, jllama = _jax()
    from localai_tpu_torch.models import llama as tllama
    from localai_tpu_torch.ops.quant import QuantWeight

    K, V = 32, 48
    x = _rng(4).standard_normal((3, K)).astype(np.float32)
    for kind in ("bf16", "tied", "int8"):
        params, args = _head_params(kind, K, V, seed=9)
        head = None if kind == "tied" else (
            QuantWeight(*args) if kind == "int8" else args[0])
        embed = args[0].T.contiguous() if kind == "tied" else \
            torch.zeros(V, K, dtype=torch.bfloat16)
        model = type("P", (), {"lm_head": head, "embed": embed})()
        out = tllama._lm_head(torch.tensor(x), model)
        ref = jllama._lm_head(jnp.asarray(x), params)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


# ------------------------------------------------------ wrappers on CPU

def test_wrappers_run_plain_on_cpu_without_counting():
    tk.reset_launch_counts()
    q, s = _weight(1, 32, 48)
    x = torch.tensor(_rng(2).standard_normal((2, 3, 32)).astype(np.float32))
    tq, ts = torch.tensor(q), torch.tensor(s)
    for dt in (torch.float32, torch.bfloat16):
        a = tk.w8a16_matmul(x.to(dt), tq, ts)
        torch.testing.assert_close(a, tk.w8a16_matmul_plain(x.to(dt), tq, ts),
                                   rtol=0, atol=0)
    hb = torch.tensor(_rng(3).standard_normal((32, 64)).astype(np.float32))
    for args in ((hb.to(torch.bfloat16),), (hb.T.contiguous().to(
            torch.bfloat16).T,), (hb,), (tq, ts)):
        torch.testing.assert_close(tk.head_matmul(x, *args),
                                   tk.head_matmul_plain(x, *args), rtol=0,
                                   atol=0)
    counts = tk.launch_counts()
    assert counts["w8a16_matmul"] == 0 and counts["head_matmul"] == 0


def test_qmatmul_routes_int8_through_the_wrapper(monkeypatch):
    """ops/quant.qmatmul hands a quantized weight to w8a16_matmul as
    stored (q, s); a dense weight is still `x @ p`, no wrapper."""
    from localai_tpu_torch.ops import quant as tquant

    seen = []

    def spy(x, q, s):
        seen.append((q, s))
        return wg.w8a16_matmul_plain(x, q, s)

    monkeypatch.setattr(tquant, "w8a16_matmul", spy)
    w = torch.tensor(_rng(5).standard_normal((32, 48)).astype(np.float32))
    x = torch.tensor(_rng(6).standard_normal((4, 32)).astype(np.float32))
    qw = tquant.quantize(w)
    y = tquant.qmatmul(x, qw)
    assert len(seen) == 1 and seen[0][0] is qw.q and seen[0][1] is qw.s
    torch.testing.assert_close(y, wg.w8a16_matmul_plain(x, qw.q, qw.s),
                               rtol=0, atol=0)
    torch.testing.assert_close(tquant.qmatmul(x, w), x @ w, rtol=0, atol=0)
    assert len(seen) == 1


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("K,N,ok", [(4096, 14336, True), (3584, 18944, True),
                                    (272, 400, True), (24, 40, False),
                                    (4096, 1000, False)])
def test_shape_checks_name_the_multiple_of_16(K, N, ok):
    """K and N multiples of 16 (every published width); a ragged tail
    inside a tile is the kernel's to mask."""
    args = ("w8a16_matmul", _meta(8, K), _meta(K, N, dtype=torch.int8),
            _meta(1, N, dtype=torch.float32), wg._ACT)
    if ok:
        assert wg._weight_checks(*args) == (K, N, False)
    else:
        with pytest.raises(ValueError, match="multiples of 16"):
            wg._weight_checks(*args)


def test_shape_checks_raise_on_what_the_kernels_do_not_take():
    q = _meta(64, 128, dtype=torch.int8)
    s = _meta(1, 128, dtype=torch.float32)
    with pytest.raises(ValueError, match="64 rows"):
        wg._weight_checks("w8a16_matmul", _meta(4, 32), q, s, wg._ACT)
    with pytest.raises(TypeError, match="activations"):
        wg._weight_checks("w8a16_matmul", _meta(4, 64, dtype=torch.int32), q,
                          s, wg._ACT)
    with pytest.raises(ValueError, match="contiguous int8"):
        wg._weight_checks("w8a16_matmul", _meta(4, 64),
                          _meta(128, 64, dtype=torch.int8).T, s, wg._ACT)
    with pytest.raises(ValueError, match="scales"):
        wg._weight_checks("w8a16_matmul", _meta(4, 64), q,
                          _meta(1, 64, dtype=torch.float32), wg._ACT)
    x32 = _meta(4, 64, dtype=torch.float32)
    # the head: row-major, or the transpose of a row-major tied embedding
    assert wg._weight_checks("head_matmul", x32, _meta(64, 128), None,
                             (torch.float32,)) == (64, 128, False)
    assert wg._weight_checks("head_matmul", x32, _meta(128, 64).T, None,
                             (torch.float32,)) == (64, 128, True)
    with pytest.raises(ValueError, match="row-major"):
        wg._weight_checks("head_matmul", x32, _meta(64, 256)[:, ::2], None,
                          (torch.float32,))
    with pytest.raises(TypeError, match="activations"):
        wg._weight_checks("head_matmul", _meta(4, 64), _meta(64, 128), None,
                          (torch.float32,))


# Qwen2-7B's projections (K, N): gate/up, down, and k/v (hidden 3584,
# intermediate 18944, 4 KV heads of 128)
QWEN2_GEOMETRIES = [(3584, 18944), (18944, 3584), (3584, 512)]


@pytest.mark.parametrize("M,K,N,route", [
    (4, 4096, 1024, "w8"), (4, 4096, 14336, "w8"), (8, 14336, 4096, "w8"),
    (40, 4096, 1024, "w8"), (192, 4096, 4096, "w8"),
    (2048, 4096, 14336, "w8"), (8, 4096, 128256, "simt"),
    (1, 272, 400, "simt")]
    + [(M, K, N, "w8") for K, N in QWEN2_GEOMETRIES for M in (4, 192, 2048)])
def test_gemm_split_from_shapes(M, K, N, route):
    """Split-K: every K tile in exactly one split, none empty, each split
    at least 256 of K deep where K has that; the (row tile, column tile,
    split) blocks number at most one wave of the route's blocks an SM
    times the SMs (the decode route: the nearest count to it), and at
    least half of that unless the splits are already at that depth; no
    split where the output tiles fill the wave alone."""
    sms = 132
    if route == "w8":
        name, tile, splits, per = wg.w8_plan(M, N, K, sms)
        assert tile[0] >= min(M, wg.GEMV_ROWS)
        assert (M <= wg.GEMV_ROWS) == (name == "gemv")
    else:
        name, tile = "simt", wg.SIMT
    per_sm, nearest = wg.PER_SM[name], name == "gemv"
    assert (route == "simt" or (splits, per) == wg.gemm_split(
        M, N, K, tile, sms, per_sm, nearest))
    splits, per = wg.gemm_split(M, N, K, tile, sms, per_sm, nearest)
    bm, bn, bk = tile
    nk = -(-K // bk)
    min_per = min(nk, wg.SPLIT_MIN_K // bk)
    assert (splits - 1) * per < nk <= splits * per
    assert per >= min_per
    tiles = -(-M // bm) * -(-N // bn)
    wave = per_sm * sms
    # the decode route takes the split count nearest a wave, the others
    # the most that fit in one
    want = max(1, round(wave / tiles) if nearest else wave // tiles)
    assert splits <= want
    assert splits * 2 > want or per == min_per
    if want == 1:
        assert splits == 1
    if want >= 2:
        assert splits >= 2 or nk < 2 * min_per


@pytest.mark.parametrize("M,K,N,route,bm", [
    (1, 4096, 14336, "gemv", 16), (16, 4096, 1024, "gemv", 16),
    (17, 4096, 1024, "wgmma", 64), (64, 4096, 14336, "wgmma", 64),
    (65, 4096, 14336, "wgmma", 128), (192, 4096, 14336, "wgmma", 192),
    (192, 4096, 1024, "wgmma", 64), (192, 14336, 4096, "wgmma", 192),
    (193, 4096, 14336, "wgmma", 256), (700, 4096, 14336, "wgmma", 256),
    (2048, 4096, 14336, "wgmma", 256), (2048, 4096, 1024, "wgmma", 128),
    (2048, 3584, 512, "wgmma", 64)])
def test_w8_plan_route_and_row_tile(M, K, N, route, bm):
    """The route is a rule of M alone: mma.sync with the weight converted
    in registers up to 16 rows (decode), wgmma above. There the row tile
    is the cheapest by wgmma_cost: the largest that fills the card at
    prefill's M; a small one with split-K where few column tiles would
    leave SMs idle (wk at M = 192: 24 tiles of 64 rows in 5 splits, not 8
    of 192 rows in 16)."""
    name, tile, splits, per = wg.w8_plan(M, N, K, 132)
    assert (name, tile[0]) == (route, bm)
    assert tile[1:] == ((128, 64) if route == "wgmma" else wg.GEMV[1:])
    if route == "wgmma":
        costs = {b: wg.wgmma_cost(M, N, K, b, 132) for b in wg.WGMMA_ROWS}
        assert costs[bm] == min(costs.values())


def _w4_splits(N, K):
    """The int4 decode route's grid on the host: (column tiles of 128,
    splits, K tiles of 128 a split) from w4_plan."""
    splits, per = wg.w4_plan(N, K, 132)
    return -(-N // 128), splits, per


@pytest.mark.parametrize("M,K,N", [(4, 4096, 14336), (1, 4096, 1024),
                                   (16, 14336, 4096), (4, 4096, 4096),
                                   (8, 3584, 512), (4, 272, 400),
                                   (4, 4096, 128256)])
def test_w4_plan_covers_every_unit_once(M, K, N):
    """The int4 decode plan: every (column tile, K tile of 128) unit lies
    in exactly one block (column tile, split), no split is empty, the
    splits but the last take the same K tiles, at least W4_SPLIT_KT, and
    the blocks stay within W4_BLOCKS_SM an SM unless the column tiles
    alone exceed it (the head's 1002: no split), at every row count."""
    tiles, splits, per = _w4_splits(N, K)
    nk = -(-K // 128)
    seen = [(t, k) for t in range(tiles) for z in range(splits)
            for k in range(z * per, min((z + 1) * per, nk))]
    assert sorted(seen) == [(t, k) for t in range(tiles)
                            for k in range(nk)]
    assert all(min((z + 1) * per, nk) > z * per for z in range(splits))
    assert per >= min(nk, wg.W4_SPLIT_KT)
    assert tiles * splits <= wg.W4_BLOCKS_SM * 132 or splits == 1
    want = {(4, 4096, 14336): (112, 2, 16), (16, 14336, 4096): (32, 8, 14),
            (4, 4096, 4096): (32, 8, 4), (1, 4096, 1024): (8, 8, 4),
            (4, 4096, 128256): (1002, 1, 32)}
    if (M, K, N) in want:
        assert (tiles, splits, per) == want[(M, K, N)]


def test_w4_split_order_sums_equal_the_product():
    """The decode route's arithmetic on the host: each split's f32 sums of
    its K tiles, the splits added in split order by the tile's last split,
    then qmatmul's rounding — equals w4a16_matmul_plain within the bf16
    bar, at a shape that takes split-K."""
    M, K, N = 3, 4096, 1024
    r = _rng(3)
    q8 = torch.tensor(r.integers(-7, 8, (K, N)), dtype=torch.int8)
    s = torch.tensor(r.random((1, N)) * 0.01 + 1e-3, dtype=torch.float32)
    x = torch.tensor(r.standard_normal((M, K)), dtype=torch.float32).to(
        torch.bfloat16)
    tiles, splits, per = _w4_splits(N, K)
    assert splits > 1
    acc = torch.zeros(M, N)
    for z in range(splits):
        k = slice(z * per * 128, min((z + 1) * per * 128, K))
        acc += x[:, k].float() @ q8[k].float()
    out = (acc.to(torch.bfloat16).float()
           * s.to(torch.bfloat16).float()).to(torch.bfloat16)
    ref = tk.w4a16_matmul_plain(x, tk.pack_int4(q8), s)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


@pytest.mark.parametrize("M,epi,route", [(1, 0, "w4"), (16, 0, "w4"),
                                         (17, 0, "w8"), (4, 1, "w4"),
                                         (17, 1, "w8")])
def test_int4_decode_rows_take_the_pdl_launch(monkeypatch, M, epi, route):
    """_launch_w8 sends a packed int4 projection or head at M <= GEMV_ROWS
    to the decode route's programmatic dependent launch (_launch_w4),
    larger M to the wgmma route."""
    took = []
    monkeypatch.setattr(wg, "_launch_w4",
                        lambda *a, **k: took.append("w4"))
    monkeypatch.setattr(wg, "_sm_count", lambda d: 132)

    class Lib:
        def __getattr__(self, name):
            took.append(name)
            return lambda *a: 0

    monkeypatch.setattr(wg._build, "load", lambda name: Lib())
    monkeypatch.setattr(wg, "_weight_map", lambda *a: ctypes_buf())
    monkeypatch.setattr(wg, "_counters", lambda d: torch.zeros(1))
    monkeypatch.setattr(wg, "_stream", lambda d: None)
    x = torch.zeros(M, 256, dtype=torch.bfloat16)
    q = torch.zeros(128, 256, dtype=torch.uint8)
    s = torch.ones(256)
    out = torch.empty(M, 256)
    wg._launch_w8("w4a16_matmul", x, q, s, out, epi)
    if route == "w4":
        assert took == ["w4"]
    else:
        assert took == ["weight_gemm_wgmma_launch"]


def ctypes_buf():
    import ctypes

    return ctypes.create_string_buffer(128)


# ---------------------------------------------- the int8 recipe, whole

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from fixtures import tiny_checkpoint

    return tiny_checkpoint(tmp_path_factory)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_recipe_greedy_tokens_equal_reference_engine(ckpt, dtype):
    """The tiny checkpoint quantized by the reference's quantize_params
    (int8 projections and head, activations in `dtype`), the same weights
    through both engines via params_from_jax: the same greedy tokens,
    through prefill, chunked prefill (extend) and the fused decode loop."""
    import jax

    from localai_tpu.engine import loader as jloader
    from localai_tpu.engine.engine import (
        Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
    )
    from localai_tpu.ops.quant import quantize_params as jquantize_params
    from localai_tpu.ops.sampling import SamplingParams as JParams
    from localai_tpu_torch.engine import loader as tloader
    from localai_tpu_torch.engine.engine import (
        Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
    )
    from localai_tpu_torch.models.llama import params_from_jax
    from localai_tpu_torch.ops.quant import is_quantized
    from localai_tpu_torch.ops.sampling import SamplingParams as TParams

    jcfg, jp, jtok = jloader.load_model(ckpt, dtype=dtype)
    jq = jquantize_params(jp)
    tcfg, _, ttok = tloader.load_model(ckpt, dtype=dtype, device="cpu")
    tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), tcfg,
                         device="cpu")
    assert is_quantized(tq.layers[0]["wq"]) and is_quantized(tq.lm_head)
    ec = dict(max_slots=2, max_context=128, prefill_buckets=(16, 32),
              prefill_chunk=32, decode_loop=8)
    prompts = [list(range(3, 12)), list(range(5, 75))]   # bucket, chunked
    streams = []
    for eng, req, par in ((JEngine(jcfg, jq, jtok, JConfig(**ec)), JRequest,
                           JParams),
                          (TEngine(tcfg, tq, ttok, TConfig(**ec),
                                   device="cpu"), TRequest, TParams)):
        streams.append([
            [o.token_id for o in eng.generate(req(
                p, par(temperature=0.0), max_tokens=12, ignore_eos=True))
             if o.token_id >= 0] for p in prompts])
    assert streams[1] == streams[0]
    assert all(len(s) == 12 for s in streams[1])


ENGINE_EC = {
    "dense": dict(max_slots=2, max_context=128, prefill_buckets=(16, 32),
                  prefill_chunk=32, decode_loop=8),
    "paged": dict(max_slots=2, max_context=128, prefill_buckets=(16, 32),
                  prefill_chunk=32, decode_loop=8, kv_pages=6),
    "ragged": dict(max_slots=3, max_context=128, prefill_buckets=(16,),
                   prefill_chunk=16, kv_pages=10, ragged_token_budget=64),
}


@pytest.mark.parametrize("path", list(ENGINE_EC))
def test_engine_metrics_count_every_forward(ckpt, monkeypatch, path):
    """chip_smoke.py holds the kernels' launches to the forwards an engine
    ran, from its metrics: admission prefills, chunked-prefill chunks (the
    non-final ones, prefill_chunks_mid, return no logits) and decode steps
    (a ragged pack counts as one), plus its graphs' warm-up steps (none on
    the CPU). Here the same sums count the calls of the two wrappers: 7 a
    layer a forward for the int8 projections, one a forward with logits
    for the head."""
    from localai_tpu_torch.engine import loader as tloader
    from localai_tpu_torch.engine.engine import (
        Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
    )
    from localai_tpu_torch.models import llama as tllama
    from localai_tpu_torch.ops import quant as tquant
    from localai_tpu_torch.ops.sampling import SamplingParams as TParams

    calls = {"w8": 0, "head": 0}

    def w8(x, q, s):
        calls["w8"] += 1
        return wg.w8a16_matmul_plain(x, q, s)

    def head(x32, w, s=None):
        calls["head"] += 1
        return wg.head_matmul_plain(x32, w, s)

    monkeypatch.setattr(tquant, "w8a16_matmul", w8)
    monkeypatch.setattr(tllama, "head_matmul", head)
    cfg, params, tok = tloader.load_model(ckpt, dtype="int8", device="cpu")
    eng = TEngine(cfg, params, tok, TConfig(**ENGINE_EC[path]), device="cpu")
    m0 = dict(eng.metrics)
    qs = [eng.submit(TRequest(p, TParams(temperature=0.0), max_tokens=10,
                              ignore_eos=True))[1]
          for p in (list(range(3, 12)), list(range(5, 75)))]
    for i in range(500):
        if i == 3:
            qs.append(eng.submit(TRequest(list(range(7, 30)),
                                          TParams(temperature=0.0),
                                          max_tokens=6, ignore_eos=True))[1])
        if not eng.step() and i > 3:
            break
    assert all(not q.empty() for q in qs)
    m = eng.metrics

    def gained(k):
        return m[k] - m0[k]

    mid = gained("prefill_chunks_mid")
    forwards = (gained("admit_dispatches") + mid
                + gained("prefill_chunks_final")
                + gained("decode_steps_dispatched"))
    if path == "ragged":
        assert gained("admit_dispatches") == 0 and mid == 0
    else:
        assert mid > 0 and gained("prefill_chunks_final") > 0
    assert calls["w8"] == 7 * cfg.num_layers * forwards
    assert calls["head"] == forwards - mid


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return torch.device("cuda")


def _card_weight(K, N, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=device) * K ** -0.5
    amax = w.abs().amax(0, keepdim=True)
    s = torch.clamp_min(amax, 1e-8) / 127
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def assert_w8_close(out, ref):
    """The bf16/f16 bar of the module docstring: 2 steps per element and
    at most MISMATCH_SHARE of the outputs different at all."""
    d = (out.float() - ref.float()).abs()
    excess = float((d - BF16["rtol"] * ref.float().abs()).max())
    share = float((out != ref).float().mean())
    assert excess <= BF16["atol"], (excess, float(d.max()))
    assert share <= MISMATCH_SHARE, share


GEOMETRIES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (3584, 512), (272, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 63, 64, 65, 191, 192, 193,
                               2047, 2048])
@pytest.mark.parametrize("K,N", GEOMETRIES + QWEN2_GEOMETRIES[:2])
def test_cuda_w8a16_bf16_vs_plain(cuda, K, N, M):
    q, s = _card_weight(K, N, cuda, seed=K + N)
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    out = tk.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert_w8_close(out, tk.w8a16_matmul_plain(x, q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_w8a16_converts_every_int8_value_exactly(cuda, dtype, M):
    """Every int8 value, -128 included, through the kernel's conversion on
    both routes (M = 4: decode, 32: wgmma): one-hot rows of x pick weight
    rows, so each output is one int8 value times a unit scale, exact in
    bf16 and f16."""
    K, N = 256, 256
    k = torch.arange(K, device=cuda)[:, None]
    n = torch.arange(N, device=cuda)[None, :]
    q = ((k + n) % 256 - 128).to(torch.int8)
    s = torch.ones(1, N, device=cuda)
    x = torch.zeros(M, K, device=cuda)
    x[torch.arange(M), torch.arange(M) * 7 % K] = 1.0
    x = x.to(getattr(torch, dtype))
    out = tk.w8a16_matmul(x, q, s)
    assert torch.equal(out, tk.w8a16_matmul_plain(x, q, s))
    assert torch.equal(out.float(), q[torch.arange(M) * 7 % K].float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3,), (2, 96), (3, 100)])
@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_cuda_w8a16_f16_f32_vs_plain(cuda, dtype, shape):
    K, N = 4096, 1024
    q, s = _card_weight(K, N, cuda, seed=7)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape + (K,), generator=g, device=cuda).to(
        getattr(torch, dtype))
    out = tk.w8a16_matmul(x, q, s)
    ref = tk.w8a16_matmul_plain(x, q, s)
    assert out.dtype == x.dtype and out.shape == shape + (N,)
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=2 ** -16, atol=5e-5)
    else:
        assert_w8_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 64])
@pytest.mark.parametrize("kind", ["bf16", "tied", "int8"])
def test_cuda_head_vs_plain(cuda, kind, M):
    K, V = 4096, 128256
    g = torch.Generator(device=cuda).manual_seed(M)
    x32 = torch.randn(M, K, generator=g, device=cuda)
    if kind == "int8":
        args = _card_weight(K, V, cuda, seed=3)
    else:
        w = (torch.randn(V, K, generator=g, device=cuda)
             * K ** -0.5).to(torch.bfloat16)
        args = (w.T,) if kind == "tied" else (w.T.contiguous(),)
    out = tk.head_matmul(x32, *args)
    ref = tk.head_matmul_plain(x32, *args)
    assert out.dtype == torch.float32 and out.shape == (M, V)
    torch.testing.assert_close(out, ref, **HEAD_CARD)
    if kind == "bf16":   # the planted fault: x32 rounded to bf16
        bad = tk.head_matmul_plain(x32.to(torch.bfloat16).float(), *args)
        assert float((bad - ref).abs().max()) > HEAD_CARD["atol"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "tied"])
def test_cuda_head_ragged_tails(cuda, kind):
    K, V = 272, 400
    g = torch.Generator(device=cuda).manual_seed(2)
    x32 = torch.randn(3, K, generator=g, device=cuda)
    w = (torch.randn(V, K, generator=g, device=cuda)
         * K ** -0.5).to(torch.bfloat16)
    args = (w.T,) if kind == "tied" else (w.T.contiguous(),)
    torch.testing.assert_close(tk.head_matmul(x32, *args),
                               tk.head_matmul_plain(x32, *args), **HEAD_CARD)


@pytest.mark.cuda
def test_cuda_split_bf16_terms_bit_for_bit(cuda):
    """The split kernel equals its plain version (run on the CPU) bit for
    bit, special values included, and counts one launch."""
    from test_torch_head_route import _special_values

    v = torch.tensor(_special_values())
    v = torch.cat([v, torch.tensor([float("inf"), float("-inf"),
                                    float("nan")])])
    x = torch.cat([v, torch.zeros(-v.numel() % 256)]).reshape(-1, 256)
    tk.reset_launch_counts()
    got = tk.split_bf16_terms(x.to(cuda))
    torch.cuda.synchronize()
    assert tk.launch_counts()["split_bf16_terms"] == 1
    want = tk.split_bf16_terms_plain(x)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [9, 17, 40, 64, 65, 192, 2048])
@pytest.mark.parametrize("kind", ["bf16", "tied"])
def test_cuda_head_tensor_core_route_vs_plain(cuda, kind, M):
    """Above HEAD_SIMT_ROWS rows a bf16 head runs the tensor cores on x's
    three bf16 terms: within HEAD_CARD of the plain version, the split
    kernel launched once, and the planted fault (x32 rounded to bf16, the
    hi term alone) rejected."""
    K, V = 4096, 32000
    g = torch.Generator(device=cuda).manual_seed(M)
    x32 = torch.randn(M, K, generator=g, device=cuda)
    w = (torch.randn(V, K, generator=g, device=cuda)
         * K ** -0.5).to(torch.bfloat16)
    args = (w.T,) if kind == "tied" else (w.T.contiguous(),)
    assert wg.head_plan(M, V, K, 132)[0] == "wgmma"
    tk.reset_launch_counts()
    out = tk.head_matmul(x32, *args)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts["head_matmul"] == counts["split_bf16_terms"] == 1
    ref = tk.head_matmul_plain(x32, *args)
    torch.testing.assert_close(out, ref, **HEAD_CARD)
    bad = tk.head_matmul_plain(x32.to(torch.bfloat16).float(), *args)
    assert float((bad - out).abs().max()) > HEAD_CARD["atol"]


@pytest.mark.cuda
@pytest.mark.parametrize("M,V", [(40, 128256), (100, 2000)])
@pytest.mark.parametrize("kind", ["bf16", "tied"])
def test_cuda_head_tensor_core_route_keeps_the_lo_term(cuda, kind, M, V):
    """On inputs whose lo terms carry every logit (hi and mid cancel along
    K; test_torch_head_route._lo_term_case) the tensor-core route returns
    the exact logits within HEAD_CARD (both row tiles; V = 2000 takes
    split-K), and the same limit rejects a route without the lo term,
    whose logits are the f64 product of hi + mid."""
    from test_torch_head_route import _lo_term_case

    K = 4096
    x, w, exact = _lo_term_case(M, K, V, kind, device=cuda)
    assert wg.head_plan(M, V, K, 132)[0] == "wgmma"
    out = tk.head_matmul(x, w)
    torch.testing.assert_close(out.double(), exact, **HEAD_CARD)
    t = tk.split_bf16_terms_plain(x.cpu())
    dropped = (t[0].double() + t[1].double()) @ w.cpu().double()
    assert float((dropped - out.cpu().double()).abs().max()) \
        > HEAD_CARD["atol"]


@pytest.mark.cuda
@pytest.mark.parametrize("V", [400, 2000])
@pytest.mark.parametrize("kind", ["bf16", "tied"])
def test_cuda_head_tensor_core_route_tails_and_splits(cuda, kind, V):
    """Ragged row, column and K tails (M = 37, K = 272) and a small
    vocabulary, whose few column tiles take split-K."""
    M, K = 37, 272
    g = torch.Generator(device=cuda).manual_seed(V)
    x32 = torch.randn(M, K, generator=g, device=cuda)
    w = (torch.randn(V, K, generator=g, device=cuda)
         * K ** -0.5).to(torch.bfloat16)
    args = (w.T,) if kind == "tied" else (w.T.contiguous(),)
    out = tk.head_matmul(x32, *args)
    torch.testing.assert_close(out, tk.head_matmul_plain(x32, *args),
                               **HEAD_CARD)
    x = torch.randn(M, 4096, generator=g, device=cuda)
    w = (torch.randn(V, 4096, generator=g, device=cuda)
         * 4096 ** -0.5).to(torch.bfloat16)
    args = (w.T,) if kind == "tied" else (w.T.contiguous(),)
    assert wg.head_plan(M, V, 4096, 132)[2] > 1
    torch.testing.assert_close(tk.head_matmul(x, *args),
                               tk.head_matmul_plain(x, *args), **HEAD_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_cuda_quantized_heads_keep_their_routes(cuda, kind):
    """head_plan is the bf16 head's: an int8 or packed int4 head at M = 40
    runs row 13's routes (its own counter), no split of x32."""
    K, V, M = 4096, 32000, 40
    q, s = (_card_weight if kind == "int8" else _card_weight4)(K, V, cuda)
    x32 = torch.randn(M, K, device=cuda)
    tk.reset_launch_counts()
    out = tk.head_matmul(x32, q, s)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts["split_bf16_terms"] == 0
    assert counts["head_matmul" if kind == "int8" else "head_matmul_int4"] \
        == 1
    torch.testing.assert_close(out, tk.head_matmul_plain(x32, q, s),
                               **HEAD_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 40])
def test_cuda_head_routes_agree(cuda, M):
    """The SIMT route and the tensor-core route, each called on its own at
    the same M, agree within HEAD_CARD."""
    K, V = 4096, 32000
    g = torch.Generator(device=cuda).manual_seed(7)
    x32 = torch.randn(M, K, generator=g, device=cuda)
    w = (torch.randn(K, V, generator=g, device=cuda)
         * K ** -0.5).to(torch.bfloat16)
    outs = {}
    for route in ("simt", "wgmma"):
        outs[route] = torch.empty(M, V, device=cuda)
        wg._launch_head("head_matmul", x32, w, outs[route], False,
                        wg.head_route(route, M, V, K, 132))
    torch.testing.assert_close(outs["wgmma"], outs["simt"], **HEAD_CARD)


def _stage_before_load(q, t=1):
    """The weight a ring stage read before its load landed would give: K
    tile t (64 rows) replaced by tile t - 1, the stage's previous
    contents."""
    qs = q.clone()
    qs[64 * t:64 * (t + 1)] = q[64 * (t - 1):64 * t]
    return qs


def _assert_faults_rejected(M, seed):
    K, N = 4096, 1024
    dev = torch.device("cuda")
    q, s = _card_weight(K, N, dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    out = tk.w8a16_matmul(x, q, s)
    assert_w8_close(out, tk.w8a16_matmul_plain(x, q, s))
    early = ((x.float() @ q.float()) * s).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        assert_w8_close(out, early)
    qd = q.clone()
    qd[64:128] = 0                                  # one K tile dropped
    with pytest.raises(AssertionError):
        assert_w8_close(out, tk.w8a16_matmul_plain(x, qd, s))
    with pytest.raises(AssertionError):             # a stage read early
        assert_w8_close(out, tk.w8a16_matmul_plain(
            x, _stage_before_load(q), s))


@pytest.mark.cuda
def test_cuda_w8a16_planted_faults_rejected(cuda):
    """Decode route (M = 8)."""
    _assert_faults_rejected(8, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [192, 2048])
def test_cuda_w8a16_wgmma_planted_faults_rejected(cuda, M):
    """Large-M route: the TMA ring's stage read early among them."""
    _assert_faults_rejected(M, seed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split", "big", "prefill", "head",
                                  "head-int8", "head-large", "head-tied"])
def test_cuda_graph_replay_equals_eager_and_repeats(cuda, case):
    """A call captured in a CUDA graph (its output and split-K workspace
    from the graph's pool, the tensor maps in its kernel's parameters)
    gives the eager call's bits, and so does every repeated call: no float
    atomics, a fixed combine order. "split": the decode route with split-K,
    "big": the wgmma route with split-K (M = 192), "prefill": the wgmma
    route with no split (M = 2048)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    if case.startswith("head"):
        # head-large / head-tied: the tensor-core route (M = 192)
        K, V = 4096, 32000
        x = torch.randn(4 if case in ("head", "head-int8") else 192, K,
                        generator=g, device=cuda)
        args = _card_weight(K, V, cuda) if case == "head-int8" else (
            (torch.randn(K, V, generator=g, device=cuda)
             * K ** -0.5).to(torch.bfloat16),)
        if case == "head-tied":
            args = (args[0].T.contiguous().T,)

        def fn():
            return tk.head_matmul(x, *args)
    else:
        M = {"split": 4, "big": 192, "prefill": 2048}[case]
        q, s = _card_weight(4096, 1024 if M < 2048 else 4096, cuda)
        x = torch.randn(M, 4096, generator=g, device=cuda).to(torch.bfloat16)

        def fn():
            return tk.w8a16_matmul(x, q, s)
    eager = fn()
    for _ in range(3):
        assert torch.equal(fn(), eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_wrappers_raise_rather_than_copy_a_weight(cuda):
    q, s = _card_weight(64, 128, cuda)
    x = torch.randn(4, 64, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous int8"):
        tk.w8a16_matmul(x, q.T.contiguous().T, s)
    with pytest.raises(ValueError, match="multiples of 16"):
        tk.w8a16_matmul(x[:, :40], q[:40], s)
    tk.reset_launch_counts()
    tk.w8a16_matmul(x, q, s)
    tk.head_matmul(x.float(), q, s)
    assert tk.launch_counts()["w8a16_matmul"] == 1
    assert tk.launch_counts()["head_matmul"] == 1


# ------------------------------------------------- the expert GEMM (MoE)

MOE_ONE_STEP = dict(rtol=2 ** -7, atol=1e-3)


def _card_experts(E, K, N, device, seed=0):
    """An int8 expert stack q [E, K, N] with scales s [E, 1, N] (each
    expert quantized per output channel), made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(E, K, N, generator=g, device=device) * K ** -0.5
    s = torch.clamp_min(w.abs().amax(1, keepdim=True), 1e-8) / 127
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def assert_moe_close(out, ref):
    d = (out.float() - ref.float()).abs()
    excess = float((d - MOE_ONE_STEP["rtol"] * ref.float().abs()).max())
    share = float((out != ref).float().mean())
    assert excess <= MOE_ONE_STEP["atol"], (excess, float(d.max()))
    assert share <= MISMATCH_SHARE, share


def _moe_x(M, E, K, shared, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (M, K) if shared else (M, E, K)
    return torch.randn(shape, generator=g, device=device).to(dtype)


# Mixtral-8x7B's w1/w3 (K, N) = (4096, 14336) and w2 (14336, 4096), and a
# small geometry with N and K tails of the tiles
MOE_GEOMETRIES = [(8, 4096, 14336), (8, 14336, 4096), (4, 272, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16, 17, 192, 2048])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-expert"])
@pytest.mark.parametrize("E,K,N", MOE_GEOMETRIES)
def test_cuda_moe_w8_vs_plain(cuda, E, K, N, shared, M):
    """Both routes (M <= 16: mma.sync; above: TMA + wgmma), x shared by the
    experts (w1, w3) or one slice an expert (w2), in one launch."""
    q, s = _card_experts(E, K, N, cuda, seed=E + K + N)
    x = _moe_x(M, E, K, shared, torch.bfloat16, cuda, seed=M)
    tk.reset_launch_counts()
    out = tk.moe_w8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert tk.launch_counts()["moe_w8_matmul"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (M, E, N)
    assert_moe_close(out, tk.moe_w8_matmul_plain(x, q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 192])
def test_cuda_moe_w8_planted_faults_rejected(cuda, M):
    """The bar rejects an expert read with the next expert's scales, a K
    tile dropped, and the scale applied after the sum (row 13's rounding
    instead of the dequantize-then-product one)."""
    E, K, N = 8, 1024, 512
    q, s = _card_experts(E, K, N, cuda, seed=9)
    x = _moe_x(M, E, K, True, torch.bfloat16, cuda, seed=10)
    out = tk.moe_w8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert_moe_close(out, tk.moe_w8_matmul_plain(x, q, s))
    with pytest.raises(AssertionError):
        assert_moe_close(out, tk.moe_w8_matmul_plain(
            x, q, torch.roll(s, 1, dims=0)))
    qd = q.clone()
    qd[:, 64:128] = 0
    with pytest.raises(AssertionError):
        assert_moe_close(out, tk.moe_w8_matmul_plain(x, qd, s))
    after = (torch.einsum("mk,ekn->men", x.float(), q.float())
             * s.transpose(0, 1)).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        assert_moe_close(out, after)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 2048])
def test_cuda_moe_w8_graph_replay_equals_eager(cuda, M):
    """A captured call gives the eager call's bits, and so does every
    repeated call (no atomics, no split-K)."""
    q, s = _card_experts(8, 4096, 1024, cuda, seed=12)
    x = _moe_x(M, 8, 4096, True, torch.bfloat16, cuda, seed=13)

    def fn():
        return tk.moe_w8_matmul(x, q, s)

    eager = fn()
    for _ in range(3):
        assert torch.equal(fn(), eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_moe_w8_raises_on_what_it_does_not_take(cuda):
    q, s = _card_experts(4, 64, 128, cuda)
    x = torch.randn(4, 64, device=cuda)
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match="bf16"):
            tk.moe_w8_matmul(x.to(dtype), q, s)
    with pytest.raises(ValueError, match="contiguous int8"):
        tk.moe_w8_matmul(x.to(torch.bfloat16), q.transpose(1, 2), s)
    with pytest.raises(ValueError, match="scales"):
        tk.moe_w8_matmul(x.to(torch.bfloat16), q, s[:, 0])



# ------------------------------------------- int4 weights (packed, uint8)

def _card_weight4(K, N, device, seed=0, E=None):
    """A packed int4 weight [K/2, N] (or a stack [E, K/2, N]) and its
    scales, quantized on the card from N(0, 1/K) values."""
    from localai_tpu_torch.ops.quant import quantize

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (K, N) if E is None else (E, K, N)
    qw = quantize(torch.randn(shape, generator=g, device=device)
                  * K ** -0.5, bits=4)
    return qw.q, qw.s


def _int4_faults(p):
    """The int8 weights two misreadings of the packed p give: the nibbles
    swapped (K rows 2j and 2j + 1 exchanged) and read unsigned."""
    swapped = tk.unpack_int4(((p & 15) << 4) | (p >> 4))
    lo, hi = (p & 15).to(torch.int8), (p >> 4).to(torch.int8)
    unsigned = torch.stack([lo, hi], dim=-2).reshape(
        *p.shape[:-2], 2 * p.shape[-2], p.shape[-1])
    return {"nibbles_swapped": swapped, "nibbles_unsigned": unsigned}


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 64, 65, 192, 193, 2048])
@pytest.mark.parametrize("K,N", GEOMETRIES)
def test_cuda_w4a16_bf16_vs_plain(cuda, K, N, M):
    """Both routes (M <= 16: mma.sync over K tiles of 128; above: TMA +
    wgmma over [32][128] packed tiles), with and without split-K."""
    q, s = _card_weight4(K, N, cuda, seed=K + N)
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    tk.reset_launch_counts()
    out = tk.w4a16_matmul(x, q, s)
    torch.cuda.synchronize()
    assert tk.launch_counts()["w4a16_matmul"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert_w8_close(out, tk.w4a16_matmul_plain(x, q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_w4a16_converts_every_int4_value_exactly(cuda, dtype, M):
    """Every nibble, -8 included, in both halves of a byte, through the
    kernel's conversion on both routes: one-hot rows of x pick weight
    rows, so each output is one int4 value times a unit scale."""
    K, N = 256, 256
    k = torch.arange(K, device=cuda)[:, None]
    n = torch.arange(N, device=cuda)[None, :]
    q8 = ((k * 3 + n) % 16 - 8).to(torch.int8)
    q, s = tk.pack_int4(q8), torch.ones(1, N, device=cuda)
    x = torch.zeros(M, K, device=cuda)
    rows = (torch.arange(M, device=cuda) * 7) % K
    x[torch.arange(M, device=cuda), rows] = 1.0
    x = x.to(getattr(torch, dtype))
    out = tk.w4a16_matmul(x, q, s)
    assert torch.equal(out, tk.w4a16_matmul_plain(x, q, s))
    assert torch.equal(out.float(), q8[rows].float())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 192, 2048])
def test_cuda_int4_planted_faults_rejected(cuda, M):
    """The bar rejects the nibbles swapped and read unsigned (projection
    and head; the experts also the next expert's scales)."""
    K, N = 4096, 1024
    q, s = _card_weight4(K, N, cuda, seed=5)
    x = torch.randn(M, K, device=cuda).to(torch.bfloat16)
    out = tk.w4a16_matmul(x, q, s)
    assert_w8_close(out, tk.w4a16_matmul_plain(x, q, s))
    for bad in _int4_faults(q).values():
        with pytest.raises(AssertionError):
            assert_w8_close(out, tk.w8a16_matmul_plain(x, bad, s))
    x32 = torch.randn(min(M, 64), K, device=cuda)
    head = tk.head_matmul(x32, q, s)
    torch.testing.assert_close(head, tk.head_matmul_plain(x32, q, s),
                               **HEAD_CARD)
    for bad in _int4_faults(q).values():
        assert float((tk.head_matmul_plain(x32, bad, s) - head).abs()
                     .max()) > HEAD_CARD["atol"]
    E = 4
    qe, se = _card_weight4(1024, 512, cuda, seed=9, E=E)
    xe = _moe_x(min(M, 192), E, 1024, True, torch.bfloat16, cuda, seed=10)
    out = tk.moe_w4_matmul(xe, qe, se)
    assert_moe_close(out, tk.moe_w4_matmul_plain(xe, qe, se))
    faults = dict(_int4_faults(qe))
    for bad in faults.values():
        with pytest.raises(AssertionError):
            assert_moe_close(out, tk.moe_w8_matmul_plain(xe, bad, se))
    with pytest.raises(AssertionError):
        assert_moe_close(out, tk.moe_w4_matmul_plain(
            xe, qe, torch.roll(se, -1, dims=0)))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 64, 192])
def test_cuda_head_int4_vs_plain(cuda, M):
    K, V = 4096, 128256
    q, s = _card_weight4(K, V, cuda, seed=3)
    x32 = torch.randn(M, K, device=cuda)
    tk.reset_launch_counts()
    out = tk.head_matmul(x32, q, s)
    torch.cuda.synchronize()
    assert tk.launch_counts()["head_matmul_int4"] == 1
    assert tk.launch_counts()["head_matmul"] == 0
    assert out.dtype == torch.float32 and out.shape == (M, V)
    torch.testing.assert_close(out, tk.head_matmul_plain(x32, q, s),
                               **HEAD_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16, 17, 192, 2048])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-expert"])
@pytest.mark.parametrize("E,K,N", MOE_GEOMETRIES)
def test_cuda_moe_w4_vs_plain(cuda, E, K, N, shared, M):
    q, s = _card_weight4(K, N, cuda, seed=E + K + N, E=E)
    x = _moe_x(M, E, K, shared, torch.bfloat16, cuda, seed=M)
    tk.reset_launch_counts()
    out = tk.moe_w4_matmul(x, q, s)
    torch.cuda.synchronize()
    assert tk.launch_counts()["moe_w4_matmul"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (M, E, N)
    assert_moe_close(out, tk.moe_w4_matmul_plain(x, q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("E,K,N", MOE_GEOMETRIES + [(2, 64, 128)])
def test_cuda_moe_w4_decode_any_grid(cuda, E, K, N, M):
    """The int4 decode route's grid at 1, 7, 97 blocks and one
    a unit: tiles cut anywhere, their parts combined in block order, each
    result within the bar of the plain version; and a unit's K rows (one
    unit, MOE4_BK rows, of expert 1) dropped is rejected."""
    q, s = _card_weight4(K, N, cuda, seed=E + K + N, E=E)
    x = _moe_x(M, E, K, True, torch.bfloat16, cuda, seed=M)
    ref = tk.moe_w4_matmul_plain(x, q, s)
    units = wg.moe4_plan(M, N, K, E, 132)[1]
    for blocks in sorted({1, min(7, units), min(97, units), units}):
        out = torch.empty(M, E, N, dtype=torch.bfloat16, device=cuda)
        wg._launch_moe4("moe_w4_matmul", x, q, s, out, blocks)
        assert_moe_close(out, ref)
    q8 = tk.unpack_int4(q)
    k0 = wg.MOE4_BK if K > wg.MOE4_BK else 0
    q8[min(1, E - 1), k0:k0 + wg.MOE4_BK] = 0
    bad = tk.moe_w8_matmul_plain(x, q8, s)
    d = (bad.float() - ref.float()).abs()
    assert float((d - MOE_ONE_STEP["rtol"] * ref.float().abs()).max()) > \
        MOE_ONE_STEP["atol"] or float((bad != ref).float().mean()) > \
        MISMATCH_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("M", [1, 4, 8, 16])
@pytest.mark.parametrize("K,N", GEOMETRIES + QWEN2_GEOMETRIES[2:])
def test_cuda_w4_decode_any_split(cuda, monkeypatch, K, N, M, dtype):
    """The int4 decode route (a programmatic dependent launch) at every W4
    geometry on the plan's split count and on 1, 2, 3 and 7 (set through
    W4_SPLIT_KT, the cap of blocks an SM lifted): each result within the
    bar of the plain version; the int4 head (EPI_F32) on the plan within
    HEAD_CARD."""
    q, s = _card_weight4(K, N, cuda, seed=K + N)
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, K, generator=g, device=cuda).to(getattr(torch, dtype))
    ref = tk.w4a16_matmul_plain(x, q, s)
    nk = -(-K // wg.GEMV4[2])
    for splits in (None, 1, 2, 3, 7):
        if splits is not None:
            monkeypatch.setattr(wg, "W4_SPLIT_KT", -(-nk // splits))
            monkeypatch.setattr(wg, "W4_BLOCKS_SM", 1 << 20)
        wg.w4_plan.cache_clear()
        assert_w8_close(tk.w4a16_matmul(x, q, s), ref)
    monkeypatch.undo()
    wg.w4_plan.cache_clear()
    if dtype == "bfloat16":
        x32 = torch.randn(M, K, generator=g, device=cuda)
        out = torch.empty(M, N, device=cuda)
        wg._launch_w4("head_matmul_int4", x32.to(torch.bfloat16), q, s, out,
                      1)
        torch.testing.assert_close(out, tk.head_matmul_plain(x32, q, s),
                                   **HEAD_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16])
def test_cuda_w4_pdl_chain_in_a_graph_equals_eager(cuda, M):
    """Consecutive int4 projections, each reading the previous one's output
    (programmatic dependent launches: a kernel's weight stream starts
    under the previous kernel's tail), captured in one CUDA graph: the
    replay gives the eager chain's bits, and so do repeated replays."""
    ws = [_card_weight4(K, N, cuda, seed=i) for i, (K, N) in enumerate(
        [(4096, 14336), (14336, 4096), (4096, 1024), (1024, 4096)])]
    x = torch.randn(M, 4096, device=cuda).to(torch.bfloat16)

    def chain():
        y = x
        for q, s in ws:
            y = tk.w4a16_matmul(y * 0.05, q, s)
        return y

    eager = chain()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = chain()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert torch.isfinite(eager.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split", "big", "prefill", "head", "moe"])
def test_cuda_int4_graph_replay_equals_eager(cuda, case):
    """The int4 twins in a CUDA graph give the eager call's bits, and so
    does every repeated call."""
    g = torch.Generator(device=cuda).manual_seed(11)
    if case == "head":
        q, s = _card_weight4(4096, 32000, cuda)
        x = torch.randn(4, 4096, generator=g, device=cuda)

        def fn():
            return tk.head_matmul(x, q, s)
    elif case == "moe":
        q, s = _card_weight4(4096, 1024, cuda, E=8)
        x = _moe_x(4, 8, 4096, True, torch.bfloat16, cuda, seed=13)

        def fn():
            return tk.moe_w4_matmul(x, q, s)
    else:
        M = {"split": 4, "big": 192, "prefill": 2048}[case]
        q, s = _card_weight4(4096, 1024 if M < 2048 else 4096, cuda)
        x = torch.randn(M, 4096, generator=g, device=cuda).to(torch.bfloat16)

        def fn():
            return tk.w4a16_matmul(x, q, s)
    eager = fn()
    for _ in range(3):
        assert torch.equal(fn(), eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_int4_wrappers_raise_on_what_they_do_not_take(cuda):
    """f32 activations (no int4 recipe serves them), an int8 weight given
    to an int4 wrapper and a packed one given to an int8 wrapper raise."""
    q, s = _card_weight4(64, 128, cuda)
    q8, _ = _card_weight(64, 128, cuda)
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(TypeError, match="activations"):
        tk.w4a16_matmul(x, q, s)
    with pytest.raises(ValueError, match="packed int4"):
        tk.w4a16_matmul(x.to(torch.bfloat16), q8, s)
    with pytest.raises(ValueError, match="contiguous int8"):
        tk.w8a16_matmul(x.to(torch.bfloat16), q, s)
    qe, se = _card_weight4(64, 128, cuda, E=2)
    with pytest.raises(TypeError, match="bf16"):
        tk.moe_w4_matmul(x.to(torch.float16), qe, se)
    with pytest.raises(ValueError, match="packed int4"):
        tk.moe_w4_matmul(x.to(torch.bfloat16), qe.view(torch.int8), se)
