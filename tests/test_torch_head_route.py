"""The bf16 head's tensor-core route and the int4 expert GEMM's decode
route in the port (localai_tpu_torch.ops.kernels.weight_gemm): their
arithmetic and their plans, on the CPU.

- split_bf16_terms_plain: x32 = hi + mid + lo in bf16, exactly (checked
  in f64) wherever x's bits lie at or above 2^-133, and defined for
  signed zeros and non-finite values;
- on inputs whose lo terms carry every logit, the route's order gives
  the exact logits and a route without the lo term misses each by more
  than the card's head tolerance;
- the route's arithmetic — the head times each term, summed in f32 —
  against the reference's _lm_head (localai_tpu.models.llama) on the same
  numpy inputs: f32 sums of the same exact products in another order,
  atol 2e-5 at K = 256 (F32 as in tests/test_torch_weight_gemm.py); in
  f64 the three terms' products sum to x's to f64 rounding (1e-12);
- head_plan: the route at each M and head layout, f16 heads on the SIMT
  route at every M;
- the int4 decode conversion (csrc w4_value, w4_pair_scaled) emulated in
  int32 views: bit for bit the reference's dequantize,
  (q.float() * s).to(bf16), over every nibble and 10^5 scales;
- moe4_plan: every (expert, column tile, K tile) unit in exactly one
  block, no block empty, each tile's parts and the counters and workspace
  within what the wrapper allocates.

Tests that need the card are in tests/test_torch_weight_gemm.py (marker
`cuda`)."""
import math

import numpy as np
import pytest
import torch

from localai_tpu_torch.ops.kernels import weight_gemm as wg
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)


def _special_values():
    """Normal, huge, tiny, subnormal-edge, signed-zero and extreme finite
    values of f32."""
    r = np.random.default_rng(0)
    normal = r.standard_normal(4096).astype(np.float32)
    huge = (r.standard_normal(512) * 1e30).astype(np.float32)
    tiny = (r.standard_normal(512) * 1e-30).astype(np.float32)
    edge = np.array([2.0 ** -110, -(2.0 ** -110) * 1.9999, 2.0 ** -126,
                     np.finfo(np.float32).max, -np.finfo(np.float32).max,
                     np.finfo(np.float32).tiny, 1.0, -1.0,
                     1 + 2.0 ** -23, 3.0e38, -3.39e38, 0.0, -0.0],
                    np.float32)
    bits = r.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    anyf = bits.view(np.float32)
    anyf = anyf[np.isfinite(anyf) & (np.abs(anyf) >= 2.0 ** -110)]
    return np.concatenate([normal, huge, tiny, edge, anyf])


def _sum64(terms):
    return terms.double().sum(0)


def test_split_terms_sum_to_x_exactly():
    x = torch.tensor(_special_values())
    t = wg.split_bf16_terms_plain(x)
    assert t.dtype == torch.bfloat16 and t.shape == (3,) + x.shape
    assert torch.equal(_sum64(t), x.double())
    # hi is x's top 16 bits, so a zero keeps its sign
    zeros = x == 0
    assert torch.equal(torch.signbit(t[0][zeros]), torch.signbit(x[zeros]))


def test_split_terms_below_bf16s_least_subnormal():
    """Bits below 2^-133 have no bf16: x's sum of terms drops them (an
    error under 2^-133), and a multiple of 2^-133 stays exact."""
    r = np.random.default_rng(1)
    x = (r.integers(-2 ** 23, 2 ** 23, 2048).astype(np.float64)
         * 2.0 ** -149).astype(np.float32)
    t = wg.split_bf16_terms_plain(torch.tensor(x))
    err = (_sum64(t) - torch.tensor(x).double()).abs()
    assert float(err.max()) < 2.0 ** -133
    on_grid = torch.tensor((x.astype(np.float64) / 2.0 ** -133) % 1 == 0)
    assert torch.equal(err[on_grid], torch.zeros_like(err[on_grid]))


def test_split_terms_of_non_finite_values():
    x = torch.tensor([math.inf, -math.inf, math.nan, -math.nan],
                     dtype=torch.float32)
    x = torch.cat([x, torch.tensor(np.array([0x7f800001, 0xffc01234],
                                            np.uint32).view(np.float32))])
    t = wg.split_bf16_terms_plain(x)
    bits = t.view(torch.int16).to(torch.int32) & 0xffff
    assert bits[0].tolist() == [0x7f80, 0xff80, 0x7fc0, 0x7fc0, 0x7fc0,
                                0x7fc0]
    assert not bits[1:].any()
    assert torch.equal(_sum64(t)[:2], x[:2].double())
    assert torch.isnan(_sum64(t)[2:]).all()


@pytest.mark.parametrize("kind", ["bf16", "tied"])
def test_terms_times_head_equal_x_times_head_in_f64(kind):
    """sum_t term_t @ w == x @ w to f64 rounding, for a bf16 [K, V] head
    and a tied embedding passed as embed.T."""
    r = np.random.default_rng(2)
    K, V = 256, 96
    x = torch.tensor(r.standard_normal((5, K)).astype(np.float32))
    e = torch.tensor(r.standard_normal((V, K)).astype(np.float32)
                     * K ** -0.5).to(torch.bfloat16)
    w = e.T if kind == "tied" else e.T.contiguous()
    t = wg.split_bf16_terms_plain(x)
    got = sum(t[i].double() @ w.double() for i in range(3))
    want = x.double() @ w.double()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("M", [1, 17, 40])
@pytest.mark.parametrize("kind", ["bf16", "tied"])
def test_terms_route_arithmetic_vs_reference_lm_head(kind, M):
    """The tensor-core route's arithmetic — the bf16 head times each term,
    f32 sums — against the reference's _lm_head on the same inputs."""
    import jax.numpy as jnp

    from localai_tpu.models import llama as jllama

    r = np.random.default_rng(M)
    K, V = 256, 200
    x = r.standard_normal((M, K)).astype(np.float32)
    h = (r.standard_normal((V, K)) * K ** -0.5).astype(np.float32)
    hb = jnp.asarray(h, jnp.bfloat16)
    if kind == "tied":
        params = {"embed": hb}
    else:
        params = {"embed": jnp.asarray(h), "lm_head": hb.T}
    ref = np.asarray(jllama._lm_head(jnp.asarray(x), params))
    w = torch.tensor(np.asarray(hb, np.float32)).to(torch.bfloat16).T
    if kind == "bf16":
        w = w.contiguous()
    t = wg.split_bf16_terms_plain(torch.tensor(x))
    out = sum(t[i].float() @ w.float() for i in range(3))
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def _lo_term_case(M, K, V, kind, device="cpu", seed=0):
    """Inputs on which x's lo terms carry every logit (as chip_smoke.py's
    head_lo_term_case builds them): along K, x alternates 1 + 2^-8 +
    2^-16 (terms 1, 2^-8, 2^-16) and 1 + 2^-8 (lo 0), row m scaled by
    2^(m % 4); column v of the head is +s_v, -s_v, ... with random signs
    s_v. hi and mid cancel pair by pair, and logit (m, v) is s_v * 2^(m %
    4) * (K / 2) * 2^-16. Returns x32 [M, K], the head as head_matmul
    takes it ([K, V] bf16, or embed.T of a tied [V, K]) and the exact
    logits f64 [M, V], on `device`."""
    sign = np.random.default_rng(seed).integers(0, 2, V) * 2 - 1
    k = np.arange(K)
    x = np.where(k % 2 == 0, 1 + 2.0 ** -8 + 2.0 ** -16, 1 + 2.0 ** -8)
    scale = 2.0 ** (np.arange(M) % 4)
    x32 = torch.tensor((scale[:, None] * x).astype(np.float32))
    e = torch.tensor((sign[:, None] * (1 - 2 * (k % 2))).astype(
        np.float32)).to(torch.bfloat16)
    w = e.T if kind == "tied" else e.T.contiguous()
    exact = torch.tensor(scale[:, None] * (K // 2) * 2.0 ** -16
                         * sign[None, :])
    return x32.to(device), w.to(device), exact.to(device)


@pytest.mark.parametrize("kind", ["bf16", "tied"])
def test_lo_term_case_rests_on_the_lo_terms(kind):
    """On _lo_term_case's inputs the hi and mid terms' products cancel, so
    the lo terms carry every logit: summed in the tensor-core route's
    order (each term's products over 64 K rows in f32, those runs' sums
    added in f32) the terms give the exact logits bit for bit, while a
    route without the lo term (all logits 0) or on x rounded to bf16
    misses each logit by more than the card tests' head tolerance, 1e-4."""
    M, K, V = 8, 4096, 64
    x, w, exact = _lo_term_case(M, K, V, kind)
    t = wg.split_bf16_terms_plain(x)
    assert not ((t[0].double() + t[1].double()) @ w.double()).any()
    wf = w.float()
    out = torch.zeros(M, V)
    for k0 in range(0, K, wg.HEAD_BK):
        run = torch.zeros(M, V)
        for i in range(3):
            run += t[i, :, k0:k0 + wg.HEAD_BK].float() \
                @ wf[k0:k0 + wg.HEAD_BK]
        out += run
    assert torch.equal(out.double(), exact)
    assert float(exact.abs().min()) > 1e-4
    bad = x.to(torch.bfloat16).double() @ w.double()
    assert float((bad - exact).abs().min()) > 1e-4


@pytest.mark.parametrize("M,route,bn", [
    (1, "simt", None), (4, "simt", None), (8, "simt", None),
    (9, "wgmma", 64), (16, "wgmma", 64), (17, "wgmma", 64),
    (40, "wgmma", 64),
    (64, "wgmma", 64), (65, "wgmma", 128), (128, "wgmma", 128),
    (192, "wgmma", 64), (256, "wgmma", 128), (2048, "wgmma", 128),
    (8192, "wgmma", 128)])
def test_head_plan_routes_by_rows(M, route, bn):
    """A bf16 head: the SIMT route up to HEAD_SIMT_ROWS rows, the tensor
    cores above, head_bn(M) rows a block (the tile that pads M least, the
    larger on a tie); the split as gemm_split puts it (none at V =
    128256: a thousand column tiles fill the card)."""
    for V in (128256, 32000):
        name, tile, splits, per = wg.head_plan(M, V, 4096, 132,
                                               torch.bfloat16)
        assert name == route
        assert (name == "wgmma") == (M > wg.HEAD_SIMT_ROWS)
        per_sm = wg.PER_SM[name]
        assert (splits, per) == wg.gemm_split(M, V, 4096, tile, 132, per_sm)
        if name == "wgmma":
            assert tile == (bn, wg.HEAD_BN, wg.HEAD_BK)
            pad = -(-M // tile[0]) * tile[0]
            assert all(pad <= -(-M // r) * r for r in wg.HEAD_ROWS)
        else:
            assert tile == wg.SIMT
        if V == 128256:
            assert splits == 1


@pytest.mark.parametrize("M", [1, 9, 17, 40, 8192])
def test_head_plan_keeps_f16_on_simt(M):
    assert wg.head_plan(M, 128256, 4096, 132, torch.float16)[0] == "simt"


def test_head_plan_split_counters_fit():
    """Where the tensor-core route splits (a small vocabulary), its blocks
    fit the card's counters, one a (row tile, column tile)."""
    sms = 132
    for M in (17, 40, 192):
        for V in (400, 2048, 4096):
            _, tile, splits, per = wg.head_plan(M, V, 4096, sms)
            blocks = -(-M // tile[0]) * -(-V // tile[1])
            if splits > 1:
                assert blocks <= wg.counters_size(sms)
            assert (splits - 1) * per < -(-4096 // tile[2]) <= splits * per


def _w4_pair_emulated(nib, s):
    """csrc w4_value + w4_pair_scaled's steps on one nibble position, in
    int32 views: the nibble xor 8 in the mantissa of 2^(23-P), minus
    2^(23-P) + 8 (f32, exact), times s (f32), rounded once to bf16."""
    out = {}
    for P in (0, 4, 8, 12):
        u = nib.to(torch.int32) << P
        magic = ((127 + 23 - P) << 23) | (8 << P)
        f = ((u & (0xF << P)) ^ magic).view(torch.float32)
        q = f - float((1 << (23 - P)) + 8)
        out[P] = (q * s).to(torch.bfloat16)
    return out


def test_w4_conversion_bit_for_bit_with_reference_dequantize():
    """Every nibble at every position the kernel reads (bits 0, 4, 8, 12
    of a word) against (q.float() * s).to(bf16), over 10^5 f32 scales:
    random bit patterns, subnormal ones and the subnormal edge, and large
    ones whose products overflow to inf."""
    r = np.random.default_rng(5)
    bits = r.integers(0, 2 ** 31, 80000, dtype=np.int64).astype(np.uint32)
    scales = bits.view(np.float32)
    scales = scales[np.isfinite(scales)]
    sub = (r.integers(1, 2 ** 23, 10000) * 2.0 ** -149).astype(np.float32)
    edge = (2.0 ** -126 * (1 + r.standard_normal(5000) * 1e-3)).astype(
        np.float32)
    large = (r.uniform(1, 3.4, 5000) * 1e38).astype(np.float32)
    common = (r.uniform(1e-5, 1e-1, 5000)).astype(np.float32)
    s = torch.tensor(np.concatenate([scales, sub, np.abs(edge), large,
                                     common]))
    assert s.numel() >= 10 ** 5
    nib = torch.arange(16, dtype=torch.int32)
    q = torch.where(nib >= 8, nib - 16, nib).to(torch.int8)
    want = (q.float()[:, None] * s[None, :]).to(torch.bfloat16)
    for P, got in _w4_pair_emulated(nib[:, None].expand(16, s.numel()),
                                    s[None, :]).items():
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), P


def _ranges(U, G):
    return [(b * U // G, (b + 1) * U // G) for b in range(G)]


@pytest.mark.parametrize("M,E,K,N", [
    (4, 8, 4096, 14336), (4, 8, 14336, 4096), (1, 8, 4096, 14336),
    (16, 8, 14336, 4096), (4, 4, 272, 400), (9, 2, 64, 128),
    (4, 8, 4096, 1024)])
def test_moe4_plan_covers_every_unit_once(M, E, K, N):
    """The grid: block b of G takes units [b*U/G, (b+1)*U/G) (csrc
    moe_w4_stream_kernel's rule), so every unit is one block's; no block
    is empty; a tile's parts are the blocks its units fall in, the first
    and last tile of each block get its two workspace slots, and the
    counters (one a tile) and the workspace (2 x M x 128 f32 a block) fit
    what the wrapper allocates."""
    sms = 132
    G, U, tiles = wg.moe4_plan(M, N, K, E, sms)
    KT = -(-K // wg.MOE4_BK)
    assert U == tiles * KT and tiles == E * -(-N // 128)
    assert 1 <= G <= U
    assert G == min(U, max(tiles, (wg.MOE4_PER_SM - (M > 8)) * sms))
    seen = np.zeros(U, np.int32)
    parts = {}   # cut tile -> [(block, workspace slot)]
    for b, (u0, u1) in enumerate(_ranges(U, G)):
        assert u1 > u0
        seen[u0:u1] += 1
        tf, tl = u0 // KT, (u1 - 1) // KT
        cut = [t for t in range(tf, tl + 1)
               if not (u0 <= t * KT and u1 >= (t + 1) * KT)]
        assert set(cut) <= {tf, tl}
        for t in cut:
            parts.setdefault(t, []).append((b, 0 if t == tf else 1))
    assert (seen == 1).all()
    # the kernel's block_of(u) = ((u + 1) G - 1) / U: the parts of a cut
    # tile are the blocks from block_of(its first unit) to block_of(its
    # last), in order, and a part's slot is 0 for its block's first tile
    for t, ps in parts.items():
        bf = ((t * KT + 1) * G - 1) // U
        bl = (((t + 1) * KT) * G - 1) // U
        assert [b for b, _ in ps] == list(range(bf, bl + 1))
        assert all(slot == (0 if t == (b * U // G) // KT else 1)
                   for b, slot in ps)
    assert tiles <= wg.counters_size(sms)
    assert G * 2 * M * 128 * 4 <= 64 << 20
