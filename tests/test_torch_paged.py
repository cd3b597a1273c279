"""The PyTorch port's paged KV slice (localai_tpu_torch.ops.paged, the paged
modes of ops/kernels/flash_attention.py, ops/kernels/paged_scatter.py, and
the model's `table=` threading) against the JAX package, on inputs made by
numpy from a seed.

Tolerances:
- ops/paged.py index arithmetic and gathers, and the scatter-append plain
  versions against the Pallas kernels (interpret mode): EXACT;
- paged decode plain versions against the Pallas kernels with `table=`:
  2e-5 in f32 (same math, sums in another order);
- the model with a table: 1e-4 on f32 logits, 6e-2 with int8 weights (the
  bars of tests/test_torch_model.py, for the same reasons; the int8-KV
  reference runs with LOCALAI_FORCE_PALLAS=1 so its paged decode and write
  are the Pallas kernels whose f32 math the port shares).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.models import llama as jllama
from localai_tpu.ops import paged as jpaged
from localai_tpu.ops.kvcache import QuantKV as JQuantKV
from localai_tpu.ops.rope import rope_table as jrope_table
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops import paged as tpaged
from localai_tpu_torch.ops.kvcache import QuantKV as TQuantKV
from localai_tpu_torch.ops.kvcache import quantize_tokens
from localai_tpu_torch.ops.rope import rope_table as trope_table
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
BLOCK = tpaged.BLOCK


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


# ------------------------------------------------------------ ops/paged.py

def test_blocks_needed_and_init_paged():
    for n in (0, 1, 127, 128, 129, 4096):
        assert tpaged.blocks_needed(n) == jpaged.blocks_needed(n)
    tk_, tv = tpaged.init_paged(2, 5, 3, 16, dtype=torch.float32)
    jk, _ = jpaged.init_paged(2, 5, 3, 16, dtype=jnp.float32)
    assert tuple(tk_.shape) == jk.shape and tv.shape == tk_.shape
    tq, _ = tpaged.init_paged(2, 5, 3, 16, cache_type="int8")
    jq, _ = jpaged.init_paged(2, 5, 3, 16, cache_type="int8")
    assert isinstance(tq, TQuantKV) and isinstance(jq, JQuantKV)
    assert tuple(tq.q.shape) == jq.q.shape
    assert tuple(tq.s.shape) == jq.s.shape == (2, 5, 3, 1, 128)
    assert tq.q.dtype == torch.int8 and tq.s.dtype == torch.float32


def _pool_and_table(seed, NB=10, KVH=2, D=16, B=3, MAXB=3):
    r = np.random.default_rng(seed)
    pool = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    perm = r.permutation(np.arange(1, NB))[:B * MAXB].reshape(B, MAXB)
    table = perm.astype(np.int32)
    table[2, 1:] = 0                     # a slot with one block allocated
    return pool, table


@pytest.mark.parametrize("quant", [False, True])
def test_paged_view_equals_reference(quant):
    pool, table = _pool_and_table(0)
    if quant:
        q, s = quantize_tokens(torch.tensor(pool))
        tcache = TQuantKV(q, s.reshape(*s.shape[:-1], 1, 128))
        jcache = JQuantKV(jnp.asarray(tcache.q.numpy()),
                          jnp.asarray(tcache.s.numpy()))
    else:
        tcache, jcache = torch.tensor(pool), jnp.asarray(pool)
    got = tpaged.paged_view(tcache, torch.tensor(table))
    ref = jpaged.paged_view(jcache, jnp.asarray(table))
    if quant:
        np.testing.assert_array_equal(_np(got.q), np.asarray(ref.q))
        np.testing.assert_array_equal(_np(got.s), np.asarray(ref.s))
        assert tuple(got.s.shape) == (3, 2, 3, 128)
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
        assert tuple(got.shape) == (3, 2, 3 * 128, 16)


# full-policy sentinel (sb >= width), a ring that has wrapped, one that has
# not, and a slot with no sinks
RING = [dict(sb=[8, 1, 2, 0], rw=[1, 3, 2, 4], length=[900, 1000, 300, 77])]


@pytest.mark.parametrize("case", RING)
def test_ring_arithmetic_equals_reference(case):
    maxb = 6
    sb, rw, length = (np.asarray(case[k], np.int32)
                      for k in ("sb", "rw", "length"))
    raw = np.arange(10, dtype=np.int32)[None, :].repeat(4, 0)
    got = tpaged.ring_block_map(torch.tensor(raw), torch.tensor(sb)[:, None],
                                torch.tensor(rw)[:, None])
    ref = jpaged.ring_block_map(jnp.asarray(raw), jnp.asarray(sb)[:, None],
                                jnp.asarray(rw)[:, None])
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    args_t = (torch.tensor(sb), torch.tensor(rw), torch.tensor(length))
    args_j = (jnp.asarray(sb), jnp.asarray(rw), jnp.asarray(length))
    for fn in ("resident_block_positions", "resident_row_positions"):
        g = getattr(tpaged, fn)(maxb, *args_t)
        r = getattr(jpaged, fn)(maxb, *args_j)
        for a, b in zip(g, r):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=fn)


# ---------------------------------------------- paged decode (kernels 3, 5)

def _pallas():
    from localai_tpu.ops.pallas import flash_attention as pfa

    return pfa


def _split_edges(B, KVH, MAXB):
    """Lengths at the edges split-KV decode creates over a MAXB-block
    table: 1, a block, a block + 1, a span and a span + 1 (decode_split on
    a 132-SM H100) and the full table."""
    _, split = tk.decode_split(MAXB * BLOCK, B * KVH, 132)
    assert split % BLOCK and split + 1 < MAXB * BLOCK
    return [1, BLOCK, BLOCK + 1, split, split + 1, MAXB * BLOCK]


def _alloc_table(seed, lens, NB, MAXB):
    """A shuffled, non-contiguous table: slot b's ceil(len/128) blocks are
    drawn from a permutation of blocks 1..NB-1, and its entries past that
    allocation are 0 (the trash block)."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, NB))
    table = np.zeros((len(lens), MAXB), np.int32)
    used = 0
    for b, n in enumerate(lens):
        k = tpaged.blocks_needed(n)
        table[b, :k] = perm[used:used + k]
        used += k
    return table


def _decode_case(seed, edges):
    """(pool_k, pool_v, table, lens, q) of a paged decode test: three slots
    over a table of 3 blocks, or (`edges`) six slots at _split_edges over a
    table of 3 blocks that _alloc_table fills."""
    if not edges:
        pool_k, table = _pool_and_table(seed)
        pool_v, _ = _pool_and_table(seed + 1)
        lens = None
    else:
        lens = _split_edges(6, 2, 3)
        r = np.random.default_rng(seed)
        NB = sum(tpaged.blocks_needed(n) for n in lens) + 1
        pool_k, pool_v = (r.standard_normal((NB, 2, BLOCK, 16)).astype(
            np.float32) for _ in range(2))
        table = _alloc_table(seed, lens, NB, 3)
    q = np.random.default_rng(seed + 2).standard_normal(
        (table.shape[0], 1, 8, 16)).astype(np.float32)
    return pool_k, pool_v, table, lens, q


# the ids of the first two cases name the window, as before the edge cases;
# the window of 150 starts inside a block (and a span) on the longer rows
@pytest.mark.parametrize("window,edges", [
    pytest.param(None, False, id="None"), pytest.param(100, False, id="100"),
    pytest.param(None, True, id="split-edges"),
    pytest.param(150, True, id="split-edges-window150")])
def test_paged_decode_plain_vs_pallas(window, edges):
    pfa = _pallas()
    pool_k, pool_v, table, lens, q = _decode_case(1, edges)
    lens = lens or [300, 129, 5]
    ref = pfa.ragged_decode(jnp.asarray(q), jnp.asarray(pool_k),
                            jnp.asarray(pool_v), jnp.asarray(lens, jnp.int32),
                            sliding_window=window,
                            table=jnp.asarray(table))
    args = (torch.tensor(q), torch.tensor(pool_k), torch.tensor(pool_v),
            torch.tensor(lens))
    out = tk.ragged_decode_plain(*args, sliding_window=window,
                                 table=torch.tensor(table))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)
    # the wrapper on CPU tensors is the plain version, counting nothing
    tk.reset_launch_counts()
    same = tk.ragged_decode(*args, sliding_window=window,
                            table=torch.tensor(table))
    torch.testing.assert_close(same, out, rtol=0, atol=0)
    assert not any(tk.launch_counts().values())


def _q8_pool(pool):
    q, s = quantize_tokens(torch.tensor(pool))            # s: [NB, KVH, 128]
    return q, s.reshape(s.shape[0], s.shape[1], 1, 128)


@pytest.mark.parametrize("window,edges", [
    pytest.param(None, False, id="None"), pytest.param(60, False, id="60"),
    pytest.param(None, True, id="split-edges"),
    pytest.param(150, True, id="split-edges-window150")])
def test_paged_decode_q8_plain_vs_pallas(window, edges):
    pfa = _pallas()
    pool_k, pool_v, table, lens, q = _decode_case(4, edges)
    kq, ks = _q8_pool(pool_k)
    vq, vs = _q8_pool(pool_v)
    lens = lens or [384, 200, 128]
    ref = pfa.ragged_decode_q8(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()),
        jnp.asarray(lens, jnp.int32), sliding_window=window,
        table=jnp.asarray(table))
    args = (torch.tensor(q), kq, ks, vq, vs, torch.tensor(lens))
    out = tk.ragged_decode_q8_plain(*args, sliding_window=window,
                                    table=torch.tensor(table))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)
    same = tk.ragged_decode_q8(*args, sliding_window=window,
                               table=torch.tensor(table))
    torch.testing.assert_close(same, out, rtol=0, atol=0)


# ------------------------------------------ scatter-append (kernels 6, 7)

SCATTER = [
    dict(active=None, sb=None),
    dict(active=[True, False, True, False], sb=None),
    # ring geometry: slot 0 full-policy sentinel, the others wrapped rings
    dict(active=[True, True, False, True], sb=([4, 1, 1, 0], [1, 2, 2, 3])),
]


def _scatter_inputs(seed, B=4, NB=10, KVH=2, D=16, MAXB=4):
    r = np.random.default_rng(seed)
    pool_k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    pool_v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    k_new = r.standard_normal((B, KVH, D)).astype(np.float32)
    v_new = r.standard_normal((B, KVH, D)).astype(np.float32)
    table = r.permutation(np.arange(1, NB))[:B * 2].reshape(B, 2)
    table = np.concatenate([table, np.zeros((B, MAXB - 2), int)], 1)
    positions = np.array([0, 127, 200, 255], np.int32)
    return pool_k, pool_v, k_new, v_new, positions, table.astype(np.int32)


def _case_args(case, lib):
    act = None if case["active"] is None else lib.asarray(case["active"])
    sb = rw = None
    if case["sb"] is not None:
        sb = lib.asarray(np.asarray(case["sb"][0], np.int32))
        rw = lib.asarray(np.asarray(case["sb"][1], np.int32))
    return act, sb, rw


class _T:
    asarray = staticmethod(torch.tensor)


@pytest.mark.parametrize("case", SCATTER, ids=["all", "inactive", "ring"])
def test_paged_scatter_append_plain_vs_pallas(case):
    from localai_tpu.ops.pallas import paged_scatter as pps

    pk, pv, kn, vn, pos, table = _scatter_inputs(7)
    ja, jsb, jrw = _case_args(case, jnp)
    rk, rv = pps.paged_scatter_append(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos), jnp.asarray(table), ja, sb=jsb, rw=jrw)
    ta, tsb, trw = _case_args(case, _T)
    tpk, tpv = torch.tensor(pk), torch.tensor(pv)
    out = tk.paged_scatter_append(tpk, tpv, torch.tensor(kn),
                                  torch.tensor(vn), torch.tensor(pos),
                                  torch.tensor(table), ta, sb=tsb, rw=trw)
    assert out[0] is tpk and out[1] is tpv            # in place
    np.testing.assert_array_equal(_np(tpk), np.asarray(rk))
    np.testing.assert_array_equal(_np(tpv), np.asarray(rv))
    # precomputed targets (what decode_step hands every layer) write the
    # same bytes
    tpk2, tpv2 = torch.tensor(pk), torch.tensor(pv)
    targets = tk.paged_targets(torch.tensor(pos), torch.tensor(table), ta,
                               sb=tsb, rw=trw)
    tk.paged_scatter_append(tpk2, tpv2, torch.tensor(kn), torch.tensor(vn),
                            None, None, targets=targets)
    assert torch.equal(tpk2, tpk) and torch.equal(tpv2, tpv)


@pytest.mark.parametrize("case", SCATTER, ids=["all", "inactive", "ring"])
def test_paged_scatter_append_q8_plain_vs_pallas(case):
    from localai_tpu.ops.pallas import paged_scatter as pps

    pk, pv, kn, vn, pos, table = _scatter_inputs(8)
    kq, ks = _q8_pool(pk)
    vq, vs = _q8_pool(pv)
    ja, jsb, jrw = _case_args(case, jnp)
    ref = pps.paged_scatter_append_q8(
        *(jnp.asarray(t.numpy()) for t in (kq, ks, vq, vs)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
        jnp.asarray(table), ja, sb=jsb, rw=jrw)
    ta, tsb, trw = _case_args(case, _T)
    out = tk.paged_scatter_append_q8(kq, ks, vq, vs, torch.tensor(kn),
                                     torch.tensor(vn), torch.tensor(pos),
                                     torch.tensor(table), ta, sb=tsb, rw=trw)
    assert out[0] is kq and out[1] is ks
    for got, want in zip((kq, ks, vq, vs), ref):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_paged_targets_inactive_rows_go_to_trash():
    table = torch.tensor([[3, 4], [5, 6], [7, 8]], dtype=torch.int32)
    pb, off = tk.paged_targets(torch.tensor([130, 5, 255]), table,
                               torch.tensor([True, False, False]))
    assert pb.tolist() == [4, 0, 0] and off.tolist() == [2, 1, 2]


# ------------------------------------------------------- the model, paged

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


def _models(ckpt, dtype):
    jcfg = jloader.load_config(ckpt, dtype=dtype)
    jp = jloader.load_params(ckpt, jcfg, dtype=dtype)
    tcfg = tloader.load_config(ckpt, dtype=dtype)
    tp = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, jp, tcfg, tp


def _pools_equalish(jc, tc, tol):
    if isinstance(jc, JQuantKV):
        jd = np.asarray(jc.q, np.float32) * np.asarray(jc.s).reshape(
            *jc.s.shape[:-2], -1)[..., None]
        td = tc.q.float().numpy() * tc.s.reshape(
            *tc.s.shape[:-2], -1)[..., None].numpy()
        np.testing.assert_allclose(td, jd, rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(_np(tc), np.asarray(jc, np.float32),
                                   rtol=tol, atol=tol)


T = 256            # max_context → MAXB = 2
NB = 7
CASES = [("float32", "", 1e-4), ("int8", "", 6e-2), ("int8", "int8", 6e-2)]


@pytest.mark.parametrize("dtype,cache_type,tol", CASES,
                         ids=["f32", "int8w", "int8w_int8kv"])
def test_paged_prefill_decode_extend_logits(ckpt, monkeypatch, dtype,
                                            cache_type, tol):
    if dtype == "int8":
        monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    jcfg, jp, tcfg, tp = _models(ckpt, dtype)
    B = 2
    rng = np.random.default_rng(0)
    toks = rng.integers(2, jcfg.vocab_size, (B, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    slots = np.array([1, 0], np.int32)
    # shuffled, non-contiguous: slot 0 holds two blocks, slot 1 one (its
    # second entry is the trash block 0)
    table = np.array([[5, 2], [3, 0]], np.int32)
    jt, tt = jnp.asarray(table), torch.tensor(table)
    jcos, jsin = jrope_table(jcfg.rope, T)
    tcos, tsin = trope_table(tcfg.rope, T)
    jkc, jvc = jpaged.init_paged(jcfg.num_layers, NB, jcfg.num_kv_heads,
                                 jcfg.head_dim, jcfg.jdtype,
                                 cache_type=cache_type)
    tkc, tvc = tpaged.init_paged(tcfg.num_layers, NB, tcfg.num_kv_heads,
                                 tcfg.head_dim, tcfg.tdtype,
                                 cache_type=cache_type)

    jl, jkc, jvc = jllama.prefill(jp, jcfg, jnp.asarray(toks),
                                  jnp.asarray(lens), jcos, jsin, jkc, jvc,
                                  jnp.asarray(slots), table=jt)
    tl = tllama.prefill(tp, tcfg, torch.tensor(toks), torch.tensor(lens),
                        tcos, tsin, tkc, tvc, torch.tensor(slots), table=tt)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=tol, atol=tol)
    _pools_equalish(jkc, tkc, tol)

    # decode: slot 1 holds row 0's prompt (16), slot 0 row 1's (9); slot 0
    # inactive → its write goes to the trash block, not through its table
    nxt = np.array([5, 7], np.int32)
    lengths = np.array([9, 16], np.int32)
    active = np.array([False, True])
    jd, jkc, jvc = jllama.decode_step(jp, jcfg, jnp.asarray(nxt),
                                      jnp.asarray(lengths), jcos, jsin, jkc,
                                      jvc, jnp.asarray(active), table=jt)
    td = tllama.decode_step(tp, tcfg, torch.tensor(nxt),
                            torch.tensor(lengths), tcos, tsin, tkc, tvc,
                            torch.tensor(active), table=tt)
    np.testing.assert_allclose(_np(td)[1], np.asarray(jd)[1], rtol=tol,
                               atol=tol)
    _pools_equalish(jkc, tkc, tol)

    # extend: a 4-token window for slot 0 at offset 9 (chunked prefill)
    win = rng.integers(2, jcfg.vocab_size, (1, 4)).astype(np.int32)
    jx, jkc, jvc = jllama.extend(jp, jcfg, jnp.asarray(win),
                                 jnp.asarray([9]), jcos, jsin, jkc, jvc,
                                 slot_map=jnp.asarray([0]), table=jt)
    tx = tllama.extend(tp, tcfg, torch.tensor(win), torch.tensor([9]), tcos,
                       tsin, tkc, tvc, slot_map=torch.tensor([0]), table=tt)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=tol, atol=tol)
    _pools_equalish(jkc, tkc, tol)

    # a final chunk across the end of the context: slot 1, 16 positions
    # from 250 — 256.. are past the table (MAXB*128 = 256); with slot 1's
    # last column on the trash block, both sides write them there
    tail = rng.integers(2, jcfg.vocab_size, (1, 16)).astype(np.int32)
    jx, jkc, jvc = jllama.extend(jp, jcfg, jnp.asarray(tail),
                                 jnp.asarray([250]), jcos, jsin, jkc, jvc,
                                 slot_map=jnp.asarray([1]),
                                 last_pos=jnp.asarray([5]), table=jt)
    tx = tllama.extend(tp, tcfg, torch.tensor(tail), torch.tensor([250]),
                       tcos, tsin, tkc, tvc, slot_map=torch.tensor([1]),
                       last_pos=torch.tensor([5]), table=tt)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=tol, atol=tol)
    _pools_equalish(jkc, tkc, tol)


def test_paged_decode_matches_dense_decode(ckpt):
    """The same two slots through a dense cache and through a shuffled
    block table give the same logits (f32): the table is pure indirection."""
    _, _, tcfg, tp = _models(ckpt, "float32")
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(2, tcfg.vocab_size, (2, 32)),
                        dtype=torch.int32)
    lens = torch.tensor([32, 20])
    slots = torch.tensor([0, 1])
    cos, sin = trope_table(tcfg.rope, T)
    dk, dv = tllama.init_kv_cache(tcfg, 2, T)
    pk, pv = tpaged.init_paged(tcfg.num_layers, NB, tcfg.num_kv_heads,
                               tcfg.head_dim, torch.float32)
    table = torch.tensor([[4, 1], [6, 2]], dtype=torch.int32)
    a = tllama.prefill(tp, tcfg, toks, lens, cos, sin, dk, dv, slots)
    b = tllama.prefill(tp, tcfg, toks, lens, cos, sin, pk, pv, slots,
                       table=table)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    nxt, ln = torch.tensor([3, 9]), lens.clone()
    for _ in range(3):
        a = tllama.decode_step(tp, tcfg, nxt, ln, cos, sin, dk, dv)
        b = tllama.decode_step(tp, tcfg, nxt, ln, cos, sin, pk, pv,
                               table=table)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        nxt, ln = a.argmax(-1), ln + 1


def test_tail_past_table_end_goes_to_trash(ckpt):
    """A final prefill chunk running past MAXB*128 on a slot whose table is
    full: the port writes the overflow rows to the trash block and leaves
    the slot's valid rows alone. (The reference's gather clamps the
    overflow to the last table column, so its write lands on valid rows of
    that block — shown here on its _cache_write.)"""
    _, _, tcfg, tp = _models(ckpt, "float32")
    cos, sin = trope_table(tcfg.rope, T)
    pk, pv = tpaged.init_paged(tcfg.num_layers, NB, tcfg.num_kv_heads,
                               tcfg.head_dim, torch.float32)
    table = torch.tensor([[2, 5]], dtype=torch.int32)          # full table
    rng = np.random.default_rng(2)
    ids = torch.tensor(rng.integers(2, tcfg.vocab_size, (1, 240)),
                       dtype=torch.int32)
    tllama.extend(tp, tcfg, ids, torch.tensor([0]), cos, sin, pk, pv,
                  slot_map=torch.tensor([0]), with_logits=False, table=table)
    before = pk[:, 5].clone()
    tail = torch.tensor(rng.integers(2, tcfg.vocab_size, (1, 32)),
                        dtype=torch.int32)
    # positions 240..271: rows 240..255 are real, 256..271 are past the end
    tllama.extend(tp, tcfg, tail, torch.tensor([240]), cos, sin, pk, pv,
                  slot_map=torch.tensor([0]), with_logits=False, table=table)
    # virtual rows 128..239 of the slot (block 5, rows 0..111) unchanged
    torch.testing.assert_close(pk[:, 5, :, :112], before[:, :, :112],
                               rtol=0, atol=0)
    assert pk[:, 0, :, :16].abs().sum() > 0      # the overflow is in trash

    kc = jnp.zeros((NB, 1, 128, 2))
    pos = jnp.arange(240, 272)[None, :]
    k = jnp.broadcast_to(pos[..., None, None] + 0.0, (1, 32, 1, 2))
    kc, _ = jllama._cache_write(kc, kc, k, k, jnp.asarray([0]), pos,
                                jnp.asarray(table.numpy()), unique=False)
    # the reference: rows 0..15 of block 5 (virtual 128..143) overwritten
    np.testing.assert_array_equal(np.asarray(kc[5, 0, :16, 0]),
                                  np.arange(256, 272))
