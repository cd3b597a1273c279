"""The PyTorch port's KV lifecycle tier (localai_tpu_torch.engine.kvtier, the
tiered reads of the paged decode and ragged attention wrappers, and the
Engine's sink_window rings, int8 cold pool and demotion) against the JAX
package, on the CPU.

- The policy layer: parse, resolve and the ring geometry equal
  localai_tpu.engine.kvtier's (values and error texts), over the reference's
  cases (tests/test_kvtier.py); the ring map and its read-side inverse equal
  ops/paged's.
- The plain versions with `kvt`: tiered paged decode against the
  reference's _decode_dq tier branch, and ragged attention against
  ragged_attention_xla[_q8](kvt=), on random pools over compact ring
  tables — drop, cold, full-policy sentinels, f32 and int8 hot pools.
- Models of the CUDA kernels' tier plans (the compressed tile order, dead
  tiles, the hot and cold splits, the combine) against the plain versions,
  with planted faults (a ring map off by one column, the cold scales
  dropped) that the bar rejects.
- The engine: its tier's configuration errors are the reference's; a
  demotion lands before the ring wraps over its block (where the
  reference's does not); the ring margin covers every write the port's
  loops make past the host's length. The engines' token parity with the
  JAX engines is tests/test_torch_kvtier_engine.py.

Tolerances: 2e-5 in f32 (the same arithmetic, sums in another order). The
int8 hot pool: the kernel keeps row 5's arithmetic (the K scale on the
score, the V scale on p, f32), where the reference's tier branch
dequantizes the pool to bf16 first — so the port's plain version equals
the reference run on the f32 products q*s at 2e-5, and the reference as it
is within 2e-2 (bf16 rounding of K/V, ROADMAP queue 3). Cold rows are
bf16(q * s) in both, as the reference's dequant gives them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import tiny_checkpoint
from localai_tpu.engine import kvtier as jkvtier
from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.ops import paged as jpaged
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import kvtier as tkvtier
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops import paged as tpaged
from localai_tpu_torch.ops.attention import NEG_INF
from localai_tpu_torch.ops.kvcache import QuantKV, quantize_tokens
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------ policy layer

POLICIES = ["", "full", "sink_window(sinks=256, window=1024)",
            "sink_window(window=512, quantize_cold=true)",
            " sink_window( sinks = 3 , window=7, quantize_cold=YES ) ",
            "lru", "sink_window", "sink_window()", "sink_window(sinks=4)",
            "sink_window(window=-1)", "sink_window(frobnicate=1)",
            "sink_window(sinks=-2, window=4)", "sink_window(sinks)"]


def _outcome(fn, *args):
    """A call's result, or its error type and text."""
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def _pol(p):
    return p if isinstance(p, tuple) else (
        p.kind, p.sinks, p.window, p.quantize_cold, p.windowed,
        p.sink_blocks, p.describe())


@pytest.mark.parametrize("text", POLICIES)
def test_parse_policy_equals_reference(text):
    assert _pol(_outcome(tkvtier.parse_policy, text)) == \
        _pol(_outcome(jkvtier.parse_policy, text))


RESOLVE = [
    ("sink_window(sinks=128, window=512)",
     "sink_window(sinks=256, window=1024)"),
    ("full", "sink_window(sinks=256, window=1024)"),
    ("", "sink_window(sinks=256, window=1024)"),
    ("sink_window(sinks=512, window=1024)",
     "sink_window(sinks=256, window=1024)"),
    ("sink_window(sinks=256, window=4096)",
     "sink_window(sinks=256, window=1024)"),
    ("sink_window(sinks=0, window=256)", "full"),
    ("sink_window(sinks=128, window=512)",
     "sink_window(sinks=256, window=1024, quantize_cold=true)"),
    ("bogus", "sink_window(sinks=256, window=1024)"),
]


@pytest.mark.parametrize("req,eng", RESOLVE)
def test_resolve_policy_equals_reference(req, eng):
    got = _outcome(tkvtier.resolve_policy, req, tkvtier.parse_policy(eng))
    want = _outcome(jkvtier.resolve_policy, req, jkvtier.parse_policy(eng))
    assert _pol(got) == _pol(want)


@pytest.mark.parametrize("window,margin", [(1024, 512), (128, 256), (1, 1),
                                           (4096, 64), (100, 33)])
def test_ring_geometry_equals_reference(window, margin):
    assert tkvtier.ring_blocks(window, margin) == \
        jkvtier.ring_blocks(window, margin)
    for text in ("sink_window(sinks=256, window=1024)",
                 "sink_window(sinks=0, window=%d)" % window):
        assert tkvtier.resident_blocks(tkvtier.parse_policy(text), margin) \
            == jkvtier.resident_blocks(jkvtier.parse_policy(text), margin)


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=512),
                                dict(decode_loop=1024, decode_block=4),
                                dict(decode_block=700, prefill_chunk=64)])
def test_engine_margin_equals_reference(kw):
    assert tkvtier.engine_margin_tokens(TConfig(**kw)) == \
        jkvtier.engine_margin_tokens(JConfig(**kw))


@pytest.mark.parametrize("total", [3, 7, 12, 23, 40])
def test_ring_maps_equal_reference(total):
    """ring_block_map and the resident inverse (positions, validity) equal
    ops/paged's, and every resident column holds the raw block the write
    map last put there."""
    sb, rw, maxb = 2, 5, 7
    raw = np.arange(total)
    t_cols = tpaged.ring_block_map(torch.tensor(raw), torch.tensor(sb),
                                   torch.tensor(rw)).numpy()
    j_cols = np.asarray(jpaged.ring_block_map(jnp.asarray(raw),
                                              jnp.asarray(sb),
                                              jnp.asarray(rw)))
    np.testing.assert_array_equal(t_cols, j_cols)
    owner = {int(c): int(r) for r, c in zip(raw, t_cols)}
    for length in (total * 128, total * 128 - 77):
        tp, tok = tpaged.resident_block_positions(
            maxb, torch.tensor([sb]), torch.tensor([rw]),
            torch.tensor([length]))
        jp, jok = jpaged.resident_block_positions(
            maxb, jnp.asarray([sb]), jnp.asarray([rw]), jnp.asarray([length]))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(
            np.where(tok.numpy(), tp.numpy(), -1),
            np.where(np.asarray(jok), np.asarray(jp), -1))
        for j in range(maxb):
            if tok[0, j] and length == total * 128:
                assert owner.get(j) == int(tp[0, j])


# ------------------------------------------------- plain reads vs reference

MAXB, NB, NBC, KVH, D = 6, 30, 14, 2, 16
LT = 1600          # max_context of the decode cases (MBC = 13 cold blocks)


def _geometry():
    """Three slots over compact tables of MAXB columns: a windowed slot past
    its ring's first wrap, a full-policy slot (sentinels), and a windowed
    slot shorter than its window. (sb, rw, sinks, window, length)."""
    return [(1, 5, 100, 300, 1100), (MAXB, 1, LT, LT, 700),
            (1, 5, 60, 200, 90)]


def _pools(seed, q8=False):
    r = np.random.default_rng(seed)
    k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    table = np.stack([r.permutation(np.arange(1, NB))[:MAXB]
                      for _ in range(3)]).astype(np.int32)
    geo = _geometry()
    kvt = {n: np.asarray([g[i] for g in geo], np.int32)
           for i, n in enumerate(("sb", "rw", "sinks", "window"))}
    lengths = np.asarray([g[4] for g in geo], np.int32)
    return k, v, table, kvt, lengths


def _cold(seed, demote):
    """A cold table [3, MBC] demoting `demote` {slot: raw blocks} to cold
    blocks 1.., and random int8 cold pools with scales."""
    r = np.random.default_rng(seed)
    mbc = -(-LT // 128)
    ctab = np.zeros((3, mbc), np.int32)
    ci = 1
    for b, raws in demote.items():
        for raw in raws:
            ctab[b, raw] = ci
            ci += 1
    cq = [r.integers(-127, 128, (NBC, KVH, 128, D)).astype(np.int8)
          for _ in range(2)]
    cs = [(r.random((NBC, KVH, 1, 128)) * 0.02 + 1e-3).astype(np.float32)
          for _ in range(2)]
    return ctab, cq, cs


DEMOTE = {0: [1, 2, 3, 4, 5], 2: [0]}


def _jkvt(kvt, ctab=None):
    d = {k: jnp.asarray(v) for k, v in kvt.items()}
    if ctab is not None:
        d["cold_tab"] = jnp.asarray(ctab)
    return d


def _tkvt(kvt, ctab=None):
    d = {k: torch.tensor(v) for k, v in kvt.items()}
    if ctab is not None:
        d["cold_tab"] = torch.tensor(ctab)
    return d


def _q(seed, B=3, H=4):
    return np.random.default_rng(seed).standard_normal(
        (B, 1, H, D)).astype(np.float32)


@pytest.mark.parametrize("cold", [False, True], ids=["drop", "cold"])
def test_tiered_decode_plain_equals_reference(cold):
    """f32 pools: the port's tiered paged decode (plain) equals the
    reference's _decode_dq tier branch within 2e-5 — the ring map, the
    residency, the retention mask (drop) or the demoted blocks read from
    the cold pool (cold), and the full-policy sentinels of slot 1."""
    from localai_tpu.models.llama import _decode_dq
    from localai_tpu.ops.kvcache import QuantKV as JQuantKV

    k, v, table, kvt, lengths = _pools(0)
    q = _q(1)
    ctab = cq = cs = None
    jck = jcv = tcold = None
    if cold:
        ctab, cq, cs = _cold(2, DEMOTE)
        jck, jcv = (JQuantKV(jnp.asarray(a), jnp.asarray(b))
                    for a, b in zip(cq, cs))
        tcold = tuple(QuantKV(torch.tensor(a), torch.tensor(b))
                      for a, b in zip(cq, cs))
    ref = _decode_dq(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lengths), table=jnp.asarray(table),
                     kvt=_jkvt(kvt, ctab), ck=jck, cv=jcv)
    out = tk.ragged_decode_plain(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), torch.tensor(lengths),
                                 table=torch.tensor(table),
                                 kvt=_tkvt(kvt, ctab), cold_kv=tcold)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_tiered_decode_plain_bf16_equals_reference():
    """A bf16 hot pool and bf16 query: within the bf16 bar (the reference
    rounds p to bf16 before the value product; the kernel keeps f32)."""
    from localai_tpu.models.llama import _decode_dq

    k, v, table, kvt, lengths = _pools(3)
    q = _q(4)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = _decode_dq(jb(q), jb(k), jb(v), jnp.asarray(lengths),
                     table=jnp.asarray(table), kvt=_jkvt(kvt))
    out = tk.ragged_decode_plain(bf(q), bf(k), bf(v), torch.tensor(lengths),
                                 table=torch.tensor(table), kvt=_tkvt(kvt))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16)


def test_tiered_decode_plain_int8_hot():
    """An int8 hot pool (drop policy on the int8 recipe): the port keeps row
    5's arithmetic, so it equals the reference run on the f32 products q*s
    within 2e-5, and the reference as it is (K/V dequantized to bf16)
    within 2e-2."""
    from localai_tpu.models.llama import _decode_dq
    from localai_tpu.ops.kvcache import QuantKV as JQuantKV

    k, v, table, kvt, lengths = _pools(5)
    q = _q(6)
    kq, ks = quantize_tokens(torch.tensor(k))
    vq, vs = quantize_tokens(torch.tensor(v))
    ks, vs = ks[:, :, None, :], vs[:, :, None, :]
    out = tk.ragged_decode_q8_plain(torch.tensor(q), kq, ks, vq, vs,
                                    torch.tensor(lengths),
                                    table=torch.tensor(table),
                                    kvt=_tkvt(kvt))
    kf = (kq.float() * ks[:, :, 0, :, None]).numpy()
    vf = (vq.float() * vs[:, :, 0, :, None]).numpy()
    exact = _decode_dq(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
                       jnp.asarray(lengths), table=jnp.asarray(table),
                       kvt=_jkvt(kvt))
    np.testing.assert_allclose(out.numpy(), np.asarray(exact), **F32)
    jq = lambda a, b: JQuantKV(jnp.asarray(a.numpy()),  # noqa: E731
                               jnp.asarray(b.numpy()))
    ref = _decode_dq(jnp.asarray(q), jq(kq, ks), jq(vq, vs),
                     jnp.asarray(lengths), table=jnp.asarray(table),
                     kvt=_jkvt(kvt))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BF16)


def test_full_sentinels_equal_untiered_plain():
    """Full-policy sentinels over an identity-width table give the untiered
    paged read exactly (the same arithmetic on the same rows)."""
    k, v, table, _, _ = _pools(7)
    q = torch.tensor(_q(8))
    lengths = torch.tensor([700, 1, 768])
    kvt = {"sb": torch.full((3,), MAXB),
           "rw": torch.ones(3, dtype=torch.int32),
           "sinks": torch.full((3,), LT), "window": torch.full((3,), LT)}
    a = tk.ragged_decode_plain(q, torch.tensor(k), torch.tensor(v), lengths,
                               table=torch.tensor(table), kvt=kvt)
    b = tk.ragged_decode_plain(q, torch.tensor(k), torch.tensor(v), lengths,
                               table=torch.tensor(table))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _ragged_pack(seed, q8=False):
    """A flat stream over compact ring tables: a windowed decode row past
    the ring's wrap, a windowed 40-row chunk, a full-policy decode row, and
    a dead q block."""
    r = np.random.default_rng(seed)
    k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    tables = np.stack([r.permutation(np.arange(1, NB))[:MAXB]
                       for _ in range(3)]).astype(np.int32)
    # (kvlen, qlen) of sequences 0..2, then a dead block
    seqs = [(1100, 1), (700, 40), (650, 1)]
    block_seq, qstart, row = [], [], 0
    for s, (_, ql) in enumerate(seqs):
        qstart.append(row)
        nb = -(-ql // 8)
        block_seq += [s] * nb
        row += nb * 8
    block_seq.append(-1)
    row += 8
    H = 4
    q = r.standard_normal((row, H, D)).astype(np.float32)
    meta = dict(block_seq=np.asarray(block_seq, np.int32),
                qstart=np.asarray(qstart, np.int32),
                qlen=np.asarray([s[1] for s in seqs], np.int32),
                kvlen=np.asarray([s[0] for s in seqs], np.int32),
                tables=tables)
    kvt = dict(sb=np.asarray([1, 1, MAXB], np.int32),
               rw=np.asarray([5, 5, 1], np.int32),
               sinks=np.asarray([100, 64, LT], np.int32),
               window=np.asarray([300, 250, LT], np.int32))
    live = [t for s, (kl, ql) in enumerate(seqs)
            for t in range(qstart[s], qstart[s] + ql)]
    return q, k, v, meta, kvt, live


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_tiered_ragged_plain_equals_reference(q8):
    """The port's tiered ragged attention (plain) equals the reference's
    ragged_attention_xla[_q8](kvt=) on the live rows within 2e-5."""
    from localai_tpu.ops.pallas import ragged_attention as jra

    q, k, v, meta, kvt, live = _ragged_pack(9)
    jm = {n: jnp.asarray(a) for n, a in meta.items()}
    tm = {n: torch.tensor(a) for n, a in meta.items()}
    if q8:
        kq, ks = quantize_tokens(torch.tensor(k))
        vq, vs = quantize_tokens(torch.tensor(v))
        ks, vs = ks[:, :, None, :], vs[:, :, None, :]
        ref = jra.ragged_attention_xla_q8(
            jnp.asarray(q), *(jnp.asarray(a.numpy()) for a in (kq, ks, vq,
                                                               vs)),
            **jm, kvt=_jkvt(kvt))
        out = tk.ragged_paged_attention_q8_plain(torch.tensor(q), kq, ks, vq,
                                                 vs, **tm, kvt=_tkvt(kvt))
    else:
        ref = jra.ragged_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **jm, kvt=_jkvt(kvt))
        out = tk.ragged_paged_attention_plain(torch.tensor(q),
                                              torch.tensor(k),
                                              torch.tensor(v), **tm,
                                              kvt=_tkvt(kvt))
    np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live],
                               **F32)


# ------------------------------------------------ the kernels' tier plans

BK, PBS = 32, 128


def _hot_block(sb, rw, cur, table_row, raw, maxb, ctab_row=None, shift=0):
    """tier_hot_block of the .cu: the pool block of raw block `raw`, or -1
    (not resident, or demoted). `shift` plants a ring map off by that many
    columns."""
    col = raw
    if raw >= sb:
        if raw < max(sb, cur - rw + 1) or raw > cur:
            return -1
        col = sb + (raw - sb + shift) % rw
    if col >= maxb:
        return -1
    if ctab_row is not None and raw < len(ctab_row) and ctab_row[raw]:
        return -1
    return int(table_row[col])


def _plan(L, sb, rw, sinks, window, cold):
    """tier_row of the .cu: (g0, gap, hot tiles, cold tiles, the effective
    sinks and window)."""
    if cold:
        sinks, window = sb * PBS, 1 << 30
    cur = (L - 1) // PBS if L > 0 else 0
    ring_lo = max(sb, cur - rw + 1)
    a = max(min(sinks, L, sb * PBS), 0)
    c = min(max(max(L - window, ring_lo * PBS), a), L)
    g0 = -(-a // BK)
    gap = max(c // BK, g0) - g0
    return g0, gap, -(-L // BK) - gap, (-(-L // BK) if cold else 0), \
        sinks, window, cur


def _partial(qh, kt, vt, ok):
    """A span's (m, l, acc) over the rows kt/vt [N, D] under mask ok [N]
    for heads qh [G, D] (pre-scaled): the kernel's online softmax in one
    go (NEG_INF masking, l over p)."""
    if kt.shape[0] == 0:
        return (torch.full((qh.shape[0],), NEG_INF),
                torch.zeros(qh.shape[0]), torch.zeros(qh.shape))
    s = torch.where(ok[None, :], qh @ kt.T, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), p @ vt


def _hot_spans(nhot, plan, full, maxb):
    """The hot spans of one (slot, KV head) as decode_tier_kernel's blocks
    walk them: hot block x of the ceil(maxb*128 / split) takes spans x, x +
    nhx, ... of tier_hot_tiles (split_f's for a full-policy slot) below
    nhot and the plan's nsplit (the workspace's hot splits; a full-policy
    slot holds at most maxb*128 rows). [(block, workspace split, kb0,
    kb1)]."""
    tps = (plan["split_f"] if full else plan["split"]) // BK
    nhx = -(-maxb * PBS // plan["split"])
    spans = []
    for x in range(nhx):
        sp = x
        while sp * tps < nhot and sp < plan["nsplit"]:
            spans.append((x, sp, sp * tps, min(sp * tps + tps, nhot)))
            sp += nhx
    return spans


def _cold_spans(L, crow, plan):
    """The cold spans of one (slot, KV head): the demoted blocks below L in
    raw order, PBS // BK tiles each, cut into spans of split_c. [(cold
    split, [(raw block, cold block, tile offset), ...])]."""
    lim = min(len(crow), -(-L // PBS))
    demoted = [(r, crow[r]) for r in range(lim) if crow[r]]
    tiles = [(r, ci, j * BK) for r, ci in demoted for j in range(PBS // BK)]
    tpc = plan["split_c"] // BK
    return [(sp, tiles[sp * tpc:(sp + 1) * tpc])
            for sp in range(-(-len(tiles) // tpc))]


def _decode_model(q, kp, vp, lengths, table, kvt, cold=None,
                  shift=0, drop_scales=False):
    """A PyTorch model of decode_tier_kernel's work: per (slot, KV head)
    the hot view's live tiles in compressed order (g0, gap), cut into
    tier_plan's spans (decode_split's for a full-policy slot, sb >= the
    table width), dead tiles skipped, the token mask per kept tile; with
    the cold tier its own spans over the demoted blocks' tiles alone,
    reading them as bf16(q * s); the combine over the spans written, hot
    then cold. f32 hot pools; `shift` and `drop_scales` plant faults."""
    B, _, H, Dh = q.shape
    kvh = kp.shape[1]
    G = H // kvh
    maxb = table.shape[1]
    ctab = None if cold is None else kvt["cold_tab"]
    plan = tk.tier_plan(maxb, 0 if ctab is None else ctab.shape[1],
                        B * kvh, 132)
    out = torch.zeros(B, H, Dh)
    cat = (lambda xs, e: torch.cat(xs) if xs else e)
    for b in range(B):
        L = int(lengths[b])
        sb, rw, sinks, window = (int(kvt[n][b]) for n in ("sb", "rw",
                                                          "sinks", "window"))
        g0, gap, nhot, _, snk, win, cur = _plan(L, sb, rw, sinks, window,
                                                cold is not None)
        crow = None if ctab is None else ctab[b].tolist()
        spans = sorted(_hot_spans(nhot, plan, sb >= maxb, maxb),
                       key=lambda x: x[1])
        for kh in range(kvh):
            qh = q[b, 0, kh * G:(kh + 1) * G].float() * Dh ** -0.5
            parts = []
            for _, _, kb0, kb1 in spans:
                rows_k, rows_v, oks = [], [], []
                for kb in range(kb0, kb1):
                    t0 = (kb if kb < g0 else kb + gap) * BK
                    pb = _hot_block(sb, rw, cur, table[b], t0 // PBS, maxb,
                                    crow, shift)
                    kept = t0 < min(snk, L) or t0 + BK > L - win
                    if pb < 0 or t0 >= L or not kept:
                        continue
                    off = t0 % PBS
                    kpos = torch.arange(t0, t0 + BK)
                    rows_k.append(kp[pb, kh, off:off + BK].float())
                    rows_v.append(vp[pb, kh, off:off + BK].float())
                    oks.append((kpos < L) & ((kpos >= L - win)
                                             | (kpos < snk)))
                parts.append(_partial(
                    qh, cat(rows_k, torch.zeros(0, Dh)),
                    cat(rows_v, torch.zeros(0, Dh)),
                    cat(oks, torch.zeros(0, dtype=torch.bool))))
            if cold is not None:
                (cq, cs), (vq_, vs_) = cold
                for _, tiles in _cold_spans(L, crow, plan):
                    rows_k, rows_v, oks = [], [], []
                    for raw, ci, off in tiles:
                        t0 = raw * PBS + off
                        if t0 >= L:
                            continue
                        sk = cs[ci, kh, 0, off:off + BK]
                        sv = vs_[ci, kh, 0, off:off + BK]
                        if drop_scales:
                            sk = sv = torch.ones(BK)
                        dq = (lambda x, s_: (x.float() * s_[:, None]).to(
                            torch.bfloat16).float())
                        rows_k.append(dq(cq[ci, kh, off:off + BK], sk))
                        rows_v.append(dq(vq_[ci, kh, off:off + BK], sv))
                        oks.append(torch.arange(t0, t0 + BK) < L)
                    parts.append(_partial(
                        qh, cat(rows_k, torch.zeros(0, Dh)),
                        cat(rows_v, torch.zeros(0, Dh)),
                        cat(oks, torch.zeros(0, dtype=torch.bool))))
            m = torch.stack([p[0] for p in parts], 1)
            l = torch.stack([p[1] for p in parts], 1)
            acc = torch.stack([p[2] for p in parts], 1)
            w = torch.exp(m - m.amax(1, keepdim=True))
            den = torch.clamp_min((w * l).sum(1), 1e-30)
            out[b, kh * G:(kh + 1) * G] = (w[..., None] * acc).sum(1) \
                / den[:, None]
    return out.reshape(B, 1, H, Dh)


def _decode_case(cold):
    k, v, table, kvt, lengths = _pools(11)
    q = torch.tensor(_q(12))
    tkv = _tkvt(kvt, None)
    coldp = None
    if cold:
        ctab, cq, cs = _cold(13, DEMOTE)
        tkv = _tkvt(kvt, ctab)
        coldp = ((torch.tensor(cq[0]), torch.tensor(cs[0])),
                 (torch.tensor(cq[1]), torch.tensor(cs[1])))
    ref = tk.ragged_decode_plain(
        q, torch.tensor(k), torch.tensor(v), torch.tensor(lengths),
        table=torch.tensor(table), kvt=tkv,
        cold_kv=None if coldp is None else tuple(QuantKV(*p) for p in coldp))
    args = (q, torch.tensor(k), torch.tensor(v), torch.tensor(lengths),
            torch.tensor(table), tkv, coldp)
    return ref, args


@pytest.mark.parametrize("cold", [False, True], ids=["drop", "cold"])
def test_tier_decode_model_vs_plain(cold):
    """The tiered decode kernel's plan (compressed tiles, dead tiles, hot
    and cold spans, the combine) gives the plain version within 2e-5; a
    ring map off by one column fails the bar, and so does the cold tier
    read without its scales."""
    ref, args = _decode_case(cold)
    out = _decode_model(*args)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32)
    bad = _decode_model(*args, shift=1)
    assert (bad - ref).abs().max().item() > 1e-2
    if cold:
        bad = _decode_model(*args, drop_scales=True)
        assert (bad - ref).abs().max().item() > 1e-2


def test_tier_decode_plan_skips_the_gap():
    """At 32k with a 1024-token window and 128 sinks the hot view walks the
    sinks and the window — 4 + 32 (+1 partial) tiles — not 1024."""
    g0, gap, nhot, _, _, _, _ = _plan(32768, 1, 12, 128, 1024, False)
    assert (g0, nhot) == (4, 36)
    assert gap == 1024 - 36


# the smoke's tiered shape (chip_smoke.py TIER_LENS: 8 slots, sinks 256,
# window 4096 at the engine's default margin), and short slots
SMOKE_TIER = dict(lens=[32768, 30001, 24577, 16500, 8193, 4097, 2000, 300],
                  sinks=256, window=4096, margin=256)


def _smoke_geometry():
    pol = tkvtier.parse_policy(
        f"sink_window(sinks={SMOKE_TIER['sinks']}, "
        f"window={SMOKE_TIER['window']})")
    return pol.sink_blocks, tkvtier.ring_blocks(SMOKE_TIER["window"],
                                                SMOKE_TIER["margin"])


@pytest.mark.parametrize("lens", [SMOKE_TIER["lens"], [300, 1, 4097, 1]],
                         ids=["smoke", "short"])
@pytest.mark.parametrize("full", [False, True], ids=["policy", "full"])
def test_tier_hot_plan_covers_every_live_tile_once(lens, full):
    """Every hot tile below nhot of each slot lies in exactly one span, the
    spans a slot writes are workspace splits 0..nh-1 (the combine's read)
    below the plan's nsplit, and a slot under the policy takes the tier's
    deep spans (one a block), a full-policy slot decode_split's. The hot
    span depth follows the rows: about 2.5 blocks an SM (int8: 5), so
    phase 2's 8 slots take 31 and 16 tiles a span and phase 10's 4 slots
    at a 1024-token window 6 and 4."""
    assert tk.tier_span_tiles(38, 64, 132, True) == 16
    assert tk.tier_span_tiles(13, 32, 132, False) == 6
    assert tk.tier_span_tiles(13, 32, 132, True) == 4
    sb, rw = _smoke_geometry()
    maxb = sb + rw
    B, kvh = len(lens), 8
    plan = tk.tier_plan(maxb, 0, B * kvh, 132)
    assert plan["split"] == tk.tier_span_tiles(maxb, B * kvh, 132,
                                               False) * BK
    assert plan["split_f"] == tk.decode_split(maxb * PBS, B * kvh, 132)[1]
    if lens == SMOKE_TIER["lens"]:  # phase 2's shape: 31 tiles a span
        assert plan["split"] == 31 * BK
    for L in lens:
        if full:  # a full-policy slot holds at most its table's rows
            L = min(L, maxb * PBS)
        g = (maxb, 1, 1 << 20, 1 << 20) if full else (
            sb, rw, SMOKE_TIER["sinks"], SMOKE_TIER["window"])
        g0, gap, nhot, _, snk, win, _ = _plan(L, *g, False)
        spans = _hot_spans(nhot, plan, full, maxb)
        tiles = [kb for _, _, kb0, kb1 in spans for kb in range(kb0, kb1)]
        assert sorted(tiles) == list(range(nhot))
        nh = len(spans)
        assert sorted(sp for _, sp, _, _ in spans) == list(range(nh))
        assert nh <= plan["nsplit"]
        tps = (plan["split_f"] if full else plan["split"]) // BK
        assert nh == min(plan["nsplit"], -(-nhot // tps))
        if not full:
            assert len({x for x, _, _, _ in spans}) == nh  # one a block
        # every kept row's tile is one of the walked tiles
        for p in range(L):
            if p < snk or p >= L - win:
                t = p // BK
                assert 0 <= (t if t < g0 else t - gap) < nhot


def test_tier_cold_plan_visits_only_demoted_blocks():
    """The cold spans walk the demoted blocks' tiles alone, each once, in
    raw order — sinks, the ring and the blocks never demoted are not
    visited — at the smoke's 32k shape with the middle demoted and at a
    scattered cold table."""
    sb, rw = _smoke_geometry()
    L = SMOKE_TIER["lens"][0]
    mbc = -(-L // PBS)
    crow = [0] * mbc
    mid = range(sb, (L - SMOKE_TIER["window"]) // PBS)
    for i, raw in enumerate(mid):
        crow[raw] = i + 1
    plan = tk.tier_plan(sb + rw, mbc, 64, 132)
    assert plan["split_c"] == tk.COLD_SPAN_TILES * BK
    assert plan["nsplit_c"] * plan["split_c"] >= mbc * PBS
    spans = _cold_spans(L, crow, plan)
    seen = [(raw, off) for _, tiles in spans for raw, _, off in tiles]
    assert seen == [(raw, j * BK) for raw in mid for j in range(PBS // BK)]
    assert len(spans) == -(-len(mid) * (PBS // BK) // (plan["split_c"]
                                                       // BK))
    assert len(spans) <= plan["nsplit_c"]
    scattered = [0] * 13
    for i, raw in enumerate((0, 3, 4, 9, 12)):
        scattered[raw] = i + 1
    seen = [raw for _, tiles in _cold_spans(1537, scattered, plan)
            for raw, _, _ in tiles]
    assert sorted(set(seen)) == [0, 3, 4, 9, 12]
    assert len(seen) == 5 * (PBS // BK)
    assert not _cold_spans(1537, [0] * 13, plan)


def _ragged_model(q, kp, vp, meta, kvt, tensor_cores=True, shift=0):
    """A PyTorch model of the tiered ragged split pass: q tiles by leader,
    tier_plan's compressed order over the tile's sinks and window, spans
    of ragged_split, stage_table's dead tiles, the row mask; the combine
    over the tile's spans."""
    T, H, Dh = q.shape
    kvh = kp.shape[1]
    G = H // kvh
    bseq, qst, qln, kvl, tab = (meta[n].tolist() for n in (
        "block_seq", "qstart", "qlen", "kvlen", "tables"))
    maxb = len(tab[0])
    nsplit, split = tk.ragged_split(T, maxb, kvh, 132)
    _, qt = tk.ragged_tiling(G, Dh, tensor_cores)
    out = torch.zeros(T, H, Dh)
    tps = split // BK
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
        qpos0 = kl - ql + row0 - qs
        kend = min(kl, qpos0 + t_hi)
        sb, rw, snk, win = (int(kvt[n][s]) for n in ("sb", "rw", "sinks",
                                                     "window"))
        cur = (kl - 1) // PBS
        ring_lo = max(sb, cur - rw + 1)
        qf = qpos0 + t_lo
        a = max(min(snk, kend, sb * PBS), 0)
        c = min(max(max(qf - win + 1, ring_lo * PBS), a), kend)
        g0 = -(-a // BK)
        gap = max(c // BK, g0) - g0
        ntile = -(-kend // BK) - gap
        for t in range(t_lo, t_hi):
            qpos = qpos0 + t
            parts = []
            for sp in range(nsplit):
                if sp * tps >= ntile:
                    continue
                rows_k, rows_v, oks = [], [], []
                for kb in range(sp * tps, min((sp + 1) * tps, ntile)):
                    t0 = (kb if kb < g0 else kb + gap) * BK
                    live = t0 < kend and (t0 < min(snk, kend)
                                          or t0 + BK > qf - win + 1)
                    pb = _hot_block(sb, rw, cur, tab[s], t0 // PBS, maxb,
                                    shift=shift)
                    if not live or pb < 0:
                        continue
                    off = t0 % PBS
                    kpos = torch.arange(t0, t0 + BK)
                    rows_k.append(kp[pb, :, off:off + BK].float())
                    rows_v.append(vp[pb, :, off:off + BK].float())
                    oks.append((kpos < kend) & (kpos <= qpos)
                               & ((kpos > qpos - win) | (kpos < snk)))
                for kh in range(kvh):
                    qh = q[row0 + t, kh * G:(kh + 1) * G].float() \
                        * Dh ** -0.5
                    if rows_k:
                        kt = torch.cat([x[kh] for x in rows_k])
                        vt = torch.cat([x[kh] for x in rows_v])
                        ok = torch.cat(oks)
                    else:
                        kt = vt = torch.zeros(0, Dh)
                        ok = torch.zeros(0, dtype=torch.bool)
                    parts.append((kh, _partial(qh, kt, vt, ok)))
            for kh in range(kvh):
                ps = [p for h_, p in parts if h_ == kh]
                m = torch.stack([p[0] for p in ps], 1)
                l = torch.stack([p[1] for p in ps], 1)
                acc = torch.stack([p[2] for p in ps], 1)
                w = torch.where(l > 0, torch.exp(m - m.amax(1, keepdim=True)),
                                torch.zeros_like(l))
                den = torch.clamp_min((w * l).sum(1), 1e-30)
                out[row0 + t, kh * G:(kh + 1) * G] = \
                    (w[..., None] * acc).sum(1) / den[:, None]
    return out


@pytest.mark.parametrize("tc", [True, False], ids=["tc", "simt"])
def test_tier_ragged_model_vs_plain(tc):
    """The tiered ragged kernel's plan (two spans a q tile through the ring
    map, dead tiles, the tile's compressed splits in the combine) gives the
    plain version's live rows within 2e-5; a ring map off by one column
    fails the bar."""
    q, k, v, meta, kvt, live = _ragged_pack(14)
    tm = {n: torch.tensor(a) for n, a in meta.items()}
    ref = tk.ragged_paged_attention_plain(torch.tensor(q), torch.tensor(k),
                                          torch.tensor(v), **tm,
                                          kvt=_tkvt(kvt))
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), meta, kvt)
    out = _ragged_model(*args, tensor_cores=tc)
    np.testing.assert_allclose(out.numpy()[live], ref.numpy()[live], **F32)
    bad = _ragged_model(*args, tensor_cores=tc, shift=1)
    assert (bad[live] - ref[live]).abs().max().item() > 1e-2


# ------------------------------------------------------------ the engines
# (the engines' parity with the JAX engines: test_torch_kvtier_engine.py)

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ckpt = tiny_checkpoint(tmp_path_factory, max_position=1024)
    return (jloader.load_model(ckpt, dtype="float32"),
            tloader.load_model(ckpt, dtype="float32", device="cpu"))


EC = dict(max_slots=3, max_context=1024, prefill_buckets=(32,),
          prefill_chunk=64, decode_loop=8, decode_block=4)
DROP = "sink_window(sinks=64, window=128)"
COLD = "sink_window(sinks=64, window=128, quantize_cold=true)"
def test_config_validation_equals_reference(models):
    """The tier's configuration errors are the reference's ValueErrors."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    bad = [dict(kv_policy="sink_window(sinks=0, window=256)"),
           dict(kv_pages=64, kv_cold_pages=8),
           dict(kv_pages=64, kv_cold_pages=1, kv_policy=COLD),
           dict(kv_pages=64, kv_cold_pages=8, cache_type="int8",
                kv_policy=COLD),
           dict(kv_pages=64, kv_cold_pages=8, ragged_token_budget=64,
                kv_policy=COLD),
           dict(kv_pages=4, kv_policy=DROP),
           dict(kv_policy="lru")]
    for kw in bad:
        ec = dict(EC, **kw)
        with pytest.raises(ValueError) as want:
            JEngine(jcfg, jp, jtok, JConfig(**ec))
        with pytest.raises(ValueError) as got:
            TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
        assert str(got.value) == str(want.value), kw


def test_ring_margin_covers_the_port_writes_ahead():
    """engine_margin_tokens sizes the ring's margin; a demote lands before
    the ring wraps only if no path writes further past the host's length
    than it. The port's paths: the pending fused decode loop (decode_loop
    steps: segments of 8 stop at the dispatch's end and a slot's budget),
    the pending fused ragged loop (ragged_loop_steps: the steps after a
    first finish run within the budgets), the block path (decode_block
    steps a dispatch, one in flight), a prefill chunk (prefill_chunk rows),
    one decode step."""
    for kw in (dict(), dict(decode_loop=8, decode_block=4, prefill_chunk=64),
               dict(ragged_token_budget=64, kv_pages=8),
               dict(decode_loop=0, decode_block=32)):
        ec = TConfig(**kw)
        ahead = max(ec.decode_loop, ec.decode_block, ec.prefill_chunk, 1)
        if ec.ragged_token_budget:
            ahead = max(ahead, ec.ragged_loop_steps)
        margin = tkvtier.engine_margin_tokens(ec)
        assert ahead <= margin, kw
        # the ring holds the window, the margin and two slack blocks: the
        # demoted block's column is not written again until the device has
        # passed (raw + ring) * 128 > host length + margin
        window = 1000
        rw = tkvtier.ring_blocks(window, margin)
        for n in range(window + 128, window + 2000, 97):
            raw = (n - window) // 128 - 1       # the last eligible block
            assert (raw + rw) * 128 > n + margin


def _prefilled(eng, req):
    """Submit `req` and step until its slot has prefilled, then two ticks
    more (a tick demotes what the last chunks moved out of the window)."""
    eng.submit(req)
    for _ in range(200):
        eng.step()
        s = eng._slots[0]
        if s is not None and s.prefilled:
            eng.step()
            eng.step()
            return
    raise AssertionError("the prompt did not prefill")


def test_demotion_lands_before_the_ring_wraps(models):
    """An idle engine's tick prefills up to max_slots chunks of one slot —
    more than the ring's margin of one chunk: a block that leaves the
    window mid-tick is overwritten through the ring before the next tick.
    The port demotes before each
    chunk, so every cold block holds its own rows: at layer 0 (whose K/V
    no attention has touched) a demoted block is quantize_tokens of the
    full-policy engine's rows, bit for bit. The reference demotes at the
    tick's start only, so blocks the later chunks overwrote through the
    ring reach its cold pool with newer rows (ROADMAP queue 3: by design
    here, not the reference's)."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    # 8 chunks of 64 a tick (an idle engine's budget is max_slots); the
    # ring holds 4 blocks (window 128, a margin of one chunk, 2 of slack)
    ec = dict(max_slots=8, max_context=1024, prefill_buckets=(32,),
              prefill_chunk=64, decode_loop=8, decode_block=4, kv_pages=48)
    prompt = np.random.default_rng(8).integers(3, 300, 900).tolist()

    def req(R, P):
        return R(list(prompt), P(temperature=0.0), max_tokens=40,
                 ignore_eos=True)

    full = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    _prefilled(full, req(TRequest, TParams))
    kfull = full._kc[0, torch.tensor(full._table[0]).long()]  # [MAXB,..]
    cold = TEngine(tcfg, tp, ttok, TConfig(
        **ec, kv_cold_pages=30, kv_policy=COLD), device="cpu")
    _prefilled(cold, req(TRequest, TParams))
    demoted = [(raw, int(ci)) for raw, ci in enumerate(cold._cold_table[0])
               if ci]
    assert len(demoted) >= 4
    for raw, ci in demoted:
        q, s = quantize_tokens(kfull[raw])
        assert torch.equal(cold._ck.q[0, ci], q), raw
        assert torch.equal(cold._ck.s[0, ci, :, 0], s), raw
    ref = JEngine(jcfg, jp, jtok, JConfig(**ec, kv_cold_pages=30,
                                          kv_policy=COLD))
    _prefilled(ref, req(JRequest, JParams))
    wrong = [raw for raw, ci in enumerate(np.asarray(ref._cold_table[0]))
             if ci and not np.array_equal(
                 np.asarray(ref._ck.q)[0, ci],
                 quantize_tokens(kfull[raw])[0].numpy())]
    assert wrong, "the reference's cold blocks all hold their own rows"
