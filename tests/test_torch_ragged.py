"""The PyTorch port's ragged slice (ops/kernels/ragged_attention.py, the
model's ragged_forward and build_ragged_loop, and the engine's ragged
ticks) against the JAX package, on inputs made by numpy from a seed.

Tolerances:
- ragged attention plain versions against the Pallas kernels (interpret
  mode) and against ragged_attention_xla: 2e-5 in f32 on live rows (same
  math, sums in another order; padding rows are garbage by contract);
  bf16 inputs 2e-2 (the bf16 bar of tests/test_torch_kernels.py);
- the flat-row scatters against ragged_scatter_xla[_q8]: EXACT over every
  block but the trash block 0, where padding rows collide by design;
- the model (the tests/test_ragged.py mixed tick, f32): logits within 2e-4
  of the JAX ragged_forward and of the port's own dense decode_step +
  prefill, written pool blocks within 1e-5; with an int8 KV pool 5e-2
  (one int8 step of a K/V element computed in another order moves it;
  the reference's own int8 twin uses the same bar);
- engines (f32): token streams EQUAL, greedy and seeded-sampled.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.models import llama as jllama
from localai_tpu.ops import paged as jpaged
from localai_tpu.ops.pallas import ragged_attention as pra
from localai_tpu.ops.rope import rope_table as jrope_table
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops import paged as tpaged
from localai_tpu_torch.ops.kernels import ragged_attention as tra
from localai_tpu_torch.ops.kvcache import quantize_tokens
from localai_tpu_torch.ops.rope import rope_table as trope_table
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from localai_tpu_torch.parallel.mesh import Mesh
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.ragged

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------- a flat stream, by hand

def _stream(seed, H=4, KVH=2, D=16, NB=12, MAXB=3):
    """A [T=48] flat stream: seq 0 a decode row at kv 200 (block 0), seq 1
    a 12-token chunk at offset 128 (blocks 1-2, rows 8..19), seq 2 a
    decode row at kv 5 (block 3), seq 3 a full 8-token chunk from 0
    (block 4), block 5 dead. Pools random, tables shuffled with entries
    past each allocation 0."""
    r = np.random.default_rng(seed)
    k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    q = r.standard_normal((48, H, D)).astype(np.float32)
    kvlen = np.array([200, 140, 5, 8], np.int32)
    perm = r.permutation(np.arange(1, NB))
    tables = np.zeros((4, MAXB), np.int32)
    used = 0
    for s, n in enumerate(kvlen):
        nb = -(-n // 128)
        tables[s, :nb] = perm[used:used + nb]
        used += nb
    meta = dict(block_seq=np.array([0, 1, 1, 2, 3, -1], np.int32),
                qstart=np.array([0, 8, 24, 32], np.int32),
                qlen=np.array([1, 12, 1, 8], np.int32),
                kvlen=kvlen, tables=tables)
    live = [0] + list(range(8, 20)) + [24] + list(range(32, 40))
    return q, k, v, meta, live


def _q8_pool(pool):
    qv, s = quantize_tokens(torch.tensor(pool))              # s [NB, KVH, 128]
    return qv, s.reshape(s.shape[0], s.shape[1], 1, 128)


# the first four cases at G = 2, then G = 7 (Qwen2-7B's group)
@pytest.mark.parametrize("dtype,window,H,KVH", [
    pytest.param(dt, w, 4, 2, id=f"{dt}-{w}")
    for dt in ("float32", "bfloat16") for w in (None, 100)] + [
    pytest.param("float32", None, 7, 1, id="float32-None-G7"),
    pytest.param("bfloat16", 100, 14, 2, id="bfloat16-100-G7")])
def test_ragged_attention_plain_vs_reference(monkeypatch, dtype, window, H,
                                             KVH):
    monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    q, k, v, meta, live = _stream(0, H=H, KVH=KVH)
    jd = getattr(jnp, dtype)
    jmeta = {n: jnp.asarray(a) for n, a in meta.items()}
    jargs = [jnp.asarray(x, jd) for x in (q, k, v)]
    ref = pra.ragged_paged_attention(*jargs, **jmeta, sliding_window=window)
    xla = pra.ragged_attention_xla(*jargs, **jmeta, sliding_window=window)
    td = getattr(torch, dtype)
    targs = [torch.tensor(x).to(td) for x in (q, k, v)]
    tmeta = {n: torch.tensor(a) for n, a in meta.items()}
    out = tk.ragged_paged_attention_plain(*targs, **tmeta,
                                          sliding_window=window)
    assert out.dtype == td and tuple(out.shape) == q.shape
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out)[live], _np(ref)[live], **tol)
    np.testing.assert_allclose(_np(out)[live], _np(xla)[live], **tol)
    # the wrapper on CPU tensors is the plain version and counts nothing
    tk.reset_launch_counts()
    same = tk.ragged_paged_attention(*targs, **tmeta, sliding_window=window)
    torch.testing.assert_close(same, out, rtol=0, atol=0)
    assert not any(tk.launch_counts().values())


@pytest.mark.parametrize("window,H,KVH", [
    pytest.param(None, 4, 2, id="None"), pytest.param(60, 4, 2, id="60"),
    pytest.param(60, 7, 1, id="60-G7")])
def test_ragged_attention_q8_plain_vs_reference(monkeypatch, window, H, KVH):
    monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    q, k, v, meta, live = _stream(1, H=H, KVH=KVH)
    kq, ks = _q8_pool(k)
    vq, vs = _q8_pool(v)
    jmeta = {n: jnp.asarray(a) for n, a in meta.items()}
    jpools = [jnp.asarray(t.numpy()) for t in (kq, ks, vq, vs)]
    ref = pra.ragged_paged_attention_q8(jnp.asarray(q), *jpools, **jmeta,
                                        sliding_window=window)
    xla = pra.ragged_attention_xla_q8(jnp.asarray(q), *jpools, **jmeta,
                                      sliding_window=window)
    tmeta = {n: torch.tensor(a) for n, a in meta.items()}
    out = tk.ragged_paged_attention_q8_plain(torch.tensor(q), kq, ks, vq, vs,
                                             **tmeta, sliding_window=window)
    np.testing.assert_allclose(_np(out)[live], _np(ref)[live], **F32)
    np.testing.assert_allclose(_np(out)[live], _np(xla)[live], **F32)
    same = tk.ragged_paged_attention_q8(torch.tensor(q), kq, ks, vq, vs,
                                        **tmeta, sliding_window=window)
    torch.testing.assert_close(same, out, rtol=0, atol=0)


def test_ragged_attention_rejects_unaligned_stream():
    q, k, v, meta, _ = _stream(2)
    tmeta = {n: torch.tensor(a) for n, a in meta.items()}
    with pytest.raises(ValueError, match="QBLK"):
        tra._attn_checks("ragged_paged_attention", torch.tensor(q[:44]),
                         k.shape, tmeta["tables"])


def _scatter_case(seed, T=160, KVH=2, D=16, NB=10):
    """T > 128 rows: live rows to shuffled (block, row) targets, padding
    rows to the trash block 0 at row t % 128 (rows 0 and 128 collide)."""
    r = np.random.default_rng(seed)
    k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    kn = r.standard_normal((T, KVH, D)).astype(np.float32)
    vn = r.standard_normal((T, KVH, D)).astype(np.float32)
    live = r.random(T) < 0.6
    slots = r.permutation((NB - 1) * 128)[:T]
    pb = np.where(live, 1 + slots // 128, 0).astype(np.int32)
    off = np.where(live, slots % 128, np.arange(T) % 128).astype(np.int32)
    return k, v, kn, vn, pb, off


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_scatter_plain_vs_reference(dtype):
    k, v, kn, vn, pb, off = _scatter_case(3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rk, rv = pra.ragged_scatter_xla(
        *(jnp.asarray(x, jd) for x in (k, v, kn, vn)), jnp.asarray(pb),
        jnp.asarray(off))
    tkp, tvp = (torch.tensor(x).to(td) for x in (k, v))
    out = tk.ragged_scatter_append(tkp, tvp, torch.tensor(kn).to(td),
                                   torch.tensor(vn).to(td), torch.tensor(pb),
                                   torch.tensor(off))
    assert out[0] is tkp and out[1] is tvp            # in place
    np.testing.assert_array_equal(_np(tkp)[1:], _np(rk)[1:])
    np.testing.assert_array_equal(_np(tvp)[1:], _np(rv)[1:])


def test_ragged_scatter_q8_plain_vs_reference():
    k, v, kn, vn, pb, off = _scatter_case(4)
    kq, ks = _q8_pool(k)
    vq, vs = _q8_pool(v)
    ref = pra.ragged_scatter_xla_q8(
        *(jnp.asarray(t.numpy()) for t in (kq, ks, vq, vs)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pb), jnp.asarray(off))
    out = tk.ragged_scatter_append_q8(kq, ks, vq, vs, torch.tensor(kn),
                                      torch.tensor(vn), torch.tensor(pb),
                                      torch.tensor(off))
    assert out[0] is kq and out[3] is vs
    for got, want in zip((kq, ks, vq, vs), ref):
        np.testing.assert_array_equal(_np(got)[1:], _np(want)[1:])


def test_unported_lanes_raise():
    q, k, v, meta, _ = _stream(5)
    tmeta = {n: torch.tensor(a) for n, a in meta.items()}
    targs = [torch.tensor(x) for x in (q, k, v)]
    # the KV tier runs now: full-policy sentinels (identity ring, retention
    # past every position) give the untiered attention
    nseq = tmeta["tables"].shape[0]
    maxb = tmeta["tables"].shape[1]
    big = torch.full((nseq,), 1 << 20, dtype=torch.int32)
    kvt = {"sb": torch.full((nseq,), maxb, dtype=torch.int32),
           "rw": torch.ones(nseq, dtype=torch.int32), "sinks": big,
           "window": big}
    np.testing.assert_array_equal(
        tk.ragged_paged_attention(*targs, **tmeta, kvt=kvt).numpy(),
        tk.ragged_paged_attention(*targs, **tmeta).numpy())
    # the tensor-parallel wrappers run now (tests/test_torch_parallel.py):
    # on a one-rank mesh they are the unsharded lane; under a mesh the
    # tiered lane waits for the parallel slice
    one = Mesh(rank=0, model=1, device=torch.device("cpu"))
    np.testing.assert_array_equal(
        tra.ragged_paged_attention_sharded(one, *targs, **tmeta).numpy(),
        tk.ragged_paged_attention(*targs, **tmeta).numpy())
    with pytest.raises(NotImplementedError, match="parallel slice"):
        tllama.ragged_forward(
            tllama.Llama(None, None, [], None, mesh=one), None,
            torch.zeros(8, dtype=torch.int32), None, None,
            torch.zeros((1, 1, 1, 128, 16)), None, None, None, None, None,
            None, None, kvt=kvt)


def test_ragged_row_targets():
    """Per-row positions and scatter targets: live rows at their sequence
    positions through the table, padding rows to trash at row % 128."""
    _, _, _, meta, live = _stream(6)
    m = {n: torch.tensor(a) for n, a in meta.items()}
    pos, pb, off = tllama.ragged_row_targets(
        m["block_seq"], m["qstart"], m["qlen"], m["kvlen"], m["tables"], 256)
    tab = meta["tables"]
    assert pos[0] == 199 and pb[0] == tab[0, 1] and off[0] == 199 - 128
    assert pos[8:20].tolist() == list(range(128, 140))
    assert (pb[8:20] == tab[1, 1]).all() and off[8:20].tolist() == list(
        range(12))
    assert pos[32:40].tolist() == list(range(8))
    dead = [r for r in range(48) if r not in live]
    assert (pb[dead] == 0).all() and (pos[dead] == 0).all()
    assert off[dead].tolist() == [r % 128 for r in dead]


# ------------------------------------------------------------- the model

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=256, dtype="float32")


def _mixed_tick_port(tp, tcfg, toks, cache_type=""):
    """tests/test_ragged.py's _mixed_tick on the port: slots A (prompt 5)
    and B (prompt 7) decode one token each while slot C's 12-token prefill
    chunk packs behind them — one ragged forward, against dense
    decode_step and dense prefill over copies of the same pool."""
    pa, pb_, pc = toks
    cos, sin = trope_table(tcfg.rope, 256)
    kc, vc = tpaged.init_paged(tcfg.num_layers, 10, tcfg.num_kv_heads,
                               tcfg.head_dim, torch.float32,
                               cache_type=cache_type)
    table = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    la = tllama.prefill(tp, tcfg, torch.tensor(pa), torch.tensor([5]), cos,
                        sin, kc, vc, torch.tensor([0]), table=table)
    lb = tllama.prefill(tp, tcfg, torch.tensor(pb_), torch.tensor([7]), cos,
                        sin, kc, vc, torch.tensor([1]), table=table)
    ta, tb = int(la.argmax(-1)[0]), int(lb.argmax(-1)[0])

    def clone(c):
        return dataclasses.replace(c, q=c.q.clone(), s=c.s.clone()) \
            if hasattr(c, "q") else c.clone()

    kd, vd = clone(kc), clone(vc)
    dl = tllama.decode_step(tp, tcfg, torch.tensor([ta, tb, 0]),
                            torch.tensor([5, 7, 0], dtype=torch.int32), cos,
                            sin, kd, vd, torch.tensor([True, True, False]),
                            table=table)
    kp, vp = clone(kc), clone(vc)
    lc = tllama.prefill(tp, tcfg, torch.tensor(pc), torch.tensor([12]), cos,
                        sin, kp, vp, torch.tensor([2]), table=table)
    tokens = torch.zeros((32,), dtype=torch.int32)
    tokens[0], tokens[8] = ta, tb
    tokens[16:28] = torch.tensor(pc[0])
    rl = tllama.ragged_forward(
        tp, tcfg, tokens, cos, sin, kc, vc,
        block_seq=torch.tensor([0, 1, 2, 2], dtype=torch.int32),
        qstart=torch.tensor([0, 8, 16], dtype=torch.int32),
        qlen=torch.tensor([1, 1, 12], dtype=torch.int32),
        kvlen=torch.tensor([6, 8, 12], dtype=torch.int32), tables=table,
        logit_rows=torch.tensor([0, 8, 27], dtype=torch.int32))
    return rl, dl, lc, kc, kd, kp, (ta, tb)


def _mixed_tick_jax(jp, jcfg, toks, cache_type=""):
    pa, pb_, pc = (jnp.asarray(t) for t in toks)
    cos, sin = jrope_table(jcfg.rope, 256)
    kc, vc = jpaged.init_paged(jcfg.num_layers, 10, jcfg.num_kv_heads,
                               jcfg.head_dim, jnp.float32,
                               cache_type=cache_type)
    table = jnp.array([[1, 2], [3, 4], [5, 6]], jnp.int32)
    la, kc, vc = jllama.prefill(jp, jcfg, pa, jnp.array([5]), cos, sin, kc,
                                vc, jnp.array([0]), table=table)
    lb, kc, vc = jllama.prefill(jp, jcfg, pb_, jnp.array([7]), cos, sin, kc,
                                vc, jnp.array([1]), table=table)
    ta = jnp.argmax(la, -1).astype(jnp.int32)[0]
    tb = jnp.argmax(lb, -1).astype(jnp.int32)[0]
    tokens = jnp.zeros((32,), jnp.int32)
    tokens = tokens.at[0].set(ta).at[8].set(tb).at[16:28].set(pc[0])
    rl, kc_r, _ = jllama.ragged_forward(
        jp, jcfg, tokens, cos, sin, kc, vc,
        block_seq=jnp.array([0, 1, 2, 2], jnp.int32),
        qstart=jnp.array([0, 8, 16], jnp.int32),
        qlen=jnp.array([1, 1, 12], jnp.int32),
        kvlen=jnp.array([6, 8, 12], jnp.int32),
        tables=table, logit_rows=jnp.array([0, 8, 27], jnp.int32))
    return rl, kc_r, (int(ta), int(tb))


def _tiny_models():
    jcfg = jllama.LlamaConfig(**TINY)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig(**TINY)
    tp = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    r = np.random.default_rng(7)
    toks = [r.integers(0, 256, (1, n)).astype(np.int32) for n in (5, 7, 12)]
    return jcfg, jp, tcfg, tp, toks


def test_ragged_forward_matches_reference_and_dense():
    """Acceptance: ONE ragged forward == the JAX ragged_forward, and == the
    port's dense decode_step + prefill over the same pool — logits and the
    written pool blocks (A at row 5 of block 1, B at row 7 of block 3, C
    rows 0..11 of block 5)."""
    jcfg, jp, tcfg, tp, toks = _tiny_models()
    rl, dl, lc, kr, kd, kp, t_port = _mixed_tick_port(tp, tcfg, toks)
    jrl, jkr, t_jax = _mixed_tick_jax(jp, jcfg, toks)
    assert t_port == t_jax
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(rl), _np(jrl), **tol)
    np.testing.assert_allclose(_np(rl[:2]), _np(dl[:2]), **tol)
    np.testing.assert_allclose(_np(rl[2]), _np(lc[0]), **tol)
    pool = dict(atol=1e-5, rtol=0)
    for blk, n, dense in ((1, 6, kd), (3, 8, kd), (5, 12, kp)):
        np.testing.assert_allclose(_np(kr[:, blk, :, :n]),
                                   _np(dense[:, blk, :, :n]), **pool)
        np.testing.assert_allclose(_np(kr[:, blk, :, :n]),
                                   _np(jkr[:, blk, :, :n]), **pool)


def test_ragged_forward_int8_kv_matches_reference(monkeypatch):
    """The int8-KV pool (the int8 recipe's cache): the port against the JAX
    ragged_forward on its Pallas kernels (interpret mode), whose f32 math
    the port's kernels share."""
    monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    jcfg, jp, tcfg, tp, toks = _tiny_models()
    rl, *_ = _mixed_tick_port(tp, tcfg, toks, cache_type="q8_0")
    jrl, _, _ = _mixed_tick_jax(jp, jcfg, toks, cache_type="q8_0")
    assert np.isfinite(_np(rl)).all()
    np.testing.assert_allclose(_np(rl), _np(jrl), rtol=5e-2, atol=5e-2)


def test_ragged_forward_unported_inputs_raise():
    """2-D logit_rows (the speculative verify windows) are served: logits
    [NSEQ, R, V], each row's those of the 1-D gather at that row. The
    multimodal inject is served: feature rows packed into the flat stream
    give the logits that prefill gives the same rows injected into its
    padded batch (and not the token prompt's). The KV tier is served:
    sentinel geometry gives the untiered forward."""
    _, _, tcfg, tp, _ = _tiny_models()
    cos, sin = trope_table(tcfg.rope, 256)
    kc, vc = tpaged.init_paged(tcfg.num_layers, 4, tcfg.num_kv_heads,
                               tcfg.head_dim, torch.float32)
    toks = torch.arange(3, 11, dtype=torch.int32)
    args = (tp, tcfg, toks, cos, sin, kc, vc,
            torch.tensor([0]), torch.tensor([0]), torch.tensor([5]),
            torch.tensor([5]), torch.tensor([[1]]))
    two = tllama.ragged_forward(*args, torch.tensor([[1, 2, 4]]))
    assert two.shape == (1, 3, tcfg.vocab_size)
    for j, r in enumerate((1, 2, 4)):
        one = tllama.ragged_forward(*args, torch.tensor([r]))
        np.testing.assert_allclose(two[:, j].numpy(), one.numpy(),
                                   rtol=0, atol=1e-6)
    rng = np.random.default_rng(3)
    extra = torch.from_numpy(rng.standard_normal(
        (8, tcfg.hidden_size)).astype(np.float32) * 0.1)
    is_embed = torch.tensor([False, True, True, False, True, False, False,
                             False])
    inj = tllama.ragged_forward(*args, torch.tensor([4]),
                                inject=(extra, is_embed))
    pk, pv = tllama.init_kv_cache(tcfg, 1, 16)
    want = tllama.prefill(tp, tcfg, toks[None, :5], torch.tensor([5]), cos,
                          sin, pk, pv, torch.tensor([0]),
                          inject=(extra[None, :5], is_embed[None, :5]))
    np.testing.assert_allclose(inj.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    plain = tllama.ragged_forward(*args, torch.tensor([4]))
    assert np.abs(inj.numpy() - plain.numpy()).max() > 1e-3
    # the KV tier runs now: sentinel geometry gives the untiered forward
    sent = {"sb": torch.tensor([1]), "rw": torch.tensor([1]),
            "sinks": torch.tensor([1 << 20]), "window": torch.tensor([1 << 20])}
    np.testing.assert_array_equal(
        tllama.ragged_forward(*args, torch.tensor([0]), kvt=sent).numpy(),
        tllama.ragged_forward(*args, torch.tensor([0])).numpy())


# ----------------------------------------------------- the fused ragged loop

def _stub_loop(tokens_by_step, max_steps=16):
    """build_ragged_loop over stub step functions: step i samples
    tokens_by_step[i] for every slot (lengths advance for live slots)."""
    calls = []

    def ragged_step(params, cos, sin, kc, vc, sampler, last_logits, lengths,
                    pack, is_decode, table):
        calls.append("ragged")
        t = torch.tensor(tokens_by_step[0], dtype=torch.int32)
        return t, t.float(), sampler, last_logits, lengths + is_decode.int()

    def decode(params, cos, sin, kc, vc, sampler, last_logits, lengths,
               active, fast_width, table=None):
        calls.append("decode")
        t = torch.tensor(tokens_by_step[len(calls) - 1], dtype=torch.int32)
        return (t, t.float(), sampler, last_logits,
                lengths + active.int())

    @dataclasses.dataclass
    class _S:
        key: torch.Tensor

    loop = tllama.build_ragged_loop(ragged_step, decode, max_steps=max_steps,
                                    limit=100)
    state = (None, None, None, None, None, _S(torch.zeros((2, 2))),
             torch.zeros((2, 3)), torch.zeros((2,), dtype=torch.int32))
    return loop, state, calls


def _run_stub(tokens_by_step, is_decode, remaining, pending, has_pack):
    loop, state, calls = _stub_loop(tokens_by_step)
    out = loop(*state, torch.tensor(is_decode), torch.tensor(remaining),
               torch.tensor([True, True]), torch.tensor([9]), pending,
               pack={}, has_pack=has_pack)
    toks, _, n_out, steps, code = out[:5]
    return toks, n_out.tolist(), steps, int(code), calls


def test_ragged_loop_exit_codes():
    """The reference's exits and their precedence: the prefill flag ends
    the dispatch after the pack (PREFILL), a finish wins over it (FINISH),
    a slot reaching its budget is a finish, and a loop that never finishes
    runs to the cap (STEPS_CAP). The host reads the stop state every
    _DONE_CHECK_EVERY steps, so a finish at step 2 ends the loop at 8."""
    E = tllama
    seq = [[1, 2]] * 16
    # prefill pending, nobody finished: one iteration, PREFILL
    _, n, steps, code, calls = _run_stub(seq, [True, True], [50, 50], True,
                                         True)
    assert (steps, code, calls, n) == (1, E.RLOOP_EXIT_PREFILL, ["ragged"],
                                       [1, 1])
    # prefill pending and an EOS (token 9) at the pack: FINISH wins
    _, _, steps, code, _ = _run_stub([[9, 2]] + seq, [True, True], [50, 50],
                                     True, True)
    assert (steps, code) == (1, E.RLOOP_EXIT_FINISH)
    # slot 0's budget (3 tokens) ends it: frozen from then on, the loop
    # stops at the next host check, slot 1 ran every step
    _, n, steps, code, _ = _run_stub(seq, [True, True], [3, 50], False, True)
    assert (steps, code, n) == (8, E.RLOOP_EXIT_FINISH, [3, 8])
    # no stop: the cap, pack + 15 decode steps
    _, n, steps, code, calls = _run_stub(seq, [True, True], [50, 50], False,
                                         True)
    assert (steps, code, n) == (16, E.RLOOP_EXIT_STEPS_CAP, [16, 16])
    assert calls == ["ragged"] + ["decode"] * 15
    # pack-free: only active slots decode; no ragged step
    _, n, steps, code, calls = _run_stub(seq, [False, True], [50, 50], False,
                                         False)
    assert (steps, n, calls[0]) == (16, [0, 16], "decode")


# ----------------------------------------------------------- the engines

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ckpt = tiny_checkpoint(tmp_path_factory)
    jcfg, jp, jtok = jloader.load_model(ckpt, dtype="float32")
    tcfg, tp, ttok = tloader.load_model(ckpt, dtype="float32", device="cpu")
    return (jcfg, jp, jtok), (tcfg, tp, ttok), ckpt


def _ec(**kw):
    """tests/test_ragged_loop.py's engine shape."""
    return dict(dict(max_slots=4, max_context=128, prefill_buckets=(16, 64),
                     prefill_chunk=16, kv_pages=10, prompt_cache=False), **kw)


def _mixed_reqs(vocab, req_cls, param_cls, n_tok=10):
    """tests/test_ragged_loop.py's stream: mixed lengths, greedy and seeded
    sampled (top-p, top-k)."""
    rng = np.random.default_rng(0)
    lens = (5, 12, 33, 7, 21, 3)
    sps = [dict(temperature=0.0), dict(temperature=0.8, seed=11),
           dict(temperature=0.7, top_p=0.9, seed=3), dict(temperature=0.0),
           dict(temperature=1.0, top_k=5, seed=7), dict(temperature=0.0)]
    return [req_cls(rng.integers(5, vocab, n).tolist(), param_cls(**sp),
                    max_tokens=n_tok, ignore_eos=True)
            for n, sp in zip(lens, sps)]


def _run_stream(eng, req_cls, param_cls, vocab):
    """Three requests, three ticks, then three more admitted mid-decode."""
    reqs = _mixed_reqs(vocab, req_cls, param_cls)
    outs = [eng.submit(r) for r in reqs[:3]]
    for _ in range(3):
        eng.step()
    outs += [eng.submit(r) for r in reqs[3:]]
    for _ in range(500):
        if not eng.step():
            break
    toks = []
    for _, q in outs:
        seq = []
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                seq.append(o.token_id)
        toks.append(seq)
    return toks, dict(eng.metrics)


@pytest.fixture(scope="module")
def dense_paged_streams(models):
    (_, _, _), (tcfg, tp, ttok), _ = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**_ec()), device="cpu")
    return _run_stream(eng, TRequest, TParams, tcfg.vocab_size)[0]


@pytest.mark.parametrize("loop_steps", [0, 16])
def test_ragged_streams_equal_reference_engine(models, dense_paged_streams,
                                               loop_steps):
    """Acceptance: the port's ragged engine emits the JAX ragged engine's
    token streams (greedy + seeded top-p/top-k, mid-decode admissions),
    single-step and fused, and the port's dense paged engine's too."""
    (jcfg, jp, jtok), (tcfg, tp, ttok), _ = models
    ec = _ec(ragged_token_budget=64, ragged_loop_steps=loop_steps)
    ref, _ = _run_stream(JEngine(jcfg, jp, jtok, JConfig(**ec)), JRequest,
                         JParams, jcfg.vocab_size)
    got, m = _run_stream(TEngine(tcfg, tp, ttok, TConfig(**ec),
                                 device="cpu"),
                         TRequest, TParams, tcfg.vocab_size)
    assert all(len(s) == 10 for s in got)
    assert got == ref
    assert got == dense_paged_streams
    assert m["ragged_dispatches"] > 0
    assert m["ragged_tokens_packed"] > m["ragged_dispatches"]
    assert m["ragged_prefill_tokens"] == 5 + 12 + 33 + 7 + 21 + 3
    assert 0 < m["budget_utilization"] <= 1
    exits = {k: v for k, v in m.items() if k.startswith("rloop_exit_")}
    if loop_steps:
        # finishes always; prefill exits from the mid-decode admissions
        assert exits["rloop_exit_finish"] > 0 and \
            exits["rloop_exit_prefill"] > 0, exits
        assert m["tokens_by_path__ragged"] > 0
        assert m["decode_steps_dispatched"] > m["decode_dispatches"]
    else:
        assert not any(exits.values()), exits


@pytest.fixture(scope="module")
def models_g7(tmp_path_factory):
    """A tiny checkpoint at GQA group size 7 (7 query heads on one KV
    head, head_dim 16): Qwen2-7B's group."""
    ckpt = tiny_checkpoint(tmp_path_factory, heads=7, kv_heads=1, hidden=112)
    jcfg, jp, jtok = jloader.load_model(ckpt, dtype="float32")
    tcfg, tp, ttok = tloader.load_model(ckpt, dtype="float32", device="cpu")
    assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim) == (7, 1, 16)
    return (jcfg, jp, jtok), (tcfg, tp, ttok)


def test_ragged_streams_equal_reference_engine_g7(models_g7):
    """At G = 7 the port's ragged engine (fused loop on) emits the JAX
    ragged engine's token streams, greedy and seeded-sampled, mid-decode
    admissions included."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models_g7
    ec = _ec(ragged_token_budget=64, ragged_loop_steps=16)
    ref, _ = _run_stream(JEngine(jcfg, jp, jtok, JConfig(**ec)), JRequest,
                         JParams, jcfg.vocab_size)
    got, m = _run_stream(TEngine(tcfg, tp, ttok, TConfig(**ec),
                                 device="cpu"),
                         TRequest, TParams, tcfg.vocab_size)
    assert all(len(s) == 10 for s in got)
    assert got == ref
    assert m["ragged_dispatches"] > 0
    assert m["ragged_prefill_tokens"] == 5 + 12 + 33 + 7 + 21 + 3


def test_admission_packs_first_chunk_in_the_same_tick(models):
    """A chunked admission's first window rides the same tick's ragged
    dispatch: after one step() of a 40-token prompt, 16 tokens (the
    prefill_chunk) are packed, and the stream equals the dense paged
    engine's."""
    (_, _, _), (tcfg, tp, ttok), _ = models
    prompt = np.random.default_rng(1).integers(5, tcfg.vocab_size,
                                               40).tolist()

    def run(**kw):
        eng = TEngine(tcfg, tp, ttok, TConfig(**_ec(**kw)), device="cpu")
        _, q = eng.submit(TRequest(prompt, TParams(temperature=0.0),
                                   max_tokens=4, ignore_eos=True))
        eng.step()
        m = dict(eng.metrics)
        for _ in range(100):
            if not eng.step():
                break
        ids = []
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                ids.append(o.token_id)
        return ids, m

    ids, m = run(ragged_token_budget=64)
    assert m["ragged_dispatches"] == 1
    assert m["ragged_tokens_packed"] == 16
    ref, _ = run()
    assert ids == ref and len(ids) == 4


def test_stop_string_takes_the_single_step(models):
    """A stop-string slot needs a host decision per token: ticks with it
    decline the fused loop (rloop_exit_host_arbitration) and still stream
    the same tokens."""
    (_, _, _), (tcfg, tp, ttok), _ = models

    def run(stop):
        eng = TEngine(tcfg, tp, ttok, TConfig(**_ec(ragged_token_budget=64)),
                      device="cpu")
        outs = [eng.submit(TRequest([3, 4, 5, 6, 7], TParams(temperature=0.0),
                                    max_tokens=8, ignore_eos=True,
                                    stop=stop))]
        eng.step()
        outs.append(eng.submit(TRequest(list(range(5, 40)),
                                        TParams(temperature=0.0),
                                        max_tokens=6, ignore_eos=True)))
        for _ in range(200):
            if not eng.step():
                break
        ids = [[] for _ in outs]
        for j, (_, q) in enumerate(outs):
            while not q.empty():
                o = q.get_nowait()
                if o.token_id >= 0:
                    ids[j].append(o.token_id)
        return ids, eng.metrics

    got, m = run(("zzzz-never",))
    ref, m0 = run(())
    assert got == ref
    assert m["rloop_exit_host_arbitration"] > 0
    assert m0["rloop_exit_host_arbitration"] == 0


def test_int8_recipe_serves(models):
    """The int8 recipe (int8 weights, int8 KV) on a ragged engine: every
    request finishes with its tokens, through mixed ragged ticks."""
    (_, _, _), (_, _, ttok), ckpt = models
    tcfg, tp, _ = tloader.load_model(ckpt, dtype="int8", device="cpu")
    eng = TEngine(tcfg, tp, ttok, TConfig(**_ec(ragged_token_budget=64,
                                                cache_type="int8")),
                  device="cpu")
    got, m = _run_stream(eng, TRequest, TParams, tcfg.vocab_size)
    assert [len(s) for s in got] == [10] * 6
    assert m["ragged_dispatches"] > 0 and m["rloop_exit_finish"] > 0


def test_ragged_requires_paged_kv(models):
    (_, _, _), (tcfg, tp, ttok), _ = models
    with pytest.raises(ValueError, match="paged"):
        TEngine(tcfg, tp, ttok, TConfig(max_slots=2, max_context=128,
                                        prefill_buckets=(16,),
                                        ragged_token_budget=64),
                device="cpu")


def test_draft_and_grammar_wait_for_their_slices(models):
    """A draft model is served on the ragged engine (spec-as-ragged; with
    draft = target every proposal is accepted and the stream is the plain
    engine's greedy one — tests/test_torch_spec.py holds it to the JAX
    engine); a grammar request is served on the ragged engine (its tokens
    are the grammar's: tests/test_torch_grammar.py holds them to the JAX
    engine)."""
    (_, _, _), (tcfg, tp, ttok), _ = models
    ec = TConfig(**_ec(ragged_token_budget=64))
    req = TRequest([3, 4, 5], TParams(temperature=0.0), max_tokens=12,
                   ignore_eos=True)
    spec = TEngine(tcfg, tp, ttok, ec, draft=(tcfg, tp), device="cpu")
    plain = TEngine(tcfg, tp, ttok, ec, device="cpu")
    assert spec.generate_text(req) == plain.generate_text(req)
    m = spec.metrics
    assert m["spec_ragged_dispatches"] > 0
    assert m["draft_accepted"] == m["draft_proposed"] > 0
    eng = TEngine(tcfg, tp, ttok, ec, device="cpu")
    a = ttok.encode("a", add_bos=False)
    assert len(a) == 1
    outs = list(eng.generate(TRequest([3, 4], TParams(temperature=0.0),
                                      max_tokens=8,
                                      grammar='root ::= "a"+')))
    ids = [o.token_id for o in outs if o.token_id >= 0]
    assert outs[-1].finished and ids
    assert all(t == a[0] or t in ttok.eos_ids for t in ids)
    assert eng.metrics["grammar_table_states"] > 1
