"""Tensor parallelism in the PyTorch port (localai_tpu_torch/parallel,
models/llama.shard_params and the sharded loads, the six `*_sharded`
kernel wrappers, the engine's broadcast/follow protocol, the worker role
and LoadModel(mesh_model=2)) against the JAX package, on the CPU.

- Shard placement: each rank's slices equal the addressable shards of the
  reference's sharded load (param_specs on a model=2 host mesh), f32 and
  int8, tied and untied heads: EXACT.
- The six wrappers run per KV-head shard and joined equal the reference's
  unsharded Pallas kernels (interpret mode): the scatters EXACT, attention
  within 2e-5 (f32, another summation order).
- Engines (f32): greedy streams EQUAL the reference's single-device engine
  and its model=2 mesh engine, dense, paged and ragged. The int8 recipe
  (int8 weights, bf16 activations, int8 KV): EQUAL the port's one-rank
  streams and the reference's single-device streams under
  LOCALAI_FORCE_PALLAS=1 (the int8-KV kernels in f32, as the port's).
  A two-process gloo world (one test, its own env, spawned like
  tests/test_distributed.py) serves them; its followers exit 0.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

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
from localai_tpu.ops.pallas import paged_scatter as pps
from localai_tpu.ops.pallas import ragged_attention as pra
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu.parallel import mesh as jmesh
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops.kvcache import quantize_tokens
from localai_tpu_torch.ops.quant import QuantWeight
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from localai_tpu_torch.parallel import distributed as tdist
from localai_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=2e-5, atol=2e-5)
CPU = torch.device("cpu")
NEW = 12


def _rank(r, tp=2):
    """Rank r of a tp-wide model axis, without a process group: its
    shards and its kernels, no collective."""
    return tmesh.Mesh(rank=r, model=tp, device=CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


@pytest.fixture(scope="module")
def tied(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory, tie=True)


# ------------------------------------------------------------ placement

def _jshard(arr, dev):
    for sh in arr.addressable_shards:
        if sh.device == dev:
            return np.asarray(sh.data).astype(np.float32)
    raise KeyError(dev)


def _leaves(params):
    """{(layer or None, name, part): tensor} of a port Llama."""
    out = {(None, "embed", ""): params.embed,
           (None, "final_norm", ""): params.final_norm}
    if params.lm_head is not None:
        h = params.lm_head
        if isinstance(h, QuantWeight):
            out[(None, "lm_head", "q")], out[(None, "lm_head", "s")] = h.q, h.s
        else:
            out[(None, "lm_head", "")] = h
    for i, lp in enumerate(params.layers):
        for n, t in list(lp.named_buffers(recurse=False)) + [
                (n, m) for n, m in lp.named_children()]:
            if isinstance(t, QuantWeight):
                out[(i, n, "q")], out[(i, n, "s")] = t.q, t.s
            else:
                out[(i, n, "")] = t
    return out


def _jleaf(tree, key):
    i, n, part = key
    x = tree[n] if i is None else tree["layers"][n]
    if part:
        x = x[part]
    return x


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("head", ["untied", "tied"])
def test_shards_equal_reference_placement(ckpt, tied, dtype, head):
    """Rank r's slices — from shard_params over the whole load, from the
    sharded load, and from the sharded synthetic load — are the
    addressable shards the reference's sharded load puts on device r."""
    d = ckpt if head == "untied" else tied
    jcfg = jloader.load_config(d, dtype=dtype)
    devs = jax.devices()[:2]
    jm = jmesh.build_mesh(jmesh.MeshConfig(data=1, model=2), devs)
    jtree = jloader.load_params(d, jcfg, dtype=dtype, mesh=jm)
    tcfg = tloader.load_config(d, dtype=dtype)
    whole = tloader.load_params(d, tcfg, dtype=dtype, device="cpu")
    assert (whole.lm_head is None) == (head == "tied")
    for r in (0, 1):
        m = _rank(r)
        a = _leaves(tllama.shard_params(whole, tcfg, m))
        b = _leaves(tloader.load_params(d, tcfg, dtype=dtype, device="cpu",
                                        mesh=m))
        assert a.keys() == b.keys()
        for key, t in a.items():
            ref = _jleaf(jtree, key)
            want = _jshard(ref, devs[r])
            if key[0] is not None:
                want = want[key[0]]
            np.testing.assert_array_equal(_np(t), want, err_msg=str(key))
            np.testing.assert_array_equal(_np(b[key]), want,
                                          err_msg=str(key))
            assert t.is_contiguous()
    # the synthetic load draws whole layers and keeps the rank's slices
    scfg = dataclasses.replace(tcfg, vocab_size=384)
    q = 8 if dtype == "int8" else None
    full = tloader._synthetic_params(scfg, dtype=torch.float32, device=CPU,
                                     qbits=q)
    for r in (0, 1):
        got = _leaves(tloader._synthetic_params(
            scfg, dtype=torch.float32, device=CPU, qbits=q, mesh=_rank(r)))
        want = _leaves(tllama.shard_params(full, scfg, _rank(r)))
        assert got.keys() == want.keys()
        for key in got:
            assert torch.equal(got[key], want[key]), key


def test_max_model_axis_equals_reference():
    base = jllama.LlamaConfig(vocab_size=128256, hidden_size=4096,
                              intermediate_size=14336, num_layers=2,
                              num_heads=32, num_kv_heads=8, head_dim=128)
    cfgs = [base,
            dataclasses.replace(base, num_heads=28, num_kv_heads=4,
                                intermediate_size=18944, vocab_size=152064),
            dataclasses.replace(base, tie_embeddings=True, vocab_size=5),
            dataclasses.replace(base, num_kv_heads=3, num_heads=6),
            dataclasses.replace(base, num_experts=8),
            dataclasses.replace(base, vocab_size=32003)]
    for jc in cfgs:
        tc = tllama.LlamaConfig(**{f.name: getattr(jc, f.name)
                                   for f in dataclasses.fields(jc)})
        for n in range(1, 9):
            assert tmesh.max_model_axis(tc, n) == jllama.max_model_axis(
                jc, n), (jc, n)


# ------------------------------------------------- the sharded wrappers

def _q8(pool):
    q, s = quantize_tokens(torch.tensor(pool))
    return q, s.reshape(s.shape[0], s.shape[1], 1, 128)


SCATTER = [dict(active=None, sb=None),
           dict(active=[True, False, True, False], sb=None),
           dict(active=[True, True, False, True],
                sb=([4, 1, 1, 0], [1, 2, 2, 3]))]


def _scatter_inputs(seed, B=4, NB=10, KVH=4, D=16, MAXB=4):
    r = np.random.default_rng(seed)
    pk = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    pv = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    kn = r.standard_normal((B, KVH, D)).astype(np.float32)
    vn = r.standard_normal((B, KVH, D)).astype(np.float32)
    table = r.permutation(np.arange(1, NB))[:B * 2].reshape(B, 2)
    table = np.concatenate([table, np.zeros((B, MAXB - 2), int)], 1)
    pos = np.array([0, 127, 200, 255], np.int32)
    return pk, pv, kn, vn, pos, table.astype(np.int32)


def _case(case, lib):
    act = None if case["active"] is None else lib(case["active"])
    if case["sb"] is None:
        return act, None, None
    return (act, lib(np.asarray(case["sb"][0], np.int32)),
            lib(np.asarray(case["sb"][1], np.int32)))


def _heads(x, r, axis=1, tp=2):
    """Rank r's contiguous slice of axis `axis`."""
    n = x.shape[axis] // tp
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(r * n, (r + 1) * n)
    return x[tuple(idx)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("case", SCATTER, ids=["all", "inactive", "ring"])
def test_paged_scatter_sharded_equals_reference(case, q8):
    """paged_scatter_append[_q8]_sharded on each rank's head shard of the
    pool, joined: the reference's unsharded kernel's pool, bit for bit."""
    pk, pv, kn, vn, pos, table = _scatter_inputs(11)
    ja, jsb, jrw = _case(case, jnp.asarray)
    ta, tsb, trw = _case(case, torch.tensor)
    if q8:
        kq, ks = _q8(pk)
        vq, vs = _q8(pv)
        pools = [kq, ks, vq, vs]
        ref = pps.paged_scatter_append_q8(
            *(jnp.asarray(t.numpy()) for t in pools), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(pos), jnp.asarray(table), ja,
            sb=jsb, rw=jrw)
    else:
        pools = [torch.tensor(pk), torch.tensor(pv)]
        ref = pps.paged_scatter_append(
            jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(pos), jnp.asarray(table), ja,
            sb=jsb, rw=jrw)
    shards = []
    for r in (0, 1):
        mine = [_heads(p, r).clone() for p in pools]
        fn = (tk.paged_scatter_append_q8_sharded if q8
              else tk.paged_scatter_append_sharded)
        out = fn(_rank(r), *mine, _heads(torch.tensor(kn), r),
                 _heads(torch.tensor(vn), r), torch.tensor(pos),
                 torch.tensor(table), ta, sb=tsb, rw=trw)
        assert all(o is m for o, m in zip(out, mine))       # in place
        shards.append(mine)
    for i, want in enumerate(ref):
        joined = torch.cat([s[i] for s in shards], dim=1)
        np.testing.assert_array_equal(_np(joined), np.asarray(want))


def _stream(seed, H=8, KVH=4, D=16, NB=12, MAXB=3):
    """tests/test_torch_ragged.py's flat stream at 4 KV heads (2 a rank):
    two decode rows, a 12-token chunk at offset 128, a full 8-token chunk,
    a dead block."""
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


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("window", [None, 100])
def test_ragged_attention_sharded_equals_reference(monkeypatch, q8, window):
    """ragged_paged_attention[_q8]_sharded on each rank's query heads and
    KV-head shard, joined on the head axis: the reference's unsharded
    Pallas kernel (interpret mode) on the live rows, within 2e-5."""
    monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    q, k, v, meta, live = _stream(3)
    jmeta = {n: jnp.asarray(a) for n, a in meta.items()}
    tmeta = {n: torch.tensor(a) for n, a in meta.items()}
    if q8:
        pools = [*_q8(k), *_q8(v)]
        ref = pra.ragged_paged_attention_q8(
            jnp.asarray(q), *(jnp.asarray(t.numpy()) for t in pools),
            **jmeta, sliding_window=window)
        fn = tk.ragged_paged_attention_q8_sharded
    else:
        pools = [torch.tensor(k), torch.tensor(v)]
        ref = pra.ragged_paged_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **jmeta,
                                         sliding_window=window)
        fn = tk.ragged_paged_attention_sharded
    tk.reset_launch_counts()
    outs = [fn(_rank(r), _heads(torch.tensor(q), r),
               *(_heads(p, r) for p in pools), **tmeta,
               sliding_window=window) for r in (0, 1)]
    assert not any(tk.launch_counts().values())   # CPU: the plain versions
    joined = torch.cat(outs, dim=1)
    np.testing.assert_allclose(_np(joined)[live], _np(ref)[live], **F32)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_ragged_scatter_sharded_equals_reference(q8):
    """ragged_scatter_append[_q8]_sharded per rank, joined: the reference's
    unsharded kernel's pools outside the trash block 0 (padding rows
    collide there by design), bit for bit."""
    r = np.random.default_rng(5)
    T, NB, KVH, D = 160, 10, 4, 16
    k = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    v = r.standard_normal((NB, KVH, 128, D)).astype(np.float32)
    kn = r.standard_normal((T, KVH, D)).astype(np.float32)
    vn = r.standard_normal((T, KVH, D)).astype(np.float32)
    live = r.random(T) < 0.6
    slots = r.permutation((NB - 1) * 128)[:T]
    pb = np.where(live, 1 + slots // 128, 0).astype(np.int32)
    off = np.where(live, slots % 128, np.arange(T) % 128).astype(np.int32)
    if q8:
        pools = [*_q8(k), *_q8(v)]
        ref = pra.ragged_scatter_append_q8(
            *(jnp.asarray(t.numpy()) for t in pools), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(pb), jnp.asarray(off))
        fn = tk.ragged_scatter_append_q8_sharded
    else:
        pools = [torch.tensor(k), torch.tensor(v)]
        ref = pra.ragged_scatter_append(
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(pb), jnp.asarray(off))
        fn = tk.ragged_scatter_append_sharded
    shards = []
    for rk in (0, 1):
        mine = [_heads(p, rk).clone() for p in pools]
        fn(_rank(rk), *mine, _heads(torch.tensor(kn), rk),
           _heads(torch.tensor(vn), rk), torch.tensor(pb), torch.tensor(off))
        shards.append(mine)
    for i, want in enumerate(ref):
        joined = torch.cat([s[i] for s in shards], dim=1)
        np.testing.assert_array_equal(_np(joined)[1:], np.asarray(want)[1:])


def test_sharded_wrappers_refuse_another_ranks_shapes():
    """A wrapper takes one rank's shards: rows of another head count than
    the pool shard, or a rank off the axis, raise."""
    pk, pv, kn, vn, pos, table = _scatter_inputs(2)
    with pytest.raises(ValueError, match="shard"):
        tk.paged_scatter_append_sharded(
            _rank(0), torch.tensor(pk[:, :2]), torch.tensor(pv[:, :2]),
            torch.tensor(kn), torch.tensor(vn), torch.tensor(pos),
            torch.tensor(table))
    with pytest.raises(ValueError, match="outside the model axis"):
        tk.ragged_scatter_append_sharded(
            tmesh.Mesh(rank=2, model=2, device=CPU), torch.tensor(pk),
            torch.tensor(pv), torch.tensor(kn), torch.tensor(vn),
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))


# ------------------------------------------- the replay protocol, in-process

def test_follower_replays_rank0_dispatches(ckpt):
    """One-rank meshes (no collective) in one process: a rank-0 engine with
    a Replicator and a follower engine replaying its stream in a thread.
    After a paged run with admission, chunked prefill and the fused loop,
    the follower's pool, lengths, logits and sampler equal rank 0's, bit
    for bit, and rank 0's streams equal an engine without a mesh."""
    cfg, params, tok = tloader.load_model(ckpt, dtype="float32",
                                          device="cpu")
    ec = dict(max_slots=2, max_context=256, prefill_buckets=(16,),
              prefill_chunk=16, kv_pages=8)
    m0, m1 = tmesh.Mesh(0, 1, CPU), tmesh.Mesh(0, 1, CPU)
    rep = tdist.Replicator(0, 1, token="t")
    box = {}

    def follow():
        chan = tdist.Follower(f"127.0.0.1:{rep.port}", token="t")
        op, kw = chan.recv()
        assert op == "engine"
        eng = TEngine(cfg, tllama.shard_params(params, cfg, m1), tok,
                      TConfig(**kw, mesh=m1), device="cpu")
        box["eng"] = eng
        eng.follow(chan)
        chan.close()

    t = threading.Thread(target=follow)
    t.start()
    from localai_tpu_torch.core.worker import engine_fields

    conf = TConfig(**ec, mesh=m0, replicator=rep)
    e0 = TEngine(cfg, tllama.shard_params(params, cfg, m0), tok, conf,
                 device="cpu")
    rep.wait_for_followers()
    rep.broadcast("engine", engine_fields(conf))
    plan = [(tok.encode("pack my box with five dozen liquor jugs " * 2),
             dict(temperature=0.0)),
            (tok.encode("hello world"), dict(temperature=0.8, seed=5))]

    def run(eng):
        qs = [eng.submit(TRequest(list(p), TParams(**sp), max_tokens=NEW,
                                  ignore_eos=True))[1] for p, sp in plan]
        while eng.step():
            pass
        return [_drain(q) for q in qs]

    got = run(e0)
    rep.close()
    t.join(timeout=60)
    assert not t.is_alive()
    e1 = box["eng"]
    for a, b in ((e0._kc, e1._kc), (e0._vc, e1._vc),
                 (e0._lengths, e1._lengths),
                 (e0._last_logits, e1._last_logits),
                 (e0._sampler.key, e1._sampler.key),
                 (e0._sampler.token_counts, e1._sampler.token_counts)):
        assert torch.equal(a, b)
    assert e1.graphs.counters()["paged"]["eager_segments"] > 0
    want = run(TEngine(cfg, params, tok, TConfig(**ec), device="cpu"))
    assert got == want and [len(s) for s in got] == [NEW, NEW]


def _drain(q):
    toks = []
    while not q.empty():
        o = q.get_nowait()
        if o.token_id >= 0:
            toks.append(o.token_id)
    return toks


def test_replicator_refuses_a_wrong_token(monkeypatch):
    monkeypatch.delenv("LOCALAI_REPLICATE_TOKEN", raising=False)
    rep = tdist.Replicator(0, 1, token="right")
    addr = f"127.0.0.1:{rep.port}"
    bad = tdist.Follower(addr, token="wrong")
    good = tdist.Follower(addr, token="right")
    rep.wait_for_followers()
    assert len(rep._conns) == 1
    rep.broadcast("decode", {"active": np.ones(2, bool)})
    op, kw = good.recv()
    assert op == "decode" and kw["active"].tolist() == [True, True]
    with pytest.raises(ConnectionError):
        bad.recv()
    rep.close()
    assert good.recv() == ("stop", {})
    good.close()
    bad.close()


def test_follower_failure_ends_the_world(ckpt):
    """A follower whose replay of an op fails reports it to rank 0 and
    raises (its process exits non-zero); rank 0's next broadcast raises
    FollowerFailed, and a rank-0 engine loop then stops for good: every
    stream ends in "error" and no restart pairs the ranks' collectives
    anew."""
    cfg, params, tok = tloader.load_model(ckpt, dtype="float32",
                                          device="cpu")
    m0, m1 = tmesh.Mesh(0, 1, CPU), tmesh.Mesh(0, 1, CPU)
    ec = dict(max_slots=2, max_context=128, prefill_buckets=(16,),
              kv_pages=4)
    rep = tdist.Replicator(0, 1, token="t")
    chan = tdist.Follower(f"127.0.0.1:{rep.port}", token="t")
    rep.wait_for_followers()
    rep.broadcast("no_such_op", {})
    e1 = TEngine(cfg, tllama.shard_params(params, cfg, m1), tok,
                 TConfig(**ec, mesh=m1), device="cpu")
    with pytest.raises(ValueError, match="unknown op 'no_such_op'"):
        e1.follow(chan)
    with pytest.raises(tdist.FollowerFailed,
                       match="follower 1 failed op 'no_such_op'"):
        rep.broadcast("decode", {})
    e0 = TEngine(cfg, tllama.shard_params(params, cfg, m0), tok,
                 TConfig(**ec, mesh=m0, replicator=rep), device="cpu")
    e0.start()
    try:
        _, q = e0.submit(TRequest(tok.encode("hello world"),
                                  TParams(temperature=0.0), max_tokens=NEW,
                                  ignore_eos=True))
        last = q.get(timeout=60)
        while not last.finished:
            last = q.get(timeout=60)
        assert last.finish_reason == "error"
        e0._thread.join(timeout=60)
        with pytest.raises(RuntimeError, match="terminated"):
            e0.submit(TRequest([3, 4], TParams(), max_tokens=2))
    finally:
        e0.stop()
        rep.close()
        chan.close()


# --------------------------------------------------- what stays refused

def test_left_out_combinations_raise(ckpt):
    """Every combination left for a later slice raises NotImplementedError
    naming the parallel slice."""
    for kw in (dict(data=2), dict(seq=2), dict(pipe=2)):
        with pytest.raises(NotImplementedError, match="parallel slice"):
            tmesh.MeshConfig(model=2, **kw)
    cfg, params, tok = tloader.load_model(ckpt, dtype="float32",
                                          device="cpu")
    m = tmesh.Mesh(0, 1, CPU)
    sp = tllama.shard_params(params, cfg, m)
    base = dict(max_slots=2, max_context=256, prefill_buckets=(16,))
    cases = [
        dict(ec=dict(kv_pages=8, kv_policy="sink_window(sinks=0, "
                     "window=64)")),
        dict(ec=dict(kv_pages=8, kv_host_bytes=1 << 20)),
        dict(ec=dict(replicator=object()), mesh=None),
        dict(draft=(cfg, params)),
    ]
    for c in cases:
        mesh = c.get("mesh", m)
        with pytest.raises(NotImplementedError, match="parallel slice"):
            TEngine(cfg, sp if mesh is not None else params, tok,
                    TConfig(**base, **c.get("ec", {}), mesh=mesh),
                    draft=c.get("draft"), device="cpu")
    eng = TEngine(cfg, sp, tok, TConfig(**base, mesh=m), device="cpu")
    for field, value in (("context_shift", True),
                         ("prompt_cache_path", "/nonexistent/x.npz"),
                         ("grammar", 'root ::= "a"'),
                         ("resume", {"emitted": 0})):
        with pytest.raises(NotImplementedError, match="parallel slice"):
            eng.submit(TRequest([3, 4], max_tokens=2, **{field: value}))
    with pytest.raises(NotImplementedError, match="parallel slice"):
        eng.preempt()
    with pytest.raises(NotImplementedError, match="parallel slice"):
        tllama.shard_params(params, dataclasses.replace(cfg, num_experts=4),
                            m)
    with pytest.raises(NotImplementedError, match="parallel slice"):
        tloader.load_params(ckpt, tloader.load_config(ckpt, dtype="int4"),
                            dtype="int4", device="cpu", mesh=m)
    with pytest.raises(NotImplementedError, match="parallel slice"):
        tdist.init_distributed("10.1.2.3:1234", 2, 0, device="cpu")
    # an unsharded model refuses a mesh engine, and a sharded one a mesh
    # it was not sharded on
    with pytest.raises(ValueError, match="sharded"):
        TEngine(cfg, params, tok, TConfig(**base, mesh=m), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tllama.shard_params(params, cfg, tmesh.Mesh(0, 3, CPU))


# ------------------------------------------ a two-process world, end to end

_WORLD = r"""
import json, sys, threading
import torch
torch.set_num_threads(1)
ckpt, plan_path, out_path = sys.argv[1:4]
plan = json.load(open(plan_path))
from localai_tpu_torch.backend import pb
from localai_tpu_torch.backend.llm import LLMServicer
from localai_tpu_torch.core.worker import World
from localai_tpu_torch.core.worker import engine_fields
from localai_tpu_torch.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.loader import (
    load_config, load_params, load_tokenizer)
from localai_tpu_torch.ops.sampling import SamplingParams

reqs = plan["requests"]
out = {}
for leg in plan["legs"]:
    name, dtype, pages = leg["name"], leg["dtype"], leg["kv_pages"]
    kv = "int8" if dtype == "int8" else ""
    if not leg["ragged"]:
        s = LLMServicer(device="cpu")
        r = s.LoadModel(pb.ModelOptions(
            model=ckpt, dtype=dtype, mesh_model=2, parallel=2,
            context_size=128, prefill_buckets=[16], kv_pages=pages,
            cache_type_key=kv), None)
        assert r.success, r.message
        streams = [None] * len(reqs)

        def one(i, q):
            rep = s.Predict(pb.PredictOptions(
                prompt_ids=q["ids"], tokens=q["n"], ignore_eos=True,
                **q["sampling"]), None)
            streams[i] = list(rep.token_ids)

        ts = [threading.Thread(target=one, args=(i, q))
              for i, q in enumerate(reqs)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        eager = s.engine.graphs.counters()
        codes = s.free()
        outputs = s.follower_output
    else:
        world = World(ckpt, dtype, 2, "cpu")
        cfg = load_config(ckpt, dtype=dtype)
        params = load_params(ckpt, cfg, dtype=dtype, device="cpu",
                             mesh=world.mesh)
        ec = EngineConfig(**plan["ragged_ec"], cache_type=kv,
                          mesh=world.mesh, replicator=world.replicator)
        eng = Engine(cfg, params, load_tokenizer(ckpt), ec, device="cpu")
        world.replicator.wait_for_followers()
        world.replicator.broadcast("engine", engine_fields(ec))
        qs = [eng.submit(GenRequest(q["ids"], SamplingParams(**q["sampling"]),
                                    max_tokens=q["n"], ignore_eos=True))[1]
              for q in reqs]
        while eng.step():
            pass
        streams = []
        for q in qs:
            toks = []
            while not q.empty():
                o = q.get_nowait()
                if o.token_id >= 0:
                    toks.append(o.token_id)
            streams.append(toks)
        eager = eng.graphs.counters()
        metrics = dict(eng.metrics)
        codes = world.close()
        outputs = world.outputs
        assert metrics["ragged_dispatches"] > 0, metrics
    out[name] = dict(streams=streams, codes=codes, eager=eager,
                     outputs=outputs)
json.dump(out, open(out_path, "w"))
print("WORLD_DONE", flush=True)
"""

RAGGED_EC = dict(max_slots=2, max_context=256, prefill_buckets=(16,),
                 prefill_chunk=16, kv_pages=8, ragged_token_budget=32)
LEGS = [dict(name=f"{path}-{dtype}", dtype=dtype,
             kv_pages=0 if path == "dense" else 8, ragged=path == "ragged")
        for dtype in ("float32", "int8")
        for path in ("dense", "paged", "ragged")]


def _requests(tok):
    return [dict(ids=tok.encode("pack my box with five dozen liquor jugs "
                                "and the quick brown fox"), n=NEW,
                 sampling=dict(temperature=0.0)),
            dict(ids=tok.encode("hello world"), n=NEW,
                 sampling=dict(temperature=0.8, seed=7, top_k=5,
                               top_p=0.9))]


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["LOCALAI_NO_PREWARM"] = "0"
    # one intra-op thread in rank 0 and in the followers it starts
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def world(ckpt, tmp_path_factory):
    """The six legs served by one rank-0 script (LoadModel(mesh_model=2,
    device="cpu") for dense and paged, the worker role's world with a
    ragged EngineConfig for ragged), each leg a follower process."""
    tok = tloader.load_tokenizer(ckpt)
    tmp = tmp_path_factory.mktemp("tpworld")
    plan = dict(legs=LEGS, requests=_requests(tok), ragged_ec=RAGGED_EC)
    (tmp / "plan.json").write_text(json.dumps(plan))
    out = tmp / "out.json"
    r = subprocess.run([sys.executable, "-c", _WORLD, ckpt,
                        str(tmp / "plan.json"), str(out)], env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "WORLD_DONE" in r.stdout, \
        (r.stdout[-3000:], r.stderr[-3000:])
    return json.loads(out.read_text()), plan


def _engine_ec(leg):
    if leg["ragged"]:
        return dict(RAGGED_EC)
    return dict(max_slots=2, max_context=128, prefill_buckets=(16,),
                prefill_chunk=128, kv_pages=leg["kv_pages"])


def _jstreams(ckpt, dtype, ec, reqs, mesh=None):
    cfg = jloader.load_config(ckpt, dtype=dtype)
    params = jloader.load_params(ckpt, cfg, dtype=dtype, mesh=mesh)
    eng = JEngine(cfg, params, jloader.load_tokenizer(ckpt),
                  JConfig(**ec, mesh=mesh,
                          cache_type="int8" if dtype == "int8" else ""))
    return [[o.token_id for o in eng.generate(JRequest(
        list(q["ids"]), JParams(**q["sampling"]), max_tokens=q["n"],
        ignore_eos=True)) if o.token_id >= 0] for q in reqs]


def _tstreams(ckpt, dtype, ec, reqs):
    cfg, params, tok = tloader.load_model(ckpt, dtype=dtype, device="cpu")
    eng = TEngine(cfg, params, tok,
                  TConfig(**ec, cache_type="int8" if dtype == "int8" else ""),
                  device="cpu")
    qs = [eng.submit(TRequest(list(q["ids"]), TParams(**q["sampling"]),
                              max_tokens=q["n"], ignore_eos=True))[1]
          for q in reqs]
    while eng.step():
        pass
    return [_drain(q) for q in qs]


@pytest.mark.parametrize("leg", LEGS, ids=[g["name"] for g in LEGS])
def test_two_rank_world_streams(world, ckpt, leg, monkeypatch):
    """The two-rank world's streams: every request to its budget; f32
    greedy equal to the reference's single-device engine and its model=2
    mesh engine (the seeded one to its single-device engine); the int8
    recipe's equal to the port's one-rank engine and, greedy, to the
    reference under LOCALAI_FORCE_PALLAS=1; the segments ran eagerly; the
    follower exited 0 with no traceback in its output."""
    got, plan = world
    res = got[leg["name"]]
    reqs = plan["requests"]
    assert res["codes"] == [0]
    assert len(res["outputs"]) == 1 and "Traceback" not in res["outputs"][0]
    path = ("rloop" if leg["ragged"] else "paged" if leg["kv_pages"]
            else "dense")
    assert res["eager"][path]["eager_segments"] > 0
    streams = res["streams"]
    assert [len(s) for s in streams] == [q["n"] for q in reqs]
    ec = _engine_ec(leg)
    if leg["dtype"] == "float32":
        assert streams == _jstreams(ckpt, "float32", ec, reqs)
        jm = jmesh.build_mesh(jmesh.MeshConfig(data=1, model=2),
                              jax.devices()[:2])
        assert streams[0] == _jstreams(ckpt, "float32", ec, reqs[:1],
                                       mesh=jm)[0]
    else:
        assert streams == _tstreams(ckpt, "int8", ec, reqs)
        monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
        assert streams[0] == _jstreams(ckpt, "int8", ec, reqs[:1])[0]
