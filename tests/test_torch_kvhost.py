"""The PyTorch port's host KV spill tier (localai_tpu_torch.engine.kvhost,
the Engine's spill and readmit ops and its allocator hooks) against the
JAX package.

- HostKVPool: the same operation scripts (the scenarios of
  tests/test_kvhost.py and tests/test_preempt.py) on both pools give equal
  return values, stats, eviction order and digests; the threaded
  spill/evict stress runs on the port's pool alone.
- The spill and readmit ops on the same pool content: from an int8 pool
  the spilled block equals the reference's byte for byte; from an f32
  pool the q bytes are equal and the scales within 1 ulp; a readmit
  followed by a spill returns the same bytes (from an f32 pool: the same
  q bytes, the scales within 1 ulp, as the reference's round trip).
- The engine: a follow-up turn whose prefix the device pool reclaimed
  streams the JAX engine's tokens, readmitting from the host tier, with
  equal kv_host_* and prompt counters — paged and ragged, f32 and int8
  pools; a fresh engine adopting the dead engine's pool does the same.

The reference's int8 paged path runs as its own CPU tests run it (its
Pallas kernels in interpret mode, LOCALAI_FORCE_PALLAS=1); its streams are
computed once, in a module fixture.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.engine.kvhost import HostKVBlock as JBlock
from localai_tpu.engine.kvhost import HostKVPool as JPool
from localai_tpu.models import llama as jllama
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.engine.kvhost import HostKVBlock as TBlock
from localai_tpu_torch.engine.kvhost import HostKVPool as TPool
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

# ------------------------------------------------------------ the pools


def _arrays(seed: int):
    """A tiny deterministic block's arrays: 8+16+8+16 = 48 bytes."""
    r = np.random.default_rng(seed)
    return (r.integers(-128, 127, (1, 1, 4, 2)).astype(np.int8),
            r.random((1, 1, 1, 4)).astype(np.float32),
            r.integers(-128, 127, (1, 1, 4, 2)).astype(np.int8),
            r.random((1, 1, 1, 4)).astype(np.float32))


def _jblk(seed=0):
    return JBlock(*_arrays(seed))


def _tblk(seed=0):
    return TBlock(*(torch.from_numpy(a) for a in _arrays(seed)))


BLK = 48


def _h(i: int) -> bytes:
    return i.to_bytes(16, "big")


# Each scenario drives a pool class with a block factory and returns its
# transcript: every return value, membership probe, stats and digest.

def _roundtrip(P, B):
    pool = P(1 << 20)
    t = [pool.accepts(_h(1)), pool.put(_h(1), B(1)), pool.contains(_h(1)),
         len(pool)]
    got = pool.get(_h(1))
    t += [bytes(np.asarray(got.kq).tobytes()), pool.contains(_h(1)),
          pool.get(_h(2)) is None, pool.stats()]
    return t


def _refusals(P, B):
    dead = P(0)
    t = [dead.accepts(_h(1)), dead.put(_h(1), B()), len(dead)]
    pool = P(1 << 20)
    t += [pool.put(_h(1), B()), pool.accepts(_h(1)), pool.put(_h(1), B()),
          len(pool), pool.stats()]
    tiny = P(BLK - 1)
    t += [tiny.put(_h(1), B()), len(tiny), tiny.stats()]
    return t


def _lru_tail_first(P, B):
    pool = P(3 * BLK)
    g1, g2 = _h(100), _h(200)
    t = [pool.put(_h(1), B(1), group=g1), pool.put(_h(2), B(2), group=g1),
         pool.put(_h(3), B(3), group=g2), pool.put(_h(4), B(4), group=g2)]
    t += [[pool.contains(_h(i)) for i in range(1, 6)], pool.stats()]
    pool.get(_h(1))
    t += [pool.put(_h(5), B(5), group=g1),
          [pool.contains(_h(i)) for i in range(1, 6)], pool.digest()]
    return t


def _pins(P, B):
    pool = P(2 * BLK)
    t = [pool.put(_h(1), B(1), group=_h(100)),
         pool.put(_h(2), B(2), group=_h(100)), pool.pin(_h(1)),
         pool.pin(_h(2)), pool.put(_h(3), B(3), group=_h(200))]
    t += [[pool.contains(_h(i)) for i in range(1, 5)], pool.stats()]
    pool.unpin(_h(2))
    t += [pool.put(_h(4), B(4), group=_h(200)),
          [pool.contains(_h(i)) for i in range(1, 5)], pool.pin(_h(99))]
    return t


def _digest(P, B):
    pool = P(1 << 20)
    pool.put(_h(1), B(1), group=_h(100))
    pool.put(_h(2), B(2), group=_h(100))
    pool.put(_h(3), B(3), group=_h(200))
    t = [pool.digest()]
    pool.get(_h(1))
    return t + [pool.digest(k=2), pool.digest(k=1)]


def _claim_refusals(P, B):
    dead = P(0)
    t = [dead.begin_spill(_h(1)), dead.stats()]
    pool = P(1 << 20)
    pool.put(_h(1), B(1))
    t += [pool.begin_spill(_h(1)), pool.begin_spill(_h(2)),
          pool.begin_spill(_h(2)), pool.accepts(_h(2)), pool.stats()]
    t += [pool.end_spill(_h(2), B(2)), pool.contains(_h(2)), pool.stats()]
    return t


def _claim_pins_chain(P, B):
    pool = P(3 * BLK)
    g = _h(100)
    t = [pool.put(_h(1), B(1), group=g), pool.put(_h(2), B(2), group=g),
         pool.begin_spill(_h(3), group=g),
         pool.put(_h(4), B(4), group=_h(200)),
         pool.put(_h(5), B(5), group=_h(200)),
         [pool.contains(_h(i)) for i in range(1, 6)]]
    t += [pool.end_spill(_h(3), B(3)),
          [pool.contains(_h(i)) for i in range(1, 6)], pool.stats(),
          pool.digest()]
    return t


def _claim_abandon(P, B):
    pool = P(1 << 20)
    t = [pool.begin_spill(_h(1)), pool.end_spill(_h(1), None),
         pool.contains(_h(1)), pool.end_spill(_h(2), B(2)),
         pool.contains(_h(2)), pool.end_spill(_h(3), None),
         pool.contains(_h(3)), pool.stats()]
    return t


SCENARIOS = [_roundtrip, _refusals, _lru_tail_first, _pins, _digest,
             _claim_refusals, _claim_pins_chain, _claim_abandon]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__.strip("_") for f in SCENARIOS])
def test_pool_equals_reference(scenario):
    got = scenario(TPool, _tblk)
    want = scenario(JPool, _jblk)
    assert got == want
    assert _tblk(3).nbytes == _jblk(3).nbytes == BLK


def test_spill_evict_race_threaded_stress():
    """Two spillers and a churner on one port pool: no deadlock, no
    exception, and the books balance — budget respected, no claim or pin
    leaked, used_bytes the sum of the resident blocks."""
    pool = TPool(8 * BLK)
    errs = []

    def spiller():
        try:
            for i in range(200):
                h, g = _h(1000 + i), _h(5000 + i // 4)
                if pool.begin_spill(h, group=g):
                    pool.end_spill(h, _tblk(i) if i % 5 else None)
        except Exception as e:          # pragma: no cover - failure path
            errs.append(e)

    def churner():
        try:
            for i in range(200):
                pool.put(_h(2000 + i), _tblk(i), group=_h(6000 + i // 3))
                pool.get(_h(1000 + i))
        except Exception as e:          # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=spiller),
               threading.Thread(target=spiller),
               threading.Thread(target=churner)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "spill/evict stress deadlocked"
    assert not errs, errs
    st = pool.stats()
    assert st["pending_spills"] == 0 and st["bytes"] <= 8 * BLK
    with pool._lock:
        assert sum(e.block.nbytes for e in pool._entries.values()) \
            == pool.used_bytes
        assert all(e.pins == 0 for e in pool._entries.values())


# ------------------------------------------------------------ the engines

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=512, dtype="float32")


@pytest.fixture(scope="module")
def parts():
    jcfg = jllama.LlamaConfig(**TINY)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig(**TINY)
    tp = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _ec(path, cache_type, **kw):
    # kv_pages is tight on purpose: 5 usable blocks barely fit one
    # conversation, so the churn tenants reclaim the released first turn's
    # chain and the host tier is its only home
    ec = dict(max_slots=2, max_context=512, prefill_buckets=(64,),
              prefill_chunk=64, kv_pages=6, prompt_cache=True,
              cache_type=cache_type)
    if path == "ragged":
        ec["ragged_token_budget"] = 64
    ec.update(kw)
    return ec


def _jeng(parts, path, ct, kvhost=None, **kw):
    (jcfg, jp), _ = parts
    return JEngine(jcfg, jp, None, JConfig(**_ec(path, ct, **kw)),
                   kvhost=kvhost)


def _teng(parts, path, ct, kvhost=None, **kw):
    _, (tcfg, tp) = parts
    return TEngine(tcfg, tp, None, TConfig(**_ec(path, ct, **kw)),
                   kvhost=kvhost, device="cpu")


# ------------------------------------------------------ spill and readmit

def _fill(eng_pools, seed):
    """The same random content in both engines' pools (int8 pools: random
    q bytes and positive scales)."""
    r = np.random.default_rng(seed)
    out = []
    for kc in eng_pools:
        if hasattr(kc, "q"):
            q = r.integers(-127, 128, kc.q.shape).astype(np.int8)
            s = (r.random(kc.s.shape) * 0.1 + 1e-3).astype(np.float32)
            out.append((q, s))
        else:
            out.append(r.standard_normal(kc.shape).astype(np.float32))
    return out


@pytest.mark.parametrize("cache_type", ["int8", ""])
def test_spill_and_readmit_ops_equal_reference(parts, cache_type):
    from localai_tpu_torch.ops.kvcache import QuantKV

    jeng = _jeng(parts, "paged", cache_type, kv_host_bytes=1 << 20)
    teng = _teng(parts, "paged", cache_type, kv_host_bytes=1 << 20)
    content = _fill([teng._kc, teng._vc], 3)
    for name, c in zip(("_kc", "_vc"), content):
        cur = getattr(teng, name)
        if isinstance(cur, QuantKV):
            cur.q.copy_(torch.from_numpy(c[0]))
            cur.s.copy_(torch.from_numpy(c[1]))
            setattr(jeng, name, type(getattr(jeng, name))(
                jnp.asarray(c[0]), jnp.asarray(c[1])))
        else:
            cur.copy_(torch.from_numpy(c))
            setattr(jeng, name, jnp.asarray(c))
    for pb in (1, 4):
        want = [np.asarray(a) for a in jeng._spill_fn(
            jeng._kc, jeng._vc, jnp.int32(pb))]
        got = [t.numpy() for t in teng._spill_arrays(pb)]
        assert [g.shape for g in got] == [w.shape for w in want]
        assert [g.dtype for g in got] == [w.dtype for w in want]
        for i in (0, 2):                          # the int8 payloads
            np.testing.assert_array_equal(got[i], want[i])
        for i in (1, 3):                          # the scales
            if cache_type:
                np.testing.assert_array_equal(got[i], want[i])
            else:
                np.testing.assert_array_max_ulp(got[i], want[i], maxulp=1)
        # readmit into another page and spill it again: the same q bytes,
        # and from an int8 pool the same scales; from an f32 pool the
        # dequantized page requantizes to scales within 1 ulp, as the
        # reference's round trip does. The page written equals the
        # reference's readmit.
        blk = TBlock(*(torch.from_numpy(w) for w in want))
        teng._readmit_block(5, b"x" * 16, blk)
        again = [t.numpy() for t in teng._spill_arrays(5)]
        jk, jv = jeng._readmit_fn(jeng._kc, jeng._vc,
                                  *[jnp.asarray(w) for w in want],
                                  jnp.int32(5))
        jeng._kc, jeng._vc = jk, jv
        jagain = [np.asarray(a) for a in jeng._spill_fn(jk, jv, jnp.int32(5))]
        for i, (a, w) in enumerate(zip(again, want)):
            if cache_type or i in (0, 2):
                np.testing.assert_array_equal(a, w)
            else:
                np.testing.assert_array_max_ulp(a, w, maxulp=1)
                np.testing.assert_array_max_ulp(a, jagain[i], maxulp=1)
        for tc, jc in ((teng._kc, jk), (teng._vc, jv)):
            if cache_type:
                np.testing.assert_array_equal(tc.q[:, 5].numpy(),
                                              np.asarray(jc.q[:, 5]))
                np.testing.assert_array_equal(tc.s[:, 5].numpy(),
                                              np.asarray(jc.s[:, 5]))
            else:
                np.testing.assert_array_equal(tc[:, 5].numpy(),
                                              np.asarray(jc[:, 5]))


# ------------------------------------------------------------ readmission

def _run(eng, req_cls, param_cls, ids, n=8):
    _, out = eng.submit(req_cls(prompt_ids=list(ids), max_tokens=n,
                                params=param_cls(temperature=0.0),
                                ignore_eos=True))
    toks = []
    while True:
        eng.step()
        while not out.empty():
            so = out.get()
            if so.token_id >= 0:
                toks.append(so.token_id)
            if so.finished:
                while eng.step():
                    pass
                return toks


_R = np.random.default_rng(7)
T1 = _R.integers(1, 127, 256).tolist()
TAIL = _R.integers(1, 127, 64).tolist()
CHURN = [np.random.default_rng(s).integers(1, 127, 256).tolist()
         for s in range(41, 44)]
# room for 5 int8 blocks of this model (20480 bytes each): the churn
# tenants' spills push the budget, so the pool evicts; the first turn's
# chain is the most recently touched group and survives
BUDGET = 5 * 20480
CACHES = ["", "int8"]
PATHS = ["paged", "ragged"]
COUNTERS = ("kv_host_spills", "kv_host_hits", "kv_host_evictions",
            "kv_host_blocks", "kv_host_bytes", "kv_host_bytes_peak",
            "prompt_tokens_processed", "prompt_tokens_reused")


def _session(make, req_cls, param_cls, restart: bool):
    """Turn 1, three churn tenants that reclaim its chain, then turn 2
    (turn 1 + its reply + 64 new tokens) — on the same engine, or, with
    `restart`, on a fresh one adopting the pool."""
    eng = make(kv_host_bytes=BUDGET)
    g1 = _run(eng, req_cls, param_cls, T1)
    streams = [g1] + [_run(eng, req_cls, param_cls, c, n=4) for c in CHURN]
    eng._host_drain()
    before = eng.kvhost_snapshot()
    if restart:
        eng = make(kvhost=eng._kvhost)
    streams.append(_run(eng, req_cls, param_cls, T1 + g1 + TAIL))
    eng._host_drain()
    return dict(streams=streams, before=before,
                metrics={k: eng.metrics[k] for k in COUNTERS},
                stats=eng.kvhost_snapshot(), digest=eng._kvhost.digest())


@pytest.fixture(scope="module")
def reference(parts):
    out = {}
    for c in CACHES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LOCALAI_FORCE_PALLAS", "1" if c else "0")
            for p in PATHS:
                out[(p, c)] = _session(
                    lambda **kw: _jeng(parts, p, c, **kw), JRequest,
                    JParams, restart=False)
    return out


@pytest.mark.parametrize("cache_type", CACHES)
@pytest.mark.parametrize("path", PATHS)
def test_readmission_equals_reference(parts, reference, path, cache_type):
    """The follow-up turn after device-pool churn readmits the first turn's
    spilled blocks from the host tier: the streams, the pool's books and
    the prompt counters are the JAX engine's."""
    want = reference[(path, cache_type)]
    got = _session(lambda **kw: _teng(parts, path, cache_type, **kw),
                   TRequest, TParams, restart=False)
    assert got["streams"] == want["streams"]
    assert got["metrics"] == want["metrics"]
    assert got["before"] == want["before"] and got["stats"] == want["stats"]
    assert got["digest"] == want["digest"]
    assert got["before"]["spills"] > 0 and got["before"]["evictions"] > 0
    assert got["stats"]["hits"] > 0
    assert got["stats"]["bytes"] <= BUDGET


@pytest.mark.parametrize("path", PATHS)
def test_fresh_engine_adopts_survivor_pool(parts, reference, path):
    """A FRESH engine handed the dead engine's pool readmits its spilled
    int8 blocks (byte-exact): the follow-up turn streams what the JAX
    engine streamed without a restart, with the same prefix covered."""
    want = reference[(path, "int8")]
    got = _session(lambda **kw: _teng(parts, path, "int8", **kw), TRequest,
                   TParams, restart=True)
    assert got["streams"] == want["streams"]
    assert got["stats"]["hits"] == want["stats"]["hits"] > 0
    assert got["metrics"]["prompt_tokens_reused"] >= 128


def test_tier_refusals_and_metrics(parts):
    with pytest.raises(ValueError, match="paged"):
        _teng(parts, "paged", "int8", kv_pages=0, kv_host_bytes=1 << 20)
    with pytest.raises(ValueError, match="paged"):
        _teng(parts, "paged", "int8", kv_pages=0, kvhost=TPool(1 << 20))
    _, (tcfg, tp) = parts
    with pytest.raises(ValueError, match="draft"):
        TEngine(tcfg, tp, None, TConfig(**_ec("paged", "int8",
                                              kv_host_bytes=1 << 20)),
                draft=(tcfg, tp), device="cpu")
    eng = _teng(parts, "paged", "int8", kv_host_bytes=1 << 20)
    assert {k for k in eng.metrics if k.startswith("kv_host_")} == {
        "kv_host_blocks", "kv_host_bytes", "kv_host_bytes_peak",
        "kv_host_hits", "kv_host_spills", "kv_host_evictions"}
    assert _teng(parts, "paged", "int8").kvhost_snapshot() == {}
