"""The PyTorch port's KV lifecycle tier in the Engine against the JAX
package's, on the CPU (the tier's ops and kernels' plain versions:
tests/test_torch_kvtier.py): the port's tiered engines stream the JAX
tiered engines' tokens (f32, greedy and seeded-sampled, mid-stream
arrivals) with equal kv_* counters and kv_blocks_peak — drop with
evictions and an admission-time policy demotion, quantize_cold with
demotions and a full cold pool's evictions, ragged drop with mixed
per-request policies, sink-only prefix borrowing (kv_recomputes) and the
ring-eviction spill into the host pool (equal digests); retention that
covers the context streams the full engine's tokens.
"""
import queue

import numpy as np
import pytest

from fixtures import tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ckpt = tiny_checkpoint(tmp_path_factory, max_position=1024)
    return (jloader.load_model(ckpt, dtype="float32"),
            tloader.load_model(ckpt, dtype="float32", device="cpu"))


EC = dict(max_slots=3, max_context=1024, prefill_buckets=(32,),
          prefill_chunk=64, decode_loop=8, decode_block=4)
DROP = "sink_window(sinks=64, window=128)"
COLD = "sink_window(sinks=64, window=128, quantize_cold=true)"
KV_KEYS = ("kv_cold_blocks", "kv_evictions", "kv_recomputes",
           "kv_policy_demotions", "kv_blocks_peak", "kv_blocks_in_use")


def _plan_reqs(seed, third_policy, third_tokens=320):
    r = np.random.default_rng(seed)
    return [(r.integers(3, 300, 40).tolist(), dict(temperature=0.0), 450,
             ""),
            (r.integers(3, 300, 150).tolist(),
             dict(temperature=0.8, seed=5), 380, ""),
            (r.integers(3, 300, 20).tolist(), dict(temperature=0.0),
             third_tokens, third_policy)]


def _drive(eng, req_cls, param_cls, plan, stagger=2):
    """Submit the plan's requests `stagger` steps apart while stepping the
    engine to the end; the token streams in plan order."""
    outs, pending, steps = [], list(plan), 0
    while pending or any(not d for _, _, d in outs):
        if pending and steps % stagger == 0:
            p, sp, n, pol = pending.pop(0)
            _, q = eng.submit(req_cls(list(p), param_cls(**sp), max_tokens=n,
                                      ignore_eos=True, kv_policy=pol))
            outs.append([q, [], False])
        eng.step()
        steps += 1
        for o in outs:
            while True:
                try:
                    c = o[0].get_nowait()
                except queue.Empty:
                    break
                if c.token_id >= 0:
                    o[1].append(c.token_id)
                if c.finished:
                    o[2] = True
        assert steps < 6000
    return [o[1] for o in outs]


def _both(models, ec, plan):
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    je = JEngine(jcfg, jp, jtok, JConfig(**ec))
    te = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    ref = _drive(je, JRequest, JParams, plan)
    got = _drive(te, TRequest, TParams, plan)
    return (got, {k: te.metrics.get(k) for k in KV_KEYS}, te), \
        (ref, {k: je.metrics.get(k) for k in KV_KEYS}, je)


CASES = {
    # drop with evictions; the third, a full-policy request too long for
    # the compact table, demotes to the engine's window
    "drop": (dict(EC, kv_pages=40, kv_policy=DROP), "full", 640),
    # quantize_cold with demotions beside a full-policy request; the cold
    # pool (2 blocks) fills, and later exits are evicted as the reference
    # counts them
    "cold": (dict(EC, kv_pages=40, kv_cold_pages=3, kv_policy=COLD),
             "full", 320),
    # ragged continuous batching under the drop policy; the third request
    # narrows the window
    "ragged": (dict(EC, kv_pages=40, ragged_token_budget=64,
                    kv_policy=DROP), "sink_window(sinks=0, window=100)", 320),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiered_engine_equals_reference(models, case):
    """The port's tiered engine streams the JAX tiered engine's tokens
    (greedy and seeded-sampled, mid-stream arrivals) with equal kv_*
    counters and kv_blocks_peak."""
    ec, third, n3 = CASES[case]
    (got, gm, te), (ref, rm, _) = _both(models, ec, _plan_reqs(3, third, n3))
    assert got == ref
    assert [len(s) for s in got] == [450, 380, n3]
    assert gm == rm
    if case == "cold":
        assert gm["kv_cold_blocks"] == 2 and gm["kv_evictions"] > 0
    else:
        assert gm["kv_evictions"] > 0
    if case == "drop":
        assert gm["kv_policy_demotions"] == 1
    # a windowed slot's residency stays within the compact table
    assert gm["kv_blocks_peak"] <= ec["max_slots"] * te._kv_resident
    if case == "ragged":
        assert te.metrics["ragged_dispatches"] > 0


def test_retention_covering_context_equals_full_engine(models):
    """sinks + window >= context: nothing leaves retention, so the tiered
    engine's streams are the untiered paged engine's (the ring map and the
    tiered reads are invisible), as tests/test_kvtier.py:253 holds."""
    (_, (tcfg, tp, ttok)) = models
    ec = dict(max_slots=3, max_context=512, prefill_buckets=(32,),
              decode_block=4, decode_loop=8)
    r = np.random.default_rng(3)
    plan = [(r.integers(3, 300, n).tolist(),
             dict(temperature=0.8, seed=10 + i), 24, "")
            for i, n in enumerate((37, 120, 64))]
    full = TEngine(tcfg, tp, ttok, TConfig(kv_pages=16, **ec), device="cpu")
    tier = TEngine(tcfg, tp, ttok, TConfig(
        kv_pages=32, kv_policy="sink_window(sinks=256, window=256)", **ec),
        device="cpu")
    assert _drive(tier, TRequest, TParams, plan) == \
        _drive(full, TRequest, TParams, plan)


def test_prefix_borrowing_and_spill_equal_reference(models):
    """Windowed admissions borrow ONLY whole sink blocks of a shared prefix
    (the excess is re-prefilled: kv_recomputes); a full-policy tenant's
    retained prefix survives; with the host tier, a ring eviction of a
    block ending inside the first window spans spills it under its chain
    hash — the streams, the counters and the host pool's digest are the
    JAX engine's, and the pool's books close."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    r = np.random.default_rng(5)
    prefix = r.integers(3, 300, 4 * 128).tolist()
    ec = dict(EC, max_slots=2, kv_pages=40, prompt_cache_min=8,
              kv_host_bytes=1 << 24,
              kv_policy="sink_window(sinks=128, window=128)")
    plan = [(prefix + [7, 8], dict(temperature=0.0), 8, "full"),
            (prefix + [9, 10], dict(temperature=0.0), 8, ""),
            (prefix + [7, 8], dict(temperature=0.0), 8, "full"),
            (r.integers(3, 300, 30).tolist(), dict(temperature=0.0), 360,
             "")]
    outs = []
    for E, C, R, P, m in ((JEngine, JConfig, JRequest, JParams,
                           (jcfg, jp, jtok)),
                          (TEngine, TConfig, TRequest, TParams,
                           (tcfg, tp, ttok))):
        kw = {} if E is JEngine else dict(device="cpu")
        eng = E(*m, C(**ec), **kw)
        streams = _drive(eng, R, P, plan, stagger=60)
        eng._host_drain()
        outs.append((streams, {k: eng.metrics[k] for k in KV_KEYS},
                     eng._kvhost.digest(), eng))
    (got, gm, gd, te), (ref, rm, rd, _) = outs[1], outs[0]
    assert got == ref and gm == rm and gd == rd
    assert gm["kv_recomputes"] >= 3 and gm["kv_evictions"] > 0
    assert got[0] == got[2]
    free = set(te._kv_free)
    assert len(free) == len(te._kv_free)
    for pb in range(1, te.ec.kv_pages):
        assert (pb in free) == (te._block_ref[pb] == 0), pb
