"""PyTorch port engine (localai_tpu_torch.engine.engine) against the JAX
package's Engine on the tiny HF checkpoint, the tests/test_decode_loop.py
pattern: the same requests, arriving mid-stream, through both engines.

f32 greedy streams must be equal token for token — over mixed prompt
lengths with mid-stream admission, chunked prefill past the largest bucket,
the fused decode loop, the block path (stop strings) and prompt-cache
reuse. Seeded sampled streams are equal too: the port's threefry is
bit-exact, so each slot draws the same uniforms from the same logits.
"""
import queue

import numpy as np
import pytest
import torch

from fixtures import tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.ops.sampling import SamplingParams as TParams


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


@pytest.fixture(scope="module")
def models(ckpt):
    jcfg, jp, jtok = jloader.load_model(ckpt, dtype="float32")
    tcfg, tp, ttok = tloader.load_model(ckpt, dtype="float32", device="cpu")
    return (jcfg, jp, jtok), (tcfg, tp, ttok)


EC = dict(max_slots=3, max_context=128, prefill_buckets=(16, 32),
          prefill_chunk=32, decode_loop=8, decode_block=4)

# (prompt, sampling, max_tokens, stop): short (bucket 16), bucket 32,
# chunked (70 > 32), a stop-string slot (block path), seeded samplers
PLAN = [
    (list(range(3, 10)), dict(temperature=0.0), 14, ()),
    (list(range(5, 75)), dict(temperature=0.0), 12, ()),
    (list(range(2, 26)), dict(temperature=0.9, top_k=0, top_p=0.9, seed=7),
     16, ()),
    (list(range(40, 52)), dict(temperature=0.8, top_k=20, seed=3), 10, ()),
    (list(range(3, 10)) + [11, 12], dict(temperature=0.0), 9,
     ("zzzz-never",)),
]


def _drive(eng, req_cls, param_cls, plan, stagger):
    """Submit plan entries while stepping, `stagger` steps apart (arrivals
    mid-stream), then run to completion. Returns token streams in plan
    order."""
    outs = []
    pending = list(plan)
    steps = 0
    while pending or any(not done for _, _, done in outs):
        if pending and steps % stagger == 0:
            p, sp, n, stop = pending.pop(0)
            _, q = eng.submit(req_cls(list(p), param_cls(**sp), max_tokens=n,
                                      ignore_eos=True, stop=stop))
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
        assert steps < 2000
    return [o[1] for o in outs]


@pytest.mark.parametrize("stagger", [1, 3])
def test_streams_equal_reference_engine(models, stagger):
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    jeng = JEngine(jcfg, jp, jtok, JConfig(**EC))
    teng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    ref = _drive(jeng, JRequest, JParams, PLAN, stagger)
    got = _drive(teng, TRequest, TParams, PLAN, stagger)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"request {i}: {a} != {b}"
    assert [len(s) for s in got] == [p[2] for p in PLAN]
    m = teng.metrics
    assert m["tokens_generated"] == sum(p[2] for p in PLAN)
    assert m["tokens_by_path__loop"] > 0 and m["tokens_by_path__dense"] > 0
    assert m["decode_steps_dispatched"] > m["decode_dispatches"]


def test_prompt_cache_reuse_matches(models):
    """A second request sharing a released slot's prefix reuses its KV rows
    (prefill only the suffix through extend) and still streams the same
    tokens as the reference."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    ec = dict(EC, max_slots=1)
    base = list(range(3, 33))
    plan = [(base, dict(temperature=0.0), 6, ()),
            (base + [40, 41, 42], dict(temperature=0.0), 8, ())]
    jeng = JEngine(jcfg, jp, jtok, JConfig(**ec))
    teng = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    ref = _drive(jeng, JRequest, JParams, plan, 50)
    got = _drive(teng, TRequest, TParams, plan, 50)
    assert got == ref
    assert teng.metrics["prompt_cache_hits"] == 1
    assert teng.metrics["prompt_tokens_reused"] == len(base)


def test_generate_text_and_eos(models):
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    text = eng.generate_text(TRequest(ttok.encode("hello world"),
                                      TParams(temperature=0.0),
                                      max_tokens=8, ignore_eos=True))
    assert isinstance(text, str)
    outs = list(eng.generate(TRequest([3, 4, 5], TParams(temperature=0.0),
                                      max_tokens=5)))
    assert outs[-1].finished
    assert outs[-1].finish_reason in ("eos", "length")


def test_threaded_serving_cancel_and_deadline(models):
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    eng.warmup()
    eng.start()
    try:
        rid, q = eng.submit(TRequest([3, 4, 5], TParams(temperature=0.0),
                                     max_tokens=100, ignore_eos=True))
        first = q.get(timeout=60)
        eng.cancel(rid)
        last = first
        while not last.finished:
            last = q.get(timeout=60)
        assert last.finish_reason == "cancelled"
        _, q2 = eng.submit(TRequest([3, 4], TParams(temperature=0.0),
                                    max_tokens=100, ignore_eos=True,
                                    deadline=1.0))      # long expired
        assert q2.get(timeout=60).finish_reason == "timeout"
    finally:
        eng.stop()


@pytest.mark.parametrize("field,value", [
    ("kv_pages", 8), ("ragged_token_budget", 16),
    ("kv_policy", "sink_window(sinks=0, window=64)"), ("kv_cold_pages", 2),
    ("kv_host_bytes", 1 << 20), ("mesh", object()),
    ("replicator", object())])
def test_unported_config_rejected(models, field, value):
    (_, _, _), (tcfg, tp, ttok) = models
    with pytest.raises(NotImplementedError, match="slice"):
        TEngine(tcfg, tp, ttok, TConfig(**{field: value}), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("grammar", "root ::= \"a\""), ("context_shift", True),
    ("prompt_cache_path", "/nonexistent/x.npz"), ("kv_policy", "w"),
    ("resume", {"emitted": 0}), ("mm_embeds", np.zeros((1, 64)))])
def test_unported_request_fields_rejected(models, field, value):
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        eng.submit(TRequest([3, 4], **{field: value}))


def test_preempt_waits_for_its_slice(models):
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        eng.preempt(0.0)


def test_device_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    without CUDA, the default raises instead of silently using the CPU."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            tloader.load_params("/nonexistent", tloader.LlamaConfig())
