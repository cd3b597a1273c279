"""The fused decode loops run in segments over fixed tensors
(localai_tpu_torch.models.llama: LoopState, loop_segment, drive_loop) and,
on the card, as CUDA graph replays (localai_tpu_torch.engine.graphs).

On the CPU: the port's engines — the dense and the paged decode loop, the
ragged engine's pack-free and mixed loops — against the JAX package's
engines on the tiny checkpoint, at max_steps 64, 16 and 12 (a partial
last segment), with mid-stream admissions, chunked prefill (extend) and a
stop-string request (the ladder path) between fused dispatches. The port's
runner there is a stand-in with a graph's contract: the segment it
records at a key's first use is the one every later run of that key
replays, and the tensors must not move (it checks their addresses). f32
greedy and seeded-sampled streams must be equal token for token. Then the
state an eager path rebinds, the segment lengths and the launch-count
bookkeeping.

On an NVIDIA card (marker `cuda`, skipped without one): graph replays
against the eager segment (graphs.EagerSegments), bit for
bit, on a tiny model; a capture error propagates; a dispatch after an
eager rebinding of `_lengths` reads the new values. Run there with
`python -m pytest --noconftest tests/test_torch_graphs.py -m cuda` (JAX is
imported inside the CPU tests only).
"""
import queue
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from localai_tpu_torch.engine import graphs as tgraphs
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops.sampling import SamplerState
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401


class _Recorded(tgraphs.GraphRunner):
    """A graph's contract on the CPU: a key's first use warms its segment
    up frozen and records it; every later run of the key calls the
    recorded segment, whatever the caller passes, after checking that the
    tensors have not moved."""

    def __init__(self, device="cpu"):
        super().__init__(device)
        self.graphed = True

    def _warm_up(self, segment, freeze):
        with freeze():
            segment()

    def _capture(self, segment):
        return segment


def _drive(eng, req_cls, param_cls, plan, stagger):
    """Submit plan entries `stagger` steps apart while stepping, then run to
    completion. Returns token streams in plan order."""
    outs, pending, steps = [], list(plan), 0
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
                o[2] = o[2] or c.finished
        assert steps < 3000
    return [o[1] for o in outs]


# short (bucket 16), bucket 32, chunked (70 > 32: extend), seeded samplers
# (top-k, top-p with the full sort), a stop-string slot (the ladder path);
# 40 tokens for the first request: several segments of every loop
PLAN = [
    (list(range(3, 10)), dict(temperature=0.0), 40, ()),
    (list(range(5, 75)), dict(temperature=0.0), 21, ()),
    (list(range(2, 26)), dict(temperature=0.9, top_k=0, top_p=0.9, seed=7),
     17, ()),
    (list(range(40, 52)), dict(temperature=0.8, top_k=20, seed=3), 19, ()),
    (list(range(3, 10)) + [11, 12], dict(temperature=0.0), 9,
     ("zzzz-never",)),
]

# path → engine shape; the loop's max_steps goes to decode_loop, and on the
# ragged engine to ragged_loop_steps as well
EC = {
    "dense": dict(max_slots=3, max_context=128, prefill_buckets=(16, 32),
                  prefill_chunk=32, decode_block=4),
    "paged": dict(max_slots=3, max_context=256, prefill_buckets=(16, 32),
                  prefill_chunk=32, decode_block=4, kv_pages=12),
    "rloop": dict(max_slots=3, max_context=256, prefill_buckets=(16, 32),
                  prefill_chunk=16, decode_block=4, kv_pages=12,
                  ragged_token_budget=32),
}


def _ec(path, steps):
    kw = dict(EC[path], decode_loop=steps)
    if path == "rloop":
        kw["ragged_loop_steps"] = steps
    return kw


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from fixtures import tiny_checkpoint
    from localai_tpu.engine import loader as jloader
    from localai_tpu_torch.engine import loader as tloader

    ckpt = tiny_checkpoint(tmp_path_factory)
    return (jloader.load_model(ckpt, dtype="float32"),
            tloader.load_model(ckpt, dtype="float32", device="cpu"))


@pytest.mark.parametrize("path,steps", [
    ("dense", 64), ("dense", 16), ("dense", 12), ("paged", 16),
    ("paged", 12), ("rloop", 16), ("rloop", 12)])
def test_recorded_segments_equal_reference_engine(models, path, steps):
    """The segment-and-driver loops, each segment the one recorded at its
    key's first use, give the JAX engine's streams; between fused
    dispatches admissions, extend chunks and ladder steps rebind the
    engine's state."""
    from localai_tpu.engine.engine import (
        Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
    )
    from localai_tpu.ops.sampling import SamplingParams as JParams

    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    ec = _ec(path, steps)
    ref = _drive(JEngine(jcfg, jp, jtok, JConfig(**ec)), JRequest, JParams,
                 PLAN, 2)
    eng = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    eng.graphs = _Recorded()
    got = _drive(eng, TRequest, TParams, PLAN, 2)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"request {i}: {a} != {b}"
    assert [len(s) for s in got] == [p[2] for p in PLAN]
    c = eng.graphs.counters()[path]
    assert c["replays"] > 0 and c["captures"] == len(eng.graphs._graphs)
    assert c["steps_replayed"] >= c["replays"]
    m = eng.metrics
    assert m["tokens_by_path__" + ("rloop" if path == "rloop" else "loop")]
    assert m["tokens_by_path__ragged" if path == "rloop"
             else "tokens_by_path__dense"] > 0


def test_fused_dispatch_adopts_rebound_state(models):
    """An eager single step rebinds the engine's sampler, last_logits and
    lengths to new tensors; the next fused dispatch copies them into the
    loop's fixed tensors (which it then binds the engine to) and reads the
    new values."""
    _, (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**_ec("paged", 16)), device="cpu")
    eng.graphs = _Recorded()
    eng.submit(TRequest(list(range(3, 12)), TParams(temperature=0.0),
                        max_tokens=30, ignore_eos=True))
    eng.step()
    active = eng._active_mask()
    assert active.any()
    eng._dev_decode(active).wait()
    assert eng._lengths is not eng._loop_st.lengths
    lengths, key = eng._lengths.clone(), eng._sampler.key.clone()
    B = eng.ec.max_slots
    fetch = eng._dev_decode_loop(active, np.full((B,), 5, np.int32),
                                 np.zeros((B,), bool))
    _, _, n_out, steps = fetch.wait()
    assert eng._lengths is eng._loop_st.lengths
    assert eng._sampler is eng._loop_st.sampler
    assert steps == 8 and n_out.tolist() == [5 * int(a) for a in active]
    assert torch.equal(eng._lengths, lengths + torch.from_numpy(n_out))
    live = torch.from_numpy(active)
    assert not torch.equal(eng._sampler.key[live], key[live])


def test_recorded_runner_rejects_moved_tensors(models):
    """A replay over tensors that moved since the capture raises."""
    _, (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**_ec("dense", 16)), device="cpu")
    eng.graphs = _Recorded()
    eng.submit(TRequest(list(range(3, 12)), TParams(temperature=0.0),
                        max_tokens=20, ignore_eos=True))
    eng.step()
    eng.step()
    assert eng.graphs.counters()["dense"]["replays"] > 0
    eng._loop_st.done = eng._loop_st.done.clone()
    with pytest.raises(RuntimeError, match="stale addresses"):
        while eng.step():
            pass


@pytest.mark.parametrize("start,max_steps,want", [
    (0, 64, [8]), (0, 16, [8]), (0, 12, [8, 4]), (0, 5, [5]), (1, 16, [7, 8]),
    (1, 12, [7, 4]), (1, 8, [7]), (3, 3, [])])
def test_segment_lengths(start, max_steps, want):
    assert tllama.segment_lengths(start, max_steps) == want


def test_drive_loop_segments_and_stop_checks():
    """drive_loop runs segments up to each multiple of 8 and asks the stop
    state only there; each segment's rows land at their own offset."""
    st = tllama.LoopState.start(
        SamplerState.init(2, 3), torch.zeros((2, 3)),
        torch.zeros((2,), dtype=torch.int32), torch.tensor([True, True]),
        torch.tensor([99, 99]), torch.tensor([False, False]),
        torch.tensor([-1]))
    runs, asked = [], []

    def run(n):
        runs.append(n)
        st.toks[:n] = torch.arange(n)[:, None] + 100 * len(runs)

    toks, lps = tllama.loop_outputs(13, st)
    steps = tllama.drive_loop(st, run, toks, lps, 1, 13,
                              lambda s: asked.append(s) or False)
    assert (steps, runs, asked) == (13, [7, 5], [8])
    assert toks[1:8, 0].tolist() == list(range(100, 107))
    assert toks[8:13, 0].tolist() == list(range(200, 205))
    assert tllama.drive_loop(st, run, toks, lps, 0, 13,
                             lambda s: True) == 0


class _Counting(tgraphs.GraphRunner):
    """A stand-in for the card: the warm-up and the capture call the
    segment (the wrappers count there as on the card); a replay runs no
    Python, as a graph's does not."""

    def __init__(self):
        super().__init__("cpu")
        self.graphed = True

    def _warm_up(self, segment, freeze):
        with freeze():
            segment()

    def _capture(self, segment):
        segment()
        return lambda: None


def test_launch_count_bookkeeping():
    """The warm-up's launches count (they run); the capture's are taken
    back (nothing runs); each replay adds the capture's counts — so a
    replayed step counts like an eager one. Counters by path."""
    tk.reset_launch_counts()
    calls = []

    def segment():
        calls.append(1)
        tk.add_launch_counts({"ragged_decode_paged": 2,
                              "paged_scatter_append": 2})

    r = _Counting()
    frozen = nullcontext
    for _ in range(3):
        r.run(("paged", 2, None), 2, segment, frozen, (1, 2))
    r.run(("paged", 4, 64), 4, segment, frozen, (1, 2))
    counts = tk.launch_counts()
    assert len(calls) == 4            # two warm-ups and two captures
    # warm-ups 2 + 2, replays 3 * 2 + 2
    assert counts["ragged_decode_paged"] == 12
    assert counts["paged_scatter_append"] == 12
    assert r.counters() == {"paged": {"captures": 2, "replays": 4,
                                      "steps_replayed": 10,
                                      "warmup_steps": 6}}
    with pytest.raises(RuntimeError, match="stale addresses"):
        r.run(("paged", 2, None), 2, segment, frozen, (1, 3))
    tk.reset_launch_counts()


def test_failed_capture_takes_its_counts_back():
    tk.reset_launch_counts()

    class _Failing(_Counting):
        def _capture(self, segment):
            segment()
            raise RuntimeError("capture refused")

    def segment():
        tk.add_launch_counts({"ragged_decode": 1})

    r = _Failing()
    with pytest.raises(RuntimeError, match="capture refused"):
        r.run(("dense", 8, None), 8, segment, nullcontext)
    assert tk.launch_counts()["ragged_decode"] == 1    # the warm-up's
    assert r._graphs == {}
    tk.reset_launch_counts()


@pytest.mark.parametrize("enabled", [True, False])
def test_gc_paused_during_a_capture(enabled):
    """The cyclic garbage collector is off inside gc_paused (a capture: a
    dead engine's graphs destroyed by a collection there would end it),
    and afterwards as it was, an exception included."""
    import gc

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with pytest.raises(ValueError):
            with tgraphs.gc_paused():
                assert not gc.isenabled()
                raise ValueError
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs of CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tiny_engine(device, path, recipe, steps=16):
    from localai_tpu_torch.ops.quant import quantize_params

    cfg = tllama.LlamaConfig(vocab_size=384, hidden_size=64,
                             intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             max_position=256, dtype="bfloat16")
    params = tllama.init_params(cfg, seed=0, device=device)
    kw = _ec(path, steps)
    if recipe == "int8":
        params = quantize_params(params)
        kw["cache_type"] = "int8"
    eng = TEngine(cfg, params, None, TConfig(**kw), device=device)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["bf16", "int8"])
@pytest.mark.parametrize("path", ["dense", "paged", "rloop"])
def test_cuda_replays_equal_eager_segments(cuda, path, recipe):
    """The same requests through graph replays and through the eager
    segment: equal tokens and logprobs, bit for bit."""
    runs = {}
    for name in ("graphs", "eager"):
        eng = _tiny_engine(cuda, path, recipe)
        if name == "eager":
            eng.graphs = tgraphs.EagerSegments(cuda)
        eng.warmup()
        qs = []
        for i, (p, sp, n, stop) in enumerate(PLAN):
            qs.append(eng.submit(TRequest(list(p), TParams(**sp),
                                          max_tokens=n, ignore_eos=True,
                                          stop=stop, logprobs=True))[1])
            eng.step()
        while eng.step():
            pass
        out = []
        for q in qs:
            toks, lps = [], []
            while not q.empty():
                o = q.get_nowait()
                if o.token_id >= 0:
                    toks.append(o.token_id)
                    lps.append(o.logprob)
            out.append((toks, lps))
        runs[name] = (out, eng.graphs.counters())
    (got, counters), (want, _) = runs["graphs"], runs["eager"]
    assert got == want
    assert [len(t) for t, _ in got] == [p[2] for p in PLAN]
    assert counters[path]["replays"] > 0


TIER_EC = {
    "paged": dict(max_slots=3, max_context=1024, prefill_buckets=(32,),
                  prefill_chunk=64, decode_block=4, kv_pages=40,
                  kv_policy="sink_window(sinks=64, window=128)"),
    "rloop": dict(max_slots=3, max_context=1024, prefill_buckets=(32,),
                  prefill_chunk=64, decode_block=4, kv_pages=40,
                  ragged_token_budget=64,
                  kv_policy="sink_window(sinks=64, window=128)"),
    "cold": dict(max_slots=3, max_context=1024, prefill_buckets=(32,),
                 prefill_chunk=64, decode_block=4, kv_pages=40,
                 kv_cold_pages=30,
                 kv_policy="sink_window(sinks=64, window=128, "
                           "quantize_cold=true)"),
}


def _tier_wave(eng, policies, n):
    """Three requests (two greedy, one seeded) long enough to leave the
    window, under `policies`; their (tokens, logprobs)."""
    r = np.random.default_rng(7)
    qs = []
    for i, pol in enumerate(policies):
        sp = (TParams(temperature=0.8, seed=9) if i == 1
              else TParams(temperature=0.0))
        qs.append(eng.submit(TRequest(r.integers(3, 300, 40 + 50 * i)
                                      .tolist(), sp, max_tokens=n,
                                      ignore_eos=True, logprobs=True,
                                      kv_policy=pol))[1])
        eng.step()
    while eng.step():
        pass
    out = []
    for q in qs:
        toks, lps = [], []
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                toks.append(o.token_id)
                lps.append(o.logprob)
        out.append((toks, lps))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case,recipe", [("paged", "bf16"), ("paged", "int8"),
                                         ("rloop", "bf16"), ("cold", "bf16")])
def test_cuda_tiered_replays_equal_eager_segments(cuda, case, recipe):
    """The KV tier on the card: the fused loops' graph replays over the
    tier's fixed geometry tensors give the eager segments' tokens and
    logprobs bit for bit, through ring wraps, evictions and (cold)
    demotions; a second wave mixing per-request policies replays the
    graphs already captured."""
    from localai_tpu_torch.ops.quant import quantize_params

    cfg = tllama.LlamaConfig(vocab_size=384, hidden_size=64,
                             intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             max_position=1024, dtype="bfloat16")
    runs = {}
    for name in ("graphs", "eager"):
        params = tllama.init_params(cfg, seed=0, device=cuda)
        kw = dict(TIER_EC[case])
        if recipe == "int8":
            params = quantize_params(params)
            kw["cache_type"] = "int8"
        eng = TEngine(cfg, params, None, TConfig(**kw), device=cuda)
        if name == "eager":
            eng.graphs = tgraphs.EagerSegments(cuda)
        eng.warmup()
        first = _tier_wave(eng, ["", "", ""], 300)
        c0 = eng.graphs.counters()
        second = _tier_wave(eng, ["full", "sink_window(sinks=0, window=64)",
                                  ""], 120)
        c1 = eng.graphs.counters()
        runs[name] = (first, second, c0, c1, dict(eng.metrics))
    (g1, g2, c0, c1, m), (e1, e2, _, _, _) = runs["graphs"], runs["eager"]
    assert g1 == e1 and g2 == e2
    path = "rloop" if case == "rloop" else "paged"
    assert c1[path]["replays"] > c0[path]["replays"] > 0
    assert c1[path]["captures"] == c0[path]["captures"]
    key = "kv_cold_blocks" if case == "cold" else "kv_evictions"
    assert m[key] > 0


@pytest.mark.cuda
def test_cuda_capture_error_propagates(cuda):
    """A segment that waits for the device (illegal under capture) makes
    the capture raise; the runner keeps no graph and counts nothing."""
    x = torch.ones(4, device=cuda)

    def segment():
        x.add_(1)
        float(x.sum())

    r = tgraphs.GraphRunner(cuda)
    before = tk.launch_counts()
    with pytest.raises(RuntimeError):
        r.run(("dense", 8, None), 8, segment, nullcontext)
    assert r._graphs == {} and tk.launch_counts() == before
    torch.cuda.synchronize()
    assert float(x.sum()) > 0    # the card still serves after the failure


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "paged"])
def test_cuda_dispatch_reads_rebound_lengths(cuda, path):
    """After an eager step rebinds `_lengths`, the next fused dispatch's
    replays start from the new lengths."""
    eng = _tiny_engine(cuda, path, "bf16")
    eng.warmup()
    eng.submit(TRequest(list(range(3, 12)), TParams(temperature=0.0),
                        max_tokens=40, ignore_eos=True))
    eng.step()
    active = eng._active_mask()
    assert active.any()
    eng._dev_decode(active).wait()
    assert eng._lengths is not eng._loop_st.lengths
    lengths = eng._lengths.clone()
    B = eng.ec.max_slots
    _, _, n_out, steps = eng._dev_decode_loop(
        active, np.full((B,), 5, np.int32), np.zeros((B,), bool)).wait()
    torch.cuda.synchronize()
    assert steps == 8 and n_out.tolist() == [5 * int(a) for a in active]
    assert torch.equal(eng._lengths.cpu(),
                       lengths.cpu() + torch.from_numpy(n_out))
    assert eng.graphs.counters()[path]["replays"] > 0
