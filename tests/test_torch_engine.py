"""PyTorch port engine (localai_tpu_torch.engine.engine) against the JAX
package's Engine on the tiny HF checkpoint, the tests/test_decode_loop.py
pattern: the same requests, arriving mid-stream, through both engines.

f32 greedy streams must be equal token for token — over mixed prompt
lengths with mid-stream admission, chunked prefill past the largest bucket,
the fused decode loop, the block path (stop strings) and prompt-cache
reuse. Seeded sampled streams are equal too: the port's threefry is
bit-exact, so each slot draws the same uniforms from the same logits.

The paged engine (kv_pages) is held to the JAX paged engine the same way —
with a pool small enough that admissions defer and retained blocks are
reclaimed, and prompts that share full blocks through the prefix index —
and the reference's paged tests (tests/test_paged_kv.py,
tests/test_paged_fast_path.py) are mirrored on the port.
"""
import queue

import numpy as np
import pytest
import torch

from fixtures import tiny_checkpoint
from torch_threads import one_torch_thread  # noqa: F401
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
from localai_tpu_torch.parallel.mesh import Mesh


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
    ("ragged_token_budget", 16),
    ("kv_policy", "sink_window(sinks=0, window=64)"), ("kv_cold_pages", 2),
    ("kv_host_bytes", 1 << 20),
    ("mesh", Mesh(rank=0, model=1, device=torch.device("cpu"))),
    ("replicator", object())])
def test_unported_config_rejected(models, field, value):
    (_, _, _), (tcfg, tp, ttok) = models
    # ragged batching and the host and retention KV tiers are served now,
    # but only over a paged pool (kv_policy), and kv_cold_pages only with a
    # quantize_cold policy: they are rejected with the reference's errors.
    # Tensor parallelism is served on the model axis: a mesh the params
    # were not sharded on is refused, and a replicator without a mesh
    # (replicas) waits for a later slice
    exc, match = ((ValueError, "paged")
                  if field in ("ragged_token_budget", "kv_host_bytes",
                               "kv_policy")
                  else (ValueError, "kv_cold_pages needs kv_policy")
                  if field == "kv_cold_pages"
                  else (ValueError, "not sharded on the engine's mesh")
                  if field == "mesh"
                  else (NotImplementedError, "slice"))
    with pytest.raises(exc, match=match):
        TEngine(tcfg, tp, ttok, TConfig(**dict(EC, **{field: value})),
                device="cpu")


@pytest.mark.parametrize("field,value", [
    ("context_shift", True),
    ("prompt_cache_path", "/nonexistent/x.npz"), ("kv_policy", "w"),
    ("resume", {"emitted": 0}), ("mm_embeds", np.zeros((1, 64)))])
def test_unported_request_fields_rejected(models, field, value):
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    if field == "resume":
        # served now: a resume is a normal request with the checkpoint's
        # fixups; on a dense engine with nothing cached it re-prefills
        out = list(eng.generate(TRequest([3, 4], TParams(temperature=0.0),
                                         max_tokens=4, ignore_eos=True,
                                         **{field: value})))
        assert out[-1].finish_reason == "length"
        assert eng.metrics["resume_reprefills"] == 1
        return
    if field == "kv_policy":
        # served now: a malformed policy is the reference's ValueError
        with pytest.raises(ValueError, match="unknown kv_policy"):
            eng.submit(TRequest([3, 4], **{field: value}))
        return
    if field == "context_shift":
        # served now: the stream runs past the 128-token context to its
        # budget (tests/test_torch_shift.py holds it to the reference)
        out = list(eng.generate(TRequest([3, 4], TParams(temperature=0.0),
                                         max_tokens=200, ignore_eos=True,
                                         **{field: value})))
        assert len(out) == 200 and out[-1].finish_reason == "length"
        return
    if field == "prompt_cache_path":
        # served now: an unreadable file is a cold prefill, and a file that
        # cannot be written is logged, not raised
        # (tests/test_torch_prompt_cache.py)
        out = list(eng.generate(TRequest([3, 4], TParams(temperature=0.0),
                                         max_tokens=4, ignore_eos=True,
                                         **{field: value})))
        assert out[-1].finish_reason == "length"
        assert eng.metrics["prompt_tokens_reused"] == 0
        return
    if field == "mm_embeds":
        # served now: image-feature rows replace token embeddings
        # (tests/test_torch_llava.py holds the streams to the reference);
        # rows of the wrong width are the reference's ValueError
        out = list(eng.generate(TRequest([3, 4], TParams(temperature=0.0),
                                         max_tokens=4, ignore_eos=True,
                                         mm_positions=np.array([1]),
                                         **{field: value})))
        assert out[-1].finish_reason == "length"
        with pytest.raises(ValueError, match="mm_embeds must be"):
            eng.submit(TRequest([3, 4], mm_embeds=np.zeros((1, 8)),
                                mm_positions=np.array([1])))
        return
    with pytest.raises(NotImplementedError, match="slice"):
        eng.submit(TRequest([3, 4], **{field: value}))


def test_preempt_waits_for_its_slice(models):
    """Engine.preempt is served now: on a dense engine without a host tier
    a live greedy stream ends "preempted" with its ResumeToken, and the
    token resumed in the same engine (the slot's prompt cache holds the
    prefix) continues into the uninterrupted stream."""
    from localai_tpu_torch.engine.resume import ResumeToken

    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    req = dict(params=TParams(temperature=0.0), max_tokens=20,
               ignore_eos=True)
    want = [o.token_id for o in eng.generate(TRequest(list(range(3, 40)),
                                                      **req))]
    eng = TEngine(tcfg, tp, ttok, TConfig(**EC), device="cpu")
    _, q = eng.submit(TRequest(list(range(3, 40)), **req))
    got = []
    while not got:
        eng.step()
        while not q.empty():
            got.append(q.get().token_id)
    man = eng.preempt(0.0)
    while True:
        o = q.get_nowait()
        if o.finished:
            break
        got.append(o.token_id)
    assert o.finish_reason == "preempted" and man == [o.resume]
    tok = ResumeToken.from_dict(o.resume)
    assert tok.emitted == got and tok.key is None
    rest = [o.token_id for o in eng.generate(TRequest(
        tok.resume_prompt, **dict(req, max_tokens=20 - tok.generated),
        resume=tok.payload())) if o.token_id >= 0]
    assert got + rest == [t for t in want if t >= 0]
    assert eng.metrics["preempts"] == 1
    assert eng.metrics["resume_readmits"] == 1


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


# ------------------------------------------------------------ paged KV

PAGED_EC = dict(EC, max_context=256)
_LONG = [(7 * j + 3) % 300 + 2 for j in range(150)]
# PLAN plus a 150-token prompt (two blocks, five chunks) and one that
# shares its first 140 tokens (a full 128-token block to borrow)
PAGED_PLAN = PLAN + [
    (_LONG, dict(temperature=0.0), 10, ()),
    (_LONG[:140] + [5, 6, 7, 8], dict(temperature=0.7, top_k=30, seed=9),
     8, ()),
]


@pytest.mark.parametrize("kv_pages,stagger", [(5, 1), (5, 3), (12, 3)])
def test_paged_streams_equal_reference_engine(models, kv_pages, stagger):
    """kv_pages=5 holds 4 usable blocks for 3 slots: admissions defer until
    a release frees blocks, and released slots' retained blocks are
    reclaimed; kv_pages=12 keeps retained prefixes around to be reused."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    ec = dict(PAGED_EC, kv_pages=kv_pages)
    jeng = JEngine(jcfg, jp, jtok, JConfig(**ec))
    teng = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    ref = _drive(jeng, JRequest, JParams, PAGED_PLAN, stagger)
    got = _drive(teng, TRequest, TParams, PAGED_PLAN, stagger)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"request {i}: {a} != {b}"
    assert [len(s) for s in got] == [p[2] for p in PAGED_PLAN]
    m = teng.metrics
    assert 0 < m["kv_blocks_peak"] <= kv_pages - 1
    assert m["tokens_by_path__loop"] > 0
    # the table ends consistent with the block lists and refcounts
    for i, blocks in enumerate(teng._slot_blocks):
        assert list(teng._table[i, :len(blocks)]) == blocks
        assert not teng._table[i, len(blocks):].any()
    # every block is either free (no reference) or held, its refcount the
    # number of slot block lists holding it
    held = [b for blocks in teng._slot_blocks for b in blocks]
    assert len(set(teng._kv_free)) == len(teng._kv_free)
    for b in range(1, kv_pages):
        assert teng._block_ref[b] == held.count(b)
        assert (b in teng._kv_free) == (held.count(b) == 0)


def test_reservation_defers_until_blocks_free(models):
    """A pool too small for two concurrent requests serves them one after
    the other instead of failing (tests/test_paged_kv.py): each reserves 2
    of the pool's 2 usable blocks, so the second admission defers until
    the first releases. The streams equal the reference's."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    ec = dict(max_slots=2, max_context=256, prefill_buckets=(32,),
              kv_pages=3, decode_block=4)
    plan = [(ttok.encode("hi there"), dict(temperature=0.0, seed=i), 130,
             ()) for i in range(2)]
    teng = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    deferred = []
    step = teng.step

    def watched_step():
        busy = step()
        deferred.append(teng._deferred is not None)
        return busy

    teng.step = watched_step
    got = _drive(teng, TRequest, TParams, plan, 1)
    assert [len(g) for g in got] == [130, 130]
    assert any(deferred) and not deferred[-1]
    assert teng.metrics["kv_blocks_peak"] == 2
    # each deferral is counted; the first release's retained blocks are
    # reclaimed for the waiting admission
    assert teng.metrics["kv_admissions_deferred"] >= 1
    assert teng.metrics["kv_slots_reclaimed"] >= 1
    jeng = JEngine(jcfg, jp, jtok, JConfig(**ec))
    assert got == _drive(jeng, JRequest, JParams, plan, 1)


def test_oversized_request_rejected(models):
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(
        max_slots=1, max_context=256, prefill_buckets=(32,), kv_pages=2),
        device="cpu")
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(TRequest(ttok.encode("hello"), TParams(),
                            max_tokens=250))


def test_paged_config_checks(models):
    (_, _, _), (tcfg, tp, ttok) = models
    with pytest.raises(ValueError, match="kv_pages must be >= 2"):
        TEngine(tcfg, tp, ttok, TConfig(**PAGED_EC, kv_pages=1),
                device="cpu")
    with pytest.raises(ValueError, match="at most 128 slots"):
        TEngine(tcfg, tp, ttok, TConfig(max_slots=129, max_context=128,
                                        prefill_buckets=(64,), kv_pages=4),
                device="cpu")


def test_paged_table_snapshot_per_dispatch(models):
    """Each dispatch reads its own copy of the block table: the allocator
    rewriting a row afterwards (release, admission) cannot reach a
    dispatch already enqueued."""
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**PAGED_EC, kv_pages=4),
                  device="cpu")
    eng._table[1, 0] = 3
    snap = eng._tab()
    eng._table[1, 0] = 2
    assert snap[1, 0].item() == 3 and eng._tab()[1, 0].item() == 2
    assert snap.dtype == torch.int32 and tuple(snap.shape) == (3, 2)


def test_paged_prefix_reuse(models):
    """A released slot's retained blocks serve a shared-prefix follow-up
    (prompt_cache_hits > 0), which still matches a cold engine's output
    and the reference's (tests/test_paged_kv.py)."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = models
    long_prefix = "the quick brown fox jumps over the lazy dog " * 4
    p1 = ttok.encode(long_prefix + "first")
    p2 = ttok.encode(long_prefix + "second question")
    ec = dict(max_slots=2, max_context=256, prefill_buckets=(32,),
              prompt_cache_min=8, decode_block=4, kv_pages=10)
    plan = [(p1, dict(temperature=0.0), 8, ()),
            (p2, dict(temperature=0.0), 8, ())]
    warm = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    got = _drive(warm, TRequest, TParams, plan, 400)
    assert warm.metrics["prompt_cache_hits"] >= 1
    cold = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    assert got[1] == _drive(cold, TRequest, TParams, plan[1:], 1)[0]
    jeng = JEngine(jcfg, jp, jtok, JConfig(**ec))
    assert got == _drive(jeng, JRequest, JParams, plan, 400)


@pytest.fixture(scope="module")
def models768(tmp_path_factory):
    ckpt = tiny_checkpoint(tmp_path_factory, max_position=768)
    return tloader.load_model(ckpt, dtype="float32", device="cpu")


def _drain(eng, q):
    ids = []
    while True:
        eng.step()
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                ids.append(o.token_id)
            if o.finished:
                return ids


def _count_takes(eng, monkeypatch):
    taken = []
    real = eng._take_blocks

    def counting(k, keep_slot):
        got = real(k, keep_slot)
        if got is not None:
            taken.extend(got)
        return got

    monkeypatch.setattr(eng, "_take_blocks", counting)
    return taken


_PREFIX_EC = dict(max_slots=2, max_context=512, prefill_buckets=(64,),
                  prefill_chunk=128, decode_block=8, kv_pages=16)


def test_prefix_cache_shares_blocks_across_slots(models768, monkeypatch):
    """A second admission sharing a 256-token prefix maps the 2 cached
    physical blocks into its own table — 2 fewer fresh blocks than a cold
    admission — and streams the same tokens (tests/test_paged_fast_path.py).
    A live request pins the retaining slot, so only the hash index can
    serve the prefix."""
    cfg, params, tok = models768
    rng = np.random.default_rng(3)
    base = rng.integers(5, cfg.vocab_size, 256).tolist()
    p1 = base + rng.integers(5, cfg.vocab_size, 40).tolist()
    p2 = base + rng.integers(5, cfg.vocab_size, 30).tolist()
    greedy = TParams(temperature=0.0)
    eng = TEngine(cfg, params, tok, TConfig(**_PREFIX_EC), device="cpu")
    _, q = eng.submit(TRequest(list(p1), greedy, max_tokens=8,
                               ignore_eos=True))
    _drain(eng, q)
    _, q_live = eng.submit(TRequest(list(p1), greedy, max_tokens=200,
                                    ignore_eos=True))
    while q_live.empty():
        eng.step()
    hits0 = eng.metrics["prompt_cache_hits"]
    taken = _count_takes(eng, monkeypatch)
    _, q2 = eng.submit(TRequest(list(p2), greedy, max_tokens=8,
                                ignore_eos=True))
    warm_ids = _drain(eng, q2)
    assert eng.metrics["prompt_cache_hits"] == hits0 + 1
    assert eng.metrics["prompt_tokens_reused"] >= 256
    cold_eng = TEngine(cfg, params, tok, TConfig(**_PREFIX_EC), device="cpu")
    cold_taken = _count_takes(cold_eng, monkeypatch)
    _, qc = cold_eng.submit(TRequest(list(p2), greedy, max_tokens=8,
                                     ignore_eos=True))
    assert warm_ids == _drain(cold_eng, qc)
    assert len(cold_taken) - len(taken) == 2


def test_prefix_cache_cow_never_corrupts_the_donor(models768):
    """The borrower writes only past the shared prefix: re-running the
    DONOR prompt after a borrower generated from the shared pages
    reproduces the original stream (tests/test_paged_fast_path.py)."""
    cfg, params, tok = models768
    rng = np.random.default_rng(11)
    base = rng.integers(5, cfg.vocab_size, 256).tolist()
    p1 = base + rng.integers(5, cfg.vocab_size, 20).tolist()
    p2 = base + rng.integers(5, cfg.vocab_size, 10).tolist()
    greedy = TParams(temperature=0.0)
    eng = TEngine(cfg, params, tok, TConfig(**_PREFIX_EC), device="cpu")

    def run(p):
        _, q = eng.submit(TRequest(list(p), greedy, max_tokens=8,
                                   ignore_eos=True))
        return _drain(eng, q)

    first = run(p1)
    run(p2)          # borrows p1's prefix pages (or its own retained slot)
    assert run(p1) == first


def test_prefix_cache_cow_swaps_a_shared_partial_block(models768):
    """Copy-on-write on the slot-retained path: a released slot whose first
    block another live slot has borrowed comes back with a prompt sharing
    only part of that block. The block is swapped for a fresh one (never
    rewritten in place), the reusable prefix falls back to the block
    boundary, and the borrower's stream equals a cold run's."""
    cfg, params, tok = models768
    rng = np.random.default_rng(5)
    base = rng.integers(5, cfg.vocab_size, 200).tolist()
    donor = base + rng.integers(5, cfg.vocab_size, 10).tolist()
    greedy = TParams(temperature=0.0)
    eng = TEngine(cfg, params, tok, TConfig(**_PREFIX_EC), device="cpu")
    _, q = eng.submit(TRequest(list(donor), greedy, max_tokens=4,
                               ignore_eos=True))
    _drain(eng, q)
    slot_a = eng._released_lru[-1]
    shared_pb = eng._slot_blocks[slot_a][0]
    # pin slot A with a live request, so the borrower lands in the other
    # slot and maps A's first block through the hash index
    _, q_live = eng.submit(TRequest(list(donor), greedy, max_tokens=70,
                                    ignore_eos=True))
    while q_live.empty():
        eng.step()
    borrower = base[:150] + [9, 9, 9]
    _, qb = eng.submit(TRequest(list(borrower), greedy, max_tokens=120,
                                ignore_eos=True))
    _drain(eng, q_live)
    assert eng._slots[slot_a] is None and eng._slots[1 - slot_a] is not None
    assert shared_pb in eng._slot_blocks[1 - slot_a]
    assert eng._block_ref[shared_pb] == 2
    # slot A comes back with a prompt diverging at 100 — inside the block
    reused = eng.metrics["prompt_tokens_reused"]
    assert eng.metrics["kv_cow_swaps"] == 0
    again = base[:100] + rng.integers(5, cfg.vocab_size, 60).tolist()
    _, qa = eng.submit(TRequest(list(again), greedy, max_tokens=4,
                                ignore_eos=True))
    _drain(eng, qa)
    assert shared_pb not in eng._slot_blocks[slot_a]
    assert eng.metrics["kv_cow_swaps"] == 1
    assert eng.metrics["prompt_tokens_reused"] == reused   # lcp fell to 0
    got = []
    while True:
        o = qb.get() if not qb.empty() else None
        if o is None:
            eng.step()
            continue
        if o.token_id >= 0:
            got.append(o.token_id)
        if o.finished:
            break
    cold = TEngine(cfg, params, tok, TConfig(**_PREFIX_EC), device="cpu")
    _, qc = cold.submit(TRequest(list(borrower), greedy, max_tokens=120,
                                 ignore_eos=True))
    assert got == _drain(cold, qc)
