"""Grammar-constrained decoding in the PyTorch port (localai_tpu_torch:
functions/matcher.py, native/grammar.cpp, the sampler's mask lanes, the
grammar lanes of the fused loops, and the engine's grammar dispatch)
against the JAX package, on the CPU.

- The matcher: token texts, the dense device tables (masks, transitions,
  accepting states) of the reference tests' SCHEMA grammar, the None
  answer of grammars whose automaton overflows, and the per-step masks
  along a walk, array for array equal to the JAX package's.
- The sampler: u8 host rows and u32 table rows of one allowed set give the
  same logits, equal to the reference's.
- The engines (tiny checkpoint, f32): greedy and seeded-sampled grammar
  streams equal the JAX engine's token for token — table-backed on the
  dense, paged and ragged engines (fused loops), host-only with
  decode_block=1, greedy host-only with decode_block=16 (block rollback),
  and grammar slots mixed with free ones; every token is accepted by the
  port's matcher. Table-backed slots ride the fused loop (a quarter of the
  host-masked engine's dispatches) and its grammar segments (graph key
  with grammar=True); the device tables keep their storage across a
  second grammar's install; a malformed GBNF rejects only its own request,
  in the engine (ValueError at submit) and over gRPC (INVALID_ARGUMENT).
- The smoke's grammars (chip_smoke.py) are the reference generator's.

On the card, chip_smoke.py holds the grammar segments' graph replays to
the eager segments (phase 3) and serves the grammar leg at full width
(phase 7).
"""
import ctypes
import threading

import numpy as np
import pytest
import torch

from fixtures import tiny_checkpoint
from test_torch_graphs import _Recorded
from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.functions import matcher as jm
from localai_tpu.functions.grammars import JSON_GRAMMAR, json_schema_grammar
from localai_tpu.ops import sampling as js
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.functions import matcher as tm
from localai_tpu_torch.ops import sampling as ts
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

# the reference tests' grammars (tests/test_grammar_device.py)
VOCAB = ['{', '}', '"', 'a', 'b', ':', ',', ' ', '0', '1', 'x']
SCHEMA = {"type": "object",
          "properties": {"a": {"type": "integer"},
                         "b": {"type": "string"}},
          "required": ["a", "b"]}
SCHEMA_G = json_schema_grammar(SCHEMA)
SMALL_G = 'root ::= "a" [01]+ ("x" | "b")?'


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ckpt = tiny_checkpoint(tmp_path_factory)
    return (jloader.load_model(ckpt, dtype="float32"),
            tloader.load_model(ckpt, dtype="float32", device="cpu"), ckpt)


# ------------------------------------------------------------- the matcher

def test_token_texts_equal(models):
    (_, _, jtok), (_, _, ttok), _ = models
    got = tm.token_texts(ttok)
    assert got == jm.token_texts(jtok)
    assert len(got) == ttok.vocab_size and any(got)


def _tables_equal(a, b):
    assert a.n_states == b.n_states
    for f in ("masks", "trans", "accepting"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("gbnf,cap", [(SCHEMA_G, 64), (SCHEMA_G, 256),
                                      (SMALL_G, 64)])
def test_tables_equal_reference(models, gbnf, cap):
    """The dense tables over the reference tests' vocabulary and over the
    tiny tokenizer's: masks, transitions and accepting states equal."""
    (_, _, jtok), (_, _, ttok), _ = models
    for texts in (VOCAB, tm.token_texts(ttok)):
        a = tm.CompiledGrammar(gbnf, texts).table(cap)
        b = jm.CompiledGrammar(gbnf, texts).table(cap)
        assert a is not None and b is not None
        _tables_equal(a, b)
        assert a.masks.dtype == np.uint32 and a.trans.dtype == np.int32


@pytest.mark.parametrize("gbnf,cap", [
    (JSON_GRAMMAR, 64), ('root ::= "b" | "a" root "x"', 64), (SMALL_G, 1)])
def test_table_overflow_returns_none(gbnf, cap):
    """Unbounded nesting never closes the reachable state set, and a
    closing grammar over a too-small cap overflows too: None in both."""
    g = tm.CompiledGrammar(gbnf, VOCAB)
    assert g.table(cap) is None
    assert jm.CompiledGrammar(gbnf, VOCAB).table(cap) is None
    if cap == 1:
        assert g.table(64) is not None and g.table(1) is None   # per cap
    assert g.table(cap) is g.table(cap)                          # memoized


def test_mask_bits_equal_along_a_walk(models):
    """The host matcher's per-step masks (EOS bits once complete) along a
    walk that completes the SCHEMA object, equal to the reference's."""
    (_, _, jtok), (_, _, ttok), _ = models
    texts = tm.token_texts(ttok)
    a = tm.CompiledGrammar(SCHEMA_G, texts).state()
    b = jm.CompiledGrammar(SCHEMA_G, texts).state()
    eos = sorted(ttok.eos_ids)
    walk = [texts.index(c) for c in '{"a":1,"b":"x"}']
    for t in walk:
        assert np.array_equal(a.mask_bits(eos), b.mask_bits(eos))
        assert a.accept(t) and b.accept(t)
    assert a.done == b.done and a.done
    assert np.array_equal(a.mask_bits(eos), b.mask_bits(eos))
    assert a.can_continue == b.can_continue
    assert not a.accept(walk[0])


def test_bad_gbnf_raises_value_error():
    with pytest.raises(ValueError, match="grammar parse error"):
        tm.CompiledGrammar('root ::= ("a"', VOCAB)


def test_native_build_is_the_ports_own():
    """The port builds its own copy of grammar.cpp into its git-ignored
    build directory (the reference's library is never loaded)."""
    from localai_tpu_torch import native

    lib = tm._lib()
    path = native.so_path("grammar")
    assert path.startswith(native.BUILD_DIR)
    assert "localai_tpu_torch" in path and "/localai_tpu/" not in path
    assert isinstance(lib, ctypes.CDLL) and lib._name == path


# ------------------------------------------------------------- the sampler

def test_pipeline_logits_u8_and_u32_rows():
    """One allowed set as the host's u8 rows and as the table's u32 words
    (uint32 and int32 bit patterns): equal masked logits, equal to the
    reference's pipeline_logits on each format."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    B, V = 3, 77
    logits = rng.standard_normal((B, V)).astype(np.float32)
    allowed = rng.random((B, V)) < 0.4
    allowed[:, 0] = True
    allowed[:, 76] = True                # the last word's top bits
    u8 = np.packbits(allowed, axis=1, bitorder="little")
    words = np.zeros((B, (V + 31) // 32 * 4), np.uint8)
    words[:, :u8.shape[1]] = u8
    u32 = words.view(np.uint32)
    state = ts.SamplerState.init(B, V)
    jstate = js.SamplerState.init(B, V)
    ref = np.asarray(js.pipeline_logits(jnp.asarray(logits), jstate,
                                        jnp.asarray(u8)))
    ref32 = np.asarray(js.pipeline_logits(jnp.asarray(logits), jstate,
                                          jnp.asarray(u32)))
    np.testing.assert_array_equal(ref, ref32)
    lt = torch.from_numpy(logits)
    outs = [ts.pipeline_logits(lt, state, torch.from_numpy(m)) for m in (
        u8, u32.view(np.int32))]
    outs.append(ts.pipeline_logits(
        lt, state, torch.from_numpy(u32.astype(np.int64)).to(torch.uint32)))
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.numpy()[~allowed] == ts.NEG_INF).all()


def test_masked_sample_needs_the_full_sampler():
    st = ts.SamplerState.init(2, 40)
    with pytest.raises(ValueError, match="full sampling path"):
        ts.sample(torch.zeros((2, 40)), st,
                  torch.full((2, 2), -1, dtype=torch.int32), topk_width=8)


# ------------------------------------------------------------- the engines

def _greq(req_cls, param_cls, tok, temp=0.0, seed=5, n=24, g=SCHEMA_G,
          ignore_eos=False):
    return req_cls(tok.encode("emit json:"),
                   param_cls(temperature=temp, seed=seed), max_tokens=n,
                   grammar=g, ignore_eos=ignore_eos)


def _preq(req_cls, param_cls, tok, n=10):
    return req_cls(tok.encode("the quick brown fox"),
                   param_cls(temperature=0.0), max_tokens=n, ignore_eos=True)


def _drain(eng, reqs, steps=2000):
    outs = [eng.submit(r) for r in reqs]
    for _ in range(steps):
        if not eng.step():
            break
    res = []
    for _, q in outs:
        ids, reason = [], None
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                ids.append(o.token_id)
            if o.finished:
                reason = o.finish_reason
        res.append((ids, reason))
    return res


def _ec(path, **kw):
    base = dict(max_slots=4, max_context=128, prefill_buckets=(16,),
                prefill_chunk=16, prompt_cache=False)
    if path in ("paged", "ragged"):
        base["kv_pages"] = 10
    if path == "ragged":
        base["ragged_token_budget"] = 64
    return dict(base, **kw)


def _both(models, ec, plan):
    """`plan`(req_cls, param_cls, tok) → requests, through the JAX engine
    and the port's. Returns (port results, reference results, port
    engine, JAX engine)."""
    (jcfg, jp, jtok), (tcfg, tp, ttok), _ = models
    jeng = JEngine(jcfg, jp, jtok, JConfig(**ec))
    teng = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    ref = _drain(jeng, plan(JRequest, JParams, jtok))
    got = _drain(teng, plan(TRequest, TParams, ttok))
    return got, ref, teng, jeng


def _conformant(tok, gbnf, ids):
    m = tm.GrammarCache(tok).get(gbnf).state()
    for t in ids:
        if t in tok.eos_ids:
            return
        assert m.accept(t), f"illegal token {t} ({tok.decode([t])!r})"


def _mixed(rc, pc, tok):
    return [_greq(rc, pc, tok, 0.0), _preq(rc, pc, tok),
            _greq(rc, pc, tok, 0.9, seed=9)]


# (path, engine config overrides, requests); every case runs greedy and
# seeded-sampled grammar slots
CASES = {
    # table-backed: the fused loops, their grammar segments
    "dense": ("dense", {}, _mixed),
    "paged": ("paged", {}, _mixed),
    "ragged": ("ragged", {}, _mixed),
    # host-only, every step under a fresh host mask
    "hostonly-block1": ("dense", dict(grammar_table_states=0,
                                      decode_block=1, decode_loop=0),
                        _mixed),
    # the recursive JSON grammar overflows the tables: host-only on the
    # paged engine's single steps, beside a free slot
    "json-overflow-paged": ("paged", dict(decode_block=1), lambda rc, pc, t: [
        _greq(rc, pc, t, 0.0, g=JSON_GRAMMAR), _preq(rc, pc, t),
        _greq(rc, pc, t, 0.9, seed=3, g=JSON_GRAMMAR)]),
    # ... and on the ragged engine: host arbitration keeps its ticks single
    "json-overflow-ragged": ("ragged", {}, lambda rc, pc, t: [
        _greq(rc, pc, t, 0.0, g=JSON_GRAMMAR), _preq(rc, pc, t)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_grammar_streams_equal_reference_engine(models, case):
    path, kw, plan = CASES[case]
    got, ref, teng, _ = _both(models, _ec(path, **kw), plan)
    assert got == ref, (got, ref)
    (_, _, _), (_, _, ttok), _ = models
    reqs = plan(TRequest, TParams, ttok)
    for (ids, reason), r in zip(got, reqs):
        assert reason is not None and ids
        if r.grammar:
            _conformant(ttok, r.grammar, ids)
    m = teng.metrics
    hostonly = kw.get("grammar_table_states") == 0 or "overflow" in case
    if hostonly:
        assert m["grammar_table_states"] == 0
    else:
        assert m["grammar_table_states"] > 1
        assert m["tokens_by_path__loop"] + m["tokens_by_path__rloop"] > 0
    if "overflow" in case:
        assert m["grammar_table_overflows"] == 1
    if path == "ragged":
        assert m["ragged_dispatches"] > 0
        if hostonly:
            # a host-only slot bars the loop: its decode ticks take the
            # block path
            assert m["tokens_by_path__dense"] > 0


def test_block_rollback_equals_reference(models):
    """Greedy host-only slots on the block path (decode_block=16): sampled
    under block-start masks, rolled back at the first rejected token or a
    grown mask, re-keyed by PRNGKey(request_id * 1000003 + generated) —
    the reference's streams and rollback count."""
    ec = _ec("dense", grammar_table_states=0, decode_block=16)

    def plan(rc, pc, tok):
        return [_greq(rc, pc, tok, 0.0, n=40), _preq(rc, pc, tok, n=30),
                _greq(rc, pc, tok, 0.0, n=30, g=SMALL_G)]

    got, ref, teng, jeng = _both(models, ec, plan)
    assert got == ref, (got, ref)
    assert teng.metrics["grammar_rollbacks"] > 0
    assert (teng.metrics["grammar_rollbacks"]
            == jeng.metrics["grammar_rollbacks"])
    assert teng.metrics["decode_steps_dispatched"] > \
        teng.metrics["decode_dispatches"]


def test_table_slots_ride_the_fused_loop(models):
    """Table-backed slots take the fused loop: under a quarter of the
    host-masked engine's dispatches for the same streams, every
    grammar-slot token from the loop."""
    (_, _, _), (tcfg, tp, ttok), _ = models
    e_tab = TEngine(tcfg, tp, ttok, TConfig(**_ec("dense", max_slots=2)),
                    device="cpu")
    e_host = TEngine(tcfg, tp, ttok, TConfig(**_ec(
        "dense", max_slots=2, grammar_table_states=0, decode_block=1,
        decode_loop=0)), device="cpu")
    for temp in (0.0, 0.9):
        a = _drain(e_tab, [_greq(TRequest, TParams, ttok, temp)])
        b = _drain(e_host, [_greq(TRequest, TParams, ttok, temp)])
        assert a == b
    assert e_tab.metrics["decode_dispatches"] < \
        e_host.metrics["decode_dispatches"] / 4
    assert e_tab.metrics["tokens_by_path__loop"] > 0


@pytest.mark.parametrize("path", ["dense", "paged", "ragged"])
def test_grammar_segments_replay_recorded(models, path):
    """With the graph contract on the CPU, warm-up prepares the grammar
    variant of each loop segment (key grammar=True), and a grammar stream
    replays it: the JAX engine's tokens; the device tables keep their
    storage across a second grammar's install."""
    (jcfg, jp, jtok), (tcfg, tp, ttok), _ = models
    ec = _ec(path, decode_loop=16, ragged_loop_steps=16)
    eng = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
    eng.graphs = _Recorded()
    eng.warmup()
    loop = "rloop" if path == "ragged" else path
    keys = set(eng.graphs._graphs)
    assert {k for k in keys if k[3]} and {k for k in keys if not k[3]}
    assert all(k[2] is None for k in keys if k[3])   # full-width sampler
    ptrs = (eng._gmasks.data_ptr(), eng._gtrans.data_ptr())
    addrs = eng._loop_addresses()
    got = _drain(eng, _mixed(TRequest, TParams, ttok))
    used = eng.metrics["grammar_table_states"]
    got += _drain(eng, [_greq(TRequest, TParams, ttok, 0.0, g=SMALL_G)])
    assert eng.metrics["grammar_table_states"] > used    # a second install
    assert (eng._gmasks.data_ptr(), eng._gtrans.data_ptr()) == ptrs
    assert eng._loop_addresses() == addrs
    # the rows installed in place are the host mirrors'
    np.testing.assert_array_equal(eng._gmasks.numpy().view(np.uint32),
                                  eng._gmasks_np)
    np.testing.assert_array_equal(eng._gtrans.numpy(), eng._gtrans_np)
    assert eng.graphs.counters()[loop]["replays"] > 0
    jeng = JEngine(jcfg, jp, jtok, JConfig(**ec))
    ref = _drain(jeng, _mixed(JRequest, JParams, jtok))
    ref += _drain(jeng, [_greq(JRequest, JParams, jtok, 0.0, g=SMALL_G)])
    assert got == ref, (got, ref)


def test_bad_gbnf_rejects_only_its_request(models):
    """A malformed GBNF is a ValueError at submit; a grammar that fails at
    admission finishes its own request with "error"; the other streams
    run to their end."""
    (_, _, _), (tcfg, tp, ttok), _ = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**_ec("ragged")), device="cpu")
    _, q = eng.submit(_preq(TRequest, TParams, ttok, n=12))
    eng.step()
    with pytest.raises(ValueError, match="grammar"):
        eng.submit(_greq(TRequest, TParams, ttok, g='root ::= ("a"'))
    real = eng._matcher_for

    def failing(g):
        if g == SMALL_G:
            raise RuntimeError("matcher failed")
        return real(g)

    eng._matcher_for = failing
    _, qbad = eng.submit(_greq(TRequest, TParams, ttok, g=SMALL_G))
    _, qok = eng.submit(_greq(TRequest, TParams, ttok))
    while eng.step():
        pass
    outs = {}
    for name, qq in (("free", q), ("bad", qbad), ("ok", qok)):
        items = []
        while not qq.empty():
            items.append(qq.get_nowait())
        outs[name] = items
    assert outs["bad"][-1].finish_reason == "error"
    assert [o.token_id for o in outs["bad"]] == [-1]
    assert outs["free"][-1].finish_reason == "length"
    assert sum(o.token_id >= 0 for o in outs["free"]) == 12
    assert outs["ok"][-1].finished and outs["ok"][-1].finish_reason != \
        "error"
    assert eng._grammar_slots == 0 and eng._grammar_hostonly == 0


def test_no_tokenizer_no_tables(models):
    """Without a tokenizer no grammar compiles: the engine keeps no device
    tables, prepares no grammar segment, and a grammar request is a
    ValueError at submit."""
    (_, _, _), (tcfg, tp, _), _ = models
    eng = TEngine(tcfg, tp, None, TConfig(**_ec("dense")), device="cpu")
    eng.graphs = _Recorded()
    eng.warmup()
    assert eng._gmasks is None and eng._gtrans is None
    assert eng._loop_st.gmasks is None
    assert not any(k[3] for k in eng.graphs._graphs)
    with pytest.raises(ValueError, match="tokenizer"):
        eng.submit(TRequest([3, 4], grammar=SMALL_G))


def test_grpc_bad_grammar_is_invalid_argument(models):
    """Over the port's gRPC backend: a grammar stream and a free stream
    run while a malformed GBNF gets INVALID_ARGUMENT; the grammar stream's
    tokens are the JAX engine's."""
    import grpc

    from localai_tpu.backend.client import BackendClient
    from localai_tpu_torch.backend.server import serve

    (jcfg, jp, jtok), (_, _, ttok), ckpt = models
    server, servicer, port = serve("127.0.0.1:0", device="cpu")
    client = BackendClient(f"127.0.0.1:{port}")
    results = {}

    def stream(name, **kw):
        chunks = list(client.predict_stream(**kw))
        results[name] = ([t for c in chunks for t in c.token_ids],
                         chunks[-1].finish_reason)

    try:
        assert client.wait_ready(attempts=40, sleep=0.1)
        r = client.load_model(model=ckpt, dtype="float32", parallel=2,
                              context_size=128, prefill_buckets=[16, 64])
        assert r.success, r.message
        prompt = ttok.encode("emit json:")
        threads = [
            threading.Thread(target=stream, args=("grammar",), kwargs=dict(
                prompt_ids=prompt, tokens=24, temperature=0.0,
                grammar=SCHEMA_G)),
            threading.Thread(target=stream, args=("free",), kwargs=dict(
                prompt_ids=prompt, tokens=16, temperature=0.0,
                ignore_eos=True))]
        for t in threads:
            t.start()
        with pytest.raises(grpc.RpcError) as err:
            list(client.predict_stream(prompt_ids=prompt, tokens=8,
                                       grammar='root ::= ("a"'))
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1)
    assert results["free"][1] == "length" and len(results["free"][0]) == 16
    jeng = JEngine(jcfg, jp, jtok, JConfig(max_slots=2, max_context=128,
                                           prefill_buckets=(16, 64)))
    ref = _drain(jeng, [JRequest(jtok.encode("emit json:"),
                                 JParams(temperature=0.0), max_tokens=24,
                                 grammar=SCHEMA_G)])
    assert results["grammar"] == ref[0]


# ------------------------------------------------------------- the smoke

def test_smoke_grammars_are_the_generators():
    """chip_smoke.py carries its grammars as GBNF text (it imports nothing
    of the JAX package): the tool-call schema's grammar and the generic
    JSON grammar, as the reference's generators write them."""
    import chip_smoke

    assert chip_smoke.TOOL_GBNF == json_schema_grammar(chip_smoke.TOOL_SCHEMA)
    assert chip_smoke.JSON_GBNF == JSON_GRAMMAR
