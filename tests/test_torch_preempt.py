"""Preemption and resume on the PyTorch port (localai_tpu_torch.engine:
ResumeToken, Engine.preempt, GenRequest.resume) against the JAX package,
on the tiny config of tests/test_preempt.py (f32 weights, kv_pages=6,
prompt_cache on), with an f32 and an int8 KV pool, on paged and ragged
engines.

Two requests — one greedy, one seeded-sampled — run side by side; the
engine is preempted once both have streamed, each ResumeToken is resumed
on a fresh engine that adopts the host pool, and everything is compared
with the JAX engine doing the same: the tokens before the preemption, the
manifest (prompt, emitted, RNG key, chain, sent_chars) and the resumed
tokens, token for token. Greedy streams also equal the uninterrupted run.
A sampled stream resumes from the key the device advanced, but its first
resumed logits come from a prefill over the readmitted KV rather than a
decode step: on an f32 pool the spill's int8 rounding moves them, and on
an int8 pool the prefill attends the chunk's fresh K/V while the decode
read them quantized — so a sampled resume equals the uninterrupted run
exactly when the reference's does (both are asserted).

The reference runs as its own CPU tests run its kernels: on an int8 pool
under LOCALAI_FORCE_PALLAS=1 (interpret mode), whose int8 paged math the
port shares; each reference stream is computed once, in a module
fixture.
"""
import json
import os
import queue
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from fixtures import tiny_checkpoint
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.engine.resume import ResumeToken as JToken
from localai_tpu.models import llama as jllama
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.engine.resume import RESUME_VERSION, ResumeToken
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=512, dtype="float32")
_R = np.random.default_rng(7)
# two prompts of one full 128-token block each; 2 + 2 blocks fit the
# 5-block pool with both streams live
REQS = [(_R.integers(1, 127, 150).tolist(), dict(temperature=0.0)),
        (_R.integers(1, 127, 160).tolist(),
         dict(temperature=0.9, top_k=40, seed=123))]
N = 64
K = 10          # preempt once each stream has at least K tokens
PATHS = ["paged", "ragged"]
CACHES = ["", "int8"]


# ------------------------------------------------------------ ResumeToken

def test_resume_token_roundtrip_and_defaults():
    tok = ResumeToken(prompt_ids=[1, 2, 3], emitted=[4, 5], key=[7, 9],
                      sent_chars=11, chain=["ab12", "cd34"],
                      deadline_left=2.5, request_id="req-1", model="m")
    assert tok.generated == 2 and tok.resume_prompt == [1, 2, 3, 4, 5]
    assert ResumeToken.from_json(tok.to_json()) == tok
    assert tok.payload() == {"emitted": 2, "key": [7, 9], "sent_chars": 11}
    t = ResumeToken.from_dict({"prompt_ids": [1], "emitted": []})
    assert t.key is None and t.chain == [] and t.generated == 0
    assert t.payload() == {"emitted": 0, "key": None, "sent_chars": 0}
    assert ResumeToken(prompt_ids=[1], emitted=[2], generated=5).generated \
        == 5
    assert RESUME_VERSION == 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resume_token_json_crosses_packages(writer):
    """A token one package writes parses in the other into an equal dict
    (the wire contract between the two backends)."""
    kw = dict(prompt_ids=[1, 2], emitted=[3], key=[4294967295, 0],
              sent_chars=3, chain=["00ff"], deadline_left=1.5,
              request_id="rid-3", model="m")
    src, dst = ((ResumeToken, JToken) if writer == "port"
                else (JToken, ResumeToken))
    s = src(**kw).to_json()
    back = dst.from_json(s)
    assert back.to_dict() == src(**kw).to_dict() == json.loads(s)
    assert back.payload() == src(**kw).payload()


@pytest.mark.parametrize("cls", [ResumeToken, JToken])
def test_resume_token_rejects_unknown_version(cls):
    with pytest.raises(ValueError, match="version"):
        cls.from_dict({"v": RESUME_VERSION + 1, "prompt_ids": [],
                       "emitted": []})


# ------------------------------------------------------------- the engines

@pytest.fixture(scope="module")
def parts():
    jcfg = jllama.LlamaConfig(**TINY)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig(**TINY)
    tp = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _ec(path, cache_type, **kw):
    ec = dict(max_slots=2, max_context=512, prefill_buckets=(64,),
              prefill_chunk=64, kv_pages=6, prompt_cache=True,
              decode_loop=8, decode_block=4, cache_type=cache_type)
    if path == "ragged":
        ec["ragged_token_budget"] = 64
    ec.update(kw)
    return ec


def _jeng(parts, path, ct, kvhost=None, tok=None, **kw):
    (jcfg, jp), _ = parts
    return JEngine(jcfg, jp, tok, JConfig(**_ec(path, ct, **kw)),
                   kvhost=kvhost)


def _teng(parts, path, ct, kvhost=None, tok=None, **kw):
    _, (tcfg, tp) = parts
    return TEngine(tcfg, tp, tok, TConfig(**_ec(path, ct, **kw)),
                   kvhost=kvhost, device="cpu")


def _drive(eng, req_cls, param_cls, reqs, stop_at=None):
    """Submit `reqs` [(prompt, sampling, max_tokens, extra)] together and
    step. Without `stop_at`, run to the end; with it, preempt once every
    stream has at least `stop_at` tokens. Returns (token lists, manifest,
    terminal outputs, texts)."""
    outs = []
    for ids, sp, n, extra in reqs:
        _, q = eng.submit(req_cls(list(ids), param_cls(**sp), max_tokens=n,
                                  ignore_eos=True, **extra))
        outs.append([q, [], None, ""])

    def pull():
        for o in outs:
            while True:
                try:
                    so = o[0].get_nowait()
                except queue.Empty:
                    break
                if so.token_id >= 0:
                    o[1].append(so.token_id)
                o[3] += so.text
                if so.finished:
                    o[2] = so

    man = None
    while any(o[2] is None for o in outs):
        eng.step()
        pull()
        if stop_at is not None and all(len(o[1]) >= stop_at for o in outs):
            assert all(o[2] is None for o in outs), "finished too early"
            man = eng.preempt()
            pull()
            break
    return [o[1] for o in outs], man, [o[2] for o in outs], \
        [o[3] for o in outs]


def _scenario(eng_fn, req_cls, param_cls, tok_cls, ref=None):
    """Uninterrupted run (unless `ref` is given); a run preempted at K
    tokens; the resume of each token on a fresh engine adopting the
    pool."""
    plan = [(ids, sp, N, {}) for ids, sp in REQS]
    if ref is None:
        ref, _, ends, _ = _drive(eng_fn(), req_cls, param_cls, plan)
        assert all(e.finish_reason == "length" for e in ends)
    eng = eng_fn(kv_host_bytes=1 << 26)
    got, man, terms, _ = _drive(eng, req_cls, param_cls, plan, stop_at=K)
    assert [t.finish_reason for t in terms] == ["preempted"] * 2
    assert [t.resume for t in terms] == man
    toks = [tok_cls.from_dict(m) for m in man]
    fresh = eng_fn(kvhost=eng._kvhost)
    rest, _, _, _ = _drive(fresh, req_cls, param_cls, [
        (t.resume_prompt, sp, N - t.generated, {"resume": t.payload()})
        for t, (_, sp) in zip(toks, REQS)])
    return dict(ref=ref, got=got, man=man, rest=rest, pool=eng._kvhost,
                metrics=dict(eng.metrics), fresh=dict(fresh.metrics))


def _jax_kernels(mp, cache_type):
    """The reference's int8 paged path as its CPU tests run it: its Pallas
    kernels in interpret mode, whose f32 math the port shares (its XLA
    int8 path rounds differently); the f32 path's XLA math already agrees
    to 1e-6."""
    mp.setenv("LOCALAI_FORCE_PALLAS", "1" if cache_type else "0")


@pytest.fixture(scope="module")
def reference(parts):
    """The JAX engine's scenario for every (path, cache type). On an f32
    pool a ragged engine streams the paged engine's tokens (their math
    agrees to 1e-6), so its uninterrupted run is the paged one's; on an
    int8 pool their prefills round differently and each runs its own."""
    out = {}
    for c in CACHES:
        with pytest.MonkeyPatch.context() as mp:
            _jax_kernels(mp, c)
            for p in PATHS:
                out[(p, c)] = _scenario(
                    lambda **kw: _jeng(parts, p, c, **kw), JRequest, JParams,
                    JToken, ref=out[("paged", c)]["ref"]
                    if p == "ragged" and not c else None)
    return out


@pytest.mark.parametrize("cache_type", CACHES)
@pytest.mark.parametrize("path", PATHS)
def test_preempt_resume_equals_reference(parts, reference, path,
                                         cache_type):
    want = reference[(path, cache_type)]
    got = _scenario(lambda **kw: _teng(parts, path, cache_type, **kw),
                    TRequest, TParams, ResumeToken)
    assert got["ref"] == want["ref"]              # uninterrupted streams
    assert got["got"] == want["got"]              # before the preemption
    assert got["man"] == want["man"]              # emitted, key, chain, ...
    assert got["rest"] == want["rest"]            # after the resume
    toks = [ResumeToken.from_dict(m) for m in got["man"]]
    assert [t.emitted for t in toks] == got["got"]
    assert toks[0].key is None and toks[1].key is not None
    assert all(len(t.chain) == 1 for t in toks)   # one full block each
    # greedy: the resumed stream is the uninterrupted one; sampled: it is
    # exactly when the reference's is
    assert got["got"][0] + got["rest"][0] == got["ref"][0]
    assert (got["got"][1] + got["rest"][1] == got["ref"][1]) == \
        (want["got"][1] + want["rest"][1] == want["ref"][1])
    for k in ("preempts", "preempt_spilled_blocks"):
        assert got["metrics"][k] == want["metrics"][k]
    assert got["metrics"]["preempt_spilled_blocks"] == 2
    # both resumes readmit their full block from the host tier
    for k in ("resume_readmits", "resume_reprefills", "kv_host_hits",
              "prompt_tokens_processed"):
        assert got["fresh"][k] == want["fresh"][k], k
    assert got["fresh"]["resume_readmits"] == 2
    assert got["fresh"]["resume_reprefills"] == 0


def _port_pool(jpool):
    """The reference pool's blocks, in its LRU and chain order, in a port
    pool of the same budget (the same bytes, as torch tensors)."""
    import torch

    from localai_tpu_torch.engine.kvhost import HostKVBlock, HostKVPool

    pool = HostKVPool(jpool.budget_bytes)
    for gkey, g in jpool._groups.items():
        for h in g.hashes:
            b = jpool._entries[h].block
            pool.put(h, HostKVBlock(*(torch.from_numpy(np.array(a)) for a in (
                b.kq, b.ks, b.vq, b.vs))), group=gkey)
    return pool


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_token_resumes_on_the_other_engine(parts, reference, writer):
    """A token (and its host pool) from one package's preempt resumes on
    the other package's engine into the writer's own resumed stream; the
    greedy one is the uninterrupted stream."""
    want = reference[("paged", "int8")]
    if writer == "reference":
        man = want["man"]
        dst = _teng(parts, "paged", "int8", kvhost=_port_pool(want["pool"]))
        cls, pcls = TRequest, TParams
    else:
        src = _teng(parts, "paged", "int8", kv_host_bytes=1 << 26)
        _, man, _, _ = _drive(src, TRequest, TParams,
                              [(ids, sp, N, {}) for ids, sp in REQS],
                              stop_at=K)
        dst = _jeng(parts, "paged", "int8", kvhost=src._kvhost)
        cls, pcls = JRequest, JParams
    toks = [ResumeToken.from_json(json.dumps(m)) for m in man]
    with pytest.MonkeyPatch.context() as mp:
        _jax_kernels(mp, "int8")
        rest, _, _, _ = _drive(dst, cls, pcls, [
            (t.resume_prompt, sp, N - t.generated, {"resume": t.payload()})
            for t, (_, sp) in zip(toks, REQS)])
    assert man == want["man"]
    assert rest == want["rest"]
    assert toks[0].emitted + rest[0] == want["ref"][0]
    assert dst.metrics["resume_readmits"] == 2


# ------------------------------------------------------------- fallbacks

def _single(parts, ct="int8", **kw):
    return lambda **k2: _teng(parts, "paged", ct, **dict(kw, **k2))


def test_tiny_pool_falls_back_to_reprefill(parts, reference):
    """A pool too small for one block spills nothing: the resume on an
    engine without a pool re-prefills and still ends in the reference's
    greedy stream."""
    plan = [(ids, sp, N, {}) for ids, sp in REQS]
    eng = _teng(parts, "paged", "int8", kv_host_bytes=64)
    got, man, _, _ = _drive(eng, TRequest, TParams, plan, stop_at=K)
    assert eng.metrics["kv_host_blocks"] == 0
    toks = [ResumeToken.from_dict(m) for m in man]
    fresh = _teng(parts, "paged", "int8")
    rest, _, _, _ = _drive(fresh, TRequest, TParams, [
        (t.resume_prompt, sp, N - t.generated, {"resume": t.payload()})
        for t, (_, sp) in zip(toks, REQS)])
    assert got[0] + rest[0] == reference[("paged", "int8")]["ref"][0]
    assert fresh.metrics["resume_reprefills"] == 2
    assert fresh.metrics["resume_readmits"] == 0


def test_second_preempt_during_resume_folds_base(parts, reference):
    """A resume preempted again checkpoints against the ORIGINAL prompt
    boundary, so a third engine still resumes into the greedy stream."""
    ids, sp = REQS[0]
    eng1 = _teng(parts, "paged", "int8", kv_host_bytes=1 << 26)
    got1, man1, _, _ = _drive(eng1, TRequest, TParams, [(ids, sp, N, {})],
                              stop_at=K)
    t1 = ResumeToken.from_dict(man1[0])
    eng2 = _teng(parts, "paged", "int8", kvhost=eng1._kvhost,
                 decode_loop=4, decode_block=2)
    got2, man2, _, _ = _drive(eng2, TRequest, TParams, [
        (t1.resume_prompt, sp, N - t1.generated, {"resume": t1.payload()})],
        stop_at=4)
    t2 = ResumeToken.from_dict(man2[0])
    assert t2.prompt_ids == ids
    assert t2.emitted == got1[0] + got2[0]
    eng3 = _teng(parts, "paged", "int8", kvhost=eng2._kvhost)
    rest, _, _, _ = _drive(eng3, TRequest, TParams, [
        (t2.resume_prompt, sp, N - t2.generated, {"resume": t2.payload()})])
    assert got1[0] + got2[0] + rest[0] == \
        reference[("paged", "int8")]["ref"][0]


def test_queued_requests_get_resubmit_entries(parts):
    """With both slots live, a queued third request has no device state:
    its manifest entry is a plain resubmit (emitted=[]), ended
    "preempted" like the live ones."""
    eng = _teng(parts, "paged", "int8", kv_host_bytes=1 << 26)
    plan = [(ids, sp, N, {}) for ids, sp in REQS]
    plan.append(([5, 6, 7], dict(temperature=0.0), 8, {}))
    _, man, terms, _ = _drive(eng, TRequest, TParams, plan[:2] + plan[2:],
                              stop_at=0)
    assert [t.finish_reason for t in terms] == ["preempted"] * 3
    assert man[2]["prompt_ids"] == [5, 6, 7] and man[2]["emitted"] == []
    assert eng.metrics["preempts"] == 1
    # the engine keeps serving: a resubmit runs to its end
    out = list(eng.generate(TRequest([5, 6, 7], TParams(temperature=0.0),
                                     max_tokens=4, ignore_eos=True)))
    assert out[-1].finish_reason == "length"


def test_preempt_from_another_thread(parts):
    """With the loop thread running, preempt hands off to it at a tick
    boundary and returns the manifest of the live stream."""
    ids, sp = REQS[0]
    eng = _teng(parts, "paged", "int8", kv_host_bytes=1 << 26)
    eng.start()
    try:
        _, q = eng.submit(TRequest(list(ids), TParams(**sp), max_tokens=400,
                                   ignore_eos=True))
        first = q.get(timeout=60)
        assert first.token_id >= 0
        man = eng.preempt(0.0)
        last = first
        while not last.finished:
            last = q.get(timeout=60)
        assert last.finish_reason == "preempted"
        assert man == [last.resume]
        assert man[0]["prompt_ids"] == ids and man[0]["emitted"]
    finally:
        eng.stop()


# ------------------------------------------------------ text and grammar

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny checkpoint with room for 512 positions (RoPE is computed,
    so only its config changes)."""
    import shutil

    d = str(tmp_path_factory.mktemp("tiny512"))
    shutil.copytree(tiny_checkpoint(tmp_path_factory), d, dirs_exist_ok=True)
    path = os.path.join(d, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["max_position_embeddings"] = 512
    with open(path, "w") as f:
        json.dump(cfg, f)
    return d


@pytest.fixture(scope="module")
def tmodel(ckpt):
    from localai_tpu_torch.engine import loader as tloader

    return tloader.load_model(ckpt, dtype="float32", device="cpu")


def _text_run(eng, ids, n, stop=(), grammar="", resume=None, stop_at=None):
    extra = dict(stop=stop, grammar=grammar)
    if resume is not None:
        extra["resume"] = resume
    toks, man, terms, texts = _drive(
        eng, TRequest, TParams, [(ids, dict(temperature=0.0), n, extra)],
        stop_at=stop_at)
    return toks[0], man, terms[0], texts[0]


@pytest.mark.parametrize("stop", [(), ("zq-never",)])
def test_text_before_plus_after_equals_uninterrupted(tmodel, stop):
    """The text streamed before the preemption plus the text after the
    resume is the uninterrupted text: no character repeated or lost, with
    and without a stop-string holdback."""
    cfg, params, tok = tmodel
    ids = tok.encode("the quick brown fox " * 30)
    assert len(ids) > 128

    def mk(kvhost=None, **kw):
        return TEngine(cfg, params, tok, TConfig(**_ec("paged", "", **kw)),
                       kvhost=kvhost, device="cpu")

    _, _, end, want = _text_run(mk(), ids, 30, stop)
    assert end.finish_reason == "length"
    eng = mk(kv_host_bytes=1 << 26)
    got, man, term, before = _text_run(eng, ids, 30, stop, stop_at=K)
    t = ResumeToken.from_dict(man[0])
    assert t.sent_chars == len(before) and t.emitted == got
    _, _, _, after = _text_run(mk(kvhost=eng._kvhost), t.resume_prompt,
                               30 - t.generated, stop, resume=t.payload())
    assert before + after == want


def test_table_grammar_slot_resumes_mid_grammar(tmodel):
    """A table-backed grammar slot preempted mid-grammar resumes with its
    automaton replayed: the resumed tokens are the uninterrupted run's."""
    cfg, params, tok = tmodel
    ids = tok.encode("list: " * 60)
    assert len(ids) > 128
    g = 'root ::= ("a" | "b" | " ")+'

    def mk(kvhost=None, **kw):
        return TEngine(cfg, params, tok, TConfig(**_ec("paged", "", **kw)),
                       kvhost=kvhost, device="cpu")

    want, _, _, _ = _text_run(mk(), ids, 30, grammar=g)
    eng = mk(kv_host_bytes=1 << 26)
    got, man, _, _ = _text_run(eng, ids, 30, grammar=g, stop_at=K)
    t = ResumeToken.from_dict(man[0])
    fresh = mk(kvhost=eng._kvhost)
    rest, _, _, _ = _text_run(fresh, t.resume_prompt, 30 - t.generated,
                              grammar=g, resume=t.payload())
    assert fresh.metrics["grammar_table_states"] > 1
    assert got + rest == want


# ------------------------------------------------------------ the backend

def _client(port):
    from localai_tpu.backend.client import BackendClient

    c = BackendClient(f"127.0.0.1:{port}")
    assert c.wait_ready(attempts=60, sleep=0.25)
    return c


LOAD = dict(dtype="float32", parallel=2, context_size=512,
            prefill_buckets=[64], kv_pages=6,
            options=json.dumps({"kv_host_bytes": 1 << 26}))


def test_backend_preempt_and_resume_json(ckpt):
    """LoadModel with kv_host_bytes serves; servicer.preempt() ends an open
    stream "preempted" with a resume_json; PredictStream with that
    resume_json continues it into the uninterrupted text."""
    import threading

    from localai_tpu_torch.backend.server import serve

    server, servicer, port = serve("127.0.0.1:0", device="cpu")
    client = _client(port)
    try:
        r = client.load_model(model=ckpt, **LOAD)
        assert r.success, r.message
        kw = dict(prompt="the quick brown fox " * 30, temperature=0.0,
                  ignore_eos=True)
        want = "".join(c.message.decode()
                       for c in client.predict_stream(tokens=300, **kw))
        chunks, it = [], client.predict_stream(tokens=300, **kw)
        for c in it:
            chunks.append(c)
            if len(chunks) == 1:
                # the first chunk carries the minimal checkpoint
                first = json.loads(c.resume_json)
                assert first == {"v": 1, "prompt_ids": first["prompt_ids"]}
            if len(chunks) == 1:
                threading.Thread(target=servicer.preempt).start()
        last = chunks[-1]
        assert last.finish_reason == "preempted" and last.resume_json
        tok = ResumeToken.from_json(last.resume_json)
        assert tok.prompt_ids == first["prompt_ids"]
        before = "".join(c.message.decode() for c in chunks)
        after = "".join(c.message.decode() for c in client.predict_stream(
            tokens=300, resume_json=last.resume_json, **kw))
        assert before + after == want
        m = client.metrics()
        assert m["preempts"] == 1 and m["resume_readmits"] == 1
        assert m["kv_host_spills"] > 0
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1)


def test_backend_sigterm_ends_streams_preempted(ckpt, tmp_path):
    """SIGTERM to `python -m localai_tpu_torch.backend` mid-stream: the
    open stream gets a terminal "preempted" reply with a resume_json
    before the process exits."""
    env = dict(os.environ, PYTHONPATH=ROOT, LOCALAI_NO_PREWARM="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "localai_tpu_torch.backend", "--addr",
         "127.0.0.1:0", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path))
    try:
        m = re.search(r"serving on port (\d+)", proc.stdout.readline())
        assert m
        client = _client(m.group(1))
        assert client.load_model(model=ckpt, **LOAD).success
        chunks = []
        for c in client.predict_stream(prompt="hello", tokens=500,
                                       temperature=0.0, ignore_eos=True):
            chunks.append(c)
            if len(chunks) == 1:
                proc.send_signal(signal.SIGTERM)
        assert chunks[-1].finish_reason == "preempted"
        tok = ResumeToken.from_json(chunks[-1].resume_json)
        got = [t for c in chunks for t in c.token_ids]
        assert tok.emitted == got and len(got) < 500
        client.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
