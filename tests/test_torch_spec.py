"""PyTorch port speculative decoding (localai_tpu_torch.engine.spec, the
draft engine, LoadModel's draft_model, engine.speculative) against the JAX
package's, on the CPU, f32.

- The draws: fold_in, uniform(keys, G) and the Gumbel noise's random bits
  are BIT-equal to jax.random's (JAX 0.9.0, threefry partitionable); the
  noise itself goes through two logs, which XLA's CPU log computes within
  4 ulps of torch's, so the noise is held within 8 ulps of max(|g|, 1);
  the categorical draws are EQUAL over 256 (key, distribution) pairs.
- One spec step, each function against its reference on the tiny target
  and draft of tests/test_spec_engine.py: tokens_out, n_out, n_extra,
  next_tokens, lengths and the sampler's keys and counts EQUAL; logprobs,
  last_logits and the written caches within 2e-5.
- The engines, token for token against the JAX engine (streams and
  draft_proposed / draft_accepted equal): dense and paged ("" and int8
  KV), greedy and seeded-sampled, two slots, a chunked prompt; a perfect
  draft. Spec-as-ragged is held to the JAX dense draft engine, the
  contract the reference states for it (tests/test_grammar_device.py's
  spec-as-ragged case): the reference's own ragged draft engine places
  every verify window one position late (a fault the port does not
  carry, shown here); a table-backed grammar on the ragged draft engine
  gives the JAX ragged engine's greedy constrained stream; the
  reference's ValueErrors for a grammar on a dense draft engine and for
  an automaton that overflows the tables.
- LoadModel(draft_model=..., n_draft=3) over gRPC; SpeculativeDecoder
  against tests/test_speculative.py's cases and the JAX decoder.
The card's checks of this path (row 2 at the 1B draft's head_dim 64, a
spec step on the card against the CPU) are `cuda`-marked tests in
tests/test_torch_kernels.py, which the card's machine imports without JAX.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.engine import spec as jspec
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.engine.speculative import SpeculativeDecoder as JDecoder
from localai_tpu.functions.grammars import json_schema_grammar
from localai_tpu.models import llama as jllama
from localai_tpu.ops import sampling as js
from localai_tpu.ops.rope import rope_table as jrope
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine import spec as tspec
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.engine.speculative import SpeculativeDecoder
from localai_tpu_torch.functions import matcher as tm
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import sampling as ts
from localai_tpu_torch.ops.rope import rope_table as trope
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

# the reference's tiny pair (tests/test_spec_engine.py, test_speculative.py)
TARGET = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position=256, dtype="float32")
DRAFT = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_layers=1, num_heads=2, num_kv_heads=2, head_dim=16,
             max_position=256, dtype="float32")
TOL = dict(rtol=0.0, atol=2e-5)


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, params) and (port cfg, params) of target and draft, from
    the same trees."""
    out = []
    for kw, seed in ((TARGET, 0), (DRAFT, 7)):
        jcfg = jllama.LlamaConfig(**kw)
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
        tcfg = tllama.LlamaConfig(**kw)
        tp = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    tcfg, device="cpu")
        out.append(((jcfg, jp), (tcfg, tp)))
    return out


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


# --------------------------------------------------------------- the draws

def _keys(n, seed=0):
    r = np.random.default_rng(seed)
    k = r.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)
    return k, torch.tensor(k.astype(np.int64)), jax.vmap(
        jax.random.wrap_key_data)(jnp.asarray(k))


def test_fold_in_uniform_and_gumbel_bits_bit_exact():
    k, t, jk = _keys(64)
    for d in (0, 1, 2, 100, 103, 2 ** 31 + 5):
        got = ts.fold_in(t, d).numpy()
        want = np.asarray(jax.vmap(lambda kk: jax.random.key_data(
            jax.random.fold_in(kk, d)))(jk))
        np.testing.assert_array_equal(got, want)
    for g in (1, 3, 4, 7):
        u = ts.uniform(t, g).numpy()
        ju = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (g,)))(
            jk))
        np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
    np.testing.assert_array_equal(
        ts.uniform(t, 1)[:, 0].numpy().view(np.uint32),
        ts.uniform_scalar(t).numpy().view(np.uint32))
    # the Gumbel noise's bits: its uniform on [tiny, 1), bit for bit
    tiny = np.float32(np.finfo(np.float32).tiny)
    u = ts._unit_floats(ts.random_bits(t, 128)).numpy() + tiny
    ju = np.asarray(jax.vmap(lambda kk: jax.random.uniform(
        kk, (128,), minval=tiny, maxval=1.0))(jk))
    np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
    # the noise: -log(-log(u)); XLA's log is within 4 ulps of torch's
    g = ts.gumbel(t, 128).numpy()
    jg = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (128,)))(jk))
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert np.all(np.abs(g - jg) <= 8 * ulp)


def test_categorical_draws_equal_jax():
    _, t, jk = _keys(256, seed=3)
    r = np.random.default_rng(4)
    p = r.dirichlet(np.full(128, 0.3), size=256).astype(np.float32)
    p[::7] = np.eye(128, dtype=np.float32)[r.integers(0, 128, 37)]
    logp = np.log(p + np.float32(1e-30)).astype(np.float32)
    got = ts.categorical(t, torch.tensor(logp)).numpy()
    want = np.asarray(jax.vmap(jax.random.categorical)(jk, jnp.asarray(logp)))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 50


# ------------------------------------------------------- one spec step

B, T_DENSE, G = 4, 64, 3


def _sampler_np(seed=5):
    """Four slots: greedy, sampled (top-k/p, penalties), greedy, sampled
    (temperature only)."""
    r = np.random.default_rng(seed)
    V = TARGET["vocab_size"]
    counts = r.integers(0, 3, (B, V)).astype(np.int32)
    bias = np.zeros((B, V), np.float32)
    bias[1, 5] = 2.0
    return dict(
        temperature=np.array([1.0, 0.9, 1.0, 0.7], np.float32),
        top_k=np.array([0, 40, 0, 0], np.int32),
        top_p=np.array([1.0, 0.95, 1.0, 1.0], np.float32),
        min_p=np.array([0.0, 0.02, 0.0, 0.0], np.float32),
        typical_p=np.ones((B,), np.float32),
        repeat_penalty=np.array([1.0, 1.1, 1.0, 1.0], np.float32),
        presence_penalty=np.array([0.0, 0.2, 0.0, 0.0], np.float32),
        frequency_penalty=np.array([0.0, 0.1, 0.0, 0.0], np.float32),
        greedy=np.array([True, False, True, False]),
        key=r.integers(0, 2 ** 32, (B, 2), dtype=np.uint64).astype(
            np.uint32),
        token_counts=counts, logit_bias=bias)


def _samplers(raw):
    j = js.SamplerState(**{k: jnp.asarray(v) for k, v in raw.items()})
    t = ts.SamplerState(**{k: torch.tensor(
        v.astype(np.int64) if k == "key" else v) for k, v in raw.items()})
    return j, t


def _tables(n):
    return [(jrope(jllama.LlamaConfig(**kw).rope, n),
             trope(tllama.LlamaConfig(**kw).rope, n)) for kw in (TARGET,
                                                                 DRAFT)]


def _cache_np(kw, lead, t, seed):
    r = np.random.default_rng(seed)
    shape = (kw["num_layers"], lead, kw["num_kv_heads"], t, kw["head_dim"])
    return [r.standard_normal(shape).astype(np.float32) * 0.5
            for _ in range(2)]


def _check_sampler(jsm, tsm):
    np.testing.assert_array_equal(_np(tsm.key), np.asarray(jsm.key))
    np.testing.assert_array_equal(_np(tsm.token_counts),
                                  np.asarray(jsm.token_counts))


@pytest.mark.parametrize("paged", [False, True])
def test_spec_decode_step_equals_reference(pair, paged):
    """build_spec_decode on a dense cache, and on a paged one with the
    inactive slot's window redirected to the trash block: greedy and
    sampled rows in one batch, slot 2 inactive."""
    ((jct, jpt), (tct, tpt)), ((jcd, jpd), (tcd, tpd)) = pair
    (jcs_t, tcs_t), (jcs_d, tcs_d) = _tables(T_DENSE)
    kd, vd = _cache_np(DRAFT, B, T_DENSE, 1)
    lengths = np.array([9, 20, 0, 33], np.int32)
    active = np.array([True, True, False, True])
    nxt = np.array([7, 3, 0, 100], np.int32)
    table = None
    if paged:
        kt, vt = _cache_np(TARGET, 9, 128, 2)       # pool [L, NB, KVH, ...]
        table = np.array([[3, 0], [5, 0], [7, 0], [2, 0]], np.int32)
    else:
        kt, vt = _cache_np(TARGET, B, T_DENSE, 2)
    raw = _sampler_np()
    jsm, tsm = _samplers(raw)
    jfn = jspec.build_spec_decode(jct, jcd, G)
    tfn = tspec.build_spec_decode(tct, tcd, G)
    jt = None if table is None else jnp.asarray(table)
    (jtok, jn, jlp, jnext, jkt, jvt, jkd, jvd, jsm2, jlen,
     jne) = jfn(jpt, jpd, *jcs_t, *jcs_d, jnp.asarray(kt), jnp.asarray(vt),
                jnp.asarray(kd), jnp.asarray(vd), jsm, jnp.asarray(lengths),
                jnp.asarray(nxt), jnp.asarray(active), jt)
    caches = [torch.tensor(x) for x in (kt, vt, kd, vd)]
    (ttok, tn, tlp, tnext, tsm2, tlen, tne) = tfn(
        tpt, tpd, *tcs_t, *tcs_d, *caches, tsm, torch.tensor(lengths),
        torch.tensor(nxt), torch.tensor(active),
        None if table is None else torch.tensor(table))
    for a, b in ((ttok, jtok), (tn, jn), (tnext, jnext), (tlen, jlen),
                 (tne, jne)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # an inactive row's logprobs read its garbage window: not compared
    np.testing.assert_allclose(_np(tlp)[active], np.asarray(jlp)[active],
                               **TOL)
    _check_sampler(jsm2, tsm2)
    assert _np(tn)[2] == 0 and (_np(tn)[active] >= 1).all()
    pad = np.arange(G + 1)[None] >= _np(tn)[:, None]
    assert (_np(ttok)[active][pad[active]] == 0).all()
    # the written caches; the last dense row takes the inactive slot's
    # garbage, in an order the two scatters need not share
    got = [_np(c) for c in caches]
    for g, w in zip(got[2:], (jkd, jvd)):
        np.testing.assert_allclose(g[..., :-1, :], np.asarray(w)[..., :-1, :],
                                   **TOL)
    for g, w, before in zip(got[:2], (jkt, jvt), (kt, vt)):
        w = np.asarray(w)
        if paged:
            np.testing.assert_allclose(g, w, **TOL)
            # the inactive window went to the trash block 0, not through
            # its table (block 7)
            np.testing.assert_array_equal(g[:, 7], before[:, 7])
            assert not np.array_equal(g[:, 0], before[:, 0])
        else:
            np.testing.assert_allclose(g[..., :-1, :], w[..., :-1, :], **TOL)


def _grammar_tables(S=6, seed=11):
    r = np.random.default_rng(seed)
    V = TARGET["vocab_size"]
    w = (V + 31) // 32
    masks = (r.random((S, V)) < 0.4)
    masks[:, 0] = True
    masks[0] = True
    bits = np.zeros((S, w), np.uint32)
    for s in range(S):
        for v in np.nonzero(masks[s])[0]:
            bits[s, v >> 5] |= np.uint32(1) << np.uint32(v & 31)
    trans = r.integers(1, S, (S, V)).astype(np.int32)
    trans[0] = 0
    return bits, trans


@pytest.mark.parametrize("grammar", [False, True])
def test_spec_ragged_step_equals_reference(pair, grammar):
    """build_spec_ragged: two verify windows (slots 0 and 3) beside a
    final prefill chunk (slot 1, an 11-token prompt) and a mid chunk (slot
    2, rows 8..23 of a 40-token prompt), with and without the grammar
    tables (slot 0 constrained, slot 3 in the identity row)."""
    ((jct, jpt), (tct, tpt)), ((jcd, jpd), (tcd, tpd)) = pair
    (jcs_t, tcs_t), (jcs_d, tcs_d) = _tables(T_DENSE)
    kd, vd = _cache_np(DRAFT, B, T_DENSE, 3)
    kt, vt = _cache_np(TARGET, 17, 128, 4)
    table = np.array([[1, 2], [3, 4], [5, 6], [7, 8]], np.int32)
    r = np.random.default_rng(9)
    lengths = np.array([9, 0, 8, 20], np.int32)
    active = np.array([True, False, False, True])
    nxt = np.array([7, 0, 0, 100], np.int32)
    Tr = 48
    tokens = np.zeros((Tr,), np.int32)
    tokens[16:27] = r.integers(0, 128, 11)
    tokens[32:48] = r.integers(0, 128, 16)
    block_seq = np.array([0, 3, 1, 1, 2, 2], np.int32)
    spec_rows = np.array([0, 0, 0, 8], np.int32)
    qstart = np.array([0, 16, 32, 8], np.int32)
    qlen = np.array([G + 1, 11, 16, G + 1], np.int32)
    kvlen = np.array([9 + G + 1, 11, 24, 20 + G + 1], np.int32)
    set_len = np.array([-1, 11, -1, -1], np.int32)
    logit_set = np.array([False, True, False, False])
    logit_rows = np.zeros((B, G + 1), np.int32)
    logit_rows[0] = np.arange(G + 1)
    logit_rows[3] = 8 + np.arange(G + 1)
    logit_rows[1] = 26
    last = r.standard_normal((B, 128)).astype(np.float32)
    meta = (tokens, spec_rows, set_len, logit_set, logit_rows, block_seq,
            qstart, qlen, kvlen, table)
    gkw_j, gkw_t = {}, {}
    if grammar:
        bits, trans = _grammar_tables()
        gstate = np.array([2, 0, 0, 0], np.int32)
        gkw_j = dict(gstate=jnp.asarray(gstate), gmasks=jnp.asarray(bits),
                     gtrans=jnp.asarray(trans))
        gkw_t = dict(gstate=torch.tensor(gstate),
                     gmasks=torch.tensor(bits.view(np.int32)),
                     gtrans=torch.tensor(trans))
    raw = _sampler_np(6)
    jsm, tsm = _samplers(raw)
    jfn = jspec.build_spec_ragged(jct, jcd, G)
    tfn = tspec.build_spec_ragged(tct, tcd, G)
    (jtok, jn, jlp, jnext, jkt, jvt, jkd, jvd, jsm2, jlast, jlen,
     jne) = jfn(jpt, jpd, *jcs_t, *jcs_d, jnp.asarray(kt), jnp.asarray(vt),
                jnp.asarray(kd), jnp.asarray(vd), jsm, jnp.asarray(last),
                jnp.asarray(lengths), jnp.asarray(nxt), jnp.asarray(active),
                *(jnp.asarray(m) for m in meta), **gkw_j)
    caches = [torch.tensor(x) for x in (kt, vt, kd, vd)]
    (ttok, tn, tlp, tnext, tsm2, tlast, tlen, tne) = tfn(
        tpt, tpd, *tcs_t, *tcs_d, *caches, tsm, torch.tensor(last),
        torch.tensor(lengths), torch.tensor(nxt), torch.tensor(active),
        *(torch.tensor(m) for m in meta), **gkw_t)
    for a, b in ((ttok, jtok), (tn, jn), (tnext, jnext), (tlen, jlen),
                 (tne, jne)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert list(_np(tlen)[1:3]) == [11, 8]
    np.testing.assert_allclose(_np(tlp), np.asarray(jlp), **TOL)
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), **TOL)
    assert not np.array_equal(_np(tlast)[1], last[1])
    _check_sampler(jsm2, tsm2)
    got = [_np(c) for c in caches]
    np.testing.assert_allclose(got[0][:, 1:], np.asarray(jkt)[:, 1:], **TOL)
    np.testing.assert_allclose(got[1][:, 1:], np.asarray(jvt)[:, 1:], **TOL)
    for g, w in zip(got[2:], (jkd, jvd)):
        np.testing.assert_allclose(g[..., :-1, :], np.asarray(w)[..., :-1, :],
                                   **TOL)
    if grammar:
        # the constrained slot's emitted tokens follow its automaton
        bits, trans = _grammar_tables()
        st = 2
        for tok in _np(ttok)[0][:_np(tn)[0]]:
            assert bits[st, tok >> 5] >> np.uint32(tok & 31) & 1
            st = trans[st, tok]


def test_admit_tail_and_draft_ingest_equal_reference(pair):
    ((jct, jpt), (tct, tpt)), ((jcd, jpd), (tcd, tpd)) = pair
    raw = _sampler_np(8)
    raw["greedy"][2] = False
    last = np.random.default_rng(2).standard_normal((B, 128)).astype(
        np.float32)
    jsm, tsm = _samplers(raw)
    mask = np.zeros((1, 16), np.uint8)
    mask[0, 1] = 0xA5
    for slot, m in ((2, None), (1, mask)):
        jtok, jlp, jsm = jspec.build_spec_admit_tail(jct)(
            jsm, jnp.asarray(last), jnp.int32(slot),
            *(() if m is None else (jnp.asarray(m),)))
        ttok, tlp, tsm = tspec.build_spec_admit_tail(tct)(
            tsm, torch.tensor(last), slot,
            None if m is None else torch.tensor(m))
        assert int(ttok) == int(jtok)
        np.testing.assert_allclose(float(tlp), float(jlp), **TOL)
        _check_sampler(jsm, tsm)
    assert 8 <= int(ttok) < 16 and (0xA5 >> (int(ttok) - 8)) & 1
    (jcs_d, tcs_d) = _tables(T_DENSE)[1]
    kd, vd = _cache_np(DRAFT, B, T_DENSE, 5)
    buf = np.random.default_rng(3).integers(0, 128, (1, 16)).astype(np.int32)
    jk, jv = jspec.build_draft_ingest(jcd)(
        jpd, *jcs_d, jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(buf),
        jnp.int32(8), jnp.int32(2))
    tk, tv = torch.tensor(kd), torch.tensor(vd)
    tspec.build_draft_ingest(tcd)(tpd, *tcs_d, tk, tv, torch.tensor(buf),
                                  torch.tensor(8), torch.tensor(2))
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **TOL)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL)
    assert not np.array_equal(_np(tk)[:, 2, :, 8:24], kd[:, 2, :, 8:24])


# --------------------------------------------------------------- engines

PLAN = [([3, 14, 15, 9, 2, 6], dict(temperature=0.0), 16),
        (list(range(5, 75)), dict(temperature=0.0), 12),
        ([27, 1, 8, 2, 8], dict(temperature=0.9, top_k=0, top_p=0.9, seed=7),
         16),
        ([4, 4, 9], dict(temperature=0.8, top_k=20, seed=3), 10)]
EC = dict(max_slots=2, max_context=256, prefill_buckets=(32,), gamma=3)
PATHS = {"dense": {}, "paged": dict(kv_pages=8),
         "paged-int8": dict(kv_pages=8, cache_type="int8"),
         "ragged": dict(kv_pages=8, ragged_token_budget=64,
                        prefill_chunk=32)}


def _drive(eng, req_cls, param_cls, plan):
    outs = []
    for p, sp, n in plan:
        _, q = eng.submit(req_cls(list(p), param_cls(**sp), max_tokens=n,
                                  ignore_eos=True))
        outs.append([q, [], False])
    for _ in range(500):
        eng.step()
        for o in outs:
            while not o[0].empty():
                x = o[0].get_nowait()
                if x.token_id >= 0:
                    o[1].append(x.token_id)
                o[2] = o[2] or x.finished
        if all(o[2] for o in outs):
            break
    return [o[1] for o in outs]


DRAFT_KEYS = ("draft_proposed", "draft_accepted", "tokens_by_path__spec")


@pytest.mark.parametrize("path", list(PATHS))
def test_draft_engine_streams_equal_reference(pair, path):
    """Greedy and seeded-sampled requests (a 70-token prompt chunks past
    the 32-token bucket) on two slots through the draft engine, against
    the JAX draft engine of the same path (the JAX dense one for the
    ragged path: see test_spec_ragged_window_position): token streams and
    draft counts equal."""
    ((jct, jpt), (tct, tpt)), ((jcd, jpd), (tcd, tpd)) = pair
    ec = dict(EC, **PATHS[path])
    jeng = JEngine(jct, jpt, None,
                   JConfig(**(EC if path == "ragged" else ec)),
                   draft=(jcd, jpd))
    teng = TEngine(tct, tpt, None, TConfig(**ec), draft=(tcd, tpd),
                   device="cpu")
    want = _drive(jeng, JRequest, JParams, PLAN)
    got = _drive(teng, TRequest, TParams, PLAN)
    assert got == want
    assert [len(s) for s in got] == [n for _, _, n in PLAN]
    for k in DRAFT_KEYS:
        assert teng.metrics[k] == jeng.metrics[k], k
    assert teng.metrics["draft_proposed"] > 0
    assert teng.metrics["tokens_by_path__spec"] == sum(len(s) for s in got)
    if path == "ragged":
        m = teng.metrics
        assert m["spec_ragged_dispatches"] > 0
        assert m["ragged_prefill_tokens"] == sum(len(p) for p, _, _ in PLAN)
        assert m["rloop_exit_finish"] == 0 and teng._ragged_loop_fn is None


def test_spec_ragged_window_position(pair):
    """A verify window starts at the carried next_token, emitted but not
    yet written, at position prompt_len + generated - 1. The reference's
    ragged tick packs it at prompt_len + generated
    (localai_tpu/engine/engine.py _spec_ragged_tick), one position late,
    leaving a hole the target then attends: with a perfect draft its
    greedy stream leaves the target's. The port's equals it, and equals
    the dense draft engine."""
    ((jct, jpt), (tct, tpt)), _ = pair
    plan = [([5, 9, 2, 7], dict(temperature=0.0), 20)]
    ec = dict(EC, gamma=4, **PATHS["ragged"])
    plain = _drive(JEngine(jct, jpt, None, JConfig(**EC)), JRequest,
                   JParams, plan)
    jrag = _drive(JEngine(jct, jpt, None, JConfig(**ec), draft=(jct, jpt)),
                  JRequest, JParams, plan)
    teng = TEngine(tct, tpt, None, TConfig(**ec), draft=(tct, tpt),
                   device="cpu")
    assert _drive(teng, TRequest, TParams, plan) == plain
    assert jrag != plain        # the reference's fault (ROADMAP queue 3)
    assert teng.metrics["draft_accepted"] == teng.metrics["draft_proposed"]


@pytest.mark.parametrize("path", ["dense", "ragged"])
def test_perfect_draft_accepts_and_equals_plain(pair, path):
    """draft = target, greedy: every proposal accepted, the plain engine's
    stream, more than one token a spec step."""
    ((jct, jpt), (tct, tpt)), _ = pair
    ec = dict(EC, gamma=4, **PATHS[path])
    plan = [([5, 9, 2, 7], dict(temperature=0.0), 20)]
    teng = TEngine(tct, tpt, None, TConfig(**ec), draft=(tct, tpt),
                   device="cpu")
    plain = TEngine(tct, tpt, None, TConfig(**dict(ec, gamma=4)),
                    device="cpu")
    got = _drive(teng, TRequest, TParams, plan)
    assert got == _drive(plain, TRequest, TParams, plan)
    m = teng.metrics
    assert m["draft_accepted"] / m["draft_proposed"] > 0.95
    assert (len(got[0]) - 1) / (m["draft_proposed"] // 4) > 1.0


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    ckpt = tiny_checkpoint(tmp_path_factory)
    return (jloader.load_model(ckpt, dtype="float32"),
            tloader.load_model(ckpt, dtype="float32", device="cpu"), ckpt)


SCHEMA_G = json_schema_grammar({
    "type": "object", "properties": {"a": {"type": "integer"},
                                     "b": {"type": "string"}},
    "required": ["a", "b"]})


def _gec(**kw):
    return dict(max_slots=4, max_context=128, prefill_buckets=(16, 64),
                prefill_chunk=16, kv_pages=14, prompt_cache=False, gamma=3,
                ragged_token_budget=96, **kw)


def _greqs(req_cls, param_cls, tok):
    return [req_cls(tok.encode("emit json:"),
                    param_cls(temperature=0.0), max_tokens=24,
                    grammar=SCHEMA_G),
            req_cls(tok.encode("emit json:"),
                    param_cls(temperature=0.8, seed=5), max_tokens=24,
                    grammar=SCHEMA_G),
            req_cls(tok.encode("the quick brown fox"),
                    param_cls(temperature=0.0), max_tokens=16,
                    ignore_eos=True)]


def _drain(eng, reqs):
    outs = [eng.submit(r)[1] for r in reqs]
    for _ in range(2000):
        if not eng.step():
            break
    res = []
    for q in outs:
        ids, reason = [], None
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                ids.append(o.token_id)
            reason = o.finish_reason if o.finished else reason
        res.append((ids, reason))
    return res


def test_grammar_on_ragged_draft_engine_equals_reference(loaded):
    """Table-backed grammars ride spec-as-ragged (the counterpart of
    tests/test_grammar_device.py's spec-as-ragged case, with grammar
    tenants beside a free one). With a perfect draft the greedy streams
    are the target's: the JAX ragged engine's (no draft; the reference's
    own ragged draft engine places its windows one position late,
    test_spec_ragged_window_position); every proposal of a greedy slot is
    accepted, and every grammar stream, the seeded-sampled one too, is
    accepted by the matcher."""
    (jcfg, jp, jtok), (tcfg, tp, ttok), _ = loaded
    jeng = JEngine(jcfg, jp, jtok, JConfig(**_gec()))
    teng = TEngine(tcfg, tp, ttok, TConfig(**_gec()), draft=(tcfg, tp),
                   device="cpu")
    want = _drain(jeng, _greqs(JRequest, JParams, jtok))
    got = _drain(teng, _greqs(TRequest, TParams, ttok))
    assert [got[0], got[2]] == [want[0], want[2]]
    assert got[1][0] and got[1][1] in ("eos", "length", "stop")
    m = teng.metrics
    assert m["spec_ragged_dispatches"] > 0
    assert m["draft_accepted"] > 0.5 * m["draft_proposed"] > 0
    assert teng.metrics["grammar_table_states"] > 1
    cg = tm.GrammarCache(ttok).get(SCHEMA_G)
    for ids, _ in got[:2]:
        st = cg.state()
        for t in ids:
            if t in ttok.eos_ids:
                assert st.done
                break
            assert st.accept(t)


def test_grammar_with_draft_raises_as_reference(loaded):
    """A grammar on a dense draft engine, and an automaton that does not
    fit the tables, raise ValueError at submit in both packages."""
    (jcfg, jp, jtok), (tcfg, tp, ttok), _ = loaded
    dense = dict(max_slots=2, max_context=128, prefill_buckets=(16,))
    for ec, g in ((dense, SCHEMA_G), (_gec(grammar_table_states=4),
                                      SCHEMA_G)):
        for E, C, R, P, cfg, p, tok, kw in (
                (JEngine, JConfig, JRequest, JParams, jcfg, jp, jtok, {}),
                (TEngine, TConfig, TRequest, TParams, tcfg, tp, ttok,
                 dict(device="cpu"))):
            eng = E(cfg, p, tok, C(**ec), draft=(cfg, p), **kw)
            with pytest.raises(ValueError, match="ragged|grammar_table"):
                eng.submit(R(tok.encode("x"), P(temperature=0.0),
                             max_tokens=4, grammar=g))


def test_draft_vocab_mismatch_raises(pair):
    ((_, _), (tct, tpt)), _ = pair
    small = tllama.LlamaConfig(**dict(DRAFT, vocab_size=64))
    with pytest.raises(ValueError, match="vocab"):
        TEngine(tct, tpt, None, TConfig(**EC),
                draft=(small, tllama.init_params(small, device="cpu")),
                device="cpu")


# --------------------------------------------------------------- backend

def test_load_draft_model_streams_over_grpc(loaded):
    """LoadModel(draft_model=<name under model_path>, n_draft=3) serves
    speculative decoding over gRPC: the JAX backend's greedy tokens, and
    the draft counts in GetMetrics."""
    from localai_tpu.backend.client import BackendClient
    from localai_tpu.backend.llm import LLMServicer as JServicer
    from localai_tpu.backend import pb as jpb
    from localai_tpu_torch.backend.server import serve

    ckpt = loaded[2]
    load = dict(model=ckpt, model_path=os.path.dirname(ckpt),
                draft_model=os.path.basename(ckpt), n_draft=3,
                context_size=128, parallel=2, dtype="float32",
                prefill_buckets=[32])
    js_ = JServicer()
    assert js_.LoadModel(jpb.ModelOptions(**load), None).success
    try:
        want = [t for rep in js_.PredictStream(jpb.PredictOptions(
            prompt="pack my box", tokens=12, temperature=0.0,
            ignore_eos=True), None) for t in rep.token_ids]
        jm = js_.GetMetrics(jpb.MetricsRequest(), None).metrics
    finally:
        js_.shutdown()
    server, servicer, port = serve("127.0.0.1:0", device="cpu")
    client = BackendClient(f"127.0.0.1:{port}")
    try:
        assert client.wait_ready(attempts=40, sleep=0.1)
        r = client.load_model(**load)
        assert r.success, r.message
        assert servicer.engine.ec.gamma == 3
        m0 = client.metrics()
        chunks = list(client.predict_stream(prompt="pack my box", tokens=12,
                                            temperature=0.0,
                                            ignore_eos=True))
        got = [t for c in chunks for t in c.token_ids]
        m = client.metrics()
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1)
    assert got == want and len(got) == 12
    assert m["draft_proposed"] - m0["draft_proposed"] > 0
    assert m["draft_accepted"] - m0["draft_accepted"] > 0   # a perfect draft
    assert m["tokens_by_path__spec"] - m0["tokens_by_path__spec"] == 12
    assert jm["draft_proposed"] > 0


# ------------------------------------------------- the standalone decoder

def _greedy_plain(tct, tpt, prompt, n):
    eng = TEngine(tct, tpt, None, TConfig(max_slots=1, max_context=256,
                                          prefill_buckets=(32,)),
                  device="cpu")
    return [o.token_id for o in eng.generate(TRequest(
        list(prompt), TParams(temperature=0.0), max_tokens=n,
        ignore_eos=True))]


def test_speculative_extend_matches_decode_chain(pair):
    """extend() over a window == sequential decode_step calls."""
    ((_, _), (tct, tpt)), _ = pair
    cos, sin = trope(tct.rope, 64)
    kc, vc = tllama.init_kv_cache(tct, 1, 64, device="cpu")
    tllama.prefill(tpt, tct, torch.tensor([[3, 14, 15, 9, 2]]),
                   torch.tensor([5]), cos, sin, kc, vc, torch.tensor([0]))
    kc2, vc2 = kc.clone(), vc.clone()
    window = torch.tensor([[7, 21, 4]])
    el = tllama.extend(tpt, tct, window, torch.tensor([5]), cos, sin, kc, vc)
    seq = [tllama.decode_step(tpt, tct, window[:, i], torch.tensor([5 + i]),
                              cos, sin, kc2, vc2)[0] for i in range(3)]
    np.testing.assert_allclose(_np(el[0]), _np(torch.stack(seq)), rtol=2e-4,
                               atol=2e-4)


def test_speculative_greedy_equals_target_greedy(pair):
    ((jct, jpt), (tct, tpt)), ((jcd, jpd), (tcd, tpd)) = pair
    prompt = [3, 14, 15, 9, 2, 6]
    dec = SpeculativeDecoder(tct, tpt, tcd, tpd, gamma=4, max_context=256,
                             device="cpu")
    out = dec.generate(prompt, 16, temperature=0.0)
    assert out == _greedy_plain(tct, tpt, prompt, 16)
    jdec = JDecoder(jct, jpt, jcd, jpd, gamma=4, max_context=256)
    assert out == jdec.generate(prompt, 16, temperature=0.0)
    assert dec.stats.proposed == jdec.stats.proposed > 0
    assert dec.stats.accepted == jdec.stats.accepted


def test_speculative_perfect_draft_full_acceptance(pair):
    ((_, _), (tct, tpt)), _ = pair
    dec = SpeculativeDecoder(tct, tpt, tct, tpt, gamma=4, max_context=256,
                             device="cpu")
    prompt = [5, 9, 2, 7]
    out = dec.generate(prompt, 12, temperature=0.0)
    assert out == _greedy_plain(tct, tpt, prompt, 12)
    assert dec.stats.acceptance_rate == 1.0


def test_speculative_sampled_equals_reference(pair):
    """temperature 0.8, seed 5: in vocab, and the JAX decoder's tokens
    (both draw from numpy's generator on the same probabilities)."""
    ((jct, jpt), (tct, tpt)), ((jcd, jpd), (tcd, tpd)) = pair
    dec = SpeculativeDecoder(tct, tpt, tcd, tpd, gamma=3, max_context=256,
                             device="cpu")
    out = dec.generate([1, 2, 3], 20, temperature=0.8, seed=5)
    assert len(out) == 20
    assert all(0 <= t < tct.vocab_size for t in out)
    jdec = JDecoder(jct, jpt, jcd, jpd, gamma=3, max_context=256)
    assert out == jdec.generate([1, 2, 3], 20, temperature=0.8, seed=5)
