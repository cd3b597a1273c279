"""Context shift in the PyTorch port (localai_tpu_torch: ops/kvcache
`requantize`, models/llama `cache_shift` / `cache_shift_paged`, the
engine's `_dev_shift` and every host length that subtracts a slot's
shifted tokens) against the JAX package, on the CPU.

Tolerances (the reference's functions called eagerly, op by op, as its
own unit tests call them; jit's rewrites move its last bits):
- f32 caches: 2e-5 (the same products and sums in the same order; the
  llama3 rope's cos differs from XLA's by an ulp at one frequency);
- bf16 caches: one bf16 step (the f32 rotation, rounded once to bf16);
- int8 caches: q and scales equal where the rotation's cos and sin equal
  XLA's bit for bit (plain and yarn rope). Under llama3 that ulp of cos
  moves a row's amax by an ulp, and amax / 127 by up to 2: scales within
  2 ulp, q equal except where the f32 value before rounding sits within
  1e-3 of a .5 tie.
Engines (the tiny checkpoint, f32 weights): greedy and seeded-sampled
streams that cross the context cap twice equal the JAX engine's token for
token on the dense, paged and ragged paths and over int8 KV; the int8-KV
reference runs under LOCALAI_FORCE_PALLAS=1, whose kernels share the port's
f32 arithmetic (its XLA CPU path dequantizes int8 KV to bf16).
"""
import queue

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
from localai_tpu.ops import kvcache as jkv
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kvcache as tkv
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
ROPES = {
    "plain": {},
    "llama3": dict(rope_scaling="llama3", rope_scale_factor=8.0,
                   rope_original_max_position=64),
    "yarn": dict(rope_scaling="yarn", rope_scale_factor=4.0,
                 rope_original_max_position=64),
}
GEOM = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=512, dtype="float32")


def _cfgs(rope):
    kw = dict(GEOM, **ROPES[rope])
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _jax_copy(t, dtype=None):
    """A JAX array of its own from a port tensor or numpy array. On the CPU
    jnp.asarray may alias a numpy buffer (and so a tensor's memory) and
    reads it when the dispatched computation runs, which can be after the
    port has written the tensor in place: every array handed to the
    reference here is a copy."""
    a = t.numpy() if isinstance(t, torch.Tensor) else t
    return jnp.array(a, dtype=dtype, copy=True)


def _quant_pair(x):
    """The same int8 cache in both packages from f32 numpy `x` [..., T, D]
    (the port's quantize_tokens, which the reference's equals bit for
    bit on the CPU)."""
    q, s = tkv.quantize_tokens(torch.from_numpy(x))
    s = s.reshape(*s.shape[:-1], s.shape[-1] // 128, 128)
    return (jkv.QuantKV(_jax_copy(q), _jax_copy(s)),
            tkv.QuantKV(q.clone(), s.clone()))


def _assert_quant_close(got, ref, pre, rope):
    """int8 parity: equal, or under llama3 (module docstring) scales within
    2 ulp and q equal except at .5 ties of `pre`, the f32 values before
    rounding (q = round(pre))."""
    if rope != "llama3":
        np.testing.assert_array_equal(_np(got.s), np.asarray(ref.s))
        np.testing.assert_array_equal(_np(got.q), np.asarray(ref.q))
        return
    np.testing.assert_array_max_ulp(_np(got.s), np.asarray(ref.s), maxulp=2)
    gq, rq = _np(got.q).astype(np.int32), np.asarray(ref.q, np.int32)
    off = gq != rq
    assert np.abs(gq - rq).max() <= 1
    frac = np.abs(np.abs(pre) % 1.0 - 0.5)
    assert (frac[off] < 1e-3).all(), f"{off.sum()} q differ off a tie"


# ------------------------------------------------------------ requantize

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_requantize_equals_reference(layout):
    """requantize in the dense [.., T // 128, 128] and the paged block
    [NB, KVH, 1, 128] scale layouts: q and scales equal the reference's."""
    rng = np.random.default_rng(1)
    shape = (2, 2, 3, 256, 16) if layout == "dense" else (2, 5, 2, 128, 16)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    jc, tc = _quant_pair(np.zeros(shape, np.float32))
    r = jkv.requantize(jc, jnp.asarray(x))
    g = tkv.requantize(tc, torch.from_numpy(x))
    assert tuple(g.s.shape) == tuple(r.s.shape) == tuple(tc.s.shape)
    np.testing.assert_array_equal(_np(g.q), np.asarray(r.q))
    np.testing.assert_array_equal(_np(g.s), np.asarray(r.s))


# ----------------------------------------------------- the dense shift

def _dense_case(kind, seed=2):
    """Caches [L, B, KVH, T, D] in both packages, lengths [B]."""
    rng = np.random.default_rng(seed)
    L, B, KVH, T, D = 2, 2, 2, 256, 16
    k = rng.standard_normal((L, B, KVH, T, D)).astype(np.float32)
    v = rng.standard_normal((L, B, KVH, T, D)).astype(np.float32)
    if kind == "int8":
        (jk, tk), (jv, tv) = _quant_pair(k), _quant_pair(v)
    else:
        jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        tdt = torch.bfloat16 if kind == "bf16" else torch.float32
        jk, jv = _jax_copy(k, jdt), _jax_copy(v, jdt)
        tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    lengths = np.array([200, 77], np.int32)
    return (jk, jv, _jax_copy(lengths)), (tk, tv,
                                            torch.from_numpy(lengths))


@pytest.mark.parametrize("rope", sorted(ROPES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_cache_shift_equals_reference(kind, rope):
    """cache_shift of slot 0 (keep 4, discard 61) against the reference's:
    K rolled and rotated back by 61 positions under the rope's scaling, V
    rolled, rows past the moved span and slot 1 as they were, lengths[0]
    down by 61 — in place in the port."""
    jcfg, tcfg = _cfgs(rope)
    (jk, jv, jl), (tk, tv, tl) = _dense_case(kind)
    kw = dict(keep=4, discard=61)
    rk, rv, rl = jllama.cache_shift(jcfg, jk, jv, jl, 0, **kw)
    if kind == "int8":
        # the f32 values the port quantizes: the shift of the dequantized
        # slot, divided by the fresh scales
        fk, fv = tkv.dequant(tk, torch.float32), tkv.dequant(tv, torch.float32)
        tllama.cache_shift(tcfg, fk, fv, tl.clone(), 0, **kw)
    gk, gv, gl = tllama.cache_shift(tcfg, tk, tv, tl, 0, **kw)
    assert gk is tk and gv is tv and gl is tl
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    assert gl.tolist() == [139, 77]
    if kind == "int8":
        for got, ref, f in ((gk, rk, fk), (gv, rv, fv)):
            s = tkv.token_scales(got)[..., None]
            _assert_quant_close(got, ref, (f / s).numpy(), rope)
        return
    tol = F32 if kind == "f32" else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(_np(gk), _np(rk), **tol)
    np.testing.assert_array_equal(_np(gv), _np(rv))


# ----------------------------------------------------- the paged shift

def _paged_case(kind, seed=3):
    """A shuffled pool [L, NB, KVH, 128, D] and a slot row whose tail
    holds an unallocated entry (trash block 0)."""
    rng = np.random.default_rng(seed)
    L, NB, KVH, D = 2, 9, 2, 16
    pool = rng.standard_normal((L, NB, KVH, 128, D)).astype(np.float32)
    row = np.array([6, 2, 8, 3, 5, 0], np.int32)
    if kind == "int8":
        jp, tp = _quant_pair(pool)
    else:
        jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        tdt = torch.bfloat16 if kind == "bf16" else torch.float32
        jp, tp = _jax_copy(pool, jdt), torch.from_numpy(pool).to(tdt)
    return jp, tp, row


def _live(x):
    """Every block but the trash block 0 (unallocated tail entries land
    there in any order)."""
    return x[:, 1:]


@pytest.mark.parametrize("rope", sorted(ROPES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_cache_shift_paged_equals_reference(kind, rope):
    """cache_shift_paged (keep 1 block, discard 2) on a shuffled pool:
    the tail blocks of the row (virtual 3.., physical 3 and 5) rotated
    back by 256 positions in place, every other block as it was."""
    jcfg, tcfg = _cfgs(rope)
    jp, tp, row = _paged_case(kind)
    kw = dict(keep_blocks=1, discard_blocks=2)
    before = _np(tp.q if kind == "int8" else tp).copy()
    ref = jllama.cache_shift_paged(jcfg, jp, jnp.asarray(row), **kw)
    if kind == "int8":
        f = tkv.dequant(tp, torch.float32)
        tllama.cache_shift_paged(tcfg, f, torch.from_numpy(row), **kw)
    got = tllama.cache_shift_paged(tcfg, tp, torch.from_numpy(row), **kw)
    assert got is tp
    if kind == "int8":
        s = tkv.token_scales(got)[..., None]
        pre = (f / s).numpy()
        _assert_quant_close(
            tkv.QuantKV(_live(got.q), _live(got.s)),
            jkv.QuantKV(_live(ref.q), _live(ref.s)), _live(pre), rope)
        q = _np(got.q)
    else:
        tol = F32 if kind == "f32" else dict(rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(_live(_np(got)), _live(_np(ref)), **tol)
        q = _np(got)
    for pb in (1, 2, 4, 6, 7, 8):       # not in the row's tail
        np.testing.assert_array_equal(q[:, pb], before[:, pb])


# ------------------------------------------ the step after a shift (int8)

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # a paged shift needs 3 blocks: contexts of 384 tokens and more
    return tiny_checkpoint(tmp_path_factory, max_position=512)


@pytest.fixture(scope="module")
def models(ckpt):
    return (jloader.load_model(ckpt, dtype="float32"),
            tloader.load_model(ckpt, dtype="float32", device="cpu"))


def _model_case(models, paged):
    """Both packages' f32 models over the same int8 KV: the port prefills
    a prompt into slot 0 (dense: 260 tokens in a [L, 2, KVH, 512, D]
    cache; paged: 400 through a shuffled 4-block row over a 7-block pool)
    and the reference starts from a copy of those rows."""
    from localai_tpu.ops.rope import rope_table as jrope
    from localai_tpu_torch.ops import paged as tpaged
    from localai_tpu_torch.ops.rope import rope_table as trope

    (jcfg, jp, _), (tcfg, tp, _) = models
    T, n = 512, 400 if paged else 260
    rng = np.random.default_rng(5)
    toks = rng.integers(3, jcfg.vocab_size, (1, n)).astype(np.int32)
    table = np.array([[5, 2, 6, 3], [0, 0, 0, 0]], np.int32) if paged \
        else None
    if paged:
        tkc, tvc = tpaged.init_paged(tcfg.num_layers, 7, tcfg.num_kv_heads,
                                     tcfg.head_dim, cache_type="int8")
    else:
        tkc, tvc = tllama.init_kv_cache(tcfg, 2, T, cache_type="int8")
    tcos, tsin = trope(tcfg.rope, T)
    tt = None if table is None else torch.from_numpy(table)
    tllama.prefill(tp, tcfg, torch.from_numpy(toks), torch.tensor([n]),
                   tcos, tsin, tkc, tvc, torch.tensor([0]), table=tt)
    jkc, jvc = (jkv.QuantKV(_jax_copy(c.q), _jax_copy(c.s))
                for c in (tkc, tvc))
    jcos, jsin = jrope(jcfg.rope, T)
    return dict(j=[jcfg, jp, jcos, jsin, jkc, jvc], t=[tcfg, tp, tcos, tsin,
                                                        tkc, tvc],
                table=table, n=n)


# the logits of the step after a shift over int8 KV: the reference's
# Pallas kernels (interpret mode) and the port's plain versions both work
# in f32 on the same int8 rows, so they differ by summation order; the
# requantized rows are equal (test_cache_shift_equals_reference). 1e-4 is
# the f32 model bar of tests/test_torch_model.py, far inside the 6e-2 int8
# bar of tests/test_torch_paged.py.
STEP_TOL = 1e-4


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_step_after_shift_logits(models, monkeypatch, paged):
    """Over int8 KV, shift slot 0 twice (dense: keep 4, discard 100;
    paged: keep 1 block, discard 1, the row permuted as the engine does)
    and decode one token after each: the logits equal the reference's
    within STEP_TOL."""
    monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    c = _model_case(models, paged)
    jcfg, jp, jcos, jsin, jkc, jvc = c["j"]
    tcfg, tp, tcos, tsin, tkc, tvc = c["t"]
    table, n = c["table"], c["n"]
    active = np.array([True, False])
    # jitted (one compile each; eager JAX compiles every op on its own)
    # jitted, as the reference's engine runs them (eager JAX compiles
    # every op on its own); jit's rewrites (a product with 1/127 for the
    # division, fused multiply-adds) move the requantized scales by an ulp
    shift_d = jax.jit(jllama.cache_shift, static_argnums=(0, 4),
                      static_argnames=("keep", "discard"))
    shift_p = jax.jit(jllama.cache_shift_paged, static_argnums=(0,),
                      static_argnames=("keep_blocks", "discard_blocks"))
    decode = jax.jit(jllama.decode_step, static_argnums=(1,))
    for step, tok in enumerate((7, 11)):
        if paged:
            row = table[0].copy()
            jkc = shift_p(jcfg, jkc, jnp.asarray(row), keep_blocks=1,
                          discard_blocks=1)
            tllama.cache_shift_paged(tcfg, tkc, torch.from_numpy(row),
                                     keep_blocks=1, discard_blocks=1)
            table[0] = np.concatenate([row[:1], row[2:], row[1:2]])
            n -= 128
            jt, tt = jnp.asarray(table), torch.from_numpy(table)
        else:
            lens = np.array([n, 0], np.int32)
            # the port decrements lens[0] in place: the reference reads
            # a copy of its own
            jkc, jvc, _ = shift_d(jcfg, jkc, jvc, _jax_copy(lens), 0,
                                  keep=4, discard=100)
            tllama.cache_shift(tcfg, tkc, tvc, torch.from_numpy(lens), 0,
                               keep=4, discard=100)
            n -= 100
            jt = tt = None
        nxt = np.array([tok, 0], np.int32)
        lens = np.array([n, 0], np.int32)
        jl, jkc, jvc = decode(
            jp, jcfg, jnp.asarray(nxt), jnp.asarray(lens), jcos, jsin, jkc,
            jvc, jnp.asarray(active), table=jt)
        tl = tllama.decode_step(tp, tcfg, torch.from_numpy(nxt),
                                torch.from_numpy(lens), tcos, tsin, tkc, tvc,
                                torch.from_numpy(active), table=tt)
        np.testing.assert_allclose(_np(tl)[0], np.asarray(jl)[0],
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=f"after shift {step + 1}")
        n += 1


# ------------------------------------------------------------- the engines

def _drive(eng, req_cls, param_cls, plan):
    """Submit the plan's requests — (when, prompt, sampling, max_tokens,
    extra GenRequest fields), `when` the step to submit at or a predicate
    on the shifts so far — and step the engine to the end. Returns per
    request (tokens, logprobs, finish reason, shift count), and `info`:
    for each shift of a paged engine whether the slot was the only holder
    of every page it had ("owned": its pages rotate in place), and the
    shifted tokens of the slot at each grammar rollback ("repairs")."""
    shifts: dict[int, int] = {}
    info = {"owned": [], "repairs": []}
    run, repair = eng._dev_shift, eng._repair

    def rolled(idx, slot):
        info["repairs"].append(slot.shifted)
        return repair(idx, slot)

    def counted(idx):
        rid = eng._slots[idx].request_id
        shifts[rid] = shifts.get(rid, 0) + 1
        if getattr(eng, "_paged", False) and hasattr(eng, "_block_ref"):
            info["owned"].append(all(eng._block_ref[b] == 1
                                     for b in eng._slot_blocks[idx]))
        return run(idx)

    eng._dev_shift, eng._repair = counted, rolled
    outs, pending, steps = [], list(plan), 0
    while pending or any(o[3] is None for o in outs):
        while pending and (pending[0][0](shifts) if callable(pending[0][0])
                           else steps >= pending[0][0]):
            _, p, sp, n, kw = pending.pop(0)
            rid, q = eng.submit(req_cls(list(p), param_cls(**sp),
                                        max_tokens=n, ignore_eos=True,
                                        logprobs=True, **kw))
            outs.append([q, [], [], None, rid])
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
                    o[2].append(c.logprob)
                if c.finished:
                    o[3] = c.finish_reason
        assert steps < 5000
    return [(o[1], o[2], o[3], shifts.get(o[4], 0)) for o in outs], info


def _rand(seed, n):
    return np.random.default_rng(seed).integers(3, 300, n).tolist()


GREEDY, SEEDED = dict(temperature=0.0), dict(temperature=0.8, seed=5)
SHIFT = dict(context_shift=True)
DENSE_EC = dict(max_slots=5, max_context=128, prefill_buckets=(32,),
                prefill_chunk=32, decode_loop=8, decode_block=4)
PAGED_EC = dict(max_slots=4, max_context=384, prefill_buckets=(32,),
                prefill_chunk=64, decode_loop=8, decode_block=4,
                kv_pages=16)
P = _rand(40, 256)            # tenant A's prompt: two full blocks


def _dense_plan():
    # dense: each shift drops (128 - 4) // 2 = 62 tokens; the cap at 126
    # rows is crossed twice by 200 tokens after 20 and 150 after 60
    return [(0, _rand(1, 20), GREEDY, 200, SHIFT),
            (2, _rand(2, 60), SEEDED, 150, SHIFT),
            (4, _rand(3, 10), GREEDY, 40, {})]


# a grammar that never completes on this vocabulary: its stream runs until
# the model picks the terminator's first byte
GBNF = 'root ::= ("0" "1" " ")+ "\\x01\\x02"'


def _dense_grammar_plan(tok):
    # the dense wave also holds a table-backed grammar slot that shifts
    # (twice, at a 101-token prompt) beside a stop-string slot, which keeps
    # both on the block path while it lives: the grammar slot's blocks,
    # sampled under block-start masks, roll back after its shifts
    return _dense_plan() + [
        (4, tok.encode("emit the digits now, then stop: " * 4), GREEDY, 200,
         dict(SHIFT, grammar=GBNF)),
        (4, _rand(4, 20), GREEDY, 100, dict(SHIFT, stop=("zzqq",)))]


def _paged_plan():
    # paged: keep 1 block, drop (3 - 1) // 2 = 1 block (128 tokens) a
    # shift; the cap at 382 rows, crossed twice by 190 tokens after 330. A (P) ends and is retained; D (P + a
    # tail) takes A's slot by its slot prompt cache, so A's two full
    # blocks stay in the hash index; B (P + a tail, shifting) would borrow
    # them, but takes lcp 0 and owns its pages; once B has shifted twice,
    # C (P) borrows A's blocks and must stream A's tokens. S shifts with a
    # seeded sampler, W is a wide-top_k sampled tenant beside them.
    return [(0, P, GREEDY, 8, {}),
            (6, P + _rand(5, 10), GREEDY, 60, {}),
            (8, P + _rand(6, 74), GREEDY, 190, SHIFT),
            (9, _rand(7, 330), SEEDED, 190, SHIFT),
            (10, _rand(8, 15), dict(temperature=0.9, top_k=200, seed=17),
             40, {}),
            (lambda sh: sh.get(2, 0) >= 2, P, GREEDY, 8, {})]


def _paged_int8_plan():
    return [(0, _rand(9, 330), GREEDY, 190, SHIFT),
            (2, _rand(10, 340), GREEDY, 180, SHIFT),
            (4, _rand(11, 30), GREEDY, 40, {})]


def _ragged_plan():
    # ragged: a prefill chunk packs beside the decode rows while the
    # shifting slots run (arrivals at steps 6 and 30)
    return [(0, _rand(12, 330), GREEDY, 190, SHIFT),
            (2, _rand(13, 340), SEEDED, 180, SHIFT),
            (6, _rand(14, 90), GREEDY, 30, {}),
            (30, _rand(15, 70), GREEDY, 30, {})]


# (engine config, plan(tokenizer), request indices that shift twice, force
# Pallas)
WAVES = {
    "dense": (DENSE_EC, _dense_grammar_plan, (0, 1, 3), False),
    "dense-int8": (dict(DENSE_EC, cache_type="int8"),
                   lambda tok: _dense_plan(), (0, 1), True),
    "paged": (PAGED_EC, lambda tok: _paged_plan(), (2, 3), False),
    "paged-int8": (dict(PAGED_EC, cache_type="int8"),
                   lambda tok: _paged_int8_plan(), (0, 1), True),
    "ragged": (dict(PAGED_EC, ragged_token_budget=64),
               lambda tok: _ragged_plan(), (0, 1), False),
}


def _shift_reads_its_row_first(je):
    """The reference engine's paged shift dispatches its program on a
    zero-copy view of the slot's table row (jnp.asarray of a numpy row;
    JAX aliases a host buffer it finds aligned) and rewrites that row in
    place right after (localai_tpu/engine/engine.py:2074-2085): whether
    the program reads the old row or the new one depends on the thread
    timing and the row's alignment, so on the state the process is in.
    Waiting for the program before the rewrite gives the engine's
    intended order every time."""
    shift = je._shift_fn
    je._shift_fn = lambda *a: jax.block_until_ready(shift(*a))


@pytest.fixture(scope="module")
def waves(models):
    """Each wave through the JAX engine and the port's, once per module:
    {name: (port results, reference results, port engine, the port's
    _drive info, reference engine, the reference's _drive info)}."""
    import os

    cache = {}

    def get(name):
        if name not in cache:
            ec, plan, _, pallas = WAVES[name]
            (jcfg, jp, jtok), (tcfg, tp, ttok) = models
            old = os.environ.get("LOCALAI_FORCE_PALLAS")
            if pallas:
                os.environ["LOCALAI_FORCE_PALLAS"] = "1"
            try:
                je = JEngine(jcfg, jp, jtok, JConfig(**ec))
                _shift_reads_its_row_first(je)
                ref, jinfo = _drive(je, JRequest, JParams, plan(jtok))
            finally:
                if old is None:
                    os.environ.pop("LOCALAI_FORCE_PALLAS", None)
                else:
                    os.environ["LOCALAI_FORCE_PALLAS"] = old
            te = TEngine(tcfg, tp, ttok, TConfig(**ec), device="cpu")
            got, info = _drive(te, TRequest, TParams, plan(ttok))
            cache[name] = (got, ref, te, info, je, jinfo)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(WAVES))
def test_shift_streams_equal_reference(waves, name):
    """Greedy and seeded-sampled streams that cross the cap twice, beside
    free tenants, equal the JAX engine's token for token, each to its
    budget ("length")."""
    got, ref, te, *_ = waves(name)
    _, plan, _, _ = WAVES[name]
    assert [g[0] for g in got] == [r[0] for r in ref]
    for (toks, _, reason, _), p in zip(got, plan(te.tok)):
        if "grammar" not in p[4]:      # a grammar slot may finish "stop"
            assert reason == "length" and len(toks) == p[3]


@pytest.mark.parametrize("name", list(WAVES))
def test_each_shifting_stream_shifts_twice(waves, name):
    """The context_shift requests shift exactly twice, as the reference's
    do, and the others never; a shifted slot holds nothing afterwards (no
    retained rows, no hash entries, no prompt-cache record)."""
    got, ref, te, info, *_ = waves(name)
    _, _, twice, _ = WAVES[name]
    owned = info["owned"]
    assert [g[3] for g in got] == [r[3] for r in ref]
    assert [g[3] for g in got] == [2 if i in twice else 0
                                   for i in range(len(got))]
    assert all(s is None for s in te._slots)
    assert te.metrics["tokens_generated"] == sum(len(g[0]) for g in got)
    # every shift rotated pages the shifting slot held alone
    assert all(owned) and len(owned) == (2 * len(twice) if te._paged else 0)


@pytest.mark.parametrize("name", ["dense-int8", "paged-int8"])
def test_int8_logprobs_equal_reference(waves, name):
    """Over int8 KV every served token's logprob — those of the steps
    after each shift included — equals the reference's within STEP_TOL
    (the reference on its Pallas kernels: see STEP_TOL)."""
    got, ref, *_ = waves(name)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[1], r[1], rtol=STEP_TOL, atol=STEP_TOL)


def test_shared_prefix_tenant_keeps_its_stream(waves):
    """The paged wave: the shifting tenant B took none of A's pages (they
    were in the hash index), and C (A's prompt, after B's two shifts)
    borrowed them and streams A's tokens; the reused prompt tokens equal
    the reference engine's."""
    got, ref, te, _, je, _ = waves("paged")
    assert got[5][0] == got[0][0]
    for k in ("prompt_tokens_reused", "prompt_cache_hits"):
        assert te.metrics[k] == je.metrics[k], k
    # D reused P through A's slot, C at least A's first full block; B
    # (lcp 0) none
    assert te.metrics["prompt_cache_hits"] == 2
    assert te.metrics["prompt_tokens_reused"] >= 256 + 128


def test_grammar_slot_shifts_then_rolls_back(waves):
    """The dense wave's table-backed grammar slot (context_shift, beside a
    stop-string slot that keeps both on the block path) shifts, and its
    later blocks roll back to the matcher's accepted prefix at the
    shifted length (_repair): the JAX engine's stream (test above) and
    rollbacks."""
    got, _, te, info, je, jinfo = waves("dense")
    assert te.metrics["grammar_table_states"] > 1      # table-backed
    assert info["repairs"] == jinfo["repairs"]
    assert any(n > 0 for n in info["repairs"])         # after a shift
    assert te.metrics["grammar_rollbacks"] == len(info["repairs"])
    assert got[3][3] == 2 and got[3][0]


@pytest.mark.parametrize("case", ["draft", "paged-tiny-context", "tiered"])
def test_submit_refuses_context_shift(models, case):
    """The reference's three ValueErrors at submit: a draft model, a paged
    context of keep + discard blocks or fewer, a sink_window policy."""
    (_, _, _), (tcfg, tp, ttok) = models
    kw, draft, match = {
        "draft": (dict(max_context=128), (tcfg, tp),
                  "not supported with a draft model"),
        "paged-tiny-context": (dict(max_context=128, kv_pages=6), None,
                               "context_shift with paged KV"),
        "tiered": (dict(max_context=512, kv_pages=16,
                        kv_policy="sink_window(sinks=64, window=128)"),
                   None, "sink_window kv_policy"),
    }[case]
    eng = TEngine(tcfg, tp, ttok, TConfig(max_slots=2, prefill_buckets=(32,),
                                          **kw), draft=draft, device="cpu")
    with pytest.raises(ValueError, match=match):
        eng.submit(TRequest([3, 4, 5], TParams(temperature=0.0),
                            max_tokens=400, ignore_eos=True,
                            context_shift=True))


def test_shifted_paged_slot_leaves_nothing(models):
    """On a paged engine with the host tier, a slot that shifted is never
    retained, hash-registered, recorded or spilled: one that ran to its
    end, and one preempted after a shift, whose ResumeToken carries no
    chain; afterwards every page is free."""
    (_, _, _), (tcfg, tp, ttok) = models
    eng = TEngine(tcfg, tp, ttok, TConfig(**dict(PAGED_EC,
                                                 kv_host_bytes=1 << 24)),
                  device="cpu")
    req = dict(params=TParams(temperature=0.0), ignore_eos=True,
               context_shift=True)
    _, qa = eng.submit(TRequest(_rand(20, 330), max_tokens=100, **req))
    rb, _ = eng.submit(TRequest(_rand(21, 340), max_tokens=220, **req))
    done = False
    while not done or not any(s is not None and s.request_id == rb
                              and s.shifted for s in eng._slots):
        eng.step()
        while not qa.empty():
            o = qa.get_nowait()
            done = done or o.finished
    assert o.finish_reason == "length" and o.generated_tokens == 100
    man = eng.preempt(0.0)
    assert len(man) == 1 and man[0]["chain"] == []
    m = eng.metrics
    assert m["preempt_spilled_blocks"] == 0 and m["kv_host_spills"] == 0
    assert m["kv_blocks_in_use"] == 0
    assert eng._hash_index == {} and eng._released_lru == []
    assert all(t == [] for t in eng._slot_kv_tokens)
