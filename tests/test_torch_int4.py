"""int4 weights in the PyTorch port (localai_tpu_torch: ops/quant with
bits=4 and the packed layout of ops/kernels.pack_int4, the int4 plain
versions of the weight GEMMs, models/llama's int4 head and experts, the
loader's int4/q4 recipe, the engines and the backend) against the JAX
package, on the CPU. (The loader's int4 leaves and the int4 recipe's
teacher-forced logits: the "int4" cases of tests/test_torch_model.py; the
int4 experts' _moe_mlp: tests/test_torch_moe.py; the kernels on the card:
the int4 `cuda` tests of tests/test_torch_weight_gemm.py.)

Tolerances:
- quantization: bit-identical (the int4 values after unpacking, and the
  scales), the port's contract;
- f32 activations: 2e-5 (the same products of exact integers and f32
  values, summed in another order);
- bf16 activations (qmatmul; the head takes x in f32): atol 1e-3 + rtol
  2**-6, tests/test_torch_weight_gemm.py's bar for the same two roundings
  (the f32 sum to bf16, then the scaled product);
- greedy streams through the dense, paged and ragged engines: token for
  token with f32 activations over the reference's quantize_params(bits=4)
  weights; the int4 recipe itself (bf16 activations) meets a near tie
  that bf16 flips (REF_MARGIN), so its streams are held to the
  reference's teacher-forced logits within the recipe's 6e-2 logit bar;
- the reference's own bar for its int4 forward (tests/test_ops.py: argmax
  agreement with the f32 model above 0.5) held for the port.
Engines run once each, in module-scoped fixtures, on one torch thread.
"""
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
from localai_tpu.ops import quant as jquant
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kernels as tk
from localai_tpu_torch.ops import quant as tquant
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2 ** -6, atol=1e-3)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


# ---------------------------------------------------------- quantization

@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(24, 40), (3, 24, 40), (4, 32, 48)],
                         ids=["2d", "layers", "experts"])
def test_quantize_int4_bit_identical(shape, src):
    """quantize(bits=4) gives the reference's int4 values (unpacked) and
    scales, packed two a byte along the input axis ([.., in/2, out]);
    quantize_np(bits=4) gives the reference's int8 container unpacked."""
    w = (_rng(4).standard_normal(shape) * 0.3).astype(np.float32)
    w[..., 3] = 0.0                          # the 1e-8 scale floor
    jw = jnp.asarray(w, jnp.dtype(src))
    w32 = np.asarray(jnp.asarray(jw, jnp.float32))
    ref = jquant.quantize(jw, bits=4)
    assert ref["q"].dtype == jnp.int4
    want_q = np.asarray(ref["q"], np.int8)
    mine = tquant.quantize(torch.tensor(w32).to(getattr(torch, src)), bits=4)
    assert mine.q.dtype == torch.uint8
    assert tuple(mine.q.shape) == shape[:-2] + (shape[-2] // 2, shape[-1])
    np.testing.assert_array_equal(tk.unpack_int4(mine.q).numpy(), want_q)
    np.testing.assert_array_equal(mine.s.numpy(), np.asarray(ref["s"]))
    mine_np = tquant.quantize_np(w32, bits=4)
    ref_np = jquant.quantize_np(w32, bits=4)
    for a, b in ((mine_np, ref_np), (mine_np, {"q": want_q,
                                               "s": np.asarray(ref["s"])})):
        np.testing.assert_array_equal(a["q"], b["q"])
        np.testing.assert_array_equal(a["s"], b["s"])
    assert mine_np["q"].dtype == np.int8
    np.testing.assert_array_equal(
        tquant.dequantize(mine, torch.float32).numpy(),
        np.asarray(jquant.dequantize(ref, jnp.float32)))


def test_pack_unpack_round_trips():
    """Every value from -8 to 7 in both nibbles: unpack(pack(v)) == v and
    pack(unpack(p)) == p for every byte; byte (j, n) holds row 2j in its
    low nibble."""
    v = torch.tensor([[a, b] for a in range(-8, 8) for b in range(-8, 8)],
                     dtype=torch.int8).T.contiguous()        # [2, 256]
    p = tk.pack_int4(v)
    assert p.dtype == torch.uint8 and tuple(p.shape) == (1, 256)
    assert torch.equal(tk.unpack_int4(p), v)
    assert torch.equal(p[0] & 15, (v[0].to(torch.int16) & 15).to(
        torch.uint8))
    every = torch.arange(256, dtype=torch.uint8).reshape(1, 256)
    assert torch.equal(tk.pack_int4(tk.unpack_int4(every)), every)
    with pytest.raises(ValueError, match="even K"):
        tk.pack_int4(torch.zeros(3, 16, dtype=torch.int8))


# ------------------------------------------------- products vs the reference

def _int4_leaf(seed, K, N):
    w = (_rng(seed).standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    ref = jquant.quantize(jnp.asarray(w), bits=4)
    return ref, tquant.quantize(torch.tensor(w), bits=4)


@pytest.mark.parametrize("M", [1, 8, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul_int4_equals_reference(dtype, M):
    ref, mine = _int4_leaf(M, 256, 384)
    x = _rng(M + 1).standard_normal((M, 256)).astype(np.float32)
    want = jquant.qmatmul(jnp.asarray(x, jnp.dtype(dtype)), ref)
    got = tquant.qmatmul(torch.tensor(x).to(getattr(torch, dtype)), mine)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


def test_lm_head_int4_equals_reference():
    """models/llama._lm_head on a packed int4 head: x32 rounded to bf16,
    exact bf16 products summed in f32, then × s in f32, as the reference's
    _lm_head does on its jnp.int4 head."""
    ref, mine = _int4_leaf(9, 64, 200)
    x = _rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    embed = np.zeros((200, 64), np.float32)
    want = jllama._lm_head(jnp.asarray(x), {"embed": jnp.asarray(embed),
                                            "lm_head": ref})
    model = type("P", (), {"lm_head": mine, "embed": torch.tensor(embed)})()
    got = tllama._lm_head(torch.tensor(x), model)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-expert"])
def test_moe_w4_plain_equals_reference_einsum(shared):
    """moe_w4_matmul_plain is the reference's dequantize-then-einsum on a
    jnp.int4 stack: each weight bf16(f32(q) * s), bf16 products summed in
    f32, rounded once."""
    E, K, N, M = 4, 64, 96, 5
    w = (_rng(7).standard_normal((E, K, N)) * K ** -0.5).astype(np.float32)
    ref = jquant.quantize(jnp.asarray(w), bits=4)
    mine = tquant.quantize(torch.tensor(w), bits=4)
    xs = (M, K) if shared else (M, E, K)
    x = _rng(8).standard_normal(xs).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jnp.einsum("mk,ekn->men" if shared else "mek,ekn->men", jx,
                      jquant.dequantize(ref, jnp.bfloat16))
    got = tk.moe_w4_matmul_plain(torch.tensor(x).to(torch.bfloat16), mine.q,
                                 mine.s)
    assert got.dtype == torch.bfloat16 and got.shape == (M, E, N)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-3)


def test_int4_wrappers_run_plain_on_cpu_without_counting(monkeypatch):
    """On the CPU the int4 wrappers are their plain versions and count
    nothing; qmatmul and _experts hand a packed weight to the int4
    wrappers as stored."""
    tk.reset_launch_counts()
    ref, mine = _int4_leaf(1, 32, 48)
    x = torch.tensor(_rng(2).standard_normal((2, 3, 32)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(
            tk.w4a16_matmul(x.to(dt), mine.q, mine.s),
            tk.w4a16_matmul_plain(x.to(dt), mine.q, mine.s), rtol=0, atol=0)
    torch.testing.assert_close(tk.head_matmul(x, mine.q, mine.s),
                               tk.head_matmul_plain(x, mine.q, mine.s),
                               rtol=0, atol=0)
    counts = tk.launch_counts()
    assert counts["w4a16_matmul"] == counts["head_matmul_int4"] == 0
    seen = []

    def spy(name, plain):
        def f(x, q, s):
            seen.append((name, q.dtype))
            return plain(x, q, s)
        return f

    monkeypatch.setattr(tquant, "w4a16_matmul",
                        spy("w4", tk.w4a16_matmul_plain))
    monkeypatch.setattr(tllama, "moe_w4_matmul",
                        spy("moe4", tk.moe_w4_matmul_plain))
    tquant.qmatmul(x, mine)
    stack = tquant.quantize(torch.randn(2, 32, 16), bits=4)
    tllama._experts(x[0], stack)
    assert seen == [("w4", torch.uint8), ("moe4", torch.uint8)]


# ------------------------------------------------------------ the model

def test_params_from_jax_carries_int4_leaves(ckpt):
    """The reference's int4 tree (jnp.int4 leaves as numpy) becomes
    packed QuantWeights whose values and scales are the reference's."""
    cfg = jloader.load_config(ckpt, dtype="int4")
    tree = jax.tree_util.tree_map(np.asarray, jloader.load_params(
        ckpt, cfg, dtype="int4"))
    model = tllama.params_from_jax(tree, tloader.load_config(
        ckpt, dtype="int4"), device="cpu")
    for i, layer in enumerate(model.layers):
        for name in layer.weight_names():
            w = layer[name]
            assert w.q.dtype == torch.uint8, name
            np.testing.assert_array_equal(
                tk.unpack_int4(w.q).numpy(),
                np.asarray(tree["layers"][name]["q"][i], np.int8))
            np.testing.assert_array_equal(
                w.s.numpy(), tree["layers"][name]["s"][i])
    np.testing.assert_array_equal(
        tk.unpack_int4(model.lm_head.q).numpy(),
        np.asarray(tree["lm_head"]["q"], np.int8))


def test_int4_forward_argmax_agrees_with_f32(ckpt):
    """The reference's own bar for its int4 forward (tests/test_ops.py:
    argmax agreement with the f32 model above 0.5 over a 10-token
    sequence), held for the port's int4 recipe."""
    from localai_tpu_torch.ops.rope import rope_table

    toks = None
    out = {}
    for dtype in ("float32", "int4"):
        cfg, params, _ = tloader.load_model(ckpt, dtype=dtype, device="cpu")
        toks = (torch.arange(10) % cfg.vocab_size)[None]
        cos, sin = rope_table(cfg.rope, 128)
        kc, vc = tllama.init_kv_cache(cfg, 1, 128)
        out[dtype] = tllama.extend(params, cfg, toks, torch.tensor([0]), cos,
                                   sin, kc, vc, slot_map=torch.tensor([0]))
    assert params.layers[0]["wq"].q.dtype == torch.uint8
    agree = (out["float32"].argmax(-1) == out["int4"].argmax(-1)).float()
    assert float(agree.mean()) > 0.5


# ------------------------------------------------------------ the engines

ENGINE_EC = {
    "dense": dict(max_slots=2, max_context=128, prefill_buckets=(16, 32),
                  prefill_chunk=32, decode_loop=8),
    "paged": dict(max_slots=2, max_context=128, prefill_buckets=(16, 32),
                  prefill_chunk=32, decode_loop=8, kv_pages=6),
    "ragged": dict(max_slots=3, max_context=128, prefill_buckets=(16,),
                   prefill_chunk=16, kv_pages=10, ragged_token_budget=64),
}
PROMPTS = [list(range(3, 12)), list(range(5, 75))]     # bucket, chunked
NEW = 12


def _streams(eng, req, par):
    return [[o.token_id for o in eng.generate(req(
        p, par(temperature=0.0), max_tokens=NEW, ignore_eos=True))
        if o.token_id >= 0] for p in PROMPTS]


@pytest.fixture(scope="module")
def recipes(ckpt):
    """Both packages' int4 models: "f32" — the f32 load quantized by the
    reference's quantize_params(bits=4), carried over by params_from_jax
    (f32 activations); "int4" — each loader's int4 recipe (bf16
    activations)."""
    jcfg, jp, jtok = jloader.load_model(ckpt, dtype="float32")
    jq = jquant.quantize_params(jp, bits=4)
    tcfg, _, ttok = tloader.load_model(ckpt, dtype="float32", device="cpu")
    tq = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                                tcfg, device="cpu")
    out = {"f32": ((jcfg, jq, jtok), (tcfg, tq, ttok)),
           "int4": (jloader.load_model(ckpt, dtype="int4"),
                    tloader.load_model(ckpt, dtype="int4", device="cpu"))}
    assert out["int4"][1][1].layers[0]["w_gate"].q.dtype == torch.uint8
    return out


@pytest.fixture(scope="module")
def streams(recipes):
    """{(recipe, path): (the JAX engine's streams or None, the port's)}:
    the reference engine runs for the f32 recipe only (the int4 recipe is
    held to teacher-forced reference logits instead)."""
    cache = {}

    def get(recipe, path):
        if (recipe, path) not in cache:
            (jcfg, jp, jtok), (tcfg, tp, ttok) = recipes[recipe]
            ec = ENGINE_EC[path]
            cache[recipe, path] = (
                _streams(JEngine(jcfg, jp, jtok, JConfig(**ec)), JRequest,
                         JParams) if recipe == "f32" else None,
                _streams(TEngine(tcfg, tp, ttok, TConfig(**ec),
                                 device="cpu"), TRequest, TParams))
        return cache[recipe, path]

    return get


@pytest.mark.parametrize("path", list(ENGINE_EC))
def test_int4_streams_equal_reference_engine(streams, path):
    """f32 activations over the reference's int4 weights: greedy streams (a
    bucketed prompt and a chunked one) through the dense, paged and ragged
    engines equal the JAX engine's token for token, each to its budget."""
    want, got = streams("f32", path)
    assert got == want
    assert all(len(s) == NEW for s in got)


# The int4 recipe's greedy streams (bf16 activations) cannot be held to the
# JAX engine's token for token: the chunked prompt's first token has a
# near tie, logits 0.41881 and 0.41838 in the reference's extend (the
# port's 0.41877 and 0.41805; the two differ by up to 0.0026 over the
# vocabulary), and the engines take the other one. So each served token
# is held to the reference's teacher-forced logits at its position: within
# the int4 recipe's logit bar (tests/test_torch_model.py, 6e-2) of the
# row's largest.
REF_MARGIN = 6e-2


@pytest.mark.parametrize("path", list(ENGINE_EC))
def test_int4_recipe_streams_hold_reference_logits(recipes, streams, path):
    """The int4 recipe (both loaders' int4 weights, bf16 activations)
    through the dense, paged and ragged engines: every stream to its
    budget, each greedy token within REF_MARGIN of the largest of the
    reference's teacher-forced logits at its position."""
    from localai_tpu.ops.rope import rope_table as jrope_table

    _, got = streams("int4", path)
    (jcfg, jp, _), _ = recipes["int4"]
    jcos, jsin = jrope_table(jcfg.rope, 128)
    for prompt, toks in zip(PROMPTS, got):
        assert len(toks) == NEW
        seq = np.array([prompt + toks[:-1]], np.int32)
        kc, vc = jllama.init_kv_cache(jcfg, 1, 128)
        logits, _, _ = jllama.extend(jp, jcfg, jnp.asarray(seq),
                                     jnp.asarray([0]), jcos, jsin, kc, vc,
                                     slot_map=jnp.asarray([0]))
        rows = np.asarray(logits, np.float32)[0, len(prompt) - 1:]
        gap = rows.max(-1) - rows[np.arange(NEW), toks]
        assert float(gap.max()) <= REF_MARGIN, gap


def test_load_model_q4_with_an_int4_draft(ckpt):
    """LoadModel(dtype="q4") with a draft_model loads both the target and
    the draft as int4 (the draft loads with the request's dtype, as the
    reference's does) and serves with speculative decoding."""
    import os

    from localai_tpu_torch.backend import pb
    from localai_tpu_torch.backend.llm import LLMServicer

    os.environ["LOCALAI_NO_PREWARM"] = "1"
    s = LLMServicer(device="cpu")
    try:
        r = s.LoadModel(pb.ModelOptions(
            model=ckpt, dtype="q4", draft_model=ckpt, n_draft=2,
            parallel=2, context_size=128, prefill_buckets=[32]), None)
        assert r.success, r.message
        eng = s.engine
        dcfg, dparams = eng._draft
        assert eng.cfg.dtype == dcfg.dtype == "bfloat16"
        for model in (eng.params, dparams):
            assert model.layers[0]["wq"].q.dtype == torch.uint8
            assert model.lm_head.q.dtype == torch.uint8
        out = s.Predict(pb.PredictOptions(prompt="hello world", tokens=6,
                                          temperature=0.0, ignore_eos=True),
                        None)
        assert out.tokens == 6
        m = s.GetMetrics(pb.MetricsRequest(), None).metrics
        assert m["draft_proposed"] > 0
    finally:
        if s.engine is not None:
            s.engine.stop()
        os.environ.pop("LOCALAI_NO_PREWARM", None)
