"""Mixtral MoE on the PyTorch port (localai_tpu_torch: the loader's expert
stacks, models/llama._moe_mlp on every path, ops/kernels.moe_w8_matmul's
plain version) against the JAX package and HF transformers, on the tiny
Mixtral that tests/test_mixtral.py builds (4 experts, top-2, hidden 32,
2 layers; a 256-position config so a paged engine has two blocks).

Tolerances:
- f32: 1e-5 for _moe_mlp (the same f32 products, summed in another
  order); 2e-3 for prefill logits against HF, as the reference's own
  test holds itself; greedy and seeded-sampled streams token for token.
- bf16, int8 and int4 _moe_mlp (x and expert weights bf16; quantized
  experts dequantized to the same bf16 bits in both packages): atol 2e-2 on
  outputs of magnitude ~1. Each of the five bf16 roundings (the two
  expert products, silu, the gated product, the down product, the
  combine) can fall one bf16 step (2**-8 relative) apart when its f32 sum
  was taken in another order, and the steps compound through the down
  product and the combine.
- int8 recipe prefill logits (bf16 activations through two layers):
  atol 5e-2 on logits of magnitude ~1, by the same argument over the
  whole forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.models import llama as jllama
from localai_tpu.ops import quant as jquant
from localai_tpu.ops.rope import rope_table as jrope_table
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.device import torch_dtype
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import quant as tquant
from localai_tpu_torch.ops.kernels import (
    moe_w8_matmul, moe_w8_matmul_plain,
)
from localai_tpu_torch.ops.rope import rope_table as trope_table
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=0.0, atol=2e-2)
INT8_LOGITS = dict(rtol=0.0, atol=5e-2)
HF = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def mixtral_ckpt(tmp_path_factory):
    from transformers import MixtralConfig, MixtralForCausalLM

    d = str(tmp_path_factory.mktemp("mixtral"))
    torch.manual_seed(0)
    cfg = MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    m = MixtralForCausalLM(cfg)
    m.eval()
    m.save_pretrained(d, safe_serialization=True)
    return d, m


def _both(d, dtype):
    jcfg = jloader.load_config(d, dtype=dtype)
    jp = jloader.load_params(d, jcfg, dtype=dtype)
    tcfg = tloader.load_config(d, dtype=dtype)
    tp = tloader.load_params(d, tcfg, dtype=dtype, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def f32_models(mixtral_ckpt):
    return _both(mixtral_ckpt[0], "float32")


def _np(x):
    """A port tensor or a JAX array as numpy (bf16 as f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bits(x):
    """The raw bytes of a leaf, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype.name == "bfloat16"
            else a).tobytes()


# ------------------------------------------------------------ the loader

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_loader_bytes_equal_reference(mixtral_ckpt, dtype):
    """Every leaf the port's loader makes is the reference loader's, byte
    for byte: the router gate [H, E] in the model dtype (bf16 under int8,
    never quantized), the expert stacks [E, in, out] (int8: q and scales
    [E, 1, out])."""
    jcfg, jp, tcfg, tp = _both(mixtral_ckpt[0], dtype)
    assert (tcfg.num_experts, tcfg.experts_per_tok) == (4, 2)
    want_gate = torch.float32 if dtype == "float32" else torch.bfloat16
    for i, layer in enumerate(tp.layers):
        assert layer.moe_gate.dtype == want_gate
        assert tuple(layer.moe_gate.shape) == (32, 4)
        assert not hasattr(layer, "w_gate")
        assert layer.weight_names() == ["wq", "wk", "wv", "wo", "moe_w1",
                                        "moe_w2", "moe_w3"]
        for name, ref in jp["layers"].items():
            mine = layer[name]
            if tquant.is_quantized(mine):
                assert jquant.is_quantized(ref), name
                assert _bits(mine.q) == _bits(np.asarray(ref["q"])[i]), name
                assert _bits(mine.s) == _bits(np.asarray(ref["s"])[i]), name
                assert tuple(mine.s.shape) == np.asarray(ref["s"])[i].shape
            else:
                assert _bits(mine) == _bits(np.asarray(ref)[i]), name
    assert tquant.is_quantized(tp.layers[0].moe_w2) == (dtype == "int8")


def _synthetic_dir(mixtral_ckpt, tmp_path, monkeypatch):
    """The tiny Mixtral's config.json alone, marked synthetic (weights
    from the loader's seed, no tokenizer)."""
    import json

    cfg = json.loads(open(f"{mixtral_ckpt[0]}/config.json").read())
    cfg["localai_synthetic"] = True
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("LOCALAI_ALLOW_SYNTHETIC", "1")
    return str(tmp_path)


def test_synthetic_mixtral_params(monkeypatch, mixtral_ckpt, tmp_path):
    """A synthetic Mixtral checkpoint (LOCALAI_ALLOW_SYNTHETIC=1) loads
    int8 expert stacks with scales [E, 1, out] and an f32 router gate,
    made on the device, as the reference's synthetic checkpoint does."""
    d = _synthetic_dir(mixtral_ckpt, tmp_path, monkeypatch)
    tcfg, tp, tok = tloader.load_model(d, dtype="int8", device="cpu")
    assert tok is None
    layer = tp.layers[1]
    assert layer.moe_gate.dtype == torch.float32
    for name, shape in (("moe_w1", (4, 32, 64)), ("moe_w2", (4, 64, 32)),
                        ("moe_w3", (4, 32, 64))):
        w = layer[name]
        assert w.q.dtype == torch.int8 and tuple(w.q.shape) == shape
        assert tuple(w.s.shape) == (4, 1, shape[2])


# -------------------------------------------------------------- _moe_mlp

def _layer_pair(cfg_kw, dtype, quantize, seed=0):
    """One layer's MoE leaves from the reference's init_params (numpy),
    as the reference's per-layer dict and the port's LlamaLayer;
    `quantize`: False, True (int8) or 4 (int4, the reference's jnp.int4
    stacks packed by params_from_jax)."""
    jcfg = jllama.LlamaConfig(**cfg_kw)
    tree = jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                              dtype=jnp.dtype(dtype))
    if quantize:
        tree = jquant.quantize_params(tree, bits=4 if quantize == 4 else 8)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tcfg = tllama.LlamaConfig(**cfg_kw)
    tp = tllama.params_from_jax(tree, tcfg, device="cpu")
    jl = {k: jax.tree_util.tree_map(lambda a: a[0], v)
          for k, v in tree["layers"].items() if k.startswith("moe_")}
    return jl, tp.layers[0], tcfg


MOE_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
               num_layers=1, num_heads=4, num_kv_heads=2, head_dim=8,
               num_experts=4, experts_per_tok=2, dtype="float32")


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
def test_moe_mlp_equals_reference(kind):
    dtype = "float32" if kind == "f32" else "bfloat16"
    jl, tl, _ = _layer_pair(dict(MOE_CFG, dtype=dtype), dtype,
                            quantize={"int8": True, "int4": 4}.get(kind,
                                                                   False))
    if kind == "int4":
        assert tl["moe_w1"].q.dtype == torch.uint8
    assert tl["moe_gate"].dtype == torch.float32
    x = np.random.default_rng(1).standard_normal((3, 5, 32)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = _np(jllama._moe_mlp(jx, jl, 2))
    got = tllama._moe_mlp(torch.from_numpy(x).to(torch_dtype(dtype)),
                          tl, 2)
    assert got.dtype == torch_dtype(dtype)
    assert got.shape == (3, 5, 32)
    np.testing.assert_allclose(_np(got), want, **(F32 if kind == "f32"
                                                   else BF16))


def test_topk_ties_pick_the_lower_expert():
    """Equal router probabilities pick the lower expert index first, as
    jax.lax.top_k does: with an all-zero gate every expert ties and the
    top 2 are experts 0 and 1 (each weighted 1/2); a gate that ties
    experts 1 and 3 above the rest picks 1 and 3. Both give the
    reference's output."""
    jl, tl, _ = _layer_pair(MOE_CFG, "float32", quantize=False)
    # positive features: experts 1 and 3 score sum(x) > 0 under the second
    # gate, above experts 0 and 2 (0)
    x = np.abs(np.random.default_rng(2).standard_normal((1, 4, 32))).astype(
        np.float32)
    gates = [np.zeros((32, 4), np.float32)]
    g = np.zeros((32, 4), np.float32)
    g[:, 1] = g[:, 3] = 1.0
    gates.append(g)
    for gate in gates:
        jl["moe_gate"] = gate
        tl.set_weight("moe_gate", torch.from_numpy(gate.copy()))
        want = _np(jllama._moe_mlp(jnp.asarray(x), jl, 2))
        got = tllama._moe_mlp(torch.from_numpy(x), tl, 2)
        np.testing.assert_allclose(_np(got), want, **F32)
    # experts 1 and 3 alone, equally weighted
    one = dict(tl.named_buffers())
    w = {k: v.clone() for k, v in one.items() if k.startswith("moe_w")}
    for k in w:
        w[k][[0, 2]] = 0
        tl.set_weight(k, w[k])
    alone = tllama._moe_mlp(torch.from_numpy(x), tl, 2)
    np.testing.assert_allclose(_np(alone), _np(got), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-expert"])
def test_moe_w8_matmul_plain_equals_reference(dtype, shared):
    """moe_w8_matmul's plain version (and its CPU dispatch) is the
    reference's dequantize(p, x.dtype) followed by its einsum: x [M, K]
    shared by the experts (w1, w3) or [M, E, K] (w2)."""
    r = np.random.default_rng(3)
    w = (r.standard_normal((4, 48, 32)) * 0.2).astype(np.float32)
    qj = jquant.quantize(jnp.asarray(w))
    q, s = torch.from_numpy(np.array(qj["q"])), torch.from_numpy(
        np.array(qj["s"]))
    assert tuple(s.shape) == (4, 1, 32)
    shape = (6, 48) if shared else (6, 4, 48)
    x = r.standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    dq = jquant.dequantize(qj, jdt)
    eq = "mk,ekn->men" if shared else "mek,ekn->men"
    want = _np(jnp.einsum(eq, jnp.asarray(x, jdt), dq))
    tx = torch.from_numpy(x).to(dtype)
    got = moe_w8_matmul(tx, q, s)
    assert got.dtype == dtype and tuple(got.shape) == (6, 4, 32)
    assert torch.equal(got, moe_w8_matmul_plain(tx, q, s))
    np.testing.assert_allclose(_np(got), want, **(
        F32 if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-3)))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_params_from_jax_carries_experts(quantize):
    """params_from_jax carries the stacked expert leaves across per layer
    — numpy arrays and {"q", "s"} dicts — and init_params draws them for
    a Mixtral config (the router gate in f32)."""
    cfg = dict(MOE_CFG, num_layers=2)
    jcfg = jllama.LlamaConfig(**cfg)
    tree = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    if quantize:
        tree = jquant.quantize_params(tree)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tp = tllama.params_from_jax(tree, tllama.LlamaConfig(**cfg),
                                device="cpu")
    for i, layer in enumerate(tp.layers):
        for k in ("moe_gate", "moe_w1", "moe_w2", "moe_w3"):
            ref = tree["layers"][k]
            if isinstance(ref, dict):
                assert np.array_equal(layer[k].q.numpy(), ref["q"][i])
                assert np.array_equal(layer[k].s.numpy(), ref["s"][i])
            else:
                assert np.array_equal(layer[k].numpy(), ref[i])
    assert tquant.is_quantized(tp.layers[0].moe_w1) == quantize
    own = tllama.init_params(tllama.LlamaConfig(**cfg), seed=0)
    assert own.layers[0].moe_gate.dtype == torch.float32
    assert tuple(own.layers[1].moe_w2.shape) == (4, 48, 32)


@pytest.mark.parametrize("kv_pages", [0, 3], ids=["dense", "paged"])
def test_load_model_serves_mixtral(monkeypatch, mixtral_ckpt, tmp_path,
                                   kv_pages):
    """The backend's LoadModel on a (synthetic, int8) Mixtral directory
    serves PredictStream on the dense engine and on the paged pool, with
    no option of its own."""
    from localai_tpu_torch.backend import pb
    from localai_tpu_torch.backend.llm import LLMServicer

    d = _synthetic_dir(mixtral_ckpt, tmp_path, monkeypatch)
    servicer = LLMServicer(device="cpu")
    try:
        r = servicer.LoadModel(pb.ModelOptions(
            model=d, dtype="int8", parallel=2, context_size=256,
            kv_pages=kv_pages), None)
        assert r.success, r.message
        assert servicer.engine.cfg.num_experts == 4
        assert bool(servicer.engine._paged) == bool(kv_pages)
        toks = [t for c in servicer.PredictStream(pb.PredictOptions(
            prompt_ids=[3, 14, 15, 92, 65], tokens=6, temperature=0.0,
            ignore_eos=True), None) for t in c.token_ids]
        assert len(toks) == 6 and all(0 <= t < 128 for t in toks)
    finally:
        servicer.shutdown()


# ----------------------------------------------------- the model, HF, JAX

def test_prefill_logits_match_hf(mixtral_ckpt, f32_models):
    """The port's prefill (last-token logits) and extend (every position)
    on the loaded checkpoint against HF's MixtralForCausalLM."""
    d, m = mixtral_ckpt
    _, _, tcfg, tp = f32_models
    ids = [1, 5, 9, 13, 17, 21, 25, 29]
    with torch.no_grad():
        ref = m(input_ids=torch.tensor([ids])).logits[0].numpy()
    cos, sin = trope_table(tcfg.rope, 64)
    kc, vc = tllama.init_kv_cache(tcfg, 1, 64, device="cpu")
    toks = torch.tensor([ids])
    last = tllama.prefill(tp, tcfg, toks, torch.tensor([8]), cos, sin, kc,
                          vc, torch.tensor([0]))
    np.testing.assert_allclose(last[0].numpy(), ref[-1], **HF)
    kc, vc = tllama.init_kv_cache(tcfg, 1, 64, device="cpu")
    every = tllama.extend(tp, tcfg, toks, torch.tensor([0]), cos, sin, kc,
                          vc)
    np.testing.assert_allclose(every[0].numpy(), ref, **HF)


def test_int8_recipe_logits_equal_reference(mixtral_ckpt):
    """dtype="int8" (int8 experts and projections, bf16 router gate and
    activations) through both packages' prefill on the same checkpoint."""
    jcfg, jp, tcfg, tp = _both(mixtral_ckpt[0], "int8")
    ids = [[3, 14, 15, 92, 65, 35, 89, 79], [2, 7, 18, 28, 18, 28, 0, 0]]
    lens = [8, 6]
    cos, sin = jrope_table(jcfg.rope, 32)
    kc, vc = jllama.init_kv_cache(jcfg, 2, 32)
    want, _, _ = jllama.prefill(jp, jcfg, jnp.asarray(ids, jnp.int32),
                                jnp.asarray(lens, jnp.int32), cos, sin, kc,
                                vc, jnp.arange(2))
    tcos, tsin = trope_table(tcfg.rope, 32)
    tkc, tvc = tllama.init_kv_cache(tcfg, 2, 32, device="cpu")
    got = tllama.prefill(tp, tcfg, torch.tensor(ids), torch.tensor(lens),
                         tcos, tsin, tkc, tvc, torch.arange(2))
    np.testing.assert_allclose(got.numpy(), _np(want), **INT8_LOGITS)
    assert np.array_equal(got.numpy().argmax(-1), _np(want).argmax(-1))


# ------------------------------------------------------------- the engines

EC = dict(max_slots=3, max_context=128, prefill_buckets=(16,),
          prefill_chunk=16, decode_loop=8, decode_block=4)
PATHS = {"dense": {}, "paged": dict(kv_pages=5),
         "ragged": dict(kv_pages=5, ragged_token_budget=48,
                        ragged_loop_steps=8)}


def _requests(req_cls, param_cls):
    """Four requests: short, chunked (40 > the 16-token chunk), greedy and
    seeded-sampled."""
    rng = np.random.default_rng(5)
    sps = [dict(temperature=0.0), dict(temperature=0.0),
           dict(temperature=0.8, top_k=20, seed=3), dict(temperature=0.0)]
    return [req_cls(rng.integers(2, 128, n).tolist(), param_cls(**sp),
                    max_tokens=10, ignore_eos=True)
            for n, sp in zip((5, 40, 12, 21), sps)]


def _serve(eng, req_cls, param_cls):
    """Two requests, two steps, then two more admitted mid-decode; the
    token streams in request order."""
    reqs = _requests(req_cls, param_cls)
    outs = [eng.submit(r) for r in reqs[:2]]
    for _ in range(2):
        eng.step()
    outs += [eng.submit(r) for r in reqs[2:]]
    for _ in range(500):
        if not eng.step():
            break
    toks = []
    for _, q in outs:
        seq = []
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                seq.append(o.token_id)
        toks.append(seq)
    return toks, dict(eng.metrics)


@pytest.mark.parametrize("path", list(PATHS))
def test_streams_equal_reference_engine(f32_models, path):
    """f32 greedy and seeded-sampled streams of the port's engine equal the
    JAX engine's, token for token, on the dense, paged and ragged paths
    (mid-decode admissions, chunked prefill, the fused loops)."""
    jcfg, jp, tcfg, tp = f32_models
    ec = dict(EC, **PATHS[path])
    ref, _ = _serve(JEngine(jcfg, jp, None, JConfig(**ec)), JRequest,
                    JParams)
    got, m = _serve(TEngine(tcfg, tp, None, TConfig(**ec), device="cpu"),
                    TRequest, TParams)
    assert [len(s) for s in got] == [10] * 4
    assert got == ref
    if path == "ragged":
        assert m["ragged_dispatches"] > 0
        assert m["ragged_prefill_tokens"] == 5 + 40 + 12 + 21
    else:
        assert m["tokens_by_path__loop"] > 0
