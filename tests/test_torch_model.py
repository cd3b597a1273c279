"""PyTorch port model + loader (localai_tpu_torch.models.llama,
localai_tpu_torch.engine.loader) against the JAX package on the tiny HF
checkpoint (tests/fixtures.build_tiny_checkpoint).

Tolerances:
- loader parameters: EXACT (same bytes; int8 payloads and scales
  bit-identical to the reference's quantization);
- f32 logits: 1e-4 — two layers of f32 matmuls summed in another order;
- int8 and int4 weights (bf16 activations): 6e-2 on logits of magnitude
  ~1 — bf16 rounds at slightly different places in the two frameworks
  (fused XLA elementwise chains vs one rounding per torch op), and int4's
  coarser values move no rounding further than int8's. The reference runs
  with LOCALAI_FORCE_PALLAS=1 so its attention is the Pallas kernels
  (interpret mode) whose f32 math the port's kernels share — its default
  CPU path dequantizes int8 KV to bf16 instead (ops/kvcache.dequant).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.models import llama as jllama
from localai_tpu.ops.kvcache import QuantKV as JQuantKV
from localai_tpu.ops.rope import rope_table as jrope_table
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import quant as tquant
from localai_tpu_torch.ops.kernels import unpack_int4
from localai_tpu_torch.ops.kvcache import QuantKV as TQuantKV
from localai_tpu_torch.ops.quant import is_quantized
from localai_tpu_torch.ops.rope import rope_table as trope_table
from torch_threads import one_torch_thread  # noqa: F401

T = 128


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


def _flat_jax(tree):
    """{name: numpy} with per-layer slices, int8 leaves as name.q / name.s
    (int4 payloads widened to int8)."""
    out = {}

    def put(name, x):
        if isinstance(x, dict):
            put(name + ".q", x["q"])
            put(name + ".s", x["s"])
        elif x.dtype == jnp.int4:
            out[name] = np.asarray(x, np.int8)
        else:
            out[name] = np.asarray(jnp.asarray(x, jnp.float32)
                                   if x.dtype == jnp.bfloat16 else x)

    for k in ("embed", "final_norm", "lm_head"):
        if k in tree:
            put(k, tree[k])
    for k, v in tree["layers"].items():
        for i in range(np.asarray(v["q"] if isinstance(v, dict)
                                  else v).shape[0]):
            put(f"layers.{i}.{k}", {"q": v["q"][i], "s": v["s"][i]}
                if isinstance(v, dict) else v[i])
    return out


def _flat_torch(model):
    """{name: numpy} of every buffer; packed int4 payloads unpacked."""
    out = {}
    for name, t in model.named_buffers():
        if t.dtype == torch.uint8:
            t = unpack_int4(t)
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4",
                                   "q4"])
def test_loader_params_equal_reference(ckpt, dtype):
    jcfg = jloader.load_config(ckpt, dtype=dtype)
    tcfg = tloader.load_config(ckpt, dtype=dtype)
    assert dataclasses_equal(jcfg, tcfg)
    ref = _flat_jax(jloader.load_params(ckpt, jcfg, dtype=dtype))
    mine = _flat_torch(tloader.load_params(ckpt, tcfg, dtype=dtype,
                                           device="cpu"))
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_quantize_params_matches_int8_load(ckpt):
    """ops/quant.quantize_params over a bf16 load gives the same int8
    payloads and scales as loading with dtype="int8" (same order: bf16 load
    cast, then per-output-channel quantization)."""
    from localai_tpu_torch.ops.quant import quantize_params

    cfg = tloader.load_config(ckpt, dtype="int8")
    q = quantize_params(tloader.load_params(ckpt, cfg, dtype="bfloat16",
                                            device="cpu"))
    ref = _flat_torch(tloader.load_params(ckpt, cfg, dtype="int8",
                                          device="cpu"))
    mine = _flat_torch(q)
    assert set(mine) == set(ref) and any(k.endswith(".q") for k in mine)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_params_from_jax(ckpt):
    cfg = jloader.load_config(ckpt, dtype="int8")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jloader.load_params(ckpt, cfg,
                                                      dtype="int8"))
    tcfg = tloader.load_config(ckpt, dtype="int8")
    model = tllama.params_from_jax(tree, tcfg, device="cpu")
    assert is_quantized(model.layers[0]["wq"]) and is_quantized(
        model.lm_head)
    assert model.embed.dtype == torch.bfloat16
    mine = _flat_torch(model)
    ref = _flat_jax(tree)
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_params_from_jax_defaults_to_cuda(ckpt):
    """Like every entry point, params_from_jax puts the weights on the
    card unless the caller asks for the CPU: without CUDA and without a
    device it raises."""
    cfg = jloader.load_config(ckpt, dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jloader.load_params(ckpt, cfg,
                                                      dtype="float32"))
    tcfg = tloader.load_config(ckpt, dtype="float32")
    if torch.cuda.is_available():
        model = tllama.params_from_jax(tree, tcfg)
        assert model.embed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tllama.params_from_jax(tree, tcfg)
    assert tllama.params_from_jax(tree, tcfg,
                                  device="cpu").embed.device.type == "cpu"


def test_mixtral_waits_for_its_slice(monkeypatch, tmp_path):
    """The Mixtral slice is ported (the name is the refusal test's): a MoE
    config initializes (router gate f32 [H, E], expert stacks [E, in,
    out]) and quantizes its experts to int8 or, since the int4 slice, to
    packed int4 (q uint8 [E, in/2, out]) in quantize_params; the loader
    takes dtype="int4" (a synthetic checkpoint's int4 payloads in [-7, 7]
    and its scales); the router gate is never quantized."""
    cfg = tllama.LlamaConfig(num_experts=4, num_layers=1, hidden_size=8,
                             intermediate_size=16, num_heads=2,
                             num_kv_heads=2, head_dim=4, vocab_size=16)
    model = tllama.init_params(cfg)
    layer = model.layers[0]
    assert layer.moe_gate.dtype == torch.float32
    assert tuple(layer.moe_gate.shape) == (8, 4)
    assert tuple(layer.moe_w1.shape) == (4, 8, 16)
    assert tuple(layer.moe_w2.shape) == (4, 16, 8)
    m4 = tquant.quantize_params(tllama.init_params(cfg), bits=4)
    assert m4.layers[0].moe_w1.q.dtype == torch.uint8
    assert tuple(m4.layers[0].moe_w1.q.shape) == (4, 4, 16)
    assert tuple(m4.layers[0].moe_w2.q.shape) == (4, 8, 8)
    assert m4.layers[0].moe_gate.dtype == torch.float32
    tquant.quantize_params(model)
    assert tuple(layer.moe_w3.s.shape) == (4, 1, 16)
    assert layer.moe_gate.dtype == torch.float32
    monkeypatch.setenv("LOCALAI_ALLOW_SYNTHETIC", "1")
    d = tmp_path / "synthetic"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(
        {"architectures": ["MixtralForCausalLM"], "vocab_size": 16,
         "hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1,
         "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 4,
         "num_local_experts": 4, "localai_synthetic": True}))
    s4 = tloader.load_params(str(d), tloader.load_config(str(d), "int4"),
                             dtype="int4", device="cpu")
    w1 = s4.layers[0].moe_w1
    assert w1.q.dtype == torch.uint8 and tuple(w1.q.shape) == (4, 4, 16)
    vals = unpack_int4(w1.q)
    assert int(vals.min()) >= -7 and int(vals.max()) <= 7
    torch.testing.assert_close(w1.s, torch.full((4, 1, 16),
                                                8 ** -0.5 * 1.73 / 7))
    assert s4.layers[0].moe_gate.dtype == torch.float32


def _models(ckpt, dtype):
    jcfg = jloader.load_config(ckpt, dtype=dtype)
    jp = jloader.load_params(ckpt, jcfg, dtype=dtype)
    tcfg = tloader.load_config(ckpt, dtype=dtype)
    tp = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, jp, tcfg, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _caches_equalish(jc, tc, tol):
    if isinstance(jc, JQuantKV):
        # int8 payloads may differ by one step where bf16 K/V differ by an
        # ulp; compare the dequantized values
        jd = np.asarray(jc.q, np.float32) * np.asarray(jc.s).reshape(
            *jc.s.shape[:-2], -1)[..., None]
        td = tc.q.float().numpy() * tc.s.reshape(
            *tc.s.shape[:-2], -1)[..., None].numpy()
        np.testing.assert_allclose(td, jd, rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(
            _np(tc.float()), np.asarray(jc, np.float32), rtol=tol, atol=tol)


CASES = [("float32", "", 1e-4), ("int8", "", 6e-2), ("int8", "int8", 6e-2),
         ("int4", "", 6e-2), ("int4", "int8", 6e-2)]


@pytest.mark.parametrize("dtype,cache_type,tol", CASES,
                         ids=["f32", "int8w", "int8w_int8kv", "int4w",
                              "int4w_int8kv"])
def test_prefill_decode_extend_logits(ckpt, monkeypatch, dtype, cache_type,
                                      tol):
    if dtype in ("int8", "int4"):
        monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    jcfg, jp, tcfg, tp = _models(ckpt, dtype)
    B = 2
    rng = np.random.default_rng(0)
    toks = rng.integers(2, jcfg.vocab_size, (B, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    slots = np.array([1, 0], np.int32)
    jcos, jsin = jrope_table(jcfg.rope, T)
    tcos, tsin = trope_table(tcfg.rope, T)
    jkc, jvc = jllama.init_kv_cache(jcfg, B, T, cache_type=cache_type)
    tkc, tvc = tllama.init_kv_cache(tcfg, B, T, cache_type=cache_type)
    assert isinstance(tkc, TQuantKV) == bool(cache_type)

    # prefill (the reference returns new caches; the port writes in place)
    jl, jkc, jvc = jllama.prefill(jp, jcfg, jnp.asarray(toks),
                                  jnp.asarray(lens), jcos, jsin, jkc, jvc,
                                  jnp.asarray(slots))
    tl = tllama.prefill(tp, tcfg, torch.tensor(toks), torch.tensor(lens),
                        tcos, tsin, tkc, tvc, torch.tensor(slots))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=tol, atol=tol)
    _caches_equalish(jkc, tkc, tol)

    # decode: slot 1 holds row 0's prompt (16), slot 0 row 1's (9);
    # slot 0 inactive → its write goes to row T-1
    nxt = np.array([5, 7], np.int32)
    lengths = np.array([9, 16], np.int32)
    active = np.array([False, True])
    jd, jkc, jvc = jllama.decode_step(jp, jcfg, jnp.asarray(nxt),
                                      jnp.asarray(lengths), jcos, jsin, jkc,
                                      jvc, jnp.asarray(active))
    td = tllama.decode_step(tp, tcfg, torch.tensor(nxt),
                            torch.tensor(lengths), tcos, tsin, tkc, tvc,
                            torch.tensor(active))
    np.testing.assert_allclose(_np(td)[1], np.asarray(jd)[1], rtol=tol,
                               atol=tol)
    _caches_equalish(jkc, tkc, tol)

    # extend: a 4-token window for slot 0 at offset 9 (chunked prefill)
    win = rng.integers(2, jcfg.vocab_size, (1, 4)).astype(np.int32)
    jx, jkc, jvc = jllama.extend(jp, jcfg, jnp.asarray(win),
                                 jnp.asarray([9]), jcos, jsin, jkc, jvc,
                                 slot_map=jnp.asarray([0]))
    tx = tllama.extend(tp, tcfg, torch.tensor(win), torch.tensor([9]), tcos,
                       tsin, tkc, tvc, slot_map=torch.tensor([0]))
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=tol, atol=tol)
    jx1, _, _ = jllama.extend(jp, jcfg, jnp.asarray(win), jnp.asarray([9]),
                              jcos, jsin, jkc, jvc, slot_map=jnp.asarray([0]),
                              last_pos=jnp.asarray([2]))
    tx1 = tllama.extend(tp, tcfg, torch.tensor(win), torch.tensor([9]),
                        tcos, tsin, tkc, tvc, slot_map=torch.tensor([0]),
                        last_pos=torch.tensor([2]))
    np.testing.assert_allclose(_np(tx1), np.asarray(jx1), rtol=tol, atol=tol)
