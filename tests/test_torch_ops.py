"""PyTorch port (localai_tpu_torch) op leaf modules against the JAX package.

Inputs are made once with numpy from a seed and fed to both. Tolerances:
- f32 elementwise ops (norms, rope, dequant): rtol/atol 1e-6 — the same
  IEEE ops in the same order, up to transcendental rounding (pow, cos/sin);
- f32 attention and matmuls: 2e-5 — sums are taken in a different order;
- bf16 inputs: one bf16 ulp at the magnitudes used (2e-2), because the two
  frameworks round intermediates at slightly different places;
- quantization (int8 payloads, scales): bit-identical, the port's contract.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from localai_tpu.ops import attention as jattn
from localai_tpu.ops import kvcache as jkv
from localai_tpu.ops import norms as jnorms
from localai_tpu.ops import quant as jquant
from localai_tpu.ops import rope as jrope
from localai_tpu_torch.ops import attention as tattn
from localai_tpu_torch.ops import kvcache as tkv
from localai_tpu_torch.ops import norms as tnorms
from localai_tpu_torch.ops import quant as tquant
from localai_tpu_torch.ops import rope as trope
from localai_tpu_torch.ops.kernels import unpack_int4
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(dtype, offset):
    r = _rng(1)
    x = r.standard_normal((3, 5, 32)).astype(np.float32)
    w = r.standard_normal((32,)).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    a = jnorms.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-5,
                        offset=offset)
    b = tnorms.rms_norm(torch.tensor(x).to(td), torch.tensor(w).to(td), 1e-5,
                        offset=offset)
    assert b.dtype == td
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(b), _np(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm(bias):
    r = _rng(2)
    x = r.standard_normal((4, 48)).astype(np.float32)
    w = r.standard_normal((48,)).astype(np.float32)
    bb = r.standard_normal((48,)).astype(np.float32) if bias else None
    a = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                          None if bb is None else jnp.asarray(bb))
    b = tnorms.layer_norm(torch.tensor(x), torch.tensor(w),
                          None if bb is None else torch.tensor(bb))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                               atol=1e-5)


ROPES = [
    dict(scaling="none"),
    dict(scaling="linear", scale_factor=4.0),
    dict(scaling="llama3", scale_factor=8.0, original_max_position=64,
         low_freq_factor=1.0, high_freq_factor=4.0, base=500000.0),
    dict(scaling="yarn", scale_factor=4.0, original_max_position=64),
    dict(scaling="yarn", scale_factor=4.0, original_max_position=64,
         attn_factor=0.9),
]


@pytest.mark.parametrize("kw", ROPES, ids=lambda k: k["scaling"]
                         + ("_af" if "attn_factor" in k else ""))
def test_rope_freqs_table_and_apply(kw):
    jc = jrope.RopeConfig(head_dim=32, **kw)
    tc = trope.RopeConfig(head_dim=32, **kw)
    jf, jm = jrope.rope_freqs(jc)
    tf, tm = trope.rope_freqs(tc)
    assert tm == pytest.approx(jm, rel=1e-12)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=0)
    jcos, jsin = jrope.rope_table(jc, 96)
    tcos, tsin = trope.rope_table(tc, 96)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=1e-5,
                               atol=1e-5)
    r = _rng(3)
    x = r.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = r.integers(0, 96, (2, 7))
    # same tables on both sides: apply_rope itself is held at f32 ulps
    a = jrope.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    b = trope.apply_rope(torch.tensor(x), torch.tensor(np.asarray(jcos)),
                         torch.tensor(np.asarray(jsin)), torch.tensor(pos))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                               atol=1e-6)


def test_apply_rope_bf16_roundtrip_dtype():
    tc = trope.RopeConfig(head_dim=16)
    cos, sin = trope.rope_table(tc, 8)
    x = torch.randn(1, 4, 2, 16, generator=torch.Generator().manual_seed(0))
    out = trope.apply_rope(x.bfloat16(), cos, sin, torch.arange(4)[None])
    assert out.dtype == torch.bfloat16
    ref = trope.apply_rope(x.bfloat16().float(), cos, sin,
                           torch.arange(4)[None])
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_quantize_bit_identical(src):
    r = _rng(4)
    w = (r.standard_normal((2, 24, 40)) * 0.3).astype(np.float32)
    w[0, :, 3] = 0.0                         # exercises the 1e-8 floor
    w[1, 5, 7] = 0.5 * 127 / 127             # ties under rounding
    jw = jnp.asarray(w, jnp.dtype(src))
    ref = jquant.quantize(jw)
    ref_np = jquant.quantize_np(np.asarray(jnp.asarray(jw, jnp.float32)))
    mine_np = tquant.quantize_np(np.asarray(jnp.asarray(jw, jnp.float32)))
    mine = tquant.quantize(torch.tensor(np.asarray(
        jnp.asarray(jw, jnp.float32))).to(getattr(torch, src)))
    for q, s in ((mine_np["q"], mine_np["s"]),
                 (mine.q.numpy(), mine.s.numpy()),
                 (ref_np["q"], ref_np["s"])):
        np.testing.assert_array_equal(q, np.asarray(ref["q"]))
        np.testing.assert_array_equal(s, np.asarray(ref["s"]))
    assert tquant.is_quantized(mine) and tquant.is_quantized(mine_np)
    np.testing.assert_array_equal(
        tquant.dequantize(mine, torch.float32).numpy(),
        np.asarray(jquant.dequantize(ref, jnp.float32)))


def test_int4_waits_for_its_slice():
    """The int4 slice is ported (the name is the refusal test's): bits=4
    quantizes to the reference's values, packed two a byte (unpacked here,
    bit-identical), and loads through qmatmul; an odd K, which no byte
    pair can hold, still raises, naming the limit."""
    r = _rng(4)
    w = (r.standard_normal((24, 40)) * 0.3).astype(np.float32)
    ref = jquant.quantize(jnp.asarray(w), bits=4)
    mine = tquant.quantize(torch.tensor(w), bits=4)
    assert mine.q.dtype == torch.uint8 and tuple(mine.q.shape) == (12, 40)
    np.testing.assert_array_equal(unpack_int4(mine.q).numpy(),
                                  np.asarray(ref["q"], np.int8))
    np.testing.assert_array_equal(mine.s.numpy(), np.asarray(ref["s"]))
    x = r.standard_normal((3, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tquant.qmatmul(torch.tensor(x), mine).numpy(),
        np.asarray(jquant.qmatmul(jnp.asarray(x), ref)), **F32)
    with pytest.raises(ValueError, match="even K"):
        tquant.quantize(torch.zeros(5, 4), bits=4)
    with pytest.raises(ValueError, match="width 3"):
        tquant.quantize(torch.zeros(4, 4), bits=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul(dtype):
    r = _rng(5)
    x = r.standard_normal((3, 4, 24)).astype(np.float32)
    w = (r.standard_normal((24, 40)) * 0.2).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jq = jquant.quantize(jnp.asarray(w))
    tq = tquant.quantize(torch.tensor(w))
    a = jquant.qmatmul(jnp.asarray(x, jd), jq)
    b = tquant.qmatmul(torch.tensor(x).to(td), tq)
    assert b.dtype == td
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(b), _np(a), rtol=tol, atol=tol)
    # dense weights: plain product
    a = jquant.qmatmul(jnp.asarray(x), jnp.asarray(w))
    b = tquant.qmatmul(torch.tensor(x), torch.tensor(w))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


def test_quantize_tokens_and_cache_scatter():
    r = _rng(6)
    x = r.standard_normal((2, 3, 5, 16)).astype(np.float32)
    jq, js = jkv.quantize_tokens(jnp.asarray(x))
    tq, ts = tkv.quantize_tokens(torch.tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    # dense [B, KVH, T, D] int8 cache; scatter rows like decode/prefill do
    B, KVH, T, D = 3, 2, 256, 16
    jc = jkv.init_quant((B, KVH, T, D))
    tc = tkv.init_quant((B, KVH, T, D))
    vals = r.standard_normal((2, KVH, 4, D)).astype(np.float32)
    rows = np.array([2, 0])
    pos = np.array([[0, 1, 130, 255], [5, 6, 7, 200]])
    jidx = (jnp.asarray(rows)[:, None, None], jnp.arange(KVH)[None, :, None],
            jnp.asarray(pos)[:, None, :])
    tidx = (torch.tensor(rows)[:, None, None],
            torch.arange(KVH)[None, :, None], torch.tensor(pos)[:, None, :])
    jc = jkv.cache_scatter(jc, jidx, jnp.asarray(vals))
    tkv.cache_scatter(tc, tidx, torch.tensor(vals))    # in place
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(tc.s.numpy(), np.asarray(jc.s))
    np.testing.assert_allclose(
        tkv.dequant(tc, torch.float32).numpy(),
        np.asarray(jkv.dequant(jc, jnp.float32)), rtol=1e-6, atol=1e-6)
    assert tkv.padded_len(129) == jkv.padded_len(129) == 256
    with pytest.raises(ValueError):
        tkv.init_quant((1, 1, 100, 16))


def _attn_inputs(seed, B, S, H, KVH, D, T=None):
    r = _rng(seed)
    q = r.standard_normal((B, S, H, D)).astype(np.float32)
    k = r.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = r.standard_normal((B, S, KVH, D)).astype(np.float32)
    kc = vc = None
    if T is not None:
        kc = r.standard_normal((B, KVH, T, D)).astype(np.float32)
        vc = r.standard_normal((B, KVH, T, D)).astype(np.float32)
    return q, k, v, kc, vc


@pytest.mark.parametrize("window", [None, 5])
def test_mha_prefill(window):
    q, k, v, _, _ = _attn_inputs(7, 3, 16, 4, 2, 16)
    lens = np.array([16, 9, 1], np.int32)
    a = jattn.mha_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(lens), sliding_window=window)
    b = tattn.mha_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(lens), sliding_window=window)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


@pytest.mark.parametrize("window", [None, 6])
def test_mha_extend(window):
    q, _, _, kc, vc = _attn_inputs(8, 2, 5, 4, 2, 16, T=32)
    qpos = np.array([[10, 11, 12, 13, 14], [0, 1, 2, 3, 4]])
    a = jattn.mha_extend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(qpos), sliding_window=window)
    b = tattn.mha_extend(torch.tensor(q), torch.tensor(kc), torch.tensor(vc),
                         torch.tensor(qpos), sliding_window=window)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


def test_mha_extend_bf16_dequantized_cache():
    """f32 queries against a bf16 (dequantized int8) cache compute in f32 on
    both sides (JAX type promotion)."""
    q, _, _, kc, vc = _attn_inputs(9, 1, 4, 2, 1, 16, T=128)
    jk = jkv.quantize_tokens(jnp.asarray(kc))
    tk = tkv.quantize_tokens(torch.tensor(kc))
    jcache = jkv.QuantKV(jk[0], jk[1].reshape(1, 1, 1, 128))
    tcache = tkv.QuantKV(tk[0], tk[1].reshape(1, 1, 1, 128))
    qpos = np.array([[40, 41, 42, 43]])
    a = jattn.mha_extend(jnp.asarray(q), jkv.dequant(jcache),
                         jnp.asarray(vc), jnp.asarray(qpos))
    b = tattn.mha_extend(torch.tensor(q), tkv.dequant(tcache),
                         torch.tensor(vc), torch.tensor(qpos))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


@pytest.mark.parametrize("window", [None, 7])
def test_mha_decode(window):
    q, _, _, kc, vc = _attn_inputs(10, 3, 1, 8, 2, 16, T=40)
    lens = np.array([1, 17, 40], np.int32)
    a = jattn.mha_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(lens), sliding_window=window)
    b = tattn.mha_decode(torch.tensor(q), torch.tensor(kc), torch.tensor(vc),
                         torch.tensor(lens), sliding_window=window)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
