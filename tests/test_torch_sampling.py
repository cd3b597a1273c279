"""PyTorch port sampling (localai_tpu_torch.ops.sampling) against the JAX
package's sampler.

The port carries a bit-exact threefry-2x32, so from the same keys the
key data, split and uniform are BIT-equal and the sampled tokens and
carried keys are EQUAL over a 100-step chain. Logprobs are f32 reductions
taken in a different order: held at 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from localai_tpu.ops import sampling as js
from localai_tpu_torch.ops import sampling as ts
from torch_threads import one_torch_thread  # noqa: F401


SEEDS = [0, 1, 7, 42, 123456789, 2**31 - 1]


def test_threefry_key_data_split_uniform_bit_exact():
    keys = np.stack([ts.threefry_seed(s) for s in SEEDS])
    ref = np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
                    for s in SEEDS])
    np.testing.assert_array_equal(keys, ref)
    t = torch.tensor(keys.astype(np.int64))
    for _ in range(5):                       # a chain of splits
        a, b = ts.split_keys(t)
        sp = np.stack([np.asarray(jax.random.key_data(jax.random.split(
            jax.random.wrap_key_data(jnp.asarray(k, jnp.uint32)), 2)))
            for k in t.numpy()])
        np.testing.assert_array_equal(a.numpy(), sp[:, 0])
        np.testing.assert_array_equal(b.numpy(), sp[:, 1])
        u = ts.uniform_scalar(b).numpy()
        ju = np.array([np.asarray(jax.random.uniform(
            jax.random.wrap_key_data(jnp.asarray(k, jnp.uint32)), ()))
            for k in sp[:, 1]], np.float32)
        np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
        t = a


def test_sampler_row_matches():
    p = js.SamplingParams(temperature=0.7, top_k=5, top_p=0.9, seed=11,
                          logit_bias={3: 2.0, 999: 1.0})
    tp = ts.SamplingParams(temperature=0.7, top_k=5, top_p=0.9, seed=11,
                           logit_bias={3: 2.0, 999: 1.0})
    a = js.sampler_row(p, 64, fallback_seed=5)
    b = ts.sampler_row(tp, 64, fallback_seed=5)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
    # no seed → the fallback seed's key
    a = js.sampler_row(js.SamplingParams(), 64, fallback_seed=9,
                       include_bias=False)
    b = ts.sampler_row(ts.SamplingParams(), 64, fallback_seed=9,
                       include_bias=False)
    assert "logit_bias" not in b
    np.testing.assert_array_equal(b["key"], np.asarray(a["key"]))


B, V = 6, 96


def _state_np(rng, seeds):
    """One knob mix per row: greedy, plain temperature, top-k, top-p,
    min-p + penalties, typical-p."""
    st = dict(
        temperature=np.array([1.0, 0.8, 0.7, 1.2, 0.9, 1.0], np.float32),
        top_k=np.array([0, 0, 8, 0, 20, 0], np.int32),
        top_p=np.array([1.0, 1.0, 1.0, 0.8, 0.95, 1.0], np.float32),
        min_p=np.array([0.0, 0.0, 0.0, 0.0, 0.05, 0.0], np.float32),
        typical_p=np.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.7], np.float32),
        repeat_penalty=np.array([1.0, 1.0, 1.1, 1.0, 1.3, 1.0], np.float32),
        presence_penalty=np.array([0, 0, 0, 0.2, 0.5, 0], np.float32),
        frequency_penalty=np.array([0, 0, 0, 0.1, 0.3, 0], np.float32),
        greedy=np.array([True] + [False] * 5),
        key=np.stack([ts.threefry_seed(s) for s in seeds]),
        token_counts=rng.integers(0, 3, (B, V)).astype(np.int32),
        logit_bias=np.where(rng.random((B, V)) < 0.05, 1.5, 0.0).astype(
            np.float32),
    )
    return st


def _jstate(st):
    return js.SamplerState(**{k: jnp.asarray(v) for k, v in st.items()})


def _tstate(st):
    d = {k: torch.tensor(v) for k, v in st.items()}
    d["key"] = d["key"].to(torch.int64)
    return ts.SamplerState(**d)


@pytest.mark.parametrize("width", [None, 32])
def test_sample_100_steps_equal(width):
    """100 chained steps on identical logits: same tokens, same carried
    keys, logprobs within 1e-5 — the full sort path and the sort-free
    top-k path (typical-p off there, as the engine guarantees)."""
    rng = np.random.default_rng(0)
    st = _state_np(rng, [3, 5, 7, 11, 13, 17])
    if width is not None:
        st["typical_p"][:] = 1.0
        st["top_k"] = np.array([0, 16, 8, 32, 20, 4], np.int32)
    jfn = jax.jit(js.sample, static_argnames=("topk_width",))
    jkey = st["key"].copy()
    tkey = torch.tensor(st["key"].astype(np.int64))
    for step in range(100):
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        jst = _jstate(dict(st, key=jkey))
        tst = _tstate(st)
        tst.key = tkey
        jt, jk, jl = jfn(jnp.asarray(logits), jst, topk_width=width)
        tt, tk, tl = ts.sample(torch.tensor(logits), tst, topk_width=width)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        jkey, tkey = np.asarray(jk), tk


def test_sampling_probs_and_mask_bits():
    rng = np.random.default_rng(1)
    st = _state_np(rng, [1, 2, 3, 4, 5, 6])
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    mask = rng.integers(0, 256, (B, (V + 7) // 8)).astype(np.uint8)
    mask[:, 0] |= 1                               # keep one token allowed
    a = js.sampling_probs(jnp.asarray(logits), _jstate(st),
                          jnp.asarray(mask))
    b = ts.sampling_probs(torch.tensor(logits), _tstate(st),
                          torch.tensor(mask))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                               atol=1e-6)
    jt, _, _ = js.sample(jnp.asarray(logits), _jstate(st), jnp.asarray(mask))
    tt, _, _ = ts.sample(torch.tensor(logits), _tstate(st),
                         torch.tensor(mask))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sampler_state_init():
    s = ts.SamplerState.init(3, 10)
    assert s.key.shape == (3, 2) and s.token_counts.shape == (3, 10)
    assert s.temperature.dtype == torch.float32
    assert ts.SamplingParams(temperature=0).normalized().greedy
