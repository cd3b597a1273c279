"""The disk prompt cache in the PyTorch port (GenRequest.prompt_cache_path
and prompt_cache_ro: Engine._load_prompt_cache, _cache_inject and
_save_prompt_cache) — the cases of tests/test_prompt_cache_disk.py on the
port, and the file crossing packages: a cache file written by the JAX
engine loads in the port and the reverse, f32 and int8, each reader
streaming what the writer's package streams from it (the int8 reference
under LOCALAI_FORCE_PALLAS=1, whose kernels share the port's f32
arithmetic). The file is the reference's np.savez; a bf16 cache is
written in f32.
"""
import os

import numpy as np
import pytest

from fixtures import tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from torch_threads import one_torch_thread  # noqa: F401

EC = dict(max_slots=2, max_context=128, prefill_buckets=(64,),
          prefill_chunk=64)
PROMPT = list(range(1, 41))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


@pytest.fixture(scope="module")
def models(ckpt):
    return (jloader.load_model(ckpt, dtype="float32"),
            tloader.load_model(ckpt, dtype="float32", device="cpu"))


def _engine(models, cache_type="", jax_side=False, **kw):
    (jcfg, jp, _), (tcfg, tp, _) = models
    ec = dict(EC, cache_type=cache_type, **kw)
    if jax_side:
        return JEngine(jcfg, jp, None, JConfig(**ec))
    return TEngine(tcfg, tp, None, TConfig(**ec), device="cpu")


def _run(eng, prompt, path="", ro=False, n=5, **kw):
    """One greedy request through `eng` (either package); its tokens."""
    jax_side = isinstance(eng, JEngine)
    req, par = (JRequest, JParams) if jax_side else (TRequest, TParams)
    out = list(eng.generate(req(
        list(prompt), par(temperature=0.0, seed=5), max_tokens=n,
        ignore_eos=True, prompt_cache_path=path, prompt_cache_ro=ro, **kw)))
    assert out[-1].finished
    return [o.token_id for o in out]


@pytest.mark.parametrize("cache_type", ["", "int8"])
def test_kv_survives_engine_restart(models, tmp_path, cache_type):
    """A fresh engine reuses the saved prefix (all but the last prompt
    token) and streams what the first one did."""
    path = str(tmp_path / "prompt.kv.npz")
    ref = _run(_engine(models, cache_type), PROMPT, path=path)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    e2 = _engine(models, cache_type)
    out = _run(e2, PROMPT, path=path)
    assert e2.metrics["prompt_tokens_reused"] == len(PROMPT) - 1
    assert e2.metrics["prompt_cache_hits"] == 1
    assert out == ref


def test_ro_does_not_write(models, tmp_path):
    """prompt_cache_ro never writes: no file from a cold run, and an
    existing file's bytes and mtime stay as they were after a read-only
    load of a longer prompt (which a writer would rewrite)."""
    path = tmp_path / "ro.kv.npz"
    _run(_engine(models), list(range(1, 30)), path=str(path), ro=True)
    assert not path.exists()
    _run(_engine(models), PROMPT, path=str(path))
    before = (path.read_bytes(), os.stat(path).st_mtime_ns)
    eng = _engine(models)
    _run(eng, PROMPT + list(range(50, 70)), path=str(path), ro=True)
    assert eng.metrics["prompt_tokens_reused"] == len(PROMPT)
    assert (path.read_bytes(), os.stat(path).st_mtime_ns) == before


def test_corrupt_file_falls_back_cold(models, tmp_path):
    path = tmp_path / "bad.kv.npz"
    path.write_bytes(b"this is not an npz")
    eng = _engine(models)
    toks = _run(eng, list(range(1, 30)), path=str(path))
    assert len(toks) == 5
    assert eng.metrics["prompt_tokens_reused"] == 0


def test_mismatched_prompt_ignored(models, tmp_path):
    """A file whose tokens share no prefix with the prompt, and one from a
    cache of another geometry (the int8 layout read by a dense engine),
    both mean a cold prefill."""
    path = str(tmp_path / "other.kv.npz")
    _run(_engine(models), PROMPT, path=path)
    eng = _engine(models)
    _run(eng, list(range(60, 100)), path=path)
    assert eng.metrics["prompt_tokens_reused"] == 0
    q8 = str(tmp_path / "q8.kv.npz")
    _run(_engine(models, "int8"), PROMPT, path=q8)
    eng = _engine(models)
    want = _run(_engine(models), PROMPT)
    assert _run(eng, PROMPT, path=q8, ro=True) == want
    assert eng.metrics["prompt_tokens_reused"] == 0


def test_bf16_cache_roundtrips(ckpt, tmp_path):
    """bf16 KV survives the npz round trip (saved in f32, as the
    reference saves it: npz keeps no bfloat16)."""
    tcfg, tp, _ = tloader.load_model(ckpt, dtype="bfloat16", device="cpu")
    path = str(tmp_path / "bf16.kv.npz")

    def engine():
        return TEngine(tcfg, tp, None, TConfig(**EC), device="cpu")

    ref = _run(engine(), PROMPT, path=path)
    with np.load(path) as z:
        assert z["k"].dtype == np.float32 and z["tokens"].dtype == np.int64
        assert z["k"].shape == (tcfg.num_layers, tcfg.num_kv_heads,
                                len(PROMPT), tcfg.head_dim)
    e2 = engine()
    out = _run(e2, PROMPT, path=path)
    assert e2.metrics["prompt_tokens_reused"] == len(PROMPT) - 1
    assert out == ref


def test_zip_magic_corrupt_file_survives(models, tmp_path):
    """A file with zip magic but garbage content cold-prefills, and the
    engine serves the next request."""
    path = tmp_path / "zip.kv.npz"
    path.write_bytes(b"PK\x03\x04" + b"\x00" * 64)
    eng = _engine(models)
    assert len(_run(eng, list(range(1, 30)), path=str(path))) == 5
    assert eng.metrics["prompt_tokens_reused"] == 0
    assert len(_run(eng, list(range(1, 20)))) == 5


@pytest.mark.parametrize("cache_type", ["", "int8"], ids=["f32", "int8"])
def test_file_crosses_packages(models, tmp_path, monkeypatch, cache_type):
    """A file written by either package loads in the other. One engine of
    each package (prompt_cache off, so a request reuses nothing but the
    file) writes a file of the prompt; then each engine serves the
    follow-up (the prompt plus 20 tokens: the whole saved prompt reused,
    the suffix on the chunked extend path) read-only from both files. A
    file gives the same stream in either package, and both files give
    the stream of a cold engine."""
    if cache_type:
        monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    engines = {side: _engine(models, cache_type, jax_side=side == "jax",
                             prompt_cache=False)
               for side in ("jax", "torch")}
    paths = {side: str(tmp_path / f"{side}.kv.npz") for side in engines}
    for side, eng in engines.items():
        _run(eng, PROMPT, path=paths[side])
    follow = PROMPT + list(range(60, 80))
    cold = _run(engines["torch"], follow, n=8)
    for writer, path in paths.items():
        outs = {}
        for side, eng in engines.items():
            reused = eng.metrics["prompt_tokens_reused"]
            outs[side] = _run(eng, follow, path=path, ro=True, n=8)
            assert (eng.metrics["prompt_tokens_reused"] - reused
                    == len(PROMPT)), (writer, side)
        assert outs["torch"] == outs["jax"] == cold, writer


def test_paged_shifted_and_hot_prefix_never_write(models, tmp_path):
    """Nothing is written by a paged engine (dense engines only, as the
    reference), by a slot that shifted, or again when the loaded file
    already covers the prompt."""
    path = tmp_path / "p.kv.npz"
    eng = _engine(models, kv_pages=8)
    _run(eng, PROMPT, path=str(path))
    assert not path.exists()
    assert eng.metrics["prompt_tokens_reused"] == 0
    _run(_engine(models), PROMPT, path=str(path), n=120, context_shift=True)
    assert not path.exists()
    _run(_engine(models), PROMPT, path=str(path))
    stamp = os.stat(path).st_mtime_ns
    eng = _engine(models)
    _run(eng, PROMPT, path=str(path))
    assert eng.metrics["prompt_tokens_reused"] == len(PROMPT) - 1
    assert os.stat(path).st_mtime_ns == stamp
