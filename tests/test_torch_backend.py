"""PyTorch port backend process (localai_tpu_torch.backend) and the port's
import hygiene.

- `python -m localai_tpu_torch.backend --device cpu` in a subprocess,
  driven over gRPC with the reference's client (same proto contract),
  streams greedy text EQUAL to the JAX package's `llm` backend (f32, tiny
  checkpoint); so does the port's servicer loaded with `kv_pages` (the
  paged KV pool) against the JAX backend loaded the same way.
- In a subprocess, importing the port's backend, engine, loader and
  quantization leaves no `jax`, `ml_dtypes` or `localai_tpu` module in
  sys.modules.
- An AST scan finds no `jax` / `localai_tpu` / `ml_dtypes` import
  anywhere in localai_tpu_torch/ or the chip scripts (chip_smoke.py,
  chip_profile.py, chip_rows.py, chip_stage_sweep.py,
  chip_host_tier.py, chip_gemm_sweep.py, chip_tier_sweep.py).
  (`localai_tpu_torch` starts with "localai_tpu": the checks match the
  name exactly or with a dot.)
"""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

from fixtures import tiny_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


def _forbidden(mod: str) -> bool:
    return any(mod == p or mod.startswith(p + ".")
               for p in ("jax", "jaxlib", "localai_tpu", "ml_dtypes"))


LOAD = dict(dtype="float32", parallel=2, context_size=128,
            prefill_buckets=[32])
PROMPTS = [("hello world", 12), ("the quick brown fox jumps", 9)]


def _stream(client, prompt, n):
    chunks = list(client.predict_stream(prompt=prompt, tokens=n,
                                        temperature=0.0, ignore_eos=True))
    return ("".join(c.message.decode() for c in chunks),
            [t for c in chunks for t in c.token_ids], chunks[-1])


def test_backend_subprocess_streams_reference_text(ckpt, tmp_path):
    from localai_tpu.backend.client import BackendClient
    from localai_tpu.backend.server import serve

    # the reference: the JAX llm backend, in process
    server, servicer, port = serve("127.0.0.1:0", "llm")
    ref = BackendClient(f"127.0.0.1:{port}")
    try:
        assert ref.wait_ready(attempts=20, sleep=0.1)
        r = ref.load_model(model=ckpt, mesh_data=1, mesh_model=1, **LOAD)
        assert r.success, r.message
        want = [_stream(ref, p, n) for p, n in PROMPTS]
    finally:
        ref.close()
        servicer.shutdown()
        server.stop(grace=1)

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "localai_tpu_torch.backend", "--addr",
         "127.0.0.1:0", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        m = re.search(r"serving on port (\d+)", line)
        assert m, line
        client = BackendClient(f"127.0.0.1:{m.group(1)}")
        assert client.wait_ready(attempts=60, sleep=0.25)
        r = client.load_model(model=ckpt, **LOAD)
        assert r.success, r.message
        assert client.status().state == 2                        # READY
        got = [_stream(client, p, n) for p, n in PROMPTS]
        for (text, ids, last), (rtext, rids, rlast), (_, n) in zip(
                got, want, PROMPTS):
            assert ids == rids
            assert text == rtext
            assert last.finish_reason == rlast.finish_reason == "length"
            assert last.tokens == n
        r = client.predict(prompt="hello world", tokens=12, temperature=0.0,
                           ignore_eos=True)
        assert r.message.decode() == want[0][0]
        assert client.tokenize("hello world").length > 0
        metrics = client.metrics()
        assert metrics["tokens_generated"] >= sum(n for _, n in PROMPTS) + 12
        client.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()


def _serve_and_stream(serve_fn, ckpt, load, prompts):
    from localai_tpu.backend.client import BackendClient

    server, servicer, port = serve_fn()
    client = BackendClient(f"127.0.0.1:{port}")
    try:
        assert client.wait_ready(attempts=40, sleep=0.1)
        r = client.load_model(model=ckpt, **load)
        assert r.success, r.message
        return [_stream(client, p, n) for p, n in prompts], client.metrics()
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1)


def test_load_kv_pages_streams_reference_text(ckpt):
    """LoadModel(kv_pages=...) serves through the paged pool: the same
    greedy text as the JAX backend with the same options, the second
    prompt reusing the first's retained blocks."""
    from localai_tpu.backend.server import serve as jserve
    from localai_tpu_torch.backend.server import serve as tserve

    load = dict(LOAD, context_size=256, kv_pages=6)
    prompts = PROMPTS + [("hello world, and more", 10)]
    want, _ = _serve_and_stream(lambda: jserve("127.0.0.1:0", "llm"), ckpt,
                                dict(load, mesh_data=1, mesh_model=1),
                                prompts)
    got, metrics = _serve_and_stream(
        lambda: tserve("127.0.0.1:0", device="cpu"), ckpt, load, prompts)
    for (text, ids, last), (rtext, rids, _), (_, n) in zip(got, want,
                                                          prompts):
        assert ids == rids and text == rtext
        assert last.finish_reason == "length" and last.tokens == n
    assert 0 < metrics["kv_blocks_peak"] <= 5


def test_load_rejects_unported_options(ckpt):
    """Options of later slices fail the load, naming the slice (a mesh's
    data axis; mesh_model is served, tests/test_torch_parallel.py). A
    draft_model is served (speculative decoding): LoadModel reads the
    draft's checkpoint — a missing one fails the load as a missing target
    does — and tests/test_torch_spec.py streams through a real one. The KV
    retention tier is served: an invalid option set fails the load with
    the reference's ValueError ("sink_window" without arguments;
    kv_cold_pages without quantize_cold), and a valid one (kv_pages with a
    sink_window policy) serves. embeddings=true is served: the load builds
    the Embedder and the CrossScorer beside the engine, and Embedding
    answers (tests/test_torch_embed.py holds them to the reference)."""
    from localai_tpu_torch.backend import pb
    from localai_tpu_torch.backend.llm import LLMServicer

    for kw, want in (
            (dict(draft_model="x"), "FileNotFoundError"),
            (dict(mesh_data=2), "slice"),
            (dict(options=json.dumps({"kv_policy": "sink_window"})),
             "ValueError: unknown kv_policy 'sink_window'"),
            (dict(options=json.dumps({"kv_cold_pages": 4})),
             "ValueError: kv_cold_pages needs kv_policy")):
        s = LLMServicer(device="cpu")
        r = s.LoadModel(pb.ModelOptions(model=ckpt, dtype="float32", **kw),
                        None)
        assert not r.success and want in r.message, (kw, r.message)
        assert s.Status(pb.HealthMessage(), None).state == 3      # ERROR
    os.environ["LOCALAI_NO_PREWARM"] = "1"
    try:
        s = LLMServicer(device="cpu")
        r = s.LoadModel(pb.ModelOptions(
            model=ckpt, dtype="float32", context_size=256, kv_pages=8,
            options=json.dumps({"kv_policy":
                                "sink_window(sinks=0, window=64)"})), None)
        assert r.success, r.message
        out = s.Predict(pb.PredictOptions(prompt="hello world", tokens=4,
                                          temperature=0.0, ignore_eos=True),
                        None)
        assert out.tokens == 4
        m = s.GetMetrics(pb.MetricsRequest(), None).metrics
        for key in ("kv_cold_blocks", "kv_evictions", "kv_recomputes",
                    "kv_policy_demotions", "kv_blocks_peak"):
            assert key in m, key
        s.engine.stop()
        s = LLMServicer(device="cpu")
        r = s.LoadModel(pb.ModelOptions(model=ckpt, dtype="float32",
                                        embeddings=True), None)
        assert r.success, r.message
        assert s.embedder is not None and s.scorer is not None
        assert s.Status(pb.HealthMessage(), None).state == 2      # READY
        vec = s.Embedding(pb.PredictOptions(prompt="hello world"),
                          None).embeddings
        assert len(vec) == s.cfg.hidden_size
        assert abs(sum(v * v for v in vec) - 1.0) < 1e-4
        s.shutdown()
    finally:
        os.environ.pop("LOCALAI_NO_PREWARM", None)


def test_import_leaves_no_jax_in_sys_modules():
    code = (
        "import sys, json\n"
        "import localai_tpu_torch.backend.server\n"
        "import localai_tpu_torch.backend.llm\n"
        "import localai_tpu_torch.backend.__main__\n"
        "import localai_tpu_torch.engine\n"
        "import localai_tpu_torch.engine.spec\n"
        "import localai_tpu_torch.engine.speculative\n"
        "import localai_tpu_torch.engine.kvhost\n"
        "import localai_tpu_torch.engine.resume\n"
        "import localai_tpu_torch.models.llama\n"
        "import localai_tpu_torch.ops.kernels\n"
        "import localai_tpu_torch.ops.quant\n"
        "import localai_tpu_torch.engine.loader\n"
        "import localai_tpu_torch.parallel.mesh\n"
        "import localai_tpu_torch.parallel.distributed\n"
        "import localai_tpu_torch.core.worker\n"
        "import localai_tpu_torch.engine.embedder\n"
        "import localai_tpu_torch.models.bert\n"
        "import localai_tpu_torch.models.clip_vit\n"
        "import localai_tpu_torch.models.llava\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "localai_tpu_torch.backend.backend_pb2" in mods
    assert "localai_tpu_torch.engine.speculative" in mods
    assert "localai_tpu_torch.engine.kvhost" in mods
    assert "localai_tpu_torch.engine.resume" in mods
    assert "localai_tpu_torch.ops.kernels.weight_gemm" in mods
    assert "localai_tpu_torch.parallel.distributed" in mods
    assert "localai_tpu_torch.core.worker" in mods
    for m in ("engine.embedder", "models.bert", "models.clip_vit",
              "models.llava"):
        assert "localai_tpu_torch." + m in mods
    bad = [m for m in mods if _forbidden(m)]
    assert bad == []


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.lineno, node.module


def test_ast_no_jax_or_reference_imports():
    files = [os.path.join(ROOT, n) for n in (
        "chip_smoke.py", "chip_profile.py", "chip_rows.py",
        "chip_stage_sweep.py", "chip_host_tier.py", "chip_gemm_sweep.py",
        "chip_tier_sweep.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "localai_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for name in ("spec.py", "speculative.py", "kvhost.py", "resume.py"):
        assert os.path.join(ROOT, "localai_tpu_torch", "engine",
                            name) in files
    for name in ("quant.py", os.path.join("kernels", "weight_gemm.py")):
        assert os.path.join(ROOT, "localai_tpu_torch", "ops", name) in files
    for name in (os.path.join("parallel", "mesh.py"),
                 os.path.join("parallel", "distributed.py"),
                 os.path.join("core", "worker.py"),
                 os.path.join("engine", "embedder.py"),
                 os.path.join("models", "bert.py"),
                 os.path.join("models", "clip_vit.py"),
                 os.path.join("models", "llava.py")):
        assert os.path.join(ROOT, "localai_tpu_torch", name) in files
    bad = [(os.path.relpath(f, ROOT), line, mod) for f in files
           for line, mod in _imports(f) if _forbidden(mod)]
    assert bad == []
    # the prefix trap: the port's own name is not a reference import
    assert not _forbidden("localai_tpu_torch.engine")
    assert _forbidden("localai_tpu.engine") and _forbidden("jax")
    assert _forbidden("ml_dtypes")
