"""The PyTorch port's llava role (models/clip_vit.py, models/llava.py, the
loader's llava checkpoints, the engine's multimodal lane and images in
the servicer's Predict) against the JAX package, on the tiny HF
LlavaForConditionalGeneration of tests/test_llava.py (built with
transformers), inputs from a numpy seed.

Tolerances:
- the CLIP tower's hidden states and the projected image features
  through vision_params_from_jax: 1e-4 in f32; the port's own loader gives
  the same tensors exactly, from both save layouts;
- engines (f32): greedy token streams with mm_embeds EQUAL to the JAX
  engine's, dense, paged, chunked and ragged; injecting the embedding rows
  of the prompt's own tokens gives the token prompt's stream;
- Predict with a base64 image: the reference servicer's token ids.
"""
import base64
import io
import json
import os
import shutil

import grpc
import numpy as np
import pytest
import torch

import jax

from fixtures import _write_safetensors, tiny_checkpoint
from localai_tpu.engine import loader as jloader
from localai_tpu.engine.engine import (
    Engine as JEngine, EngineConfig as JConfig, GenRequest as JRequest,
)
from localai_tpu.models import clip_vit as jclip
from localai_tpu.models import llava as jllava
from localai_tpu.ops.sampling import SamplingParams as JParams
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.engine.engine import (
    Engine as TEngine, EngineConfig as TConfig, GenRequest as TRequest,
)
from localai_tpu_torch.models import clip_vit as tclip
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.models import llava as tllava
from localai_tpu_torch.ops.sampling import SamplingParams as TParams
from localai_tpu_torch.parallel.mesh import Mesh
from torch_threads import one_torch_thread  # noqa: F401

IMG = 100
F32 = dict(rtol=1e-4, atol=1e-4)
NEW = 8


@pytest.fixture(scope="module")
def llava_ckpt(tmp_path_factory):
    """tests/test_llava.py's tiny llava (CLIP 28/14 → 4 patches, 3 layers;
    text hidden 48, vocab 128), saved in the classic layout, with the tiny
    Llama checkpoint's tokenizer files."""
    from transformers import (
        CLIPVisionConfig, LlamaConfig as HFLlama, LlavaConfig,
        LlavaForConditionalGeneration,
    )

    vc = CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=28, patch_size=14,
        projection_dim=32)
    tc = HFLlama(
        vocab_size=128, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)
    cfg = LlavaConfig(
        vision_config=vc, text_config=tc, image_token_index=IMG,
        vision_feature_layer=-2, vision_feature_select_strategy="default")
    torch.manual_seed(0)
    d = str(tmp_path_factory.mktemp("llava"))
    LlavaForConditionalGeneration(cfg).eval().save_pretrained(
        d, safe_serialization=True)
    src = tiny_checkpoint(tmp_path_factory)
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(src, f), os.path.join(d, f))
    return d


def _relayout(name: str) -> str:
    """A classic llava key in the 4.52+ layout."""
    if name == "language_model.lm_head.weight":
        return "lm_head.weight"
    if name.startswith("language_model.model."):
        return "model.language_model." + name[len("language_model.model."):]
    return "model." + name


@pytest.fixture(scope="module")
def llava_new_layout(tmp_path_factory, llava_ckpt):
    """The same weights saved under the 4.52+ key spelling."""
    from safetensors.numpy import load_file

    d = str(tmp_path_factory.mktemp("llava_new"))
    tensors = load_file(os.path.join(llava_ckpt, "model.safetensors"))
    assert "vision_tower.vision_model.pre_layrnorm.weight" in tensors
    _write_safetensors(os.path.join(d, "model.safetensors"),
                       {_relayout(k): v for k, v in tensors.items()})
    for f in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(llava_ckpt, f), os.path.join(d, f))
    return d


@pytest.fixture(scope="module")
def vision(llava_ckpt):
    """(reference (vcfg, params, meta), port's vision params converted
    from the reference's)."""
    jv = jllava.load_vision(llava_ckpt)
    tree = jax.tree_util.tree_map(np.asarray, jv[1])
    return jv, tllava.vision_params_from_jax(tree, device="cpu")


def _flat(p, prefix=""):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, lp in enumerate(v):
                out.update(_flat(lp, f"{prefix}{k}.{i}."))
        else:
            out[prefix + k] = v
    return out


# ------------------------------------------------------ the vision side

def test_is_llava_and_both_layouts_load(llava_ckpt, llava_new_layout,
                                        vision):
    _, conv = vision
    ref = _flat(conv)
    tcfg = tloader.load_config(llava_ckpt, dtype="float32")
    assert (tcfg.vocab_size, tcfg.hidden_size) == (128, 48)
    text = None
    for d in (llava_ckpt, llava_new_layout):
        assert tllava.is_llava(d)
        vcfg, params, meta = tllava.load_vision(d, device="cpu")
        assert (vcfg.n_patches, meta.image_token_index) == (4, IMG)
        assert meta.vision_feature_layer == -2
        mine = _flat(params)
        assert set(mine) == set(ref)
        for k in ref:
            torch.testing.assert_close(mine[k], ref[k], rtol=0, atol=0)
        # the seeded init has the loader's layout
        init = _flat({"tower": tclip.init_vision_params(vcfg, device="cpu")})
        assert {k: v.shape for k, v in init.items()} == {
            k: v.shape for k, v in mine.items() if k.startswith("tower.")}
        p = tloader.load_params(d, tcfg, dtype="float32", device="cpu")
        flat = {k: v for k, v in p.named_buffers()}
        if text is None:
            text = flat
        for k in text:
            torch.testing.assert_close(flat[k], text[k], rtol=0, atol=0)
    assert not tllava.is_llava(os.path.dirname(llava_ckpt))


def test_vision_forward_and_encode_images_match_reference(vision):
    (jvcfg, jparams, jmeta), tparams = vision
    tvcfg = tclip.ClipVisionConfig(**{
        f: getattr(jvcfg, f) for f in ("hidden_size", "intermediate_size",
                                       "num_layers", "num_heads",
                                       "image_size", "patch_size",
                                       "layer_norm_eps", "dtype")})
    px = np.random.default_rng(0).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    for layer in (-2, -1, 1):
        want = np.asarray(jclip.vision_forward(jparams["tower"], jvcfg, px,
                                               feature_layer=layer))
        got = tclip.vision_forward(tparams["tower"], tvcfg,
                                   torch.from_numpy(px), feature_layer=layer)
        assert got.shape == want.shape == (2, 5, 32)
        np.testing.assert_allclose(got.numpy(), want, **F32)
    meta = tllava.LlavaMeta(**vars(jmeta))
    for strategy in ("default", "full"):
        m = tllava.LlavaMeta(IMG, -2, strategy)
        jm = jllava.LlavaMeta(IMG, -2, strategy)
        want = np.asarray(jllava.encode_images(jparams, jvcfg, jm, px))
        got = tllava.encode_images(tparams, tvcfg, m, px)
        assert got.shape == want.shape == (2, 4 if strategy == "default"
                                           else 5, 48)
        np.testing.assert_allclose(got.numpy(), want, **F32)
    assert meta.select_strategy == "default"


def test_expand_image_tokens_and_decode():
    ids, pos = tllava.expand_image_tokens([1, IMG, 2, IMG, 3], 2, 4, IMG)
    assert ids == [1] + [IMG] * 4 + [2] + [IMG] * 4 + [3]
    assert pos.tolist() == [1, 2, 3, 4, 6, 7, 8, 9]
    assert (ids, pos.tolist()) == tuple(
        x if isinstance(x, list) else x.tolist()
        for x in jllava.expand_image_tokens([1, IMG, 2, IMG, 3], 2, 4, IMG))
    for bad in ([1, 2], [IMG, IMG]):
        with pytest.raises(ValueError, match="placeholder"):
            tllava.expand_image_tokens(bad, 1, 4, IMG)
    raw = b"\x89PNG..."
    b64 = base64.b64encode(raw).decode()
    assert tllava.decode_image_b64(b64) == raw
    assert tllava.decode_image_b64("data:image/png;base64," + b64) == raw


# ------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def text(llava_ckpt):
    jcfg = jloader.load_config(llava_ckpt, dtype="float32")
    tcfg = tloader.load_config(llava_ckpt, dtype="float32")
    return (jcfg, jloader.load_params(llava_ckpt, jcfg, dtype="float32"),
            tcfg, tloader.load_params(llava_ckpt, tcfg, dtype="float32",
                                      device="cpu"))


@pytest.fixture(scope="module")
def mm_prompt(vision):
    """Two images' features and a 36-token prompt: the first image's rows
    at 2..5, the second's at 14..17 (across a 16-token chunk edge)."""
    (jvcfg, jparams, jmeta), _ = vision
    px = np.random.default_rng(1).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    feats = np.asarray(jllava.encode_images(jparams, jvcfg, jmeta, px),
                       np.float32)
    rng = np.random.default_rng(2)
    base = rng.integers(1, IMG, 30).tolist()
    base[2], base[11] = IMG, IMG
    ids, pos = tllava.expand_image_tokens(base, 2, 4, IMG)
    assert len(ids) == 36 and pos.tolist()[4:] == [14, 15, 16, 17]
    return ids, feats.reshape(-1, feats.shape[-1]), pos


ENGINES = {
    "dense": dict(prefill_buckets=(64,), prefill_chunk=64),
    "paged": dict(prefill_buckets=(64,), prefill_chunk=64, kv_pages=6),
    "chunked": dict(prefill_buckets=(16,), prefill_chunk=16),
    "ragged": dict(prefill_buckets=(16,), prefill_chunk=16, kv_pages=6,
                   ragged_token_budget=32),
}


def _streams(eng, reqs):
    outs = [eng.submit(r)[1] for r in reqs]
    for _ in range(500):
        if not eng.step():
            break
    toks = []
    for q in outs:
        seq = []
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                seq.append(o.token_id)
        toks.append(seq)
    return toks


def _reqs(req_cls, par_cls, prompt, feats, pos, salt=3):
    """The multimodal request, then a text request beside it."""
    other = np.random.default_rng(salt).integers(1, IMG, 9).tolist()
    return [req_cls(list(prompt), par_cls(temperature=0.0), max_tokens=NEW,
                    ignore_eos=True, mm_embeds=feats, mm_positions=pos),
            req_cls(other, par_cls(temperature=0.0), max_tokens=NEW,
                    ignore_eos=True)]


@pytest.mark.parametrize("path", list(ENGINES))
def test_mm_streams_equal_reference_engine(text, mm_prompt, path):
    """Greedy f32 streams of a multimodal request beside a text request:
    the port's engine emits the JAX engine's tokens on each path; on the
    port, injecting the prompt's own embedding rows gives the token
    prompt's stream (the inject lane is an identity for them)."""
    jcfg, jp, tcfg, tp = text
    ids, feats, pos = mm_prompt
    ec = dict(max_slots=2, max_context=128, **ENGINES[path])
    ref = _streams(JEngine(jcfg, jp, None, JConfig(**ec)),
                   _reqs(JRequest, JParams, ids, feats, pos))
    eng = TEngine(tcfg, tp, None, TConfig(**ec), device="cpu")
    got = _streams(eng, _reqs(TRequest, TParams, ids, feats, pos))
    assert all(len(s) == NEW for s in got)
    assert got == ref
    m = eng.metrics
    if path == "ragged":
        assert m["ragged_prefill_tokens"] == len(ids) + 9
    elif path == "chunked":
        assert m["prefill_chunks_mid"] >= 2
    # identity: the prompt's own embedding rows at the image positions
    own = tp.embed[torch.as_tensor(np.asarray(ids)[pos])].float().numpy()
    eng = TEngine(tcfg, tp, None, TConfig(**ec), device="cpu")
    toks = _streams(eng, _reqs(TRequest, TParams, ids, own, pos))
    plain = _streams(TEngine(tcfg, tp, None, TConfig(**ec), device="cpu"),
                     [TRequest(list(ids), TParams(temperature=0.0),
                               max_tokens=NEW, ignore_eos=True)])
    assert toks[0] == plain[0]
    assert toks[0] != got[0]


def test_mm_ragged_with_a_draft_equals_reference(text, mm_prompt):
    """Spec-as-ragged packs the feature rows too: the port's ragged engine
    with the target as its own draft (greedy: every proposal accepted)
    emits the JAX dense engine's multimodal stream."""
    jcfg, jp, tcfg, tp = text
    ids, feats, pos = mm_prompt
    ref = _streams(JEngine(jcfg, jp, None, JConfig(
        max_slots=2, max_context=128, **ENGINES["dense"])),
        _reqs(JRequest, JParams, ids, feats, pos))
    eng = TEngine(tcfg, tp, None, TConfig(max_slots=2, max_context=128,
                                          gamma=3, **ENGINES["ragged"]),
                  draft=(tcfg, tp), device="cpu")
    got = _streams(eng, _reqs(TRequest, TParams, ids, feats, pos))
    assert got == ref
    assert eng.metrics["spec_ragged_dispatches"] > 0
    dense = TEngine(tcfg, tp, None, TConfig(
        max_slots=2, max_context=128, gamma=3, **ENGINES["dense"]),
        draft=(tcfg, tp), device="cpu")
    with pytest.raises(ValueError, match="ragged continuous batching"):
        dense.submit(_reqs(TRequest, TParams, ids, feats, pos)[0])


def test_mm_request_checks_and_exclusions(text, mm_prompt):
    """submit's checks (the reference's ValueError texts); an mm prompt
    takes no prefix reuse and records none; under a mesh it raises,
    naming the parallel slice."""
    jcfg, jp, tcfg, tp = text
    ids, feats, pos = mm_prompt
    ec = TConfig(max_slots=1, max_context=128, kv_pages=6,
                 **ENGINES["chunked"])
    eng = TEngine(tcfg, tp, None, ec, device="cpu")
    jeng = JEngine(jcfg, jp, None, JConfig(max_slots=1, max_context=128,
                                           **ENGINES["chunked"]))
    for kw in (dict(mm_embeds=feats[:, :5], mm_positions=pos),
               dict(mm_embeds=feats, mm_positions=pos[:-1]),
               dict(mm_embeds=feats, mm_positions=pos + 30),
               dict(mm_embeds=feats, mm_positions=pos[::-1].copy())):
        msgs = []
        for e, rc, pc in ((jeng, JRequest, JParams),
                          (eng, TRequest, TParams)):
            with pytest.raises(ValueError) as err:
                e.submit(rc(list(ids), pc(temperature=0.0), max_tokens=2,
                            **kw))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], msgs
    # the same mm prompt twice: no reuse either time, no record kept
    for _ in range(2):
        _streams(eng, _reqs(TRequest, TParams, ids, feats, pos)[:1])
        assert eng.metrics["prompt_tokens_reused"] == 0
        assert eng._slot_kv_tokens[0] == [] and not eng._hash_index
    m0 = Mesh(0, 1, torch.device("cpu"))
    meng = TEngine(tcfg, tllama.shard_params(tp, tcfg, m0), None,
                   TConfig(max_slots=1, max_context=128, mesh=m0,
                           **ENGINES["dense"]), device="cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        meng.submit(_reqs(TRequest, TParams, ids, feats, pos)[0])


# ------------------------------------------------------------ gRPC surface

class _Ctx:
    def abort(self, code, details):
        raise _Aborted(code, details)

    def add_callback(self, fn):
        pass


class _Aborted(Exception):
    def __init__(self, code, details):
        super().__init__(f"{code}: {details}")
        self.code, self.details = code, details


def _png(color) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (40, 30), color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_predict_with_images_equals_reference(llava_ckpt, monkeypatch):
    from localai_tpu.backend import pb as jpb
    from localai_tpu.backend.llm import LLMServicer as JServicer
    from localai_tpu_torch.backend import pb as tpb
    from localai_tpu_torch.backend.llm import LLMServicer as TServicer

    monkeypatch.setenv("LOCALAI_NO_PREWARM", "1")
    load = dict(model=llava_ckpt, dtype="float32", parallel=2,
                context_size=128, prefill_buckets=[16, 32])
    js, ts = JServicer(), TServicer(device="cpu")
    assert js.LoadModel(jpb.ModelOptions(mesh_data=1, mesh_model=1, **load),
                        None).success
    r = ts.LoadModel(tpb.ModelOptions(**load), None)
    assert r.success, r.message
    assert ts.vision is not None
    try:
        red, blue = _png((200, 40, 40)), "data:image/png;base64," + _png(
            (20, 40, 220))
        cases = [dict(prompt_ids=[1, 5, IMG, 9], images=[red]),
                 dict(prompt_ids=[1, 5, 9], images=[blue]),   # image first
                 dict(prompt_ids=[1, IMG, 5, IMG, 9], images=[red, blue]),
                 dict(prompt_ids=[1, 5, IMG, 9])]
        for kw in cases:
            opts = dict(tokens=6, temperature=0.0, ignore_eos=True, **kw)
            want = js.Predict(jpb.PredictOptions(**opts), _Ctx())
            got = ts.Predict(tpb.PredictOptions(**opts), _Ctx())
            assert list(got.token_ids) == list(want.token_ids), kw
            assert got.prompt_tokens == want.prompt_tokens
        assert ts.Predict(tpb.PredictOptions(**dict(
            cases[0], tokens=6, temperature=0.0, ignore_eos=True)),
            _Ctx()).prompt_tokens == 3 + 4
        stream = list(ts.PredictStream(tpb.PredictOptions(
            prompt_ids=[1, 5, IMG, 9], images=[red], tokens=4,
            temperature=0.0, ignore_eos=True), _Ctx()))
        assert [t for c in stream for t in c.token_ids] == list(
            ts.Predict(tpb.PredictOptions(prompt_ids=[1, 5, IMG, 9],
                                          images=[red], tokens=4,
                                          temperature=0.0, ignore_eos=True),
                       _Ctx()).token_ids)
        for kw in (dict(prompt_ids=[1, IMG], images=["!!not base64"]),
                   dict(prompt_ids=[1, IMG],
                        images=[base64.b64encode(b"no image").decode()]),
                   dict(prompt_ids=[1, 5], images=[red, blue])):
            codes = []
            for s, pb in ((js, jpb), (ts, tpb)):
                with pytest.raises(_Aborted) as err:
                    s.Predict(pb.PredictOptions(tokens=2, **kw), _Ctx())
                codes.append(err.value.code)
                assert err.value.details.startswith("bad image: ")
            assert codes == [grpc.StatusCode.INVALID_ARGUMENT] * 2
        with pytest.raises(_Aborted) as err:
            ts.Predict(tpb.PredictOptions(prompt_ids=[1], tokens=2,
                                          audios=["x"]), _Ctx())
        assert err.value.code == grpc.StatusCode.UNIMPLEMENTED
        assert "whisper" in err.value.details
    finally:
        js.shutdown()
        ts.shutdown()


def test_images_need_a_vision_tower_and_one_card(llava_ckpt,
                                                 tmp_path_factory,
                                                 monkeypatch):
    from localai_tpu_torch.backend import pb
    from localai_tpu_torch.backend.llm import LLMServicer

    monkeypatch.setenv("LOCALAI_NO_PREWARM", "1")
    s = LLMServicer(device="cpu")
    assert s.LoadModel(pb.ModelOptions(
        model=tiny_checkpoint(tmp_path_factory), dtype="float32",
        parallel=1, context_size=128, prefill_buckets=[16]), None).success
    try:
        with pytest.raises(_Aborted) as err:
            s.Predict(pb.PredictOptions(prompt_ids=[1, 2], tokens=2,
                                        images=[_png((1, 2, 3))]), _Ctx())
        assert err.value.code == grpc.StatusCode.INVALID_ARGUMENT
        assert err.value.details == \
            "model has no vision tower; images unsupported"
    finally:
        s.shutdown()
    r = LLMServicer(device="cpu").LoadModel(pb.ModelOptions(
        model=llava_ckpt, dtype="float32", mesh_model=2), None)
    assert not r.success and "parallel" in r.message, r.message
    with open(os.path.join(llava_ckpt, "config.json")) as f:
        assert json.load(f)["image_token_index"] == IMG
