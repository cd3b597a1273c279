"""The PyTorch port's embeddings roles (models/llama.hidden_states,
encode_pooled and forward_train; engine/embedder.py Embedder and
CrossScorer; models/bert.py; the servicer's Embedding and Rerank RPCs and
the BERT load) against the JAX package, on the tiny Llama checkpoint
(tests/fixtures.build_tiny_checkpoint) and a tiny HF BertModel built with
transformers, inputs from a numpy seed.

Tolerances:
- f32 hidden states, pooled vectors, logits and scores: 1e-4 (the same
  math, sums in another order);
- the int8 recipe (bf16 activations): 6e-2, tests/test_torch_model.py's
  bar, with the reference's attention on its Pallas kernels
  (LOCALAI_FORCE_PALLAS=1), whose f32 math the port's kernels share;
- BERT through bert_params_from_jax: 1e-4; the port's own loader gives
  the same tensors exactly;
- rerank: the same order, scores within 1e-4; errors: the same texts and
  gRPC codes.
"""
import os
import shutil

import grpc
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import tiny_checkpoint
from localai_tpu.engine import embedder as jemb
from localai_tpu.engine import loader as jloader
from localai_tpu.models import bert as jbert
from localai_tpu.models import llama as jllama
from localai_tpu_torch.engine import embedder as temb
from localai_tpu_torch.engine import loader as tloader
from localai_tpu_torch.models import bert as tbert
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.parallel.mesh import Mesh
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=6e-2, atol=6e-2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory)


@pytest.fixture(scope="module")
def models(ckpt):
    """{dtype: (jax cfg, jax params, port cfg, port params)}."""
    out = {}
    for dtype in ("float32", "int8"):
        jcfg = jloader.load_config(ckpt, dtype=dtype)
        tcfg = tloader.load_config(ckpt, dtype=dtype)
        out[dtype] = (jcfg, jloader.load_params(ckpt, jcfg, dtype=dtype),
                      tcfg, tloader.load_params(ckpt, tcfg, dtype=dtype,
                                                device="cpu"))
    return out


def _batch(cfg, lens, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (len(lens), s)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    return toks, np.asarray(lens, np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------ the cacheless forwards

def test_hidden_states_pooled_and_logits_match_reference(models):
    jcfg, jp, tcfg, tp = models["float32"]
    toks, lens = _batch(tcfg, [5, 16, 1, 11], 16)
    jh = jllama.hidden_states(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens))
    th = tllama.hidden_states(tp, tcfg, torch.from_numpy(toks),
                              torch.from_numpy(lens))
    assert th.shape == (4, 16, tcfg.hidden_size) and th.dtype == torch.float32
    for b, n in enumerate(lens):   # padded positions: don't-care
        np.testing.assert_allclose(_np(th)[b, :n], _np(jh)[b, :n], **F32)
    for norm in (True, False):
        jv = jllama.encode_pooled(jp, jcfg, jnp.asarray(toks),
                                  jnp.asarray(lens), normalize=norm)
        tv = tllama.encode_pooled(tp, tcfg, torch.from_numpy(toks),
                                  torch.from_numpy(lens), normalize=norm)
        np.testing.assert_allclose(_np(tv), _np(jv), **F32)
    np.testing.assert_allclose(np.linalg.norm(_np(tv), axis=-1) > 0, True)
    jl = jllama.forward_train(jp, jcfg, jnp.asarray(toks))
    tl = tllama.forward_train(tp, tcfg, torch.from_numpy(toks))
    assert tl.shape == (4, 16, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)


def test_pooled_int8_recipe_matches_reference(models, monkeypatch):
    monkeypatch.setenv("LOCALAI_FORCE_PALLAS", "1")
    jcfg, jp, tcfg, tp = models["int8"]
    toks, lens = _batch(tcfg, [7, 12], 12, seed=1)
    jv = jllama.encode_pooled(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens))
    tv = tllama.encode_pooled(tp, tcfg, torch.from_numpy(toks),
                              torch.from_numpy(lens))
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(_np(tv), _np(jv), **BF16)
    jl = jllama.forward_train(jp, jcfg, jnp.asarray(toks))
    tl = tllama.forward_train(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16)


def test_cacheless_forwards_refuse_a_mesh(models):
    _, _, tcfg, tp = models["float32"]
    sharded = tllama.shard_params(tp, tcfg, Mesh(0, 1, CPU))
    toks = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="parallel"):
        tllama.encode_pooled(sharded, tcfg, toks, torch.tensor([4]))
    with pytest.raises(NotImplementedError, match="parallel"):
        tllama.forward_train(sharded, tcfg, toks)
    for cls in (temb.Embedder, temb.CrossScorer):
        with pytest.raises(NotImplementedError, match="parallel"):
            cls(tcfg, tp, mesh=Mesh(0, 1, CPU), device="cpu")


# ------------------------------------------------ Embedder / CrossScorer

def test_embedder_buckets_and_batch_padding(models):
    jcfg, jp, tcfg, tp = models["float32"]
    je = jemb.Embedder(jcfg, jp, buckets=(8, 16, 1024))
    te = temb.Embedder(tcfg, tp, buckets=(8, 16, 1024), device="cpu")
    # max_position 256 drops the 1024 bucket, as the reference does
    assert te.buckets == je.buckets == (8, 16)
    rng = np.random.default_rng(2)
    for lens in ([3], [3, 9, 16], [1, 2, 3, 4, 5]):   # nb 1, 4, 8
        ids = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in lens]
        want = je.embed(ids)
        got = te.embed(ids)
        assert got.shape == want.shape == (len(lens), tcfg.hidden_size)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)
    assert te.embed([]).shape == je.embed([]).shape == (0, tcfg.hidden_size)
    for e in (je, te):
        with pytest.raises(ValueError) as err:
            e.embed([list(range(1, 18))])
        assert str(err.value) == ("input length 17 exceeds max embedding "
                                  "bucket 16")


def test_cross_scorer_matches_reference(models):
    jcfg, jp, tcfg, tp = models["float32"]
    js = jemb.CrossScorer(jcfg, jp, buckets=(16, 32))
    ts = temb.CrossScorer(tcfg, tp, buckets=(16, 32), device="cpu")
    rng = np.random.default_rng(4)
    q = rng.integers(1, tcfg.vocab_size, 5).tolist()
    docs = [rng.integers(1, tcfg.vocab_size, n).tolist()
            for n in (3, 20, 9, 14, 1)]
    want, got = js.score(q, docs), ts.score(q, docs)
    assert got.shape == want.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)
    assert got.argsort().tolist() == want.argsort().tolist()
    assert ts.score(q, []).shape == (0,)
    for s in (js, ts):
        with pytest.raises(ValueError) as err:
            s.score(q, [list(range(1, 30))])
        assert str(err.value) == ("query+document length 34 exceeds max "
                                  "bucket 32")


# ---------------------------------------------------------------- BERT

@pytest.fixture(scope="module")
def bert_ckpt(tmp_path_factory, ckpt):
    """A tiny HF BertModel (tests/test_bert.py's) with the tiny Llama
    checkpoint's tokenizer files, so both packages' TokenizeString
    answer."""
    from transformers import BertConfig, BertModel

    d = str(tmp_path_factory.mktemp("bert"))
    torch.manual_seed(0)
    BertModel(BertConfig(
        vocab_size=400, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2)).eval() \
        .save_pretrained(d, safe_serialization=True)
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(ckpt, f), os.path.join(d, f))
    return d


@pytest.fixture(scope="module")
def bert_models(bert_ckpt):
    jcfg = jbert.load_bert_config(bert_ckpt)
    jp = jbert.load_bert_params(bert_ckpt, jcfg)
    tcfg = tbert.load_bert_config(bert_ckpt)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tcfg, tbert.bert_params_from_jax(tree, device="cpu")


def test_bert_loader_equals_params_from_jax(bert_ckpt, bert_models):
    _, _, tcfg, tp = bert_models
    assert tbert.is_bert_dir(bert_ckpt) and tcfg.num_layers == 2
    mine = tbert.load_bert_params(bert_ckpt, tcfg, device="cpu")
    assert mine["layers"][0]["wqkv"].shape == (64, 192)
    # the seeded init (synthetic checkpoints) has the loader's layout
    init = tbert.init_bert_params(tcfg, device="cpu")
    assert {k: v.shape for k, v in init.items() if k != "layers"} == {
        k: v.shape for k, v in mine.items() if k != "layers"}
    assert [{k: v.shape for k, v in lp.items()} for lp in init["layers"]] \
        == [{k: v.shape for k, v in lp.items()} for lp in mine["layers"]]
    for k in ("word_emb", "pos_emb", "type_emb", "emb_ln_w", "emb_ln_b"):
        torch.testing.assert_close(mine[k], tp[k], rtol=0, atol=0)
    for a, b in zip(mine["layers"], tp["layers"]):
        for k in tbert.LAYER_KEYS:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_bert_encode_pooled_and_embedder_match_reference(bert_models):
    jcfg, jp, tcfg, tp = bert_models
    toks, lens = _batch(tcfg, [4, 9, 1], 9, seed=5)
    jh = jbert.bert_encode(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens))
    th = tbert.bert_encode(tp, tcfg, torch.from_numpy(toks),
                           torch.from_numpy(lens))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(_np(th)[b, :n], _np(jh)[b, :n], **F32)
    jv = jbert.bert_pooled(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens))
    tv = tbert.bert_pooled(tp, tcfg, torch.from_numpy(toks),
                           torch.from_numpy(lens))
    np.testing.assert_allclose(_np(tv), _np(jv), **F32)
    je = jbert.BertEmbedder(jcfg, jp, buckets=(8, 16))
    te = tbert.BertEmbedder(tcfg, tp, buckets=(8, 16), device="cpu")
    ids = [[1, 2, 3], [4, 5], list(range(6, 15))]
    np.testing.assert_allclose(te.embed(ids), je.embed(ids), **F32)
    with pytest.raises(ValueError, match="exceeds max embedding bucket 16"):
        te.embed([list(range(1, 20))])


# ------------------------------------------------------------ gRPC surface

class _Ctx:
    """A servicer context whose abort raises with the status code."""

    def abort(self, code, details):
        raise _Aborted(code, details)

    def add_callback(self, fn):
        pass


class _Aborted(Exception):
    def __init__(self, code, details):
        super().__init__(f"{code}: {details}")
        self.code, self.details = code, details


def _servicers(model, **kw):
    from localai_tpu.backend import pb as jpb
    from localai_tpu.backend.llm import LLMServicer as JServicer
    from localai_tpu_torch.backend import pb as tpb
    from localai_tpu_torch.backend.llm import LLMServicer as TServicer

    js, ts = JServicer(), TServicer(device="cpu")
    r = js.LoadModel(jpb.ModelOptions(model=model, dtype="float32",
                                      mesh_data=1, mesh_model=1, **kw), None)
    assert r.success, r.message
    r = ts.LoadModel(tpb.ModelOptions(model=model, dtype="float32", **kw),
                     None)
    assert r.success, r.message
    return (js, jpb), (ts, tpb)


def _both(pair, rpc, msg, **kw):
    """[(result or _Aborted)] of `rpc` on the reference and the port."""
    out = []
    for s, pb in pair:
        try:
            out.append(getattr(s, rpc)(getattr(pb, msg)(**kw), _Ctx()))
        except _Aborted as e:
            out.append(e)
    return out


@pytest.fixture()
def no_prewarm(monkeypatch):
    monkeypatch.setenv("LOCALAI_NO_PREWARM", "1")


def test_servicer_embedding_and_rerank_match_reference(ckpt, no_prewarm):
    pair = _servicers(ckpt, embeddings=True, parallel=2, context_size=256,
                      prefill_buckets=[16, 64])
    try:
        (ts, _) = pair[1]
        assert ts.embedder is not None and ts.scorer is not None
        want, got = _both(pair, "Embedding", "PredictOptions",
                          prompt_ids=[1, 5, 9, 13, 2])
        assert got.prompt_tokens == want.prompt_tokens == 5
        np.testing.assert_allclose(got.embeddings, want.embeddings, **F32)
        texts = ["hello world", "the quick brown fox jumps over the dog",
                 "pack my box"]
        want, got = _both(pair, "Embedding", "PredictOptions", prompts=texts)
        assert got.prompt_tokens == want.prompt_tokens > 0
        assert len(got.vectors) == len(want.vectors) == 3
        for a, b in zip(got.vectors, want.vectors):
            np.testing.assert_allclose(a.values, b.values, **F32)
        want, got = _both(pair, "Embedding", "PredictOptions",
                          prompt="hello world")
        np.testing.assert_allclose(got.embeddings, want.embeddings, **F32)
        # past the last bucket: the reference's message, INVALID_ARGUMENT
        want, got = _both(pair, "Embedding", "PredictOptions",
                          prompt_ids=list(range(1, 70)))
        assert got.code == want.code == grpc.StatusCode.INVALID_ARGUMENT
        assert got.details == want.details
        docs = ["the quick brown fox", "hello world hello world",
                "jumps over the lazy dog", "pack my box with five dozen"]
        want, got = _both(pair, "Rerank", "RerankRequest", query="hello",
                          documents=docs, top_n=3)
        assert [r.index for r in got.results] == \
            [r.index for r in want.results]
        assert len(got.results) == 3
        for a, b in zip(got.results, want.results):
            assert a.text == b.text == docs[a.index]
            assert abs(a.relevance_score - b.relevance_score) <= 1e-4
        want, got = _both(pair, "Rerank", "RerankRequest", query="hello",
                          documents=[])
        assert got.code == want.code == grpc.StatusCode.INVALID_ARGUMENT
        assert got.details == want.details == "query and documents required"
    finally:
        for s, _ in pair:
            s.shutdown()


def test_servicer_without_embeddings_refuses_them(ckpt, no_prewarm):
    pair = _servicers(ckpt, parallel=2, context_size=128,
                      prefill_buckets=[16])
    try:
        for rpc, msg, kw in (("Embedding", "PredictOptions",
                              dict(prompt_ids=[1, 2])),
                             ("Rerank", "RerankRequest",
                              dict(query="a", documents=["b"]))):
            want, got = _both(pair, rpc, msg, **kw)
            assert got.code == want.code == \
                grpc.StatusCode.FAILED_PRECONDITION
            assert got.details == want.details
    finally:
        for s, _ in pair:
            s.shutdown()


def test_servicer_bert_dir_is_embedding_only(bert_ckpt, no_prewarm):
    from localai_tpu_torch.backend import pb as tpb
    from localai_tpu_torch.backend.llm import LLMServicer as TServicer

    from localai_tpu.backend import pb as jpb
    from localai_tpu.backend.llm import LLMServicer as JServicer

    js, ts = JServicer(), TServicer(device="cpu")
    assert js.LoadModel(jpb.ModelOptions(model=bert_ckpt), None).success
    r = ts.LoadModel(tpb.ModelOptions(model=bert_ckpt), None)
    assert r.success, r.message
    assert ts.engine is None and isinstance(ts.embedder, tbert.BertEmbedder)
    assert ts.Status(tpb.HealthMessage(), None).state == 2       # READY
    pair = ((js, jpb), (ts, tpb))
    want, got = _both(pair, "Embedding", "PredictOptions",
                      prompt_ids=[1, 2, 3, 7])
    assert len(got.embeddings) == 64
    np.testing.assert_allclose(got.embeddings, want.embeddings, **F32)
    want, got = _both(pair, "Embedding", "PredictOptions",
                      prompts=["hello world", "the quick brown fox"])
    for a, b in zip(got.vectors, want.vectors):
        np.testing.assert_allclose(a.values, b.values, **F32)
    want, got = _both(pair, "TokenizeString", "PredictOptions",
                      prompt="hello world")
    assert list(got.tokens) == list(want.tokens) and got.length > 0
    want, got = _both(pair, "Predict", "PredictOptions", prompt_ids=[1],
                      tokens=2)
    assert got.code == want.code == grpc.StatusCode.FAILED_PRECONDITION
    # a second LoadModel answers "already loaded"
    r = ts.LoadModel(tpb.ModelOptions(model=bert_ckpt), None)
    assert r.success and r.message == "already loaded"
    ts.shutdown()
    assert ts.embedder is None


def test_load_refuses_the_roles_under_a_mesh(ckpt, bert_ckpt):
    from localai_tpu_torch.backend import pb
    from localai_tpu_torch.backend.llm import LLMServicer

    for model, kw in ((ckpt, dict(embeddings=True)), (bert_ckpt, {})):
        s = LLMServicer(device="cpu")
        r = s.LoadModel(pb.ModelOptions(model=model, dtype="float32",
                                        mesh_model=2, **kw), None)
        assert not r.success
        assert "under a mesh" in r.message and "parallel" in r.message, \
            r.message
