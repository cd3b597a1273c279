"""BERT-family encoder, the universal embeddings role (counterpart of
localai_tpu/models/bert.py).

Covers BertModel / RobertaModel / XLMRobertaModel checkpoints (Roberta's
only structural deltas: position ids start at pad + 1 = 2, and token
types collapse to one row). Bidirectional attention with a padding mask
is a plain torch.matmul pair around an f32 softmax, in the reference's
order of rounding (no fused attention: BERT attends both ways, so the
causal flash_prefill kernel does not apply, and in the reference it is an
XLA einsum outside any Pallas kernel); LayerNorm in f32
(ops/norms.layer_norm); masked-mean pooling + L2 norm (the
sentence-transformers recipe). Parameters: a dict of tensors with the
layers as a list of per-layer dicts ([in, out] matmul layout, q/k/v fused
into one wqkv), in f32 by default.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch import not_ported
from localai_tpu_torch.device import resolve_device, torch_dtype
from localai_tpu_torch.engine.embedder import Embedder
from localai_tpu_torch.ops.norms import layer_norm

BERT_FAMILY = {
    "BertModel": {},
    "BertForMaskedLM": {},
    "RobertaModel": {"position_offset": 2},
    "XLMRobertaModel": {"position_offset": 2},
    "CamembertModel": {"position_offset": 2},
}

LAYER_KEYS = ("wqkv", "bqkv", "wo", "bo", "ln1_w", "ln1_b", "w_in", "b_in",
              "w_out", "b_out", "ln2_w", "ln2_b")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    position_offset: int = 0      # Roberta: padding_idx + 1
    dtype: str = "float32"        # embeddings are accuracy-sensitive: f32
                                  # by default, bf16 on request

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def load_bert_config(model_dir: str, dtype: str | None = None) -> BertConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hf: dict[str, Any] = json.load(f)
    arch = (hf.get("architectures") or ["BertModel"])[0]
    if arch not in BERT_FAMILY:
        raise ValueError(f"unsupported encoder architecture {arch!r}")
    extra = BERT_FAMILY[arch]
    return BertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        max_position=hf.get("max_position_embeddings", 512),
        type_vocab_size=hf.get("type_vocab_size", 2),
        ln_eps=hf.get("layer_norm_eps", 1e-12),
        position_offset=extra.get("position_offset", 0),
        dtype=dtype or "float32",
    )


def is_bert_dir(model_dir: str) -> bool:
    """Does this checkpoint's config.json want the encoder path?"""
    try:
        with open(os.path.join(model_dir, "config.json")) as f:
            arch = (json.load(f).get("architectures") or [""])[0]
        return arch in BERT_FAMILY
    except (OSError, ValueError):
        return False


# ---------------------------------------------------------------- params

def init_bert_params(cfg: BertConfig, seed: int = 0, dtype=None,
                     device=None) -> dict:
    """Random init in load_bert_params' layout (tests, synthetic
    checkpoints): N(0, 1/fan_in) weights from a torch.Generator seeded
    with `seed`, zero biases, unit LayerNorm gains, on `device` (default:
    the card)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else cfg.tdtype
    gen = torch.Generator(device=device).manual_seed(seed)
    h, I = cfg.hidden_size, cfg.intermediate_size

    def w(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * fan_in ** -0.5).to(dtype)

    def const(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)

    layers = [{
        "wqkv": w((h, 3 * h), h), "bqkv": const(3 * h, 0.0),
        "wo": w((h, h), h), "bo": const(h, 0.0),
        "ln1_w": const(h, 1.0), "ln1_b": const(h, 0.0),
        "w_in": w((h, I), h), "b_in": const(I, 0.0),
        "w_out": w((I, h), I), "b_out": const(h, 0.0),
        "ln2_w": const(h, 1.0), "ln2_b": const(h, 0.0),
    } for _ in range(cfg.num_layers)]
    return {
        "word_emb": w((cfg.vocab_size, h), h),
        "pos_emb": w((cfg.max_position, h), h),
        "type_emb": w((cfg.type_vocab_size, h), h),
        "emb_ln_w": const(h, 1.0), "emb_ln_b": const(h, 0.0),
        "layers": layers,
    }


def load_bert_params(model_dir: str, cfg: BertConfig, dtype=None,
                     device=None) -> dict:
    """HF safetensors → the params dict on `device` (default: the card):
    torch Linear weights [out, in] transposed to [in, out], q/k/v fused
    into one wqkv. A synthetic checkpoint (loader._is_synthetic) gets
    init_bert_params' seeded weights."""
    from localai_tpu_torch.engine.loader import _is_synthetic, _TensorReader

    device = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else cfg.tdtype
    if _is_synthetic(model_dir):
        return init_bert_params(cfg, 0, dtype, device)
    r = _TensorReader(model_dir)
    pre = "bert." if any(n.startswith("bert.") for n in r.index) else ""

    def t(name):
        # copy=True: the reader's mmap closes after the load
        return r.get(pre + name).to(device=device, dtype=dtype, copy=True)

    def lin(name):  # torch Linear → ([in, out] weight, bias)
        return t(name + ".weight").T.contiguous(), t(name + ".bias")

    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        qw, qb = lin(p + "attention.self.query")
        kw, kb = lin(p + "attention.self.key")
        vw, vb = lin(p + "attention.self.value")
        ow, ob = lin(p + "attention.output.dense")
        iw, ib = lin(p + "intermediate.dense")
        dw, db = lin(p + "output.dense")
        layers.append({
            "wqkv": torch.cat([qw, kw, vw], dim=1),
            "bqkv": torch.cat([qb, kb, vb]),
            "wo": ow, "bo": ob,
            "ln1_w": t(p + "attention.output.LayerNorm.weight"),
            "ln1_b": t(p + "attention.output.LayerNorm.bias"),
            "w_in": iw, "b_in": ib, "w_out": dw, "b_out": db,
            "ln2_w": t(p + "output.LayerNorm.weight"),
            "ln2_b": t(p + "output.LayerNorm.bias"),
        })
    params = {
        "word_emb": t("embeddings.word_embeddings.weight"),
        "pos_emb": t("embeddings.position_embeddings.weight"),
        "type_emb": t("embeddings.token_type_embeddings.weight"),
        "emb_ln_w": t("embeddings.LayerNorm.weight"),
        "emb_ln_b": t("embeddings.LayerNorm.bias"),
        "layers": layers,
    }
    r.close()
    return params


def bert_params_from_jax(tree, device=None) -> dict:
    """The reference's params (numpy leaves, layers stacked on a leading
    [L] axis) → the port's dict on `device` (default: the card)."""
    device = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x)).to(device)

    lay = tree["layers"]
    n = np.asarray(lay["wqkv"]).shape[0]
    return {
        **{k: leaf(v) for k, v in tree.items() if k != "layers"},
        "layers": [{k: leaf(np.asarray(lay[k])[i]) for k in LAYER_KEYS}
                   for i in range(n)],
    }


# ---------------------------------------------------------------- forward

def bert_encode(params: dict, cfg: BertConfig, tokens, lengths):
    """tokens [B, S] int, lengths [B] → final hidden states [B, S, H] in
    the params' dtype."""
    b, s = tokens.shape
    dev = tokens.device
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    dtype = params["word_emb"].dtype
    pos = torch.arange(s, device=dev) + cfg.position_offset
    x = (params["word_emb"][tokens.long()] + params["pos_emb"][pos][None]
         + params["type_emb"][0][None, None])
    x = layer_norm(x.float(), params["emb_ln_w"], params["emb_ln_b"],
                   cfg.ln_eps).to(dtype)
    # bidirectional padding mask [B, 1, 1, S]
    valid = torch.arange(s, device=dev)[None, :] < lengths.to(dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float()[:, None, None, :]
    scale = hd ** -0.5

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)      # [B, NH, S, D]

    for lp in params["layers"]:
        q, k, v = (x @ lp["wqkv"] + lp["bqkv"]).split(h, dim=-1)
        q, k, v = heads(q), heads(k), heads(v)
        att = torch.matmul(q, k.transpose(-1, -2)).float()
        att = torch.softmax(att * scale + bias, dim=-1).to(x.dtype)
        ctx = torch.matmul(att, v).transpose(1, 2).reshape(b, s, h)
        x = layer_norm((x + ctx @ lp["wo"] + lp["bo"]).float(),
                       lp["ln1_w"], lp["ln1_b"], cfg.ln_eps).to(x.dtype)
        y = F.gelu(x @ lp["w_in"] + lp["b_in"])             # exact (erf)
        x = layer_norm((x + y @ lp["w_out"] + lp["b_out"]).float(),
                       lp["ln2_w"], lp["ln2_b"], cfg.ln_eps).to(x.dtype)
    return x


def bert_pooled(params: dict, cfg: BertConfig, tokens, lengths,
                normalize: bool = True):
    """Masked-mean pooled sentence embeddings [B, H] f32, L2-normalized
    unless `normalize` is False."""
    s = tokens.shape[1]
    x = bert_encode(params, cfg, tokens, lengths).float()
    mask = (torch.arange(s, device=x.device)[None, :]
            < lengths.to(x.device)[:, None]).float()
    pooled = (x * mask[..., None]).sum(1) / torch.clamp_min(
        mask.sum(1)[:, None], 1.0)
    if normalize:
        pooled = pooled / torch.clamp_min(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-9)
    return pooled


class BertEmbedder(Embedder):
    """The bucketed embeddings runner (engine.Embedder) with the encoder
    swapped for bert_pooled (_bucket and embed inherited)."""

    def __init__(self, cfg: BertConfig, params, *,
                 buckets: tuple[int, ...] = (64, 256, 512), mesh=None,
                 device=None):
        if mesh is not None:
            raise not_ported("BERT embeddings under a mesh", "parallel")
        self.cfg = cfg
        self.params = params
        # position ids shift by position_offset (Roberta): the usable
        # sequence length is max_position - offset
        top = cfg.max_position - cfg.position_offset
        self.buckets = tuple(sorted(b for b in buckets if b <= top)) or (
            min(64, top),)
        self.device = resolve_device(device)
        self._fn = bert_pooled
