"""Checkpoint loading: HF safetensors → models.llama.Llama (counterpart of
localai_tpu/engine/loader.py).

Tensors are read lazily per shard from an mmap with torch.frombuffer (BF16
included — no ml_dtypes), transposed once into the [in, out] matmul
layout, cast to the compute dtype and placed on the target device.
dtype="int8" (or "int4"/"q4") casts each projection to bf16 first and then
quantizes it per output channel on the device — the reference's order, so
the int8 payload (the int4 values, packed: ops/quant) and scales are
bit-identical to localai_tpu.engine.loader.load_params.
Mixtral checkpoints stack each layer's experts into [E, in, out] (each
expert quantized on its own, which equals quantizing the stack: the
scales reduce over the input axis only) and keep the router gate [H, E]
in the model dtype, unquantized, as the reference does.
A llava checkpoint's language side loads as any Llama-family model: its
config is `text_config`, and the tensor reader resolves both llava save
layouts' spellings of the text weights (models/llava.py loads the vision
side).
With a `mesh` (tensor parallelism, parallel/mesh.py) each rank keeps only
its shards (models/llama.shard_leaf), one projection held whole at a
time: a projection is read, cast and, for int8, quantized whole — the
reference's host quantization, so the scales equal the single-device
load's bit for bit — and then sliced; no rank holds the whole bf16 stack.
"""
from __future__ import annotations

import json
import mmap
import os
import warnings
from typing import Any

import torch

from localai_tpu_torch import not_ported
from localai_tpu_torch.device import resolve_device, torch_dtype
from localai_tpu_torch.models.llama import (
    Llama, LlamaConfig, LlamaLayer, init_params, shard_layer, shard_leaf,
    tp_check,
)
from localai_tpu_torch.ops.kernels import pack_int4
from localai_tpu_torch.ops.quant import QMAX, QuantWeight, quantize

# HF architectures the Llama-family decoder covers
LLAMA_FAMILY = {
    "LlamaForCausalLM": {},
    "MistralForCausalLM": {},
    "MixtralForCausalLM": {"moe": True},
    "Qwen2ForCausalLM": {"qkv_bias": True},
    "TinyLlamaForCausalLM": {},
}

_QBITS = {"int8": 8, "q8": 8, "int4": 4, "q4": 4}


def load_config(model_dir: str, dtype: str | None = None) -> LlamaConfig:
    """Parse HF config.json into a LlamaConfig. `dtype` overrides the compute
    dtype (int8/int4 = weight quantization; activations stay bf16)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf: dict[str, Any] = json.load(f)

    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if hf.get("model_type") == "llava" or arch.startswith("Llava"):
        # vision-language checkpoint: the language side is a plain
        # Llama-family config nested under text_config (the vision side
        # loads separately: models/llava.py)
        hf = dict(hf["text_config"])
        arch = (hf.get("architectures")
                or [{"llama": "LlamaForCausalLM",
                     "mistral": "MistralForCausalLM",
                     "qwen2": "Qwen2ForCausalLM"}.get(
                        hf.get("model_type", "llama"), "LlamaForCausalLM")])[0]
    if arch not in LLAMA_FAMILY:
        raise ValueError(f"unsupported architecture {arch!r}")
    extra = LLAMA_FAMILY[arch]

    num_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads

    kw: dict[str, Any] = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        max_position=hf.get("max_position_embeddings", 8192),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        rope_base=hf.get("rope_theta", 10000.0),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        sliding_window=hf.get("sliding_window"),
        qkv_bias=hf.get("attention_bias", extra.get("qkv_bias", False)),
    )
    if extra.get("moe") or hf.get("num_local_experts"):
        kw["num_experts"] = hf.get("num_local_experts", 8)
        kw["experts_per_tok"] = hf.get("num_experts_per_tok", 2)
    if dtype is not None:
        kw["dtype"] = "bfloat16" if dtype in _QBITS else dtype

    rs = hf.get("rope_scaling") or hf.get("rope_parameters") or None
    if rs and isinstance(rs, dict) and rs.get(
            "rope_type", rs.get("type")) not in (None, "default"):
        rope_type = rs.get("rope_type", rs.get("type"))
        kw["rope_scaling"] = rope_type
        kw["rope_scale_factor"] = rs.get("factor", 1.0)
        kw["rope_original_max_position"] = rs.get(
            "original_max_position_embeddings", kw["max_position"])
        if rope_type == "llama3":
            kw["rope_low_freq_factor"] = rs.get("low_freq_factor", 1.0)
            kw["rope_high_freq_factor"] = rs.get("high_freq_factor", 4.0)
        if rope_type == "yarn":
            kw["rope_beta_fast"] = rs.get("beta_fast", 32.0)
            kw["rope_beta_slow"] = rs.get("beta_slow", 1.0)
            kw["rope_attn_factor"] = rs.get("attention_factor")
    return LlamaConfig(**kw)


class _SafetensorsFile:
    """Minimal safetensors reader: 8-byte header length, JSON header {name:
    {dtype, shape, data_offsets}}, then raw little-endian tensor data,
    viewed zero-copy through an mmap (tensors stay on the host until the
    loader moves them)."""

    _DTYPES = {
        "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
        "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
        "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
        "BOOL": torch.bool,
    }

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        hlen = int.from_bytes(self._mm[:8], "little")
        self._header: dict[str, Any] = json.loads(self._mm[8:8 + hlen])
        self._header.pop("__metadata__", None)
        self._base = 8 + hlen

    def keys(self):
        return self._header.keys()

    def get(self, name: str) -> torch.Tensor:
        meta = self._header[name]
        lo, hi = meta["data_offsets"]
        dtype = self._DTYPES[meta["dtype"]]
        count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
        with warnings.catch_warnings():
            # the mmap is read-only; every tensor is copied (cast/moved)
            # before anything could write to it
            warnings.simplefilter("ignore", UserWarning)
            t = torch.frombuffer(self._mm, dtype=dtype, count=count,
                                 offset=self._base + lo)
        return t.reshape(meta["shape"])

    def close(self):
        self._mm.close()
        self._f.close()


class _TensorReader:
    """Lazy per-tensor host reads across safetensors shards."""

    def __init__(self, model_dir: str):
        self.dir = model_dir
        self.index = self._shard_index(model_dir)
        self._open: dict[str, _SafetensorsFile] = {}

    @staticmethod
    def _shard_index(model_dir: str) -> dict[str, str]:
        """tensor name → safetensors filename (single-file or index.json)."""
        idx = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                return json.load(f)["weight_map"]
        name = "model.safetensors"
        if os.path.exists(os.path.join(model_dir, name)):
            f = _SafetensorsFile(os.path.join(model_dir, name))
            try:
                return {k: name for k in f.keys()}
            finally:
                f.close()
        raise FileNotFoundError(f"no safetensors checkpoint in {model_dir}")

    @staticmethod
    def _variants(name: str):
        """Key spellings across HF save layouts: plain Llama, classic LLaVA
        (language_model.model.* + language_model.lm_head.*), and the 4.52+
        LLaVA relayout (model.language_model.* + top-level lm_head.*)."""
        yield name
        yield "language_model." + name
        if name.startswith("model."):
            yield "model.language_model." + name[len("model."):]

    def _resolve(self, name: str) -> str | None:
        for v in self._variants(name):
            if v in self.index:
                return v
        return None

    def __contains__(self, name: str) -> bool:
        return self._resolve(name) is not None

    def get(self, name: str) -> torch.Tensor:
        key = self._resolve(name)
        if key is None:
            raise KeyError(name)
        fname = self.index[key]
        if fname not in self._open:
            self._open[fname] = _SafetensorsFile(os.path.join(self.dir, fname))
        return self._open[fname].get(key)

    def close(self):
        for f in self._open.values():
            f.close()
        self._open.clear()


def _mesh_check(cfg: LlamaConfig, qbits, mesh) -> None:
    if mesh is None:
        return
    tp_check(cfg, mesh)
    if qbits == 4:
        raise not_ported("int4 weights under a mesh", "parallel")


def load_params(model_dir: str, cfg: LlamaConfig, *, dtype=None,
                device=None, mesh=None) -> Llama:
    """Load + restructure a HF Llama-family checkpoint onto `device`
    (default: the CUDA device). HF stores projections [out, in]; they are
    transposed once here. dtype="int8" (8 bits) or "int4"/"q4" (4)
    quantizes every projection (and the lm_head) per output channel after
    the bf16 load cast. `mesh`: keep this rank's shards only (module
    docstring)."""
    device = resolve_device(device)
    qbits = _QBITS.get(dtype)
    tdtype = (torch.bfloat16 if qbits else
              torch_dtype(dtype) if dtype is not None else cfg.tdtype)
    _mesh_check(cfg, qbits, mesh)

    if _is_synthetic(model_dir):
        # benchmark checkpoints: config.json declares the geometry, weights
        # are seeded random init made on the device
        return _synthetic_params(cfg, dtype=tdtype, device=device,
                                 qbits=qbits, mesh=mesh)

    r = _TensorReader(model_dir)

    def get(name: str, transpose: bool = False, quant: bool = False,
            leaf: str | None = None):
        t = r.get(name)
        t = t.T if transpose else t
        # copy=True: the reader's mmap closes after the load
        t = t.to(device=device, dtype=tdtype, copy=True).contiguous()
        t = quantize(t, qbits) if (quant and qbits) else t
        # a sharded load slices after the whole projection's quantization
        return t if (mesh is None or leaf is None) else shard_leaf(
            leaf, t, mesh)

    def experts(p: str, which: str):
        # block_sparse_moe.experts.{e}.w{1,2,3}: [out, in] each, stacked
        # transposed into [E, in, out]; int8/int4 quantizes each expert's
        # bf16 copy, so only one expert is ever held beside the stack
        ws = [get(f"{p}block_sparse_moe.experts.{e}.{which}.weight", True,
                  True) for e in range(cfg.num_experts)]
        if qbits:
            return QuantWeight(torch.stack([w.q for w in ws]),
                               torch.stack([w.s for w in ws]))
        return torch.stack(ws)

    L = "model.layers.{i}."
    layers = []
    for i in range(cfg.num_layers):
        p = L.format(i=i)
        w = {
            "attn_norm": get(p + "input_layernorm.weight"),
            "wq": get(p + "self_attn.q_proj.weight", True, True, "wq"),
            "wk": get(p + "self_attn.k_proj.weight", True, True, "wk"),
            "wv": get(p + "self_attn.v_proj.weight", True, True, "wv"),
            "wo": get(p + "self_attn.o_proj.weight", True, True, "wo"),
            "mlp_norm": get(p + "post_attention_layernorm.weight"),
        }
        if cfg.num_experts:
            # the router stays in the model dtype (bf16 under int8), as
            # the reference's load cast leaves it: _moe_mlp casts it to f32
            w["moe_gate"] = get(p + "block_sparse_moe.gate.weight", True)
            for which in ("w1", "w2", "w3"):
                w["moe_" + which] = experts(p, which)
        else:
            w["w_gate"] = get(p + "mlp.gate_proj.weight", True, True,
                              "w_gate")
            w["w_up"] = get(p + "mlp.up_proj.weight", True, True, "w_up")
            w["w_down"] = get(p + "mlp.down_proj.weight", True, True,
                              "w_down")
        if cfg.qkv_bias:
            w["bq"] = get(p + "self_attn.q_proj.bias", leaf="bq")
            w["bk"] = get(p + "self_attn.k_proj.bias", leaf="bk")
            w["bv"] = get(p + "self_attn.v_proj.bias", leaf="bv")
        layers.append(LlamaLayer(w))
    head = None
    if not cfg.tie_embeddings:
        if "lm_head.weight" not in r:
            raise ValueError(
                "config says untied embeddings but lm_head.weight is missing")
        head = get("lm_head.weight", True, True, "lm_head")
    params = Llama(cfg, get("model.embed_tokens.weight"), layers,
                   get("model.norm.weight"), head, mesh=mesh)
    r.close()
    return params


def _synthetic_params(cfg: LlamaConfig, *, dtype, device, qbits=None,
                      seed: int = 0, mesh=None) -> Llama:
    """Deterministic random params at any scale, made on `device` from a
    seeded torch.Generator. The quantized case generates the integer
    payload and scales directly (no full-precision intermediate): values
    in [-qmax, qmax] (127, or 7 for int4, packed a projection at a time),
    each scale fan_in^-0.5 * 1.73 / qmax, so the dequantized weights have
    ~1/sqrt(fan_in) std like init_params; a Mixtral config gets quantized
    expert stacks (scales [E, 1, out]) and an f32 router gate, as the
    reference's synthetic checkpoint does. With a `mesh` every layer is
    drawn whole, as without one, and sliced to the rank's shards before
    the next is drawn: each rank holds its shards of the same weights."""
    if qbits is None:
        return init_params(cfg, seed=seed, dtype=dtype, device=device,
                           mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, hd = cfg.hidden_size, cfg.head_dim
    nh, nkv, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

    qmax = QMAX[qbits]

    def qrand(shape, fan_in):
        q = torch.randint(-qmax, qmax + 1, shape, generator=gen,
                          device=device, dtype=torch.int8)
        s = torch.full(shape[:-2] + (1, shape[-1]),
                       (fan_in ** -0.5) * (1.73 / qmax), dtype=torch.float32,
                       device=device)
        return QuantWeight(pack_int4(q) if qbits == 4 else q, s)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        w = {"attn_norm": ones(h), "wq": qrand((h, nh * hd), h),
             "wk": qrand((h, nkv * hd), h), "wv": qrand((h, nkv * hd), h),
             "wo": qrand((nh * hd, h), nh * hd), "mlp_norm": ones(h)}
        if cfg.num_experts:
            e = cfg.num_experts
            w.update(moe_gate=torch.randn((h, e), generator=gen,
                                          device=device) * h ** -0.5,
                     moe_w1=qrand((e, h, inter), h),
                     moe_w2=qrand((e, inter, h), inter),
                     moe_w3=qrand((e, h, inter), h))
        else:
            w.update(w_gate=qrand((h, inter), h), w_up=qrand((h, inter), h),
                     w_down=qrand((inter, h), inter))
        if cfg.qkv_bias:
            for k, n in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
                w[k] = torch.zeros((n,), dtype=dtype, device=device)
        layers.append(LlamaLayer(w if mesh is None else shard_layer(w, mesh)))
    embed = (torch.randn((cfg.vocab_size, h), generator=gen, device=device,
                         dtype=torch.float32) * h ** -0.5).to(dtype)
    head = None if cfg.tie_embeddings else qrand((h, cfg.vocab_size), h)
    if head is not None and mesh is not None:
        head = shard_leaf("lm_head", head, mesh)
    return Llama(cfg, embed, layers, ones(h), head, mesh=mesh)


def _is_synthetic(model_dir: str) -> bool:
    """True for benchmark checkpoints: config.json with
    "localai_synthetic": true AND the LOCALAI_ALLOW_SYNTHETIC=1 opt-in, so a
    stray config key never makes a server silently serve random weights."""
    if os.environ.get("LOCALAI_ALLOW_SYNTHETIC") != "1":
        return False
    try:
        with open(os.path.join(model_dir, "config.json")) as fh:
            return bool(json.load(fh).get("localai_synthetic"))
    except (OSError, ValueError):
        return False


def load_tokenizer(model_dir: str):
    """Tokenizer for a model dir; None for synthetic benchmark checkpoints
    (callers drive the engine with prompt_ids)."""
    from localai_tpu_torch.engine.tokenizer import Tokenizer

    try:
        return Tokenizer.from_dir(model_dir)
    except FileNotFoundError:
        if not _is_synthetic(model_dir):
            raise
        return None


def load_model(model_dir: str, *, dtype=None, device=None, mesh=None):
    """config.json + safetensors + tokenizer in one call → (cfg, params, tok).
    `device` defaults to the CUDA device; pass "cpu" to load on the host.
    `mesh`: this rank's shards only."""
    cfg = load_config(model_dir, dtype=dtype)
    params = load_params(model_dir, cfg, dtype=dtype, device=device,
                         mesh=mesh)
    return cfg, params, load_tokenizer(model_dir)
