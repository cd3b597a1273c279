"""CLIP ViT vision tower, the eyes of the multimodal chat path
(counterpart of localai_tpu/models/clip_vit.py).

The HF `CLIPVisionModel` layout, run layer by layer:
- the patch conv [H, 3, P, P] (stride P, no bias) as a matmul over
  flattened patches: a P×P conv of stride P is a linear map per patch;
- the class embedding prepended, learned position embeddings added;
- "pre_layrnorm" (sic, HF's spelling) before the encoder;
- pre-LN blocks, quick_gelu (x·σ(1.702x)) MLP;
- LLaVA reads hidden_states[vision_feature_layer] (default -2), so the
  final post_layernorm is not applied to the features returned.
Attention is a plain torch.matmul pair around an f32 softmax, in the
reference's order of rounding (bidirectional, so not the causal
flash_prefill kernel; an XLA einsum in the reference). Parameters: a dict
of tensors with the layers as a list of per-layer dicts ([in, out]
layout), f32 by default.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from localai_tpu_torch.device import resolve_device, torch_dtype
from localai_tpu_torch.ops.norms import layer_norm

LAYER_KEYS = ("ln1_w", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo",
              "bo", "ln2_w", "ln2_b", "fc1", "b1", "fc2", "b2")


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def from_hf(hf: dict[str, Any], dtype: str | None = None):
        return ClipVisionConfig(
            hidden_size=hf.get("hidden_size", 1024),
            intermediate_size=hf.get("intermediate_size", 4096),
            num_layers=hf.get("num_hidden_layers", 24),
            num_heads=hf.get("num_attention_heads", 16),
            image_size=hf.get("image_size", 336),
            patch_size=hf.get("patch_size", 14),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            dtype=dtype or "float32",
        )


# CLIP pixel normalization (OpenAI checkpoints; HF CLIPImageProcessor)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(data: bytes, cfg: ClipVisionConfig) -> np.ndarray:
    """Image bytes → pixel_values [1, 3, S, S] f32 on the host: a bicubic
    square resize to image_size (llava's processor) and CLIP's
    normalization. Pillow is imported here, only when an image comes."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    img = img.resize((cfg.image_size, cfg.image_size), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0                    # [S, S, 3]
    x = (x - IMAGE_MEAN) / IMAGE_STD
    return x.transpose(2, 0, 1)[None]                          # [1, 3, S, S]


def vision_forward(params: dict, cfg: ClipVisionConfig, pixel_values,
                   feature_layer: int = -2):
    """pixel_values [B, 3, S, S] (a tensor on the params' device, or
    numpy) → hidden states [B, 1 + N, H] at `feature_layer`, counted as HF
    counts hidden_states (-1: after the last block, -2: after the one
    before). The CLS row is included; callers slice."""
    dtype = params["patch_embed"].dtype
    x = torch.as_tensor(pixel_values).to(
        device=params["patch_embed"].device, dtype=dtype)
    b = x.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    # [B, 3, G, p, G, p] → [B, G*G, 3*p*p]: each patch flattened in the
    # conv kernel's element order (channel-major), so the matmul is HF's
    # stride-P conv
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g * g, 3 * p * p)
    x = x @ params["patch_embed"]                              # [B, N, H]
    cls = params["class_embed"].to(x.dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]       # [B, 1+N, H]
    x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"],
                   cfg.layer_norm_eps)

    n_run = (cfg.num_layers + 1 + feature_layer if feature_layer < 0
             else feature_layer)
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    scale = hd ** -0.5
    for lp in params["layers"][:n_run]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(b, -1, nh, hd)
        k = (h @ lp["wk"] + lp["bk"]).reshape(b, -1, nh, hd)
        v = (h @ lp["wv"] + lp["bv"]).reshape(b, -1, nh, hd)
        s = torch.matmul((q * scale).transpose(1, 2),
                         k.permute(0, 2, 3, 1))                # [B,NH,Q,K]
        a = torch.softmax(s.float(), dim=-1).to(x.dtype)
        o = torch.matmul(a, v.transpose(1, 2)).transpose(1, 2)
        x = x + (o.reshape(b, -1, nh * hd) @ lp["wo"] + lp["bo"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        h = h @ lp["fc1"] + lp["b1"]
        h = h * torch.sigmoid(1.702 * h)                       # quick_gelu
        x = x + (h @ lp["fc2"] + lp["b2"])
    return x


def init_vision_params(cfg: ClipVisionConfig, seed: int = 0,
                       device=None) -> dict:
    """Random init in load_vision_params' layout (tests, synthetic
    checkpoints): N(0, 1/fan_in) weights from a torch.Generator seeded
    with `seed`, zero biases, unit LayerNorm gains, on `device` (default:
    the card)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size
    pdim = 3 * cfg.patch_size ** 2
    dt = cfg.tdtype

    def norm(shape, fan):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * fan ** -0.5).to(dt)

    def const(n, v):
        return torch.full((n,), v, dtype=dt, device=device)

    layers = [{
        "ln1_w": const(H, 1.0), "ln1_b": const(H, 0.0),
        "wq": norm((H, H), H), "bq": const(H, 0.0),
        "wk": norm((H, H), H), "bk": const(H, 0.0),
        "wv": norm((H, H), H), "bv": const(H, 0.0),
        "wo": norm((H, H), H), "bo": const(H, 0.0),
        "ln2_w": const(H, 1.0), "ln2_b": const(H, 0.0),
        "fc1": norm((H, I), H), "b1": const(I, 0.0),
        "fc2": norm((I, H), I), "b2": const(H, 0.0),
    } for _ in range(cfg.num_layers)]
    return {
        "patch_embed": norm((pdim, H), pdim),
        "class_embed": norm((H,), H),
        "pos_embed": norm((1 + cfg.n_patches, H), H),
        "pre_ln_w": const(H, 1.0), "pre_ln_b": const(H, 0.0),
        "layers": layers,
    }


def load_vision_params(reader, cfg: ClipVisionConfig, *, prefix: str,
                       dtype=None, device=None) -> dict:
    """HF CLIPVisionModel weights → the params dict on `device` (default:
    the card). `reader` is an engine.loader._TensorReader; `prefix` is
    "vision_tower." or "model.vision_tower." (both LLaVA save layouts)."""
    device = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else cfg.tdtype

    def get(name, transpose=False):
        t = reader.get(prefix + "vision_model." + name)
        t = t.T if transpose else t
        # copy=True: the reader's mmap closes after the load
        return t.to(device=device, dtype=dt, copy=True).contiguous()

    linear = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
              "wv": "self_attn.v_proj", "wo": "self_attn.out_proj",
              "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    bias = {"bq": "wq", "bk": "wk", "bv": "wv", "bo": "wo", "b1": "fc1",
            "b2": "fc2"}
    norms = {"ln1_w": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
             "ln2_w": "layer_norm2.weight", "ln2_b": "layer_norm2.bias"}
    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}."
        lp = {k: get(p + n + ".weight", True) for k, n in linear.items()}
        lp.update({k: get(p + linear[w] + ".bias") for k, w in bias.items()})
        lp.update({k: get(p + n) for k, n in norms.items()})
        layers.append(lp)
    conv = get("embeddings.patch_embedding.weight")            # [H, 3, P, P]
    return {
        "patch_embed": conv.reshape(conv.shape[0], -1).T.contiguous(),
        "class_embed": get("embeddings.class_embedding"),
        "pos_embed": get("embeddings.position_embedding.weight"),
        "pre_ln_w": get("pre_layrnorm.weight"),
        "pre_ln_b": get("pre_layrnorm.bias"),
        "layers": layers,
    }
