"""LLaVA-style vision-language chat: images in Predict (counterpart of
localai_tpu/models/llava.py).

  CLIP ViT tower (models/clip_vit.py)
    → hidden_states[vision_feature_layer], CLS dropped
    → a 2-layer projector (exact gelu) into the text hidden size
    → spliced into the prompt as injected embeddings: the engine's
      admission, chunked extend and ragged pack take an (extra, is_embed)
      inject pair, so image features ride the same continuous-batching
      slots as text tokens (engine/engine.py) — no separate vision path.

Both HF LLaVA save layouts load: the classic `language_model.model.* /
vision_tower.* / multi_modal_projector.*` and the 4.52+
`model.language_model.* / model.vision_tower.* /
model.multi_modal_projector.* / lm_head.*`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.clip_vit import (
    LAYER_KEYS, ClipVisionConfig, load_vision_params, preprocess_image,
    vision_forward,
)

PROJ_KEYS = ("proj_w1", "proj_b1", "proj_w2", "proj_b2")


@dataclasses.dataclass(frozen=True)
class LlavaMeta:
    image_token_index: int
    vision_feature_layer: int = -2
    select_strategy: str = "default"   # "default" drops CLS, "full" keeps


def is_llava(model_dir: str) -> bool:
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return False
    with open(path) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or [""])[0]
    return hf.get("model_type") == "llava" or arch.startswith("Llava")


def load_vision(model_dir: str, dtype: str | None = None, device=None):
    """The vision side of a LLaVA checkpoint on `device` (default: the
    card): (vision_cfg, {"tower": ..., "proj_w1", "proj_b1", "proj_w2",
    "proj_b2"}, LlavaMeta). f32 unless `dtype` says otherwise."""
    from localai_tpu_torch.engine.loader import _TensorReader

    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf: dict[str, Any] = json.load(f)
    vcfg = ClipVisionConfig.from_hf(hf.get("vision_config") or {},
                                    dtype=dtype or "float32")
    meta = LlavaMeta(
        image_token_index=hf.get("image_token_index", 32000),
        vision_feature_layer=hf.get("vision_feature_layer", -2),
        select_strategy=hf.get("vision_feature_select_strategy", "default"),
    )
    r = _TensorReader(model_dir)
    try:
        tower_prefix = next(
            p for p in ("vision_tower.", "model.vision_tower.")
            if p + "vision_model.pre_layrnorm.weight" in r)
        proj_prefix = next(
            p for p in ("multi_modal_projector.",
                        "model.multi_modal_projector.")
            if p + "linear_1.weight" in r)
        tower = load_vision_params(r, vcfg, prefix=tower_prefix,
                                   device=device)

        def get(name, transpose=False):
            t = r.get(proj_prefix + name)
            t = t.T if transpose else t
            return t.to(device=device, dtype=vcfg.tdtype,
                        copy=True).contiguous()

        params = {"tower": tower,
                  "proj_w1": get("linear_1.weight", True),
                  "proj_b1": get("linear_1.bias"),
                  "proj_w2": get("linear_2.weight", True),
                  "proj_b2": get("linear_2.bias")}
    finally:
        r.close()
    return vcfg, params, meta


def vision_params_from_jax(tree, device=None) -> dict:
    """The reference's vision params (numpy leaves: {"tower": ... with its
    layers stacked on a leading [L] axis, "proj_w1", "proj_b1", "proj_w2",
    "proj_b2"}) → the port's dict on `device` (default: the card)."""
    device = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x)).to(device)

    tower = tree["tower"]
    lay = tower["layers"]
    n = np.asarray(lay["wq"]).shape[0]
    out = {k: leaf(tree[k]) for k in PROJ_KEYS}
    out["tower"] = {
        **{k: leaf(v) for k, v in tower.items() if k != "layers"},
        "layers": [{k: leaf(np.asarray(lay[k])[i]) for k in LAYER_KEYS}
                   for i in range(n)],
    }
    return out


def encode_images(params: dict, vcfg: ClipVisionConfig, meta: LlavaMeta,
                  pixel_values) -> torch.Tensor:
    """pixel_values [N, 3, S, S] → projected image features [N, n_tok,
    H_text] on the params' device (n_tok = n_patches under the
    CLS-dropping "default" strategy)."""
    with torch.no_grad():
        feats = vision_forward(params["tower"], vcfg, pixel_values,
                               feature_layer=meta.vision_feature_layer)
        if meta.select_strategy != "full":
            feats = feats[:, 1:]                               # drop CLS
        h = F.gelu(feats @ params["proj_w1"] + params["proj_b1"])
        return h @ params["proj_w2"] + params["proj_b2"]


def expand_image_tokens(prompt_ids: list[int], n_images: int, n_tok: int,
                        image_token: int) -> tuple[list[int], np.ndarray]:
    """HF LlavaProcessor's expansion: each single image token in the prompt
    becomes n_tok copies. Returns (expanded ids, the positions [n_images *
    n_tok] of the expanded image slots, in image order)."""
    occurrences = [i for i, t in enumerate(prompt_ids) if t == image_token]
    if len(occurrences) != n_images:
        raise ValueError(
            f"prompt has {len(occurrences)} image placeholder(s) but "
            f"{n_images} image(s) were attached")
    out: list[int] = []
    positions: list[int] = []
    for t in prompt_ids:
        if t == image_token:
            positions.extend(range(len(out), len(out) + n_tok))
            out.extend([image_token] * n_tok)
        else:
            out.append(t)
    return out, np.asarray(positions, np.int64)


def decode_image_b64(data: str) -> bytes:
    """A proto images entry: raw base64, or a data: URL."""
    import base64

    if data.startswith("data:"):
        data = data.split(",", 1)[1]
    return base64.b64decode(data)


__all__ = [
    "LlavaMeta", "is_llava", "load_vision", "encode_images",
    "expand_image_tokens", "decode_image_b64", "preprocess_image",
    "vision_params_from_jax",
]
