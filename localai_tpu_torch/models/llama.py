"""Llama-family decoder (Llama 2/3, Mistral, Mixtral, Qwen2, TinyLlama) in
PyTorch (counterpart of localai_tpu/models/llama.py).

Weights keep the reference's [in, out] orientation (x @ W) and live per
layer in an nn.Module; the KV cache keeps the head-major layout [L, B, KVH,
T, D] (int8 caches: ops/kvcache.QuantKV with T padded to 128), or — with a
block `table` [B, MAXB] — the paged block pool [L, NB, KVH, 128, D] of
ops/paged.py. Where the reference returns new cache arrays, the port
writes into the caches it was given, in place, and returns only the
logits.

Attention on the main path goes through ops/kernels/: the prefill and
decode wrappers (and, paged, the decode scatter-append write) launch the
CUDA kernels for CUDA tensors and run their plain versions for CPU tensors
(the selection the reference's _attn_impls makes between Pallas and XLA).
Chunked prefill (`extend`) attends with the plain ops/attention.mha_extend,
reading a paged cache through ops/paged.paged_view, as the reference does.
The ragged slice (`ragged_forward`, `build_ragged_loop`) serves mixed
prefill+decode ticks over one flat token stream through the ragged
attention and flat-row scatter kernels.
The cacheless full-sequence forwards (`hidden_states`, `forward_train`,
`encode_pooled`: the embeddings and rerank roles, engine/embedder.py)
attend through flash_prefill under the lengths mask and write no cache.
The multimodal lane (`inject`: extra rows and an is_embed mask) replaces
token embeddings with image features before the first layer in
`prefill`, `extend` and `ragged_forward` (models/llava.py).
Mixtral's MLP (`_moe_mlp`, on every path through `_mlp`) routes each
token to its top-k experts with dense dispatch; quantized expert stacks
go through the expert GEMM kernels (ops/kernels.moe_w8_matmul, int8;
moe_w4_matmul, packed int4).

The KV lifecycle tier (`kvt`, engine/kvtier.py) rides every paged path as
a dict of per-slot geometry [B] int32 — "sb", "rw" (ring), "sinks",
"window" (retention) — and, with the cold tier, "cold_tab" [B, MBC] and
the int8 cold pools "cold_k"/"cold_v" [L, NBc, KVH, 128, D] (read-only
here: the engine demotes). Writes map raw blocks through
ops/paged.ring_block_map; decode and ragged attention take kvt in their
kernels; the first prefill chunk attends under ops/attention's
mha_prefill_tiered and `extend` against the resident view at true
positions (mha_extend_tiered), as the reference does. kvt=None keeps
every path as it is untiered.

Tensor parallelism on the `model` axis (parallel/mesh.py): shard_params
keeps one rank's Megatron slices (q/k/v/gate/up columns, wo/down rows, the
untied lm_head's vocab columns; int8 scales follow their columns, a
row-parallel projection's scales stay whole), the caches hold the rank's
num_kv_heads // tp heads, every forward sums the row-parallel products
over the axis (one all-reduce after wo and one after w_down a layer) and
the vocab-parallel head all-gathers its f32 logits, so every rank holds
the same logits. Under a mesh the paged decode write and the ragged
path's attention and writes pass the mesh to their kernel wrappers
(ops/kernels): the rank's launch of rows 6-11 on its own heads, counted
under the `*_sharded` names.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from localai_tpu_torch import not_ported
from localai_tpu_torch.device import resolve_device, torch_dtype
from localai_tpu_torch.ops.attention import (
    mha_extend, mha_extend_tiered, mha_prefill_tiered,
)
from localai_tpu_torch.ops.kernels import (
    QBLK, flash_prefill, head_matmul, moe_w4_matmul, moe_w8_matmul,
    pack_int4, paged_scatter_append, paged_scatter_append_q8,
    paged_targets, ragged_decode, ragged_decode_q8, ragged_paged_attention,
    ragged_paged_attention_q8, ragged_scatter_append,
    ragged_scatter_append_q8,
)
from localai_tpu_torch.ops.kvcache import (
    QuantKV, cache_scatter, dequant, init_quant, is_quant_kind, padded_len,
    requantize,
)
from localai_tpu_torch.ops.paged import (
    BLOCK, paged_view, ring_block_map, tiered_positions,
)
from localai_tpu_torch.ops.norms import rms_norm
from localai_tpu_torch.ops.quant import QuantWeight, is_quantized, qmatmul
from localai_tpu_torch.ops.rope import (
    RopeConfig, apply_rope, rope_freqs, rope_table,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position: int = 8192
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_scaling: str = "none"          # none|linear|yarn|llama3
    rope_scale_factor: float = 1.0
    rope_original_max_position: int = 8192
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_attn_factor: float | None = None
    qkv_bias: bool = False              # Qwen2
    tie_embeddings: bool = False
    sliding_window: int | None = None   # Mistral
    num_experts: int = 0                # Mixtral MoE (0 = dense MLP)
    experts_per_tok: int = 2
    dtype: str = "bfloat16"

    @property
    def rope(self) -> RopeConfig:
        return RopeConfig(
            head_dim=self.head_dim,
            base=self.rope_base,
            scaling=self.rope_scaling,
            scale_factor=self.rope_scale_factor,
            original_max_position=self.rope_original_max_position,
            low_freq_factor=self.rope_low_freq_factor,
            high_freq_factor=self.rope_high_freq_factor,
            beta_fast=self.rope_beta_fast,
            beta_slow=self.rope_beta_slow,
            attn_factor=self.rope_attn_factor,
        )

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


# ---------------------------------------------------------------- params

class LlamaLayer(nn.Module):
    """One decoder layer's weights: norms as [H] buffers, projections as
    [in, out] buffers or QuantWeight submodules. `layer["wq"]` reads like
    the reference's per-layer param dict. A Mixtral layer holds the router
    `moe_gate` [H, E] (never quantized) and the expert stacks `moe_w1`,
    `moe_w3` [E, H, I] and `moe_w2` [E, I, H] (QuantWeight: s [E, 1, out])
    in place of w_gate / w_up / w_down."""

    PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                   "moe_w1", "moe_w2", "moe_w3")

    def __init__(self, weights: dict):
        super().__init__()
        for name, w in weights.items():
            self.set_weight(name, w)

    def set_weight(self, name: str, w) -> None:
        self._buffers.pop(name, None)
        self._modules.pop(name, None)
        if isinstance(w, nn.Module):
            self.add_module(name, w)
        else:
            self.register_buffer(name, w)

    def weight_names(self):
        return [n for n in self.PROJECTIONS
                if n in self._buffers or n in self._modules]

    def __getitem__(self, name: str):
        return getattr(self, name)


class Llama(nn.Module):
    """The whole model's weights: embed [V, H], per-layer LlamaLayers,
    final_norm [H] and lm_head [H, V] (None with tied embeddings). `mesh`:
    the parallel/mesh.Mesh whose rank's shards these are (shard_params),
    None for a whole model."""

    def __init__(self, cfg: LlamaConfig, embed, layers, final_norm,
                 lm_head=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("final_norm", final_norm)
        self.set_head(lm_head)

    def set_head(self, head) -> None:
        self._buffers.pop("lm_head", None)
        self._modules.pop("lm_head", None)
        if isinstance(head, nn.Module):
            self.add_module("lm_head", head)
        else:
            self.register_buffer("lm_head", head)


def init_params(cfg: LlamaConfig, seed: int = 0, dtype=None,
                device=None, mesh=None) -> Llama:
    """Random init (tests, synthetic checkpoints): N(0, 1/fan_in) weights
    drawn from a torch.Generator seeded with `seed`, on `device`. A
    Mixtral config draws the router gate in f32 and the expert stacks in
    `dtype`, as the reference's init_params does. With a `mesh` each
    layer is drawn whole, as without one, and only this rank's slices are
    kept (shard_layer): the same weights, sharded, one layer held whole
    at a time."""
    if mesh is not None:
        tp_check(cfg, mesh)
    dtype = torch_dtype(dtype) if dtype is not None else cfg.tdtype
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    h, hd = cfg.hidden_size, cfg.head_dim
    nh, nkv, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

    def norm(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * fan_in ** -0.5).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        w = {"attn_norm": ones(h), "wq": norm((h, nh * hd), h),
             "wk": norm((h, nkv * hd), h), "wv": norm((h, nkv * hd), h),
             "wo": norm((nh * hd, h), nh * hd), "mlp_norm": ones(h)}
        if cfg.num_experts:
            e = cfg.num_experts
            w.update(moe_gate=norm((h, e), h).float(),
                     moe_w1=norm((e, h, inter), h),
                     moe_w2=norm((e, inter, h), inter),
                     moe_w3=norm((e, h, inter), h))
        else:
            w.update(w_gate=norm((h, inter), h), w_up=norm((h, inter), h),
                     w_down=norm((inter, h), inter))
        if cfg.qkv_bias:
            w.update(bq=torch.zeros((nh * hd,), dtype=dtype, device=device),
                     bk=torch.zeros((nkv * hd,), dtype=dtype, device=device),
                     bv=torch.zeros((nkv * hd,), dtype=dtype, device=device))
        layers.append(LlamaLayer(w if mesh is None else shard_layer(w, mesh)))
    embed = norm((cfg.vocab_size, h), h)
    head = None if cfg.tie_embeddings else norm((h, cfg.vocab_size), h)
    if head is not None and mesh is not None:
        head = shard_leaf("lm_head", head, mesh)
    return Llama(cfg, embed, layers, ones(h), head, mesh=mesh)


def _to_torch(x) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16, read through its bit pattern) →
    torch tensor on the CPU."""
    a = np.array(x)       # a writable copy: torch tensors may be written
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, cfg: LlamaConfig, device=None) -> Llama:
    """The reference's parameter tree (numpy leaves, layers stacked on a
    leading [L] axis, int8 or int4 projections as {"q", "s"} dicts —
    Mixtral's expert stacks [L, E, in, out] and their scales [L, E, 1,
    out] too) → Llama on `device` (default: the card; raises without CUDA
    unless "cpu" is asked for). int4 payloads (numpy's view of jnp.int4)
    are widened to int8 and packed (ops/kernels.pack_int4)."""
    device = resolve_device(device)

    def leaf(x, i=None):
        if isinstance(x, dict):
            q = np.asarray(x["q"])
            if q.dtype.name == "int4":
                q = pack_int4(torch.from_numpy(np.asarray(
                    q if i is None else q[i], np.int8)))
                return QuantWeight(q.to(device), leaf(x["s"], i))
            return QuantWeight(leaf(x["q"], i), leaf(x["s"], i))
        t = _to_torch(x if i is None else np.asarray(x)[i])
        return t.to(device)

    layers = [LlamaLayer({k: leaf(v, i) for k, v in tree["layers"].items()})
              for i in range(cfg.num_layers)]
    head = tree.get("lm_head")
    return Llama(cfg, leaf(tree["embed"]), layers, leaf(tree["final_norm"]),
                 None if head is None else leaf(head))


# ---------------------------------------------------- tensor parallelism

# the reference's param_specs: column-parallel projections (and their
# biases) split the output axis, row-parallel ones the input axis
_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW = ("wo", "w_down")
_BIAS = ("bq", "bk", "bv")


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a slice in storage of its own (a view would
    keep the whole weight alive)."""
    return t.clone(memory_format=torch.contiguous_format)


def tp_check(cfg: LlamaConfig, mesh) -> None:
    """What a mesh's model axis must divide (the reference's
    max_model_axis dims; the KV heads are the num_kv_heads % tp gate of its
    models/llama._pallas_paged_scatter, here a refusal: the port keeps no
    replicated pool); Mixtral's experts raise (expert parallelism waits
    for its slice)."""
    if cfg.num_experts:
        raise not_ported("expert parallelism (Mixtral's experts on the "
                         "model axis)", "parallel")
    for n, what in ((cfg.num_heads * cfg.head_dim, "q width"),
                    (cfg.num_kv_heads, "num_kv_heads"),
                    (cfg.intermediate_size, "intermediate_size")):
        mesh.local(n, what)
    if not cfg.tie_embeddings:
        mesh.local(cfg.vocab_size, "vocab_size (vocab-parallel lm_head)")


def shard_leaf(name: str, w, mesh):
    """This rank's slice of one layer leaf (or of the untied lm_head,
    name "lm_head"), where the reference's param_specs(cfg, qbits=8) puts
    it: columns of wq/wk/wv/w_gate/w_up and of their int8 q and s, rows of
    wo/w_down's q with s whole, slices of bq/bk/bv, vocab columns of the
    head; norms whole. Packed int4 raises (int4 under TP waits)."""
    if isinstance(w, QuantWeight) and w.q.dtype == torch.uint8:
        raise not_ported("int4 weights under a mesh", "parallel")
    if name in _COLUMN or name == "lm_head":
        if isinstance(w, QuantWeight):
            sl = mesh.span(w.q.shape[-1], name)
            return QuantWeight(_own(w.q[..., sl]), _own(w.s[..., sl]))
        return _own(w[..., mesh.span(w.shape[-1], name)])
    if name in _ROW:
        if isinstance(w, QuantWeight):
            return QuantWeight(_own(w.q[mesh.span(w.q.shape[0], name)]),
                               w.s)
        return _own(w[mesh.span(w.shape[0], name)])
    if name in _BIAS:
        return _own(w[mesh.span(w.shape[0], name)])
    return w


def shard_layer(weights: dict, mesh) -> dict:
    """shard_leaf over one layer's {name: weight}."""
    return {k: shard_leaf(k, w, mesh) for k, w in weights.items()}


def shard_params(params: Llama, cfg: LlamaConfig, mesh) -> Llama:
    """This rank's Llama: every leaf sliced as shard_leaf places it (the
    addressable shard the reference's shard_params(params, param_specs(cfg,
    qbits)) gives this rank), on the device the leaves are on; embed and
    the norms replicated."""
    tp_check(cfg, mesh)
    layers = [LlamaLayer(shard_layer(
        {**dict(lp.named_buffers(recurse=False)),
         **dict(lp.named_children())}, mesh)) for lp in params.layers]
    head = params.lm_head
    return Llama(cfg, params.embed, layers, params.final_norm,
                 None if head is None else shard_leaf("lm_head", head, mesh),
                 mesh=mesh)


def _tp(params: Llama, cfg: LlamaConfig, k_cache):
    """The mesh a forward's collectives run on: the one the params were
    sharded on (None for a whole model). A sharded model over a cache that
    does not hold the rank's num_kv_heads // tp heads raises."""
    mesh = params.mesh
    if mesh is not None and k_cache.shape[2] != kv_heads(cfg, mesh):
        raise ValueError(f"a cache of {k_cache.shape[2]} KV heads on rank "
                         f"{mesh.rank} of {mesh.model}: the rank holds "
                         f"{kv_heads(cfg, mesh)}")
    return mesh


def _reduce(y, mesh):
    """A row-parallel product's partial sums, summed over the model axis
    (the reference's psum after wo and after w_down)."""
    return y if mesh is None else mesh.all_reduce(y)


# ---------------------------------------------------------------- KV cache

def kv_heads(cfg: LlamaConfig, mesh=None) -> int:
    """The KV heads one rank's cache holds: num_kv_heads, or its share on
    the mesh's model axis."""
    if mesh is None:
        return cfg.num_kv_heads
    return mesh.local(cfg.num_kv_heads, "num_kv_heads")


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  cache_type: str = "", device=None, mesh=None):
    """Head-major caches [L, B, KVH, T, D] (KVH the rank's kv_heads on a
    mesh). cache_type "int8"/"q8_0" stores int8 + per-token scales with T
    padded to the 128-token scale tile."""
    kvh = kv_heads(cfg, mesh)
    if is_quant_kind(cache_type):
        shape = (cfg.num_layers, batch, kvh, padded_len(max_len),
                 cfg.head_dim)
        return init_quant(shape, device=device), init_quant(shape,
                                                            device=device)
    dtype = torch_dtype(dtype) if dtype is not None else cfg.tdtype
    shape = (cfg.num_layers, batch, kvh, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _cache_write(kc, vc, k, v, rows, positions, table=None, redirect=None,
                 kvt=None):
    """Write window K/V [B, S, KVH, D] into one layer's head-major caches
    [B', KVH, T, D] at (rows[b], :, positions[b, s]) — in place. Rows may
    repeat (batched admission pads groups by repeating a plan: identical
    values).

    redirect [B] bool (paged only): rows flagged True write to the trash
    block 0 at offset (rows[b] * S + s) % 128, never through their table
    (a slot's table can map its last virtual block to a retained, shared
    prefix block) — the inactive rows of the paged speculative verify.
    The offsets are distinct while B * S <= 128.

    With a paged `table` [B', MAXB] the cache is a block pool [NB, KVH,
    128, D] and (slot, position) resolves to (table[slot, pos // 128], :,
    pos % 128). A position past the table's end (a final prefill chunk's
    padded tail) goes to the trash block 0: the reference's gather clamps
    it to the last column instead, which can land on a real block's valid
    rows. (Decode's inactive slots never come here: decode_step sends
    them to the trash block through the scatter kernel's targets.)

    kvt (paged, the KV tier): raw block indices map through the rows'
    ring (ring_block_map) before the table lookup, so a windowed slot's
    writes reuse its ring columns in place; full-policy slots carry the
    identity sentinel."""
    kvh = kc.shape[1]
    dev = k.device
    rows = rows.long().to(dev)
    positions = positions.long().to(dev)
    if table is None:
        idx = (rows[:, None, None],
               torch.arange(kvh, device=dev)[None, :, None],
               positions[:, None, :])
    else:
        maxb = table.shape[1]
        raw = torch.div(positions, BLOCK, rounding_mode="floor")
        if kvt is not None:
            raw = ring_block_map(raw, kvt["sb"].to(dev).long()[rows][:, None],
                                 kvt["rw"].to(dev).long()[rows][:, None])
        pb = table.long()[rows[:, None], torch.clamp_max(raw, maxb - 1)]
        pb = torch.where(raw < maxb, pb, torch.zeros_like(pb))
        off = torch.remainder(positions, BLOCK)
        if redirect is not None:
            red = redirect.to(dev)[:, None]
            s = positions.shape[1]
            tr_off = torch.remainder(
                rows[:, None] * s + torch.arange(s, device=dev)[None, :],
                BLOCK)
            pb = torch.where(red, torch.zeros_like(pb), pb)
            off = torch.where(red, tr_off, off)
        # off < 128 == SCALE_TILE (ops/paged.py asserts BLOCK ==
        # SCALE_TILE), so an int8 pool's scale lands at [pb, h, 0, off]
        idx = (pb[:, None, :], torch.arange(kvh, device=dev)[None, :, None],
               off[:, None, :])
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if isinstance(kc, QuantKV):
        cache_scatter(kc, idx, kt)
        cache_scatter(vc, idx, vt)
        return
    kc[idx] = kt.to(kc.dtype)
    vc[idx] = vt.to(vc.dtype)


def _tiered_kv(kc, vc, table_rows, ctab=None, ck=None, cv=None):
    """The RESIDENT (ring-mapped) cache view of the KV tier, as the
    reference's _tiered_kv gathers it for chunked prefill: the rows' table
    gather [B, KVH, MAXB*128, D] (QuantKV pools dequantized to bf16, as
    `dequant` does), and with `ctab` [B, MBC] the cold tier's view of this
    layer's int8 pools ck/cv concatenated (dequantized to bf16, then cast
    to the hot view's dtype). Its rows' true positions and validity are the
    layer-independent _tiered_rows. Returns (k, v)."""
    k = dequant(paged_view(kc, table_rows))
    v = dequant(paged_view(vc, table_rows))
    if ctab is not None:
        k = torch.cat([k, dequant(paged_view(ck, ctab)).to(k.dtype)], dim=2)
        v = torch.cat([v, dequant(paged_view(cv, ctab)).to(v.dtype)], dim=2)
    return k, v


def _tiered_rows(maxb, sb, rw, length, ctab=None):
    """True positions and validity [B, T] of _tiered_kv's rows (residency
    and pos < length, ops/paged.tiered_positions; demoted blocks valid in
    the cold part only)."""
    pos, ok, posc, okc = tiered_positions(maxb, sb, rw, length, ctab)
    if ctab is not None:
        pos = torch.cat([pos, posc], dim=1)
        ok = torch.cat([ok, okc], dim=1)
    return pos, ok


def _cold_layer(kvt, i):
    """Layer i's cold pools (k, v) of a kvt with the cold tier, else
    None."""
    if kvt is None or "cold_tab" not in kvt:
        return None
    return kvt["cold_k"][i], kvt["cold_v"][i]


# ---------------------------------------------------------------- forward

def _qkv(x, lp, cfg: LlamaConfig):
    b, s, _ = x.shape
    q = qmatmul(x, lp["wq"])
    k = qmatmul(x, lp["wk"])
    v = qmatmul(x, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    # -1 heads: the rank's share on a mesh (its column slices)
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    return q, k, v


def _lm_head(x32, params: Llama):
    """Vocabulary projection in f32 (tied embeddings or separate, possibly
    quantized, lm_head) through ops/kernels.head_matmul, which reads the
    head as stored. A quantized head (int8, or packed int4) is a bf16×bf16
    product with f32 accumulation, then × s in f32: the activations round
    to bf16, the integer values are exact. On a mesh an untied head is the
    rank's vocab columns: its f32 logits are all-gathered, in rank order,
    so every rank holds the whole row (a tied head is the replicated
    embedding)."""
    head = params.lm_head
    if head is None:
        return head_matmul(x32, params.embed.T)
    if is_quantized(head):
        out = head_matmul(x32, head.q, head.s)
    else:
        out = head_matmul(x32, head)
    mesh = getattr(params, "mesh", None)
    return out if mesh is None else mesh.all_gather(out, dim=-1)


def _mlp(x, lp, cfg: LlamaConfig, mesh=None):
    """SwiGLU (or Mixtral's experts); on a mesh w_down's partial sums are
    summed over the model axis."""
    if cfg.num_experts:
        return _moe_mlp(x, lp, cfg.experts_per_tok)
    return _reduce(qmatmul(F.silu(qmatmul(x, lp["w_gate"]))
                           * qmatmul(x, lp["w_up"]), lp["w_down"]), mesh)


def _attn_out(attn, lp, mesh):
    """The attention output projection, wo's partial sums summed over the
    model axis on a mesh."""
    return _reduce(qmatmul(attn, lp["wo"]), mesh)


def _experts(x, w):
    """Every expert's product: x [M, K], shared by the experts, or [M, E,
    K], expert e's own rows, against the stack w [E, K, N] → [M, E, N] in
    x's dtype. Quantized stacks go through ops/kernels.moe_w8_matmul
    (int8) or moe_w4_matmul (packed int4), which read them as stored (each
    weight element bf16(q·s) as it loads, the reference's
    dequantize-then-einsum rounding); bf16/f32 stacks are one batched
    product over the experts, as the reference's einsums are."""
    if is_quantized(w):
        if w.q.dtype == torch.uint8:
            return moe_w4_matmul(x, w.q, w.s)
        return moe_w8_matmul(x, w.q, w.s)
    if x.dim() == 2:
        x = x.unsqueeze(0).expand(w.shape[0], -1, -1)
    else:
        x = x.transpose(0, 1)
    return torch.bmm(x, w).transpose(0, 1)


def _moe_mlp(x, lp, k: int):
    """Mixtral's top-k routed experts (the reference's _moe_mlp): an f32
    softmax router over the gate (cast to f32 at use), the top k
    renormalized with a 1e-9 floor, and dense dispatch — every expert runs
    on every token and the combine weights zero the rest, one sum over the
    experts in x's dtype. Shapes only, nothing read back to the host, so
    the fused loops' CUDA graphs replay it."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    probs = torch.softmax(x2.float() @ lp["moe_gate"].float(), dim=-1)
    # a stable descending sort: ties take the lower expert first, as
    # jax.lax.top_k does (torch.topk promises no order on ties)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    # the reference's one-hot einsum: each expert's weight, or 0
    combine = torch.zeros_like(probs).scatter_(-1, top_i, top_w)
    h = F.silu(_experts(x2, lp["moe_w1"])) * _experts(x2, lp["moe_w3"])
    y = _experts(h, lp["moe_w2"])                              # [M, E, H]
    out = torch.bmm(combine.to(x.dtype)[:, None, :], y)[:, 0]
    return out.reshape(shape)


def _embed(params: Llama, tokens, dtype):
    return params.embed[tokens.long()].to(dtype)


def _inject(x, inject):
    """The multimodal lane: rows with `is_embed` take `extra` (f32 image
    features, models/llava.py) in place of their token embedding, cast to
    x's dtype, before the first layer — the reference's jnp.where. `inject`
    is (extra [..., H], is_embed [...] bool) over x's leading axes, or
    None."""
    if inject is None:
        return x
    extra, is_embed = inject
    return torch.where(is_embed.to(x.device)[..., None],
                       extra.to(device=x.device, dtype=x.dtype), x)


def prefill(params: Llama, cfg: LlamaConfig, tokens, lengths, cos, sin,
            k_cache, v_cache, slot_map, table=None, inject=None, kvt=None):
    """Padded prompt batch → last-token logits [B, V] f32, writing K/V into
    cache rows slot_map[b] (in place; through the block `table` when the
    cache is paged). tokens: [B, S]; lengths: [B]. Attention runs on the
    fresh K/V, so it is the same kernel either way. `inject` (extra [B, S,
    H] f32, is_embed [B, S] bool): positions with is_embed take `extra`
    rows instead of the token embedding (_inject; image features).

    kvt (the KV tier): the writes map through the ring and the attention
    is mha_prefill_tiered under each slot's sinks/window — with the cold
    tier the window lifts to 1 << 30 (exited content is demoted, not
    dropped), as the reference does."""
    b, s = tokens.shape
    dev = tokens.device
    mesh = _tp(params, cfg, k_cache)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    if kvt is not None:
        sm = slot_map.long().to(dev)
        sinks = kvt["sinks"].to(dev)[sm]
        window = kvt["window"].to(dev)[sm]
        if "cold_tab" in kvt:
            window = torch.full_like(window, 1 << 30)
    x = _inject(_embed(params, tokens, cfg.tdtype), inject)
    for i, lp in enumerate(params.layers):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        if kvt is not None:
            attn = mha_prefill_tiered(q, k, v, lengths, sinks, window)
        else:
            attn = flash_prefill(q, k, v, lengths,
                                 sliding_window=cfg.sliding_window)
        x = x + _attn_out(attn.reshape(b, s, -1), lp, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, mesh)
        _cache_write(k_cache[i], v_cache[i], k, v, slot_map, positions,
                     table, kvt=kvt)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    last_idx = torch.clamp_min(lengths.long().to(dev) - 1, 0)
    last = x[torch.arange(b, device=dev), last_idx]
    return _lm_head(last.float(), params)


def decode_step(params: Llama, cfg: LlamaConfig, tokens, lengths, cos, sin,
                k_cache, v_cache, active=None, table=None, kvt=None):
    """One decode step over ALL slots. tokens: [B] last sampled token per
    slot; lengths: [B] valid cache entries BEFORE this token (it is written
    at index lengths). `active` [B] bool: inactive slots write to the last
    cache row T-1, which is never readable (the engine stops at
    max_context-2). Returns logits [B, V] f32.

    `table` [B, MAXB] int: the cache is the paged block pool. Each layer's
    write is the scatter-append kernel, whose targets (block, row) are
    computed once here — positions, table and active are the same for all
    layers; inactive rows go to the trash block 0 at row b % 128, never
    through their own table (its last virtual block can be a retained,
    shared prefix block). Attention reads through the table.

    kvt (paged, the KV tier): the targets map through each slot's ring, and
    attention is the tiered paged kernel (the ring map, the retention mask
    and, with kvt["cold_tab"], the cold pools "cold_k"/"cold_v" of each
    layer, read-only), which takes the place of the sliding window."""
    b = tokens.shape[0]
    dev = tokens.device
    mesh = _tp(params, cfg, k_cache)
    kv_quant = isinstance(k_cache, QuantKV)
    positions = lengths.long()[:, None]
    if table is None:
        T = k_cache.shape[3]
        wpos = positions if active is None else torch.where(
            active[:, None], positions, torch.full_like(positions, T - 1))
        rows = torch.arange(b, device=dev)
    else:
        targets = paged_targets(
            lengths, table, active,
            sb=None if kvt is None else kvt["sb"],
            rw=None if kvt is None else kvt["rw"])
    attn_len = lengths + 1
    x = _embed(params, tokens, cfg.tdtype)[:, None, :]
    for i, lp in enumerate(params.layers):
        kc, vc = k_cache[i], v_cache[i]     # this layer's views
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        if table is None:
            _cache_write(kc, vc, k, v, rows, wpos)
        elif kv_quant:
            paged_scatter_append_q8(kc.q, kc.s, vc.q, vc.s, k[:, 0], v[:, 0],
                                    lengths, table, active, targets=targets,
                                    mesh=mesh)
        else:
            paged_scatter_append(kc, vc, k[:, 0], v[:, 0], lengths, table,
                                 active, targets=targets, mesh=mesh)
        if kv_quant:
            attn = ragged_decode_q8(q, kc.q, kc.s, vc.q, vc.s, attn_len,
                                    sliding_window=cfg.sliding_window,
                                    table=table, kvt=kvt)
        else:
            attn = ragged_decode(q, kc, vc, attn_len,
                                 sliding_window=cfg.sliding_window,
                                 table=table, kvt=kvt,
                                 cold_kv=_cold_layer(kvt, i))
        x = x + _attn_out(attn.reshape(b, 1, -1), lp, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, mesh)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    return _lm_head(x[:, 0].float(), params)


def extend(params: Llama, cfg: LlamaConfig, tokens, start, cos, sin,
           k_cache, v_cache, slot_map=None, with_logits=True, last_pos=None,
           table=None, inject=None, redirect=None, kvt=None):
    """Forward a window of S tokens per row starting at cache offset
    `start` [B] — the chunked-prefill workhorse. Writes the window's K/V
    (in place) and returns logits for every window position [B, S, V], or
    [B, V] at `last_pos` [B], or None with with_logits=False.

    A final chunk's padded tail can run past the cache end: those rows are
    garbage by contract (they sit above every real query and are masked),
    so their rope lookups clamp to the last table row and their cache
    writes go to a row that is never readable — the last cache row (dense)
    or the trash block (paged `table`, see _cache_write). A paged cache is
    read through ops/paged.paged_view of the rows' table rows. `redirect`
    [B] bool (paged): flagged rows write their whole window to the trash
    block (the speculative verify's inactive rows, _cache_write).
    `inject` (extra [B, S, H] f32, is_embed [B, S] bool): a multimodal
    chunk's image-feature rows replace their token embeddings (_inject).

    kvt (paged, the KV tier): the window writes through the ring and
    attends the resident view at true positions (_tiered_kv,
    mha_extend_tiered): under the retention mask, or — with the cold tier,
    drop_window False — every valid row, hot or cold. A padded final
    chunk's tail lands in ring margin columns at positions above every real
    query, so the kv_pos <= q_pos mask hides it."""
    b, s = tokens.shape
    dev = tokens.device
    mesh = _tp(params, cfg, k_cache)
    rows = (torch.arange(b, device=dev) if slot_map is None
            else slot_map.long().to(dev))
    positions = start.long().to(dev)[:, None] + torch.arange(
        s, device=dev)[None, :]
    rpos = torch.clamp_max(positions, cos.shape[0] - 1)
    if table is None:
        wpos = torch.clamp_max(positions, k_cache.shape[3] - 1)
    else:
        wpos = positions
        row_table = table.long().to(dev)[rows]
    if kvt is not None:
        # the rows' geometry (and cold table), and the view's length: the
        # window's end
        geo = {k: kvt[k].to(dev)[rows] for k in
               ("sb", "rw", "sinks", "window", "cold_tab") if k in kvt}
        kv_pos, kv_ok = _tiered_rows(row_table.shape[1], geo["sb"],
                                     geo["rw"], start.long().to(dev) + s,
                                     geo.get("cold_tab"))
    x = _inject(_embed(params, tokens, cfg.tdtype), inject)
    for i, lp in enumerate(params.layers):
        kc, vc = k_cache[i], v_cache[i]
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = apply_rope(q, cos, sin, rpos)
        k = apply_rope(k, cos, sin, rpos)
        _cache_write(kc, vc, k, v, rows, wpos, table, redirect, kvt=kvt)
        if kvt is not None:
            cold = _cold_layer(kvt, i)
            ck, cv = cold if cold is not None else (None, None)
            kr, vr = _tiered_kv(kc, vc, row_table, ctab=geo.get("cold_tab"),
                                ck=ck, cv=cv)
            attn = mha_extend_tiered(q, kr, vr, positions, kv_pos, kv_ok,
                                     geo["sinks"], geo["window"],
                                     drop_window=cold is None)
        else:
            if table is not None:
                kr, vr = paged_view(kc, row_table), paged_view(vc, row_table)
            else:
                kr = kc if slot_map is None else kc[rows]
                vr = vc if slot_map is None else vc[rows]
            attn = mha_extend(q, dequant(kr), dequant(vr), positions,
                              sliding_window=cfg.sliding_window)
        x = x + _attn_out(attn.reshape(b, s, -1), lp, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, mesh)
    if not with_logits:
        return None
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    if last_pos is not None:
        x = x[torch.arange(b, device=dev), last_pos.long().to(dev)]
    return _lm_head(x.float(), params)


def ragged_row_targets(block_seq, qstart, qlen, kvlen, tables, max_pos,
                       kvt=None):
    """Per-row (position, scatter block, in-block row) [T] of a flat stream,
    derived from the per-sequence metadata (the reference's in-forward
    derivation). A live row's position is clipped to the rope table
    (max_pos rows); a padding row takes position 0 and writes to the trash
    block 0 at row `row % 128` (collisions there only overwrite other
    padding rows, and nothing reads block 0). kvt (the KV tier, [NSEQ]
    geometry like tables): raw blocks map through each sequence's ring
    before the table lookup."""
    dev = tables.device
    t = block_seq.shape[0] * QBLK
    rows = torch.arange(t, device=dev)
    sid = block_seq.long()[rows // QBLK]
    s = sid.clamp_min(0)
    qs, ql = qstart.long()[s], qlen.long()[s]
    live = (sid >= 0) & (rows >= qs) & (rows < qs + ql)
    pos = kvlen.long()[s] - ql + (rows - qs)
    pos = torch.where(live, pos.clamp(0, max_pos - 1), 0)
    raw = torch.div(pos, BLOCK, rounding_mode="floor")
    if kvt is not None:
        raw = ring_block_map(raw, kvt["sb"].to(dev).long()[s],
                             kvt["rw"].to(dev).long()[s])
    raw = raw.clamp_max(tables.shape[1] - 1)
    pb = torch.where(live, tables.long()[s, raw], 0)
    off = torch.where(live, pos % BLOCK, rows % BLOCK)
    return pos, pb.to(torch.int32), off.to(torch.int32)


def ragged_forward(params: Llama, cfg: LlamaConfig, tokens, cos, sin,
                   k_cache, v_cache, block_seq, qstart, qlen, kvlen, tables,
                   logit_rows, kvt=None, inject=None):
    """Mixed prefill+decode forward over ONE flat token stream (ragged
    continuous batching): decode rows and chunked-prefill windows of
    different requests in a single [T] stream, one dispatch on the paged
    pool, no bucket padding.

    tokens: [T] int, T a multiple of QBLK (8); every sequence's rows start
    on a QBLK boundary. Per-sequence metadata ([NSEQ], dead entries padded):
    qstart/qlen (row span), kvlen (cache length INCLUDING this chunk),
    tables [NSEQ, MAXB]; block_seq [T/QBLK] (-1 = padding block);
    logit_rows [NSEQ] — the flat row of each sequence's last token (mid
    prefill chunks may point anywhere; their logits are ignored) — or
    [NSEQ, R], R rows a sequence (the speculative verify windows).

    Per-row positions and scatter targets are derived once here
    (ragged_row_targets) and every layer reuses them. Each layer writes
    first (this tick's K/V land in the pool through the flat-row scatter)
    and then attends through the table (write-then-attend: kvlen already
    counts the new rows). k_cache/v_cache: paged pools [L, NB, KVH, 128, D]
    (QuantKV for int8 KV), updated IN PLACE. Returns logits [NSEQ, V] f32
    ([NSEQ, R, V] for 2-D logit_rows).

    `kvt` (the KV tier, per-sequence [NSEQ] geometry: sequence = engine
    slot): the row targets map through each sequence's ring and attention
    is the tiered ragged kernel. `inject` (extra [T, H] f32, is_embed [T]
    bool): rows with is_embed take `extra` directly instead of the token-id
    embedding lookup (_inject; a multimodal prompt's chunk in the flat
    stream)."""
    t = tokens.shape[0]
    dev = tokens.device
    if params.mesh is not None and kvt is not None:
        raise not_ported("the KV retention tier under a mesh", "parallel")
    mesh = _tp(params, cfg, k_cache)
    kv_quant = isinstance(k_cache, QuantKV)
    block_seq, qstart, qlen, kvlen, tables = (
        m.to(device=dev, dtype=torch.int32).contiguous()
        for m in (block_seq, qstart, qlen, kvlen, tables))
    pos, pb, off = ragged_row_targets(block_seq, qstart, qlen, kvlen, tables,
                                      cos.shape[0], kvt)
    meta = (block_seq, qstart, qlen, kvlen, tables)
    sw = cfg.sliding_window
    x = _inject(_embed(params, tokens, cfg.tdtype), inject)[None]  # [1,T,H]
    for i, lp in enumerate(params.layers):
        kc, vc = k_cache[i], v_cache[i]
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = apply_rope(q, cos, sin, pos[None])
        k = apply_rope(k, cos, sin, pos[None])
        if kv_quant:
            ragged_scatter_append_q8(kc.q, kc.s, vc.q, vc.s, k[0], v[0], pb,
                                     off, mesh=mesh)
            attn = ragged_paged_attention_q8(q[0], kc.q, kc.s, vc.q, vc.s,
                                             *meta, sliding_window=sw,
                                             kvt=kvt, mesh=mesh)
        else:
            ragged_scatter_append(kc, vc, k[0], v[0], pb, off, mesh=mesh)
            attn = ragged_paged_attention(q[0], kc, vc, *meta,
                                          sliding_window=sw, kvt=kvt,
                                          mesh=mesh)
        x = x + _attn_out(attn.reshape(1, t, -1), lp, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, mesh)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    last = x[0][logit_rows.long().to(dev)]
    return _lm_head(last.float(), params)


# ------------------------------------------------- cacheless forwards

def _no_mesh(params: Llama, what: str) -> None:
    if params.mesh is not None:
        raise not_ported(f"{what} under a mesh", "parallel")


def hidden_states(params: Llama, cfg: LlamaConfig, tokens, lengths=None):
    """Full-sequence causal forward → final-norm hidden states [B, S, H] in
    the model dtype, writing no KV cache. tokens: [B, S]; `lengths` [B]
    masks padded positions out of attention (default: all S). Attention is
    flash_prefill (row 1) under the model's sliding window, the
    projections qmatmul (rows 13 / 13i4 on a quantized recipe)."""
    _no_mesh(params, "the cacheless forwards (embeddings, rerank)")
    b, s = tokens.shape
    dev = tokens.device
    cos, sin = rope_table(cfg.rope, s, device=dev)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    x = _embed(params, tokens, cfg.tdtype)
    for lp in params.layers:
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        attn = flash_prefill(q, k, v, lengths,
                             sliding_window=cfg.sliding_window)
        x = x + qmatmul(attn.reshape(b, s, -1), lp["wo"])
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg)
    return rms_norm(x, params.final_norm, cfg.rms_eps)


def forward_train(params: Llama, cfg: LlamaConfig, tokens):
    """Full-sequence causal forward → logits [B, S, V] f32 (the rerank
    scorer's and evaluation's path; _lm_head, row 14 / 14i4)."""
    x = hidden_states(params, cfg, tokens)
    return _lm_head(x.float(), params)


def encode_pooled(params: Llama, cfg: LlamaConfig, tokens, lengths,
                  normalize: bool = True):
    """Masked-mean-pooled embeddings [B, H] f32 over the first lengths[b]
    positions, L2-normalized (floor 1e-9) unless `normalize` is False —
    the embeddings role (the reference's mean pooling)."""
    s = tokens.shape[1]
    x = hidden_states(params, cfg, tokens, lengths).float()
    mask = (torch.arange(s, device=x.device)[None, :]
            < lengths.to(x.device)[:, None]).float()
    pooled = (x * mask[..., None]).sum(1) / torch.clamp_min(
        mask.sum(1)[:, None], 1.0)
    if normalize:
        pooled = pooled / torch.clamp_min(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-9)
    return pooled


def shift_rotation(cfg: LlamaConfig, distance: int, device=None):
    """(cos, sin) [head_dim // 2] f32 of the angle distance·inv_freq (the
    rope's scaling included, ops/rope.rope_freqs): the context shift
    rotates moved K rows back by `distance` positions with them. Made once
    per engine, on its device (a shift then copies nothing from the
    host)."""
    inv_freq, _ = rope_freqs(cfg.rope)
    ang = inv_freq * distance
    return torch.cos(ang).to(device), torch.sin(ang).to(device)


def _rotate_back(x, rot):
    """Rotate f32 rows x [..., D] by -angle, rot = (cos, sin) of angle:
    x1' = x1·cos + x2·sin, x2' = x2·cos - x1·sin."""
    c, s = rot
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c + x2 * s, x2 * c - x1 * s], dim=-1)


def cache_shift(cfg: LlamaConfig, k_cache, v_cache, lengths, slot: int, *,
                keep: int, discard: int, rot=None):
    """llama.cpp-style context shift of ONE slot of a dense cache [L, B,
    KVH, T, D], IN PLACE: keep the first `keep` sink rows, drop the next
    `discard`, slide the rest left and lengths[slot] -= discard.

    Cached K is stored post-RoPE, so the moved rows rotate by -discard
    positions (a pure rotation by -discard·inv_freq; the yarn / llama3
    attention scale is a uniform factor and commutes with it); V moves
    unrotated. The rows moved are those below the DEVICE length (`lengths`
    as it stands when the shift runs, an in-flight step's write included),
    so nothing waits for the host. An int8 cache dequantizes the slot to
    f32, shifts it and requantizes the whole slot (fresh scales), as the
    reference does. `rot`: shift_rotation(cfg, discard) made beforehand on
    the cache's device (computed here when None). Returns (k_cache,
    v_cache, lengths), the same objects."""
    quant = isinstance(k_cache, QuantKV)
    dev = (k_cache.q if quant else k_cache).device
    rot = rot if rot is not None else shift_rotation(cfg, discard, dev)
    T = k_cache.shape[3]
    ks = dequant(k_cache[:, slot], torch.float32) if quant else k_cache[:, slot]
    vs = dequant(v_cache[:, slot], torch.float32) if quant else v_cache[:, slot]
    ks_rot = _rotate_back(torch.roll(ks, -discard, dims=2).float(),
                          rot).to(ks.dtype)
    vs_m = torch.roll(vs, -discard, dims=2)
    idx = torch.arange(T, device=dev)[None, None, :, None]
    move = (idx >= keep) & (idx < lengths[slot] - discard)
    k_new = torch.where(move, ks_rot, ks)
    v_new = torch.where(move, vs_m, vs)
    if quant:
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            rq = requantize(cache[:, slot], new)
            cache.q[:, slot] = rq.q
            cache.s[:, slot] = rq.s
    else:
        k_cache[:, slot] = k_new
        v_cache[:, slot] = v_new
    lengths[slot] -= discard
    return k_cache, v_cache, lengths


def cache_shift_paged(cfg: LlamaConfig, k_pool, row_table, *,
                      keep_blocks: int, discard_blocks: int, rot=None):
    """Block-granular context shift of ONE paged slot: its K tail blocks
    re-rotate by -discard_blocks·128 positions IN PLACE in the pool
    [L, NB, KVH, 128, D] (int8 pools through the f32 round trip of
    requantize). The slide itself is the caller's permutation of the
    slot's table row (sink blocks stay, the discarded ones re-append as
    tail capacity); V blocks never move or change.

    row_table [MAXB] (on the pool's device) is the PRE-permutation row:
    its entries from virtual block keep_blocks + discard_blocks on are
    rotated, unallocated ones (0) landing in the trash block. `rot`:
    shift_rotation(cfg, discard_blocks * 128), made when None. Returns
    k_pool."""
    quant = isinstance(k_pool, QuantKV)
    dev = (k_pool.q if quant else k_pool).device
    rot = rot if rot is not None else shift_rotation(
        cfg, discard_blocks * BLOCK, dev)
    tail = row_table[keep_blocks + discard_blocks:].long()
    kb = k_pool[:, tail]                          # [L, TAIL, KVH, BS, D]
    kf = dequant(kb, torch.float32) if quant else kb.float()
    rotated = _rotate_back(kf, rot)
    if quant:
        rq = requantize(kb, rotated)
        k_pool.q[:, tail] = rq.q
        k_pool.s[:, tail] = rq.s
    else:
        k_pool[:, tail] = rotated.to(k_pool.dtype)
    return k_pool


# the fused loops read their device-side `done` flags (a host sync) once per
# this many steps; frozen slots make the steps in between inert. It is also
# the length of a loop segment, the unit that the engine's CUDA graphs
# capture (engine/graphs.py)
_DONE_CHECK_EVERY = 8


@dataclasses.dataclass
class LoopState:
    """The fused loops' carried state in fixed tensors, which loop_segment
    updates IN PLACE: the sampler (a SamplerState), last_logits [B, V] f32,
    lengths [B] int32, the stop state done [B] bool and n_out [B] int32, the
    dispatch's inputs remaining [B] int32, check_eos [B] bool, eos_ids [E]
    and the paged block table [B, MAXB] (None for a dense cache), one
    segment's token and logprob rows toks/lps [_DONE_CHECK_EVERY, B], and
    the grammar lane: each slot's automaton state gstate [B] int32 and the
    shared device grammar tables gmasks [S, ceil(V/32)] (u32 words held as
    int32 bit patterns, LSB-first allowed-token rows) and gtrans [S, V]
    int32 (next state per token), None without tables. Row 0 of the tables
    is the identity state (all tokens allowed, a self-loop) that every
    unconstrained slot sits in. kvt: the KV tier's geometry (and cold
    tier) in fixed tensors, None untiered. A segment reads and writes no
    other tensor across iterations, so a CUDA graph captured over one
    segment replays the next of any dispatch that fills the same
    tensors."""
    sampler: Any
    last_logits: torch.Tensor
    lengths: torch.Tensor
    done: torch.Tensor
    n_out: torch.Tensor
    remaining: torch.Tensor
    check_eos: torch.Tensor
    eos_ids: torch.Tensor
    table: torch.Tensor | None
    toks: torch.Tensor
    lps: torch.Tensor
    gstate: torch.Tensor
    gmasks: torch.Tensor | None = None
    gtrans: torch.Tensor | None = None
    kvt: dict | None = None

    @classmethod
    def start(cls, sampler, last_logits, lengths, active, remaining,
              check_eos, eos_ids, table=None, gstate=None, gmasks=None,
              gtrans=None, kvt=None) -> "LoopState":
        """A state in new tensors for last_logits, lengths, the sampler
        key, the stop state and gstate (zeros when None: the identity
        row): the caller's stay as they are (the other sampler fields are
        shared; the step updates token_counts in place, as it always
        has)."""
        B, dev = lengths.shape[0], lengths.device
        return cls(
            sampler=dataclasses.replace(sampler, key=sampler.key.clone()),
            last_logits=last_logits.clone(), lengths=lengths.clone(),
            done=~active,
            n_out=torch.zeros((B,), dtype=torch.int32, device=dev),
            remaining=remaining, check_eos=check_eos, eos_ids=eos_ids,
            table=table,
            toks=torch.zeros((_DONE_CHECK_EVERY, B), dtype=torch.int32,
                             device=dev),
            lps=torch.zeros((_DONE_CHECK_EVERY, B), dtype=torch.float32,
                            device=dev),
            gstate=(torch.zeros((B,), dtype=torch.int32, device=dev)
                    if gstate is None else gstate.to(torch.int32).clone()),
            gmasks=gmasks, gtrans=gtrans, kvt=kvt)

    def adopt(self, sampler, last_logits, lengths):
        """Copy into this state's tensors each of `sampler`'s fields,
        `last_logits` and `lengths` that is another tensor than its own (an
        eager step returns new ones)."""
        for f in dataclasses.fields(sampler):
            _copy_into(getattr(self.sampler, f.name), getattr(sampler, f.name))
        _copy_into(self.last_logits, last_logits)
        _copy_into(self.lengths, lengths)

    def addresses(self) -> tuple:
        """The device addresses of every tensor of the state (a CUDA graph
        captured over it reads these)."""
        ts = [getattr(self.sampler, f.name)
              for f in dataclasses.fields(self.sampler)]
        ts += [getattr(self, f.name) for f in dataclasses.fields(self)
               if f.name not in ("sampler", "kvt")]
        for v in (self.kvt or {}).values():
            ts += [v.q, v.s] if isinstance(v, QuantKV) else [v]
        return tuple(t.data_ptr() for t in ts if t is not None)

    def grammar_mask(self):
        """Each slot's allowed-token row of the device grammar table,
        gathered at its automaton state: [B, ceil(V/32)]."""
        return self.gmasks.index_select(0, self.gstate)

    def advance_grammar(self, tokens, live):
        """Step each live slot's automaton on its sampled token (a frozen
        slot's state holds): gstate = gtrans[gstate, token]."""
        nxt = self.gtrans[self.gstate.long(), tokens.long()]
        self.gstate.copy_(torch.where(live, nxt, self.gstate))

    @contextlib.contextmanager
    def frozen(self):
        """Every slot frozen while the body runs: a segment then changes
        nothing but the scratch rows toks/lps (a frozen slot's cache writes
        go to the trash row or block; its counts, key, logits, length and
        grammar state hold)."""
        done = self.done.clone()
        self.done.fill_(True)
        try:
            yield
        finally:
            self.done.copy_(done)


def _copy_into(dst, src):
    if src is not dst:
        dst.copy_(src)


def _stops(st: LoopState, tokens, live, limit: int):
    """The slots that finish at this iteration: live ones that sampled an
    EOS id (slots with check_eos), reached their `remaining` budget or the
    context margin `limit`."""
    is_eos = st.check_eos & (tokens[:, None] == st.eos_ids[None, :]).any(1)
    return live & (is_eos | (st.n_out >= st.remaining)
                   | (st.lengths >= limit))


def loop_segment(step_fn, st: LoopState, n: int, limit: int, params, cos,
                 sin, kc, vc, fast_width=None, grammar: bool = False):
    """`n` (at most _DONE_CHECK_EVERY) iterations of the fused loops'
    decode body over `st`, IN PLACE: sample→decode for the live slots
    (step_fn with the active mask ~done), freeze the finished ones (their
    key and last_logits hold; step_fn already holds their lengths and
    counts and sends their cache writes to the trash row or block),
    iteration i's tokens and logprobs into st.toks[i] / st.lps[i], then
    n_out and the stop state. Nothing in it waits for the device, so a CUDA
    graph captures it whole.

    The grammar variant (`grammar`, the reference's gstate lane; full-width
    sampling, fast_width None): each iteration gathers every slot's mask
    row at its automaton state, samples under it, and advances the live
    slots' states through gtrans on the sampled tokens.

    step_fn(params, cos, sin, kc, vc, sampler, last_logits, lengths,
    active, fast_width, table=table[, mask_bits=mask]) → (tokens,
    logprobs, sampler, logits, lengths)."""
    for i in range(n):
        live = ~st.done
        kw = {"mask_bits": st.grammar_mask()} if grammar else {}
        if st.kvt is not None:
            kw["kvt"] = st.kvt
        tokens, lp, sampler, logits, lengths = step_fn(
            params, cos, sin, kc, vc, st.sampler, st.last_logits, st.lengths,
            live, fast_width, table=st.table, **kw)
        st.sampler.key.copy_(torch.where(live[:, None], sampler.key,
                                         st.sampler.key))
        st.last_logits.copy_(torch.where(live[:, None], logits,
                                         st.last_logits))
        st.lengths.copy_(lengths)
        st.toks[i] = tokens
        st.lps[i] = lp
        st.n_out.add_(live.to(torch.int32))
        if grammar:
            st.advance_grammar(tokens, live)
        st.done |= _stops(st, tokens, live, limit)


def loop_outputs(max_steps: int, st: LoopState):
    """A dispatch's own token and logprob rings [max_steps, B] (zeros past
    the steps it runs)."""
    B, dev = st.lengths.shape[0], st.lengths.device
    return (torch.zeros((max_steps, B), dtype=torch.int32, device=dev),
            torch.zeros((max_steps, B), dtype=torch.float32, device=dev))


def drive_loop(st: LoopState, run, toks, lps, steps: int, max_steps: int,
               stop) -> int:
    """The host side of a fused loop, from iteration `steps` up to
    `max_steps`: at every multiple of _DONE_CHECK_EVERY it asks
    `stop(steps)` (one host sync) whether to end, else runs the iterations up to the next
    multiple (or to max_steps) as one segment — `run(n)` runs loop_segment's
    n iterations, directly or as the replay of a CUDA graph — and copies the
    segment's rows into the dispatch's own toks/lps. Returns the
    iterations run."""
    while steps < max_steps:
        if steps % _DONE_CHECK_EVERY == 0 and stop(steps):
            break
        n = min(_DONE_CHECK_EVERY - steps % _DONE_CHECK_EVERY,
                max_steps - steps)
        run(n)
        toks[steps:steps + n] = st.toks[:n]
        lps[steps:steps + n] = st.lps[:n]
        steps += n
    return steps


def segment_lengths(start: int, max_steps: int) -> list[int]:
    """The segment lengths drive_loop runs from iteration `start` to
    `max_steps` when no stop ends it early, in order of first use."""
    out = []
    while start < max_steps:
        n = min(_DONE_CHECK_EVERY - start % _DONE_CHECK_EVERY,
                max_steps - start)
        if n not in out:
            out.append(n)
        start += n
    return out


def _segment_runner(run, step_fn, st, limit, params, cos, sin, kc, vc,
                    fast_width, grammar):
    """drive_loop's run(n): the builders' `run` hook, or loop_segment
    called directly."""
    if run is not None:
        return lambda n: run(st, n, fast_width, grammar)
    return lambda n: loop_segment(step_fn, st, n, limit, params, cos, sin,
                                  kc, vc, fast_width, grammar)


def build_decode_loop(step_fn, *, max_steps: int, limit: int,
                      start=LoopState.start, run=None):
    """The fused decode loop: up to `max_steps` sample→decode iterations per
    dispatch with per-slot stop conditions kept on the device (EOS-set
    membership for slots with `check_eos`, the per-slot token budget
    `remaining`, the context margin `limit`).

    PyTorch has no on-device while loop, so the host drives the loop
    (drive_loop) in segments of _DONE_CHECK_EVERY iterations (loop_segment)
    with the stop state on the device. A finished slot is frozen — its key
    and last_logits stop advancing, its length stops and its cache writes
    go to the trash row through step_fn's active mask — so extra iterations
    are inert, and the host checks `done.all()` (one sync) only between
    segments — not before the first: a dispatch starts with a live slot
    (with none, its first segment runs inert). `steps` counts the
    iterations actually run.

    Grammar-constrained slots ride the same loop through the device
    automaton tables (`gstate` [B] int32 each slot's state, `gmasks`,
    `gtrans`: LoopState's grammar lane): each iteration gathers the slot's
    mask row, samples under it and advances the state on the sampled token
    (loop_segment's grammar variant). Unconstrained slots sit in the
    identity row 0, so their streams equal the maskless variant's.

    The engine's hooks: `start(sampler, last_logits, lengths, active,
    remaining, check_eos, eos_ids, table, gstate, gmasks, gtrans)` returns
    the dispatch's LoopState (default LoopState.start, in new tensors; the
    engine fills its fixed ones); `run(st, n, fast_width, grammar)` runs
    loop_segment's n iterations over it (default: directly; the engine
    replays the segment's CUDA graph, engine/graphs.py).

    step_fn(params, cos, sin, kc, vc, sampler, last_logits, lengths, active,
    fast_width, table=table[, kvt=kvt]) → (tokens, logprobs, sampler,
    logits, lengths); `table` is the paged block table (None for a dense
    cache) and `kvt` the KV tier's geometry (LoopState.kvt), the same for
    every step of the dispatch.
    Returns (tokens [max_steps, B], logprobs [max_steps, B], n_out [B],
    steps, sampler, last_logits, lengths); slot b's valid tokens are rows
    0..n_out[b]-1."""

    def decode_loop(params, cos, sin, kc, vc, sampler, last_logits, lengths,
                    active, remaining, check_eos, eos_ids, fast_width=None,
                    table=None, gstate=None, gmasks=None, gtrans=None,
                    kvt=None):
        st = start(sampler, last_logits, lengths, active, remaining,
                   check_eos, eos_ids, table, gstate, gmasks, gtrans,
                   kvt=kvt)
        toks, lps = loop_outputs(max_steps, st)
        steps = drive_loop(
            st, _segment_runner(run, step_fn, st, limit, params, cos, sin,
                                kc, vc, fast_width, gstate is not None),
            toks, lps, 0, max_steps, lambda s: s > 0 and bool(st.done.all()))
        return (toks, lps, st.n_out, steps, st.sampler, st.last_logits,
                st.lengths)

    return decode_loop


# fused ragged-loop exit codes (the reference's RLOOP_EXIT_*)
RLOOP_EXIT_STEPS_CAP = 0   # ran the full max_steps budget
RLOOP_EXIT_FINISH = 1      # a decode slot finished (EOS/max_tokens/context)
RLOOP_EXIT_PREFILL = 2     # the host had prefill/admission work pending


def ragged_pack_step(ragged_step, st: LoopState, limit: int, params, cos,
                     sin, kc, vc, pack, is_decode, grammar: bool = False):
    """Iteration 0 of a fused ragged dispatch over `st`: the mixed tick's
    single-step body (every packed decode row samples and advances), its
    results adopted into st's tensors, then n_out and the stop state. The
    grammar variant samples under each slot's mask row at its state
    (`mask0`) and advances the decode rows' states. Returns the
    iteration's (tokens, logprobs)."""
    kw = {"mask_bits": st.grammar_mask()} if grammar else {}
    if st.kvt is not None:
        kw["kvt"] = st.kvt
    tokens, lp, sampler, last_logits, lengths = ragged_step(
        params, cos, sin, kc, vc, st.sampler, st.last_logits, st.lengths,
        pack, is_decode, st.table, **kw)
    st.adopt(sampler, last_logits, lengths)
    st.n_out.add_(is_decode.to(torch.int32))
    if grammar:
        st.advance_grammar(tokens, is_decode)
    st.done |= _stops(st, tokens, is_decode, limit)
    return tokens, lp


def ragged_stop(st: LoopState, is_decode) -> bool:
    """The fused ragged loop's host check: every slot frozen, or a decode
    slot finished (its first-finish exit)."""
    return bool(st.done.all() | (is_decode & st.done).any())


def ragged_exit_code(st: LoopState, is_decode, prefill_pending: bool):
    """The dispatch's exit code ([] int32 tensor): RLOOP_EXIT_FINISH if a
    decode slot finished, else RLOOP_EXIT_PREFILL if prefill was pending
    (after a pack) with a slot left, else RLOOP_EXIT_STEPS_CAP."""
    finish = (is_decode & st.done).any()
    code = finish.to(torch.int32) * RLOOP_EXIT_FINISH
    if prefill_pending:
        code = code + (~finish & (~st.done).any()).to(
            torch.int32) * RLOOP_EXIT_PREFILL
    return code


def build_ragged_loop(ragged_step, decode_step, *, max_steps: int,
                      limit: int, start=LoopState.start, run=None):
    """The fused ragged tick: the mixed ragged dispatch plus up to
    `max_steps - 1` decode iterations for every live decode slot in one
    dispatch. Iteration 0 runs `ragged_step` (the engine's single-step mixed
    body: sample, splice into the flat stream, one ragged_forward, the
    set_len/logit_set commits; ragged_pack_step); iterations >= 1 run
    `decode_step`, the paged decode body of the fused decode loop, over the
    decode-live slots (loop_segment). Slots mid-prefill (or whose final
    chunk just packed) sit the continuation out frozen. With has_pack=False
    iteration 0 is skipped: the pure-decode loop of a ragged engine.

    Stops, as the reference's: a decode slot finishing (EOS set for
    `check_eos` slots, its `remaining` budget, the `limit` context margin),
    `prefill_pending` (the host has prefill or admission work: the dispatch
    ends after iteration 0), or max_steps. A finished slot is frozen — its
    key, last_logits and length stop — so extra iterations are inert for
    it. PyTorch has no device while loop: the host drives the decode
    iterations in segments (drive_loop), the stop state on the device, and
    reads it (one sync, ragged_stop) at every multiple of
    _DONE_CHECK_EVERY, as build_decode_loop does; `prefill_pending` is a
    host bool and costs no sync. So after a first finish a dispatch may run
    up to _DONE_CHECK_EVERY - 1 more steps than the reference's; only live
    slots advance in them, within their `remaining` budgets, so token
    streams are unchanged. As in build_decode_loop, a dispatch starts with
    a live slot, and the hooks `start` (given `is_decode` as its `active`)
    and `run` are the engine's. With `gstate` (and the tables) every
    iteration runs the grammar variant: the pack samples under each slot's
    row at its state and advances the decode rows only, the decode
    iterations as build_decode_loop's.

    Returns (toks [max_steps, B], lps [max_steps, B], n_out [B], steps,
    exit_code [] int32 tensor, sampler, last_logits, lengths); the exit
    code is RLOOP_EXIT_FINISH if a decode slot finished, else
    RLOOP_EXIT_PREFILL if prefill was pending with a slot left, else
    RLOOP_EXIT_STEPS_CAP."""

    def ragged_loop(params, cos, sin, kc, vc, sampler, last_logits, lengths,
                    is_decode, remaining, check_eos, eos_ids,
                    prefill_pending: bool, pack=None, table=None,
                    fast_width=None, gstate=None, gmasks=None, gtrans=None,
                    kvt=None, *, has_pack: bool):
        grammar = gstate is not None
        st = start(sampler, last_logits, lengths, is_decode, remaining,
                   check_eos, eos_ids, table, gstate, gmasks, gtrans,
                   kvt=kvt)
        live = ~st.done       # is_decode on the device
        toks, lps = loop_outputs(max_steps, st)
        steps = 0
        if has_pack:
            toks[0], lps[0] = ragged_pack_step(ragged_step, st, limit,
                                               params, cos, sin, kc, vc,
                                               pack, live, grammar)
            steps = 1
        pending = has_pack and prefill_pending
        if not pending:
            steps = drive_loop(
                st, _segment_runner(run, decode_step, st, limit, params, cos,
                                    sin, kc, vc, fast_width, grammar),
                toks, lps, steps, max_steps,
                lambda s: s > 0 and ragged_stop(st, live))
        return (toks, lps, st.n_out, steps,
                ragged_exit_code(st, live, pending), st.sampler,
                st.last_logits, st.lengths)

    return ragged_loop
