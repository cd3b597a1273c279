"""Paged-KV decode write — scatter-append of one K/V row per slot into the
block pool, with its plain PyTorch version (counterpart of
localai_tpu/ops/pallas/paged_scatter.py).

Two wrappers, each beside its plain version with the same signature:
- paged_scatter_append / _plain — bf16/f32 pools [NB, KVH, BS, D];
- paged_scatter_append_q8 / _plain — int8 pools + per-token f32 scales
  [NB, KVH, 1, BS]; the kernel (csrc/paged_scatter.cu) reads the new bf16
  or f32 rows, quantizes each (slot, head) row as
  ops/kvcache.quantize_tokens does, bit for bit, and writes the int8 row
  and its scale element, all in one launch; the plain version runs
  quantize_tokens and then the index writes.

Slot b's row goes to block table[b, pos // 128], row pos % 128; an
inactive slot goes to the trash block 0 at row b % 128 (`paged_targets`,
the reference's _targets, plain PyTorch outside the kernel). The pools are
written IN PLACE and returned — the port's counterpart of the Pallas
`input_output_aliases`. A decode step computes the targets once and hands
them to every layer's call (`targets=`): positions, table and active are
the same for all layers.

The KV lifecycle tier's demotion (`paged_demote_q8`, the reference's
engine _demote) runs on the same quantizing kernel: one hot block [KVH,
128, D] of a layer is KVH*128 rows of one head, written to the cold pool
viewed as blocks of one head [NBc*KVH, 1, 128, D], targets from
`demote_targets` — no kernel of its own and no op chain.

The tensor-parallel wrappers `paged_scatter_append_sharded` and
`paged_scatter_append_q8_sharded` (the reference's shard_map wrappers)
are one rank's launch of the same kernels on its KV-head shard of the
pool, counted apart: the unsharded wrappers given `mesh=`.

A wrapper given CPU tensors runs the plain version (advanced-index
assignment); given CUDA tensors it launches the kernel or raises. Each
launch adds one to its count in LAUNCHES, and nothing else does.
"""
from __future__ import annotations

import torch

from localai_tpu_torch.ops.kernels import _build
from localai_tpu_torch.ops.kernels.flash_attention import (
    _DTYPE_CODE, _check_cuda, _on, _raise_rc, _stream,
)
from localai_tpu_torch.ops.kvcache import quantize_tokens
from localai_tpu_torch.ops.paged import BLOCK, ring_block_map

LAUNCHES = {"paged_scatter_append": 0, "paged_scatter_append_q8": 0,
            "paged_demote_q8": 0, "paged_scatter_append_sharded": 0,
            "paged_scatter_append_q8_sharded": 0}


def paged_targets(positions, table, active=None, sb=None, rw=None):
    """(physical block [B], in-block row [B]) int32 for each slot's new
    token. Inactive rows route to the trash block at row b % BLOCK
    (distinct while B <= BLOCK, which the engine checks; past that, two
    inactive slots share a trash row that nothing reads). sb/rw ([B] int,
    optional): ring geometry (ops/paged.ring_block_map) applied to the raw
    block index before the table lookup. A raw index past the table clamps
    to its last column, as the reference's gather does; only an inactive
    slot's stale position can get there, and it goes to trash."""
    b = positions.shape[0]
    dev = table.device
    positions = positions.to(device=dev, dtype=torch.int64)
    raw = torch.div(positions, BLOCK, rounding_mode="floor")
    if sb is not None:
        raw = ring_block_map(raw, sb.to(dev).long(), rw.to(dev).long())
    raw = torch.clamp(raw, 0, table.shape[1] - 1)
    rows = torch.arange(b, device=dev)
    pb = table.long()[rows, raw]
    off = torch.remainder(positions, BLOCK)
    if active is not None:
        act = active.to(dev)
        pb = torch.where(act, pb, torch.zeros_like(pb))
        off = torch.where(act, off, rows % BLOCK)
    return pb.to(torch.int32), off.to(torch.int32)


def _resolve(positions, table, active, sb, rw, targets):
    return targets if targets is not None else paged_targets(
        positions, table, active, sb=sb, rw=rw)


def paged_scatter_append_plain(k_pool, v_pool, k_new, v_new, positions,
                               table, active=None, sb=None, rw=None,
                               targets=None):
    """Plain version of paged_scatter_append: pool[pb, :, off] = row."""
    pb, off = (t.long() for t in _resolve(positions, table, active, sb, rw,
                                          targets))
    k_pool[pb, :, off] = k_new.to(k_pool.dtype)
    v_pool[pb, :, off] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def paged_scatter_append_q8_plain(kq, ks, vq, vs, k_new, v_new, positions,
                                  table, active=None, sb=None, rw=None,
                                  targets=None):
    """Plain version of paged_scatter_append_q8: quantize each row, then
    pool[pb, :, off] = int8 row and scales[pb, :, 0, off] = its scale."""
    pb, off = (t.long() for t in _resolve(positions, table, active, sb, rw,
                                          targets))
    kq_n, ks_n = quantize_tokens(k_new)              # [B, KVH, D], [B, KVH]
    vq_n, vs_n = quantize_tokens(v_new)
    kq[pb, :, off] = kq_n
    ks[pb, :, 0, off] = ks_n.to(ks.dtype)
    vq[pb, :, off] = vq_n
    vs[pb, :, 0, off] = vs_n.to(vs.dtype)
    return kq, ks, vq, vs


def _shapes(name, k_pool, v_pool, k_new, v_new):
    NB, KVH, bs, D = k_pool.shape
    B = k_new.shape[0]
    if bs != BLOCK or v_pool.shape != k_pool.shape or \
            k_new.shape != (B, KVH, D) or v_new.shape != k_new.shape:
        raise ValueError(f"{name}: bad shapes pool{tuple(k_pool.shape)} "
                         f"new{tuple(k_new.shape)}")
    return B, KVH, D, NB


def launch_rows(name, k_pool, v_pool, k_new, v_new, targets):
    """Launch the row-scatter kernel (csrc/paged_scatter.cu) on CUDA
    tensors: row b of k_new/v_new [B, KVH, D] to pool block targets[0][b],
    row targets[1][b]. Counts nothing: each wrapper that calls it counts
    its own launch (this one and ragged_attention.ragged_scatter_append)."""
    B, KVH, D, NB = _shapes(name, k_pool, v_pool, k_new, v_new)
    dev = k_new.device
    kn, vn = _on(k_new, k_pool.dtype, dev), _on(v_new, k_pool.dtype, dev)
    _check_cuda(name, (kn, vn, k_pool, v_pool),
                (None, None, kn.dtype, kn.dtype))
    pb = _on(targets[0], torch.int32, dev)
    off = _on(targets[1], torch.int32, dev)
    lib = _build.load("paged_scatter")
    rc = lib.paged_scatter_launch(
        k_pool.element_size(), kn.data_ptr(), vn.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), pb.data_ptr(), off.data_ptr(),
        B, KVH, D, NB, _stream(dev))
    _raise_rc(name, rc)


def launch_rows_q8(name, kq, ks, vq, vs, k_new, v_new, targets):
    """The int8 twin of launch_rows: one launch quantizes the bf16/f32 rows
    (per token, symmetric over D) and writes the int8 rows and their scales
    [NB, KVH, 1, BS]; no PyTorch arithmetic runs on the rows. Counts
    nothing."""
    B, KVH, D, NB = _shapes(name, kq, vq, k_new, v_new)
    if ks.shape != (NB, KVH, 1, BLOCK) or vs.shape != ks.shape:
        raise ValueError(f"{name}: bad pool/scale shapes")
    if k_new.dtype not in _DTYPE_CODE or v_new.dtype != k_new.dtype:
        raise TypeError(f"{name}: new rows must be bf16 or f32 alike, got "
                        f"{k_new.dtype} and {v_new.dtype}")
    dev = k_new.device
    kn, vn = _on(k_new, k_new.dtype, dev), _on(v_new, k_new.dtype, dev)
    _check_cuda(name, (kn, vn, kq, ks, vq, vs),
                (None, None) + (torch.int8, torch.float32) * 2)
    pb = _on(targets[0], torch.int32, dev)
    off = _on(targets[1], torch.int32, dev)
    lib = _build.load("paged_scatter")
    rc = lib.paged_scatter_q8_launch(
        _DTYPE_CODE[kn.dtype], kn.data_ptr(), vn.data_ptr(),
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        pb.data_ptr(), off.data_ptr(), B, KVH, D, NB, _stream(dev))
    _raise_rc(name, rc)


def paged_scatter_append(k_pool, v_pool, k_new, v_new, positions, table,
                         active=None, sb=None, rw=None, targets=None,
                         mesh=None):
    """Append one K/V token per slot into the paged pools, IN PLACE.

    k_pool/v_pool: [NB, KVH, BS, D]; k_new/v_new: [B, KVH, D] (this step's
    rope-applied K and raw V rows, cast to the pool dtype); positions: [B]
    write position (= the slot's current length); table: [B, MAXB] int;
    active: [B] bool or None; sb/rw: ring geometry or None; targets:
    (pb, off) precomputed by paged_targets (then positions/table/active/
    sb/rw are not read); mesh: a tensor-parallel rank's shards (see
    paged_scatter_append_sharded). Returns (k_pool, v_pool), the same
    tensors."""
    name = counted("paged_scatter_append", mesh, k_new.shape[1],
                   k_pool.shape[1])
    if _on_cpu(name, k_new):
        return paged_scatter_append_plain(k_pool, v_pool, k_new, v_new,
                                          positions, table, active, sb, rw,
                                          targets)
    launch_rows(name, k_pool, v_pool, k_new, v_new,
                _resolve(positions, table, active, sb, rw, targets))
    LAUNCHES[name] += 1
    return k_pool, v_pool


def paged_scatter_append_q8(kq, ks, vq, vs, k_new, v_new, positions, table,
                            active=None, sb=None, rw=None, targets=None,
                            mesh=None):
    """int8 variant, IN PLACE: pools kq/vq [NB, KVH, BS, D] int8 with scales
    ks/vs [NB, KVH, 1, BS] f32. k_new/v_new arrive dense [B, KVH, D] (bf16
    or f32 on the card) and are quantized per token, symmetric over D (on
    the card inside the kernel). Returns (kq, ks, vq, vs), the same
    tensors."""
    name = counted("paged_scatter_append_q8", mesh, k_new.shape[1],
                   kq.shape[1])
    if _on_cpu(name, k_new):
        return paged_scatter_append_q8_plain(kq, ks, vq, vs, k_new, v_new,
                                             positions, table, active, sb,
                                             rw, targets)
    launch_rows_q8(name, kq, ks, vq, vs, k_new, v_new,
                   _resolve(positions, table, active, sb, rw, targets))
    LAUNCHES[name] += 1
    return kq, ks, vq, vs


def demote_targets(ci, kvh: int, rows=None):
    """(block [KVH*128], row [KVH*128]) int32 targets of paged_demote_q8
    for cold block `ci`: row h*128 + t of the hot block goes to block ci*KVH
    + h of the one-head view, row t. `rows` ([KVH*128] int32 arange on the
    block's device, made once by the caller) keeps a demote to one device
    op; without it it is made here."""
    if rows is None:
        rows = torch.arange(kvh * BLOCK, dtype=torch.int32)
    return (torch.div(rows, BLOCK, rounding_mode="floor") + ci * kvh,
            torch.remainder(rows, BLOCK))


def paged_demote_q8_plain(kq, ks, vq, vs, k_blk, v_blk, targets):
    """Plain version of paged_demote_q8: quantize_tokens of each row, then
    the int8 rows and scales into the cold block."""
    nbc, kvh, _, d = kq.shape
    return paged_scatter_append_q8_plain(
        kq.view(nbc * kvh, 1, BLOCK, d), ks.view(nbc * kvh, 1, 1, BLOCK),
        vq.view(nbc * kvh, 1, BLOCK, d), vs.view(nbc * kvh, 1, 1, BLOCK),
        k_blk.reshape(kvh * BLOCK, 1, d), v_blk.reshape(kvh * BLOCK, 1, d),
        None, None, targets=targets)


def paged_demote_q8(kq, ks, vq, vs, k_blk, v_blk, targets):
    """Demote one layer's hot block into a cold block, IN PLACE: k_blk/v_blk
    [KVH, 128, D] (bf16/f32, contiguous: a block of the hot pool) quantized
    per token, as ops/kvcache.quantize_tokens does bit for bit, into the
    int8 pools kq/vq [NBc, KVH, 128, D] and scales ks/vs [NBc, KVH, 1, 128]
    at `targets` (demote_targets of the cold block). On the card: one
    launch of the quantizing row kernel (scatter_q8_rows)."""
    if k_blk.device.type == "cpu":
        return paged_demote_q8_plain(kq, ks, vq, vs, k_blk, v_blk, targets)
    if k_blk.device.type != "cuda":
        raise ValueError(f"paged_demote_q8: unsupported device "
                         f"{k_blk.device}")
    nbc, kvh, bs, d = kq.shape
    if k_blk.shape != (kvh, BLOCK, d) or v_blk.shape != k_blk.shape \
            or not (k_blk.is_contiguous() and v_blk.is_contiguous()):
        raise ValueError(f"paged_demote_q8: blocks must be contiguous "
                         f"[{kvh}, {BLOCK}, {d}], got {tuple(k_blk.shape)}")
    if bs != BLOCK or ks.shape != (nbc, kvh, 1, BLOCK) \
            or vq.shape != kq.shape or vs.shape != ks.shape:
        raise ValueError("paged_demote_q8: bad cold pool shapes")
    launch_rows_q8("paged_demote_q8", kq.view(nbc * kvh, 1, BLOCK, d),
                   ks.view(nbc * kvh, 1, 1, BLOCK),
                   vq.view(nbc * kvh, 1, BLOCK, d),
                   vs.view(nbc * kvh, 1, 1, BLOCK),
                   k_blk.view(kvh * BLOCK, 1, d),
                   v_blk.view(kvh * BLOCK, 1, d), targets)
    LAUNCHES["paged_demote_q8"] += 1
    return kq, ks, vq, vs


# ------------------------------------------------------ tensor parallelism
# The reference's *_sharded wrappers run the kernel per KV-head shard under
# shard_map, the targets (ring map folded in) computed outside it from
# replicated positions/table/active. PyTorch runs TP as SPMD: a rank's
# shard_map body is its own launch on the rows [B, KVH/tp, D] and the pool
# shard [NB, KVH/tp, 128, D] it holds, the targets computed outside the
# launch, alike on every rank.

def counted(name, mesh, heads, pool_heads, grouped=False):
    """The LAUNCHES key a wrapper's launch adds to: `name`, or on a
    tensor-parallel `mesh` its `*_sharded` twin, once the operands are
    held to one rank's shards: `heads` (the new rows' KV heads, or q's
    heads when `grouped`: whole GQA groups) on a pool shard of
    `pool_heads` KV heads, on a rank of `mesh`."""
    if mesh is None:
        return name
    name += "_sharded"
    if not 0 <= mesh.rank < mesh.model:
        raise ValueError(f"{name}: rank {mesh.rank} outside the model axis "
                         f"({mesh.model})")
    if (heads % pool_heads) if grouped else (heads != pool_heads):
        raise ValueError(f"{name}: {heads} heads on a pool shard of "
                         f"{pool_heads} KV heads: not this rank's shard")
    return name


def _on_cpu(name, x):
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one; raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def paged_scatter_append_sharded(mesh, k_pool, v_pool, k_new, v_new,
                                 positions, table, active=None, sb=None,
                                 rw=None, targets=None):
    """TP wrapper of paged_scatter_append (the reference's
    paged_scatter.py:141): the rank's rows k_new/v_new [B, KVH/tp, D] into
    its pool shard [NB, KVH/tp, 128, D], IN PLACE. The targets, ring map
    (sb/rw) included, are computed outside the launch (paged_targets; or
    given as `targets`), as the reference folds the ring outside
    shard_map."""
    return paged_scatter_append(k_pool, v_pool, k_new, v_new, positions,
                                table, active, sb, rw, targets, mesh=mesh)


def paged_scatter_append_q8_sharded(mesh, kq, ks, vq, vs, k_new, v_new,
                                    positions, table, active=None, sb=None,
                                    rw=None, targets=None):
    """TP wrapper of paged_scatter_append_q8 (the reference's
    paged_scatter.py:183): the int8 pools' and their scales' KV-head
    shards, IN PLACE, the targets outside the launch."""
    return paged_scatter_append_q8(kq, ks, vq, vs, k_new, v_new, positions,
                                   table, active, sb, rw, targets, mesh=mesh)
