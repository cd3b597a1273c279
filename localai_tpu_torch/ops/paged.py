"""Paged KV cache — block-paged storage + per-slot block tables
(counterpart of localai_tpu/ops/paged.py).

  storage:  [L, NBLOCKS, KVH, BS, D]   BS = 128 tokens (the int8 scale tile)
  table:    [B, MAXB] int32            virtual block v of slot b lives in
                                       physical block table[b, v]

Physical block 0 is the TRASH block: unallocated table entries point at it,
so redirected writes (inactive slots, a final prefill chunk's padded tail
past the table end) land somewhere harmless, and reads never reach it
(every read is masked by `lengths`, and a slot's length never exceeds its
allocation — the engine reserves blocks for prompt + max_tokens at
admission).

The CUDA decode kernels read K/V through the table and the decode write is
the scatter-append kernel (ops/kernels/paged_scatter.py), so decode traffic
stays O(valid tokens) and O(slots). `paged_view` below materializes the
virtual per-slot view with a gather: the plain versions and chunked
prefill (`extend`) read through it, as the reference's XLA path does.

int8 storage reuses ops/kvcache.QuantKV: with BS == SCALE_TILE the scale
pool is [.., NB, KVH, 1, 128], and `cache_scatter`'s tok//128, tok%128
arithmetic is the identity on an in-block row (always < 128).
"""
from __future__ import annotations

import torch

from localai_tpu_torch.ops.kvcache import SCALE_TILE, QuantKV, init_quant

BLOCK = 128  # tokens per physical block == kvcache.SCALE_TILE
assert BLOCK == SCALE_TILE, "paged int8 scales need one scale row per block"


def init_paged(num_layers: int, nblocks: int, kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, cache_type: str = "", device=None):
    """Zero block pools [L, NB, KVH, BS, D] for K and V (the trash block is
    the CALLER's count: pass nblocks already including physical block 0).
    cache_type "int8"/"q8_0" → QuantKV pools with scales [L, NB, KVH, 1,
    128]."""
    from localai_tpu_torch.ops.kvcache import is_quant_kind

    shape = (num_layers, nblocks, kv_heads, BLOCK, head_dim)
    if is_quant_kind(cache_type):
        return (init_quant(shape, device=device),
                init_quant(shape, device=device))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def paged_view(cache, table):
    """Materialize the virtual per-slot cache [B, KVH, MAXB*BS, D] from one
    layer's block pool [NB, KVH, BS, D] (QuantKV pools: scales as [B, KVH,
    MAXB, 128], the dense scale layout). A gather — the plain versions and
    chunked prefill read through it; the decode kernels never do."""
    table = table.long()
    maxb = table.shape[1]
    if isinstance(cache, QuantKV):
        q = paged_view(cache.q, table)
        s = cache.s[table]                       # [B, MAXB, KVH, 1, 128]
        b = s.shape[0]
        s = s.permute(0, 2, 1, 3, 4).reshape(b, s.shape[2], maxb, BLOCK)
        return QuantKV(q, s)
    g = cache[table]                             # [B, MAXB, KVH, BS, D]
    b, _, kvh, _, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, kvh, maxb * BLOCK, d)


def blocks_needed(tokens: int) -> int:
    """Virtual blocks required to hold `tokens` cache rows."""
    return -(-tokens // BLOCK)


# --------------------------------------------------------------- KV lifecycle
# Ring-mapped compact residency (the reference's engine/kvtier.py): a slot
# under a sink_window(sinks, window) policy keeps sink_blocks identity
# columns plus a ring of ring_blocks columns reused in place. Pure index
# arithmetic over per-slot tensors `sb` (sink blocks) and `rw` (ring
# width); full-policy slots carry the sentinel sb >= table width, which
# makes the mapping the identity. The write paths map raw blocks through
# ring_block_map before the table lookup (paged_targets, _cache_write,
# ragged_row_targets); the plain read paths build the resident view's true
# positions with tiered_positions, and the tiered CUDA kernels walk the
# same sets without gathering them.


def ring_block_map(raw_block, sb, rw):
    """Raw (virtual) block index → resident table column: identity for
    raw_block < sb, the ring sb + (raw_block - sb) % rw after it."""
    rw = torch.clamp_min(rw, 1)
    return torch.where(raw_block < sb, raw_block,
                       sb + torch.remainder(raw_block - sb, rw))


def resident_block_positions(maxb: int, sb, rw, length):
    """Which raw block each table column holds, and whether it is a live
    resident — the read-side inverse of ring_block_map. sb/rw/length: [B]
    int. Returns (raw [B, maxb] int32, ok [B, maxb] bool)."""
    dev = length.device
    j = torch.arange(maxb, dtype=torch.int32, device=dev)[None, :]
    sb = sb[:, None].to(torch.int32)
    rw = torch.clamp_min(rw[:, None].to(torch.int32), 1)
    cur = torch.div(torch.clamp_min(length[:, None].to(torch.int32) - 1, 0),
                    BLOCK, rounding_mode="floor")
    m = torch.remainder(cur - sb, rw)
    o = j - sb
    raw_ring = cur - torch.remainder(m - o, rw)
    raw = torch.where(j < sb, j, raw_ring)
    ok = (j < sb) | ((j < sb + rw) & (raw_ring >= sb))
    return raw.to(torch.int32), ok


def resident_row_positions(maxb: int, sb, rw, length):
    """Per-row true positions + validity of the gathered resident view
    ([B, maxb*BLOCK], paged_view's token axis): residency and pos <
    length."""
    raw, okb = resident_block_positions(maxb, sb, rw, length)
    b = raw.shape[0]
    rows = torch.arange(BLOCK, dtype=torch.int32, device=raw.device)
    pos = (raw[:, :, None] * BLOCK + rows[None, None, :]).reshape(
        b, maxb * BLOCK)
    ok = okb[:, :, None].expand(b, maxb, BLOCK).reshape(b, maxb * BLOCK)
    ok = ok & (pos < length[:, None].to(torch.int32))
    return pos, ok


def tiered_positions(maxb: int, sb, rw, length, ctab=None):
    """Row positions and validity of the tier's views (the reference's
    _tiered_kv without the gathers). Returns (pos, ok) of the resident
    (ring-mapped) view [B, maxb*BLOCK] — residency and pos < length —
    and, with the cold table ctab [B, MBC] (cold block per raw block, 0 =
    not demoted), (posc, okc) of the cold view [B, MBC*BLOCK]; a demoted
    block then drops out of the resident view (its ring column may already
    hold a newer block's rows) and is valid in the cold view below
    `length`."""
    pos, ok = resident_row_positions(maxb, sb, rw, length)
    if ctab is None:
        return pos, ok, None, None
    b = pos.shape[0]
    mbc = ctab.shape[1]
    dev = pos.device
    raw, _ = resident_block_positions(maxb, sb, rw, length)
    demoted = ctab.to(dev) != 0                               # [B, MBC]
    hot_dem = torch.gather(demoted, 1, raw.long().clamp(0, mbc - 1))
    hot_dem = hot_dem & (raw >= 0) & (raw < mbc)              # [B, maxb]
    ok = ok & ~hot_dem[:, :, None].expand(b, maxb, BLOCK).reshape(
        b, maxb * BLOCK)
    posc = torch.arange(mbc * BLOCK, dtype=torch.int32,
                        device=dev)[None, :].expand(b, mbc * BLOCK)
    okc = demoted[:, :, None].expand(b, mbc, BLOCK).reshape(b, mbc * BLOCK)
    okc = okc & (posc < length.to(dev)[:, None])
    return pos, ok, posc, okc
