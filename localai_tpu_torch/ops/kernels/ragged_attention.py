"""Ragged paged attention and the flat-stream KV writes, with their plain
PyTorch versions (counterpart of localai_tpu/ops/pallas/ragged_attention.py).

One flat token stream serves a mixed tick: one row per live decode slot
plus chunked-prefill windows, packed into q [T, H, D], every row attending
to its own sequence's paged KV through the block table. The packing
contract is the reference's:
- rows are grouped by sequence and every sequence's rows start at a
  QBLK-aligned row, so each QBLK-row q block belongs to exactly one
  sequence (its tail rows up to the next boundary are padding);
- block_seq [T/QBLK] maps each q block to its sequence (-1 = dead block);
- qstart/qlen [NSEQ] give each sequence's first row and row count;
- kvlen [NSEQ] is the attended KV length INCLUDING this tick's tokens
  (write-then-attend: the row at position p attends to 0..p);
- tables [NSEQ, MAXB] are the per-sequence block-table rows.
Padding rows are garbage by contract and callers ignore them (the kernel
writes 0 there, the plain version a uniform average).

Four wrappers, each beside its plain version with the same signature:
- ragged_paged_attention / _plain — bf16/f32 pools [NB, KVH, 128, D]
  (csrc/ragged_attention.cu);
- ragged_paged_attention_q8 / _plain — int8 pools with per-token f32
  scales [NB, KVH, 1, 128] (csrc/ragged_attention.cu, q8 variant);
- ragged_scatter_append / _plain — row t of k/v_new [T, KVH, D] to block
  pb[t], row off[t], in place: the paged scatter kernel
  (csrc/paged_scatter.cu) with B = T host-free targets, as the reference
  builds it on paged_scatter's _append_kernel;
- ragged_scatter_append_q8 / _plain — the int8 twin: the paged scatter's
  quantizing kernel (csrc/paged_scatter.cu) quantizes each row per token
  and writes the int8 rows and their scales in one launch.

On the card ragged attention is split-KV (csrc/ragged_attention.cu): a
split pass gives each (q tile, KV head, span of `split` tokens) its own
block, where a q tile is up to QT consecutive q blocks of one sequence (a
prefill chunk's K/V tile is read once for all of them, a decode row's q
block is its own tile) and the spans come from `ragged_split`, from shapes
alone; a combine pass merges each row's spans. bf16 q runs on the tensor
cores up to head_dim 256, f32 q and wider bf16 heads on a SIMT variant of
the same pass (`ragged_tiling` gives both tilings).

The plain attention versions gather only the table-mapped blocks of each q
block ([NQB, KVH, MAXB*128, D], never the whole pool) and run one masked
softmax, the reference's ragged_attention_xla structure, with the kernel's
math: f32 scores from the pre-scaled query, the K scale on the score
columns and the V scale on p (int8), the 1e-30 floor.

The KV lifecycle tier (`kvt`, engine/kvtier.py: per-sequence sb, rw,
sinks, window [NSEQ] over compact ring tables) runs in the same kernels:
each q tile walks two spans of keys, the sinks [0, sinks) and its window
(q_first - window, q_last], in one compressed order whose tiles take their
table entries through ring_block_map (raw block indices run up to
kvlen/128 while MAXB is the compact width); a row keeps the resident keys
at kv_pos <= q_pos with kv_pos > q_pos - window or kv_pos < sinks, the
reference's _xla_core tier branch. Its plain versions gather the table
rows as the untiered ones do and take the true positions and residency of
ops/paged.resident_row_positions (the reference's _tier_blocks). Tiered
launches count apart (`ragged_paged_attention_tier`,
`ragged_paged_attention_q8_tier`).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Each launch adds one to the wrapper's count
in LAUNCHES, and nothing else does. The tensor-parallel `*_sharded`
wrappers (the reference's shard_map wrappers) launch the same kernels on
one rank's KV-head shard and count apart: the unsharded wrappers given
`mesh=`.
"""
from __future__ import annotations

import functools

import torch

from localai_tpu_torch.ops.attention import NEG_INF
from localai_tpu_torch.ops.kernels import _build
from localai_tpu_torch.ops.kernels.flash_attention import (
    _DTYPE_CODE, _check_cuda, _on, _raise_rc, _sm_count, _stream, _window,
)
from localai_tpu_torch import not_ported
from localai_tpu_torch.ops.kernels.paged_scatter import (
    _on_cpu, counted, launch_rows, launch_rows_q8, paged_scatter_append_plain,
    paged_scatter_append_q8_plain,
)
from localai_tpu_torch.ops.paged import BLOCK, resident_row_positions

QBLK = 8   # q rows per block; every sequence's rows start on a boundary

# The kernels' one limit (csrc/ragged_attention.cu): bf16 q up to head_dim
# 256 runs on the tensor cores (a warp's 16 rows hold a 16 x D f32
# accumulator); above that, and for f32 q, the SIMT variant holds 4096 / D
# compact rows a block, 16 outputs of 256 threads: 8 rows (one q block of
# one head) at D = 512. Any GQA group size fits either way.
RAGGED_MAX_HEAD_DIM = 512
RAGGED_TILE = 32   # tokens per K/V tile of the split pass (BK in the .cu)
RAGGED_TC_ROWS = 128   # compact (token, head) rows of a tensor-core block
# Rows times spans of the partials' workspace at most: 68 MB of f32
# partials at H=32, D=128
RAGGED_PARTIAL_ROWS = 4096


def ragged_tiling(G: int, D: int, tensor_cores: bool) -> tuple[int, int]:
    """(GC, QT) of the split pass (`tiling` in the .cu, which
    ragged_attention_tiling reports): a block holds GC of a KV head's G
    query heads for the live rows of QT consecutive q blocks of one
    sequence, at most 128 compact rows on the tensor cores and 4096 // D
    (at least QBLK) in the SIMT variant."""
    rows = RAGGED_TC_ROWS if tensor_cores else max(4096 // D, QBLK)
    gc = min(G, max(1, rows // QBLK))
    return gc, max(1, rows // (QBLK * gc))


@functools.lru_cache(maxsize=None)
def ragged_split(T: int, maxb: int, rows: int, sms: int) -> tuple[int, int]:
    """(nsplit, split) of split-KV ragged attention over a T-row stream
    whose sequences attend through MAXB-block tables (MAXB*128 tokens), for
    rows = KVH KV heads on a card with `sms` SMs. A span is at most 8
    tiles (a block walks it in sequence) and at least 2 (a block keeps two
    in flight); between those, about 2 blocks per SM if every q block were
    a full-length sequence — most are shorter, and a block past its tile's
    keys exits at once. T * nsplit stays within RAGGED_PARTIAL_ROWS (the
    workspace holds T*H*nsplit partials), which lengthens the spans of a
    long table under a long stream. Shapes only, never kvlen, so a tick
    needs no device sync (and each shape is computed once). nsplit *
    split >= MAXB*128 > (nsplit - 1) * split."""
    tokens = maxb * BLOCK
    tiles = -(-tokens // RAGGED_TILE)
    blocks = max(T // QBLK, 1) * rows
    want = min(max(1, -(-2 * sms // blocks)), -(-tiles // 2))
    want = max(want, -(-tiles // 8))
    want = min(want, max(1, RAGGED_PARTIAL_ROWS // T))
    split = -(-tiles // want) * RAGGED_TILE
    return -(-tokens // split), split


def _ragged_workspace(t, h, kvh, d, maxb, device):
    """(nsplit, split, workspace) of one call: ragged_split's spans and the
    f32 partials [T*H*nsplit*(D+2)] they write."""
    nsplit, split = ragged_split(t, maxb, kvh, _sm_count(device))
    ws = torch.empty(t * h * nsplit * (d + 2), dtype=torch.float32,
                     device=device)
    return nsplit, split, ws


LAUNCHES = {"ragged_paged_attention": 0, "ragged_paged_attention_q8": 0,
            "ragged_paged_attention_tier": 0,
            "ragged_paged_attention_q8_tier": 0,
            "ragged_scatter_append": 0, "ragged_scatter_append_q8": 0,
            "ragged_paged_attention_sharded": 0,
            "ragged_paged_attention_q8_sharded": 0,
            "ragged_scatter_append_sharded": 0,
            "ragged_scatter_append_q8_sharded": 0}

_TIER_KEYS = ("sb", "rw", "sinks", "window")


def _meta_i32(device, *meta):
    return tuple(m.to(device=device, dtype=torch.int32).contiguous()
                 for m in meta)


# ------------------------------------------------------------ plain versions

def _gather_blocks(pool, block_seq, tables):
    """[NQB, KVH, MAXB*BS, ...] per-q-block view through the table (a
    scale pool [NB, KVH, 1, BS] gives [NQB, KVH, MAXB*BS])."""
    tab = tables.long()[block_seq.long().clamp_min(0)]         # [NQB, MAXB]
    g = pool[tab]                                 # [NQB, MAXB, KVH, BS, D]
    nqb, maxb, kvh, bs = g.shape[:4]
    if g.shape[3] == 1:                           # scales [.., KVH, 1, BS]
        return g[:, :, :, 0].permute(0, 2, 1, 3).reshape(
            nqb, kvh, maxb * g.shape[4])
    return g.permute(0, 2, 1, 3, 4).reshape(nqb, kvh, maxb * bs,
                                            g.shape[4])


def _tier_blocks(block_seq, kvlen, tables, kvt):
    """Per-q-block tier metadata for _plain_core (the reference's
    _tier_blocks): true row positions and residency of the ring-mapped
    gathered view, and each block's sinks and window. None without kvt."""
    if kvt is None:
        return None
    dev = tables.device
    s_b = block_seq.to(dev).long().clamp_min(0)
    sb, rw, sinks, window = (kvt[k].to(dev).long()[s_b] for k in _TIER_KEYS)
    pos, ok = resident_row_positions(tables.shape[1], sb, rw,
                                     kvlen.to(dev).long()[s_b])
    return pos, ok, sinks, window


def _plain_core(q, kg, vg, ks, vs, block_seq, qstart, qlen, kvlen,
                sliding_window, tier=None):
    """q [T, H, D]; kg/vg [NQB, KVH, C, D] f32 per-q-block gathered KV;
    ks/vs [NQB, KVH, C] scales or None; tier: _tier_blocks' metadata (the
    retention mask then replaces the length and window masks). Returns [T,
    H, D] in q.dtype."""
    t, h, d = q.shape
    nqb, kvh, c, _ = kg.shape
    g = h // kvh
    dev = q.device
    qb = q.reshape(nqb, QBLK, kvh, g, d).float() * d ** -0.5
    sc = torch.einsum("nqhgd,nhcd->nhqgc", qb, kg)
    if ks is not None:
        sc = sc * ks[:, :, None, None, :]
    block_seq = block_seq.to(dev).long()
    s_b = block_seq.clamp_min(0)
    klen = kvlen.to(dev).long()[s_b][:, None]                   # [NQB, 1]
    qs = qstart.to(dev).long()[s_b][:, None]
    ql = qlen.to(dev).long()[s_b][:, None]
    grow = torch.arange(t, device=dev).reshape(nqb, QBLK)
    q_pos = klen - ql + (grow - qs)                             # [NQB, QBLK]
    valid = (grow >= qs) & (grow < qs + ql) & (block_seq[:, None] >= 0)
    if tier is None:
        kv_pos = torch.arange(c, device=dev)[None, None, :]
        mask = (valid[:, :, None] & (kv_pos <= q_pos[:, :, None])
                & (kv_pos < klen[:, :, None]))
        if sliding_window:
            mask = mask & (kv_pos > q_pos[:, :, None] - int(sliding_window))
    else:
        pos, ok, sinks, window = tier
        kv_pos = pos.long()[:, None, :]                        # [NQB, 1, C]
        mask = (valid[:, :, None] & ok[:, None, :]
                & (kv_pos <= q_pos[:, :, None]))
        mask = mask & ((kv_pos > q_pos[:, :, None] - window[:, None, None])
                       | (kv_pos < sinks[:, None, None]))
    sc = torch.where(mask[:, None, :, None, :], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p * vs[:, :, None, None, :] if vs is not None else p
    o = torch.einsum("nhqgc,nhcd->nqhgd", pv, vg)
    o = o / torch.clamp_min(l.permute(0, 2, 1, 3, 4), 1e-30)
    return o.reshape(t, h, d).to(q.dtype)


def ragged_paged_attention_plain(q, k_pool, v_pool, block_seq, qstart, qlen,
                                 kvlen, tables, sliding_window=None,
                                 kvt=None):
    """Plain version of ragged_paged_attention."""
    kg = _gather_blocks(k_pool, block_seq, tables).float()
    vg = _gather_blocks(v_pool, block_seq, tables).float()
    return _plain_core(q, kg, vg, None, None, block_seq, qstart, qlen, kvlen,
                       sliding_window,
                       _tier_blocks(block_seq, kvlen, tables, kvt))


def ragged_paged_attention_q8_plain(q, k_q, k_s, v_q, v_s, block_seq, qstart,
                                    qlen, kvlen, tables, sliding_window=None,
                                    kvt=None):
    """Plain version of ragged_paged_attention_q8."""
    return _plain_core(
        q, _gather_blocks(k_q, block_seq, tables).float(),
        _gather_blocks(v_q, block_seq, tables).float(),
        _gather_blocks(k_s, block_seq, tables).float(),
        _gather_blocks(v_s, block_seq, tables).float(), block_seq, qstart,
        qlen, kvlen, sliding_window,
        _tier_blocks(block_seq, kvlen, tables, kvt))


def ragged_scatter_append_plain(k_pool, v_pool, k_new, v_new, pb, off):
    """Plain version of ragged_scatter_append: pool[pb, :, off] = row."""
    return paged_scatter_append_plain(k_pool, v_pool, k_new, v_new, None,
                                      None, targets=(pb, off))


def ragged_scatter_append_q8_plain(kq, ks, vq, vs, k_new, v_new, pb, off):
    """Plain version of ragged_scatter_append_q8."""
    return paged_scatter_append_q8_plain(kq, ks, vq, vs, k_new, v_new, None,
                                         None, targets=(pb, off))


# ------------------------------------------------------------------ kernels

def _attn_checks(name, q, pool_shape, tables):
    t, h, d = q.shape
    if t % QBLK:
        raise ValueError(
            f"ragged stream rows T={t} must be a multiple of QBLK={QBLK} "
            "(the engine's token budget is QBLK-aligned by construction)")
    if len(pool_shape) != 4 or pool_shape[2] != BLOCK \
            or pool_shape[3] != d or h % pool_shape[1]:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(pool_shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if tables.dim() != 2:
        raise ValueError(f"{name}: tables must be [NSEQ, MAXB]")
    kvh = pool_shape[1]
    if d % 16 or not 0 < d <= RAGGED_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 16 "
                         f"and at most {RAGGED_MAX_HEAD_DIM} (QBLK*head_dim "
                         f"outputs of one head over a SIMT block's 256 "
                         f"threads)")
    return t, h, kvh, d, tables.shape[1]


def _prep(name, q, pools, tables, meta):
    """Check a launch's tensors (pools: k, ks, v, vs; ks/vs None for
    bf16/f32) and bring q and the metadata to the kernel's form: (q
    contiguous, int32 metadata)."""
    kp, ks, vp, vs = pools
    if vp.shape != kp.shape:
        raise ValueError(f"{name}: k/v pool shapes differ")
    t, h, kvh, d, maxb = _attn_checks(name, q, kp.shape, tables)
    q = q.contiguous()
    if ks is None:
        _check_cuda(name, (q, kp, vp), (None, q.dtype, q.dtype))
    else:
        nb = kp.shape[0]
        if ks.shape != (nb, kvh, 1, BLOCK) or vs.shape != ks.shape:
            raise ValueError(f"{name}: bad pool/scale shapes")
        _check_cuda(name, (q, kp, ks, vp, vs),
                    (None, torch.int8, torch.float32, torch.int8,
                     torch.float32))
    return q, _meta_i32(q.device, *meta)


def _launch(name, q, pools, meta, sliding_window):
    """One untiered split-KV launch (ragged_attention_launch, or its q8
    twin when the pools carry scales) over _prep's tensors. Counts
    nothing: each wrapper counts its own launch."""
    kp, ks, vp, vs = pools
    t, h, d = q.shape
    kvh, maxb = kp.shape[1], meta[4].shape[1]
    out = torch.empty_like(q)
    nsplit, split, ws = _ragged_workspace(t, h, kvh, d, maxb, q.device)
    lib = _build.load("ragged_attention")
    tail = (out.data_ptr(), t, h, kvh, maxb, d, _window(sliding_window),
            d ** -0.5, ws.data_ptr(), nsplit, split, _stream(q.device))
    mp = tuple(m.data_ptr() for m in meta)
    if ks is None:
        rc = lib.ragged_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            *mp, *tail)
    else:
        rc = lib.ragged_attention_q8_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), kp.data_ptr(), ks.data_ptr(),
            vp.data_ptr(), vs.data_ptr(), *mp, *tail)
    _raise_rc(name, rc)
    return out


def _attn_name(name, mesh, q, pool, kvt):
    """The LAUNCHES key of an attention launch (counted); the KV tier
    raises under a mesh."""
    if mesh is not None and kvt is not None:
        raise not_ported("the KV retention tier under a mesh", "parallel")
    return counted(name, mesh, q.shape[1], pool.shape[1], grouped=True)


def ragged_paged_attention(q, k_pool, v_pool, block_seq, qstart, qlen,
                           kvlen, tables, sliding_window=None, kvt=None,
                           mesh=None):
    """Flat-stream GQA attention over paged KV. q: [T, H, D], T a multiple
    of QBLK; pools [NB, KVH, 128, D] in q's dtype; metadata per the module
    docstring; `kvt` the KV tier's per-sequence geometry (sliding_window is
    then ignored); `mesh` a tensor-parallel rank's shards (see
    ragged_paged_attention_sharded). Returns [T, H, D] in q.dtype (padding
    rows garbage)."""
    name = _attn_name("ragged_paged_attention", mesh, q, k_pool, kvt)
    if _on_cpu(name, q):
        return ragged_paged_attention_plain(q, k_pool, v_pool, block_seq,
                                            qstart, qlen, kvlen, tables,
                                            sliding_window, kvt)
    pools = (k_pool, None, v_pool, None)
    q, meta = _prep(name, q, pools, tables,
                    (block_seq, qstart, qlen, kvlen, tables))
    if kvt is not None:
        return _ragged_tier(q, pools, meta, kvt)
    out = _launch(name, q, pools, meta, sliding_window)
    LAUNCHES[name] += 1
    return out


def ragged_paged_attention_q8(q, k_q, k_s, v_q, v_s, block_seq, qstart,
                              qlen, kvlen, tables, sliding_window=None,
                              kvt=None, mesh=None):
    """int8 twin: pools k_q/v_q [NB, KVH, 128, D] int8 with per-token scales
    k_s/v_s [NB, KVH, 1, 128] f32 (ops/paged.py layout)."""
    name = _attn_name("ragged_paged_attention_q8", mesh, q, k_q, kvt)
    if _on_cpu(name, q):
        return ragged_paged_attention_q8_plain(q, k_q, k_s, v_q, v_s,
                                               block_seq, qstart, qlen,
                                               kvlen, tables, sliding_window,
                                               kvt)
    pools = (k_q, k_s, v_q, v_s)
    q, meta = _prep(name, q, pools, tables,
                    (block_seq, qstart, qlen, kvlen, tables))
    if kvt is not None:
        return _ragged_tier(q, pools, meta, kvt)
    out = _launch(name, q, pools, meta, sliding_window)
    LAUNCHES[name] += 1
    return out


def _ragged_tier(q, pools, meta, kvt):
    """The tiered launch (ragged_attention_tier_launch) over checked
    pools (k, ks, v, vs; ks/vs None for bf16/f32) and int32 metadata; the
    spans of ragged_split over the compact tables."""
    kp, ks, vp, vs = pools
    q8 = ks is not None
    name = "ragged_paged_attention_q8" if q8 else "ragged_paged_attention"
    t, h, d = q.shape
    kvh = kp.shape[1]
    tables = meta[4]
    geo = [_on(kvt[k], torch.int32, q.device) for k in _TIER_KEYS]
    for g in geo:
        if g.shape != (tables.shape[0],):
            raise ValueError(f"{name}: kvt geometry must be "
                             f"[NSEQ={tables.shape[0]}]")
    out = torch.empty_like(q)
    nsplit, split, ws = _ragged_workspace(t, h, kvh, d, tables.shape[1],
                                          q.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _build.load("ragged_attention")
    rc = lib.ragged_attention_tier_launch(
        _DTYPE_CODE[q.dtype], int(q8), q.data_ptr(), kp.data_ptr(), ptr(ks),
        vp.data_ptr(), ptr(vs), *(m.data_ptr() for m in meta),
        *(g.data_ptr() for g in geo), out.data_ptr(), t, h, kvh,
        tables.shape[1], d, d ** -0.5, ws.data_ptr(), nsplit, split,
        _stream(q.device))
    _raise_rc(f"{name} (tiered)", rc)
    LAUNCHES[name + "_tier"] += 1
    return out


def ragged_scatter_append(k_pool, v_pool, k_new, v_new, pb, off, mesh=None):
    """Write each flat row into its pool slot, IN PLACE. k_new/v_new: [T,
    KVH, D]; pb/off: [T] int (padding rows aim at trash block 0); `mesh` a
    tensor-parallel rank's shards. Returns (k_pool, v_pool), the same
    tensors."""
    name = counted("ragged_scatter_append", mesh, k_new.shape[1],
                   k_pool.shape[1])
    if _on_cpu(name, k_new):
        return ragged_scatter_append_plain(k_pool, v_pool, k_new, v_new, pb,
                                           off)
    launch_rows(name, k_pool, v_pool, k_new, v_new, (pb, off))
    LAUNCHES[name] += 1
    return k_pool, v_pool


def ragged_scatter_append_q8(kq, ks, vq, vs, k_new, v_new, pb, off,
                             mesh=None):
    """int8 twin, IN PLACE: quantize the flat rows, then write int8 rows and
    scale elements into [NB, KVH, 128, D] / [NB, KVH, 1, 128]. Returns (kq,
    ks, vq, vs), the same tensors."""
    name = counted("ragged_scatter_append_q8", mesh, k_new.shape[1],
                   kq.shape[1])
    if _on_cpu(name, k_new):
        return ragged_scatter_append_q8_plain(kq, ks, vq, vs, k_new, v_new,
                                              pb, off)
    launch_rows_q8(name, kq, ks, vq, vs, k_new, v_new, (pb, off))
    LAUNCHES[name] += 1
    return kq, ks, vq, vs


# ------------------------------------------------------ tensor parallelism
# The reference's *_sharded wrappers run rows 8-11 per KV-head shard under
# shard_map. PyTorch runs TP as SPMD, so a rank's shard_map body is its own
# launch of the same kernel on the heads it holds: q [T, H/tp, D] (the
# rank's query heads: q is kv-head-major, so an even KV-head split keeps
# every GQA group on one rank) and the pools' KV-head shard [NB, KVH/tp,
# 128, D]; the metadata is every rank's alike. Each counts its own
# launches; on CPU tensors it runs the plain version.

def ragged_paged_attention_sharded(mesh, q, k_pool, v_pool, block_seq,
                                   qstart, qlen, kvlen, tables,
                                   sliding_window=None):
    """TP wrapper of ragged_paged_attention (the reference's
    ragged_attention.py:436): this rank's attention on its heads."""
    return ragged_paged_attention(q, k_pool, v_pool, block_seq, qstart,
                                  qlen, kvlen, tables, sliding_window,
                                  mesh=mesh)


def ragged_paged_attention_q8_sharded(mesh, q, k_q, k_s, v_q, v_s,
                                      block_seq, qstart, qlen, kvlen,
                                      tables, sliding_window=None):
    """TP wrapper of ragged_paged_attention_q8 (the reference's
    ragged_attention.py:458): the int8 pools' and their scales' KV-head
    shards."""
    return ragged_paged_attention_q8(q, k_q, k_s, v_q, v_s, block_seq,
                                     qstart, qlen, kvlen, tables,
                                     sliding_window, mesh=mesh)


def ragged_scatter_append_sharded(mesh, k_pool, v_pool, k_new, v_new, pb,
                                  off):
    """TP wrapper of ragged_scatter_append (the reference's
    ragged_attention.py:541): the rank's flat rows [T, KVH/tp, D] into its
    pool shard, IN PLACE."""
    return ragged_scatter_append(k_pool, v_pool, k_new, v_new, pb, off,
                                 mesh=mesh)


def ragged_scatter_append_q8_sharded(mesh, kq, ks, vq, vs, k_new, v_new,
                                     pb, off):
    """TP wrapper of ragged_scatter_append_q8 (the reference's
    ragged_attention.py:555): quantizing writes into the rank's int8 pool
    and scale shards, IN PLACE."""
    return ragged_scatter_append_q8(kq, ks, vq, vs, k_new, v_new, pb, off,
                                    mesh=mesh)
