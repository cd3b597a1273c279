"""Prefill and decode attention kernels of the main path, with their plain
PyTorch versions (counterpart of localai_tpu/ops/pallas/flash_attention.py).

Three wrappers, each beside its plain version with the same signature:
- flash_prefill / flash_prefill_plain — causal GQA attention over a padded
  prompt batch (csrc/flash_prefill.cu);
- ragged_decode / ragged_decode_plain — one query token per slot against
  the dense KV cache, or (`table=`) against the paged block pool through a
  block table (csrc/decode_attention.cu; split-KV in both modes: a split
  pass and a combine pass, spans from `decode_split`);
- ragged_decode_q8 / ragged_decode_q8_plain — the same over an int8 cache
  with per-token scales (csrc/decode_attention.cu: both modes on the split
  pass's int8 flag).

Paged mode also takes the KV lifecycle tier (`kvt`, engine/kvtier.py):
per-slot ring geometry sb/rw and retention sinks/window [B] int32 over a
compact ring table, and, on a dense hot pool, the int8 cold tier
(kvt["cold_tab"] [B, ceil(max_context/128)] with this layer's cold pools
`cold_kv`). The tiered kernel walks true positions: a raw block reads from
the cold pool where the cold table has it, else from the hot pool through
ring_block_map where it is resident, else not at all; the retention mask
(pos < L and pos >= L - window or pos < sinks; with the cold tier pos < L
only) takes the place of the model's sliding window. Its spans cover the
live tiles (sinks and window), not 0..L, in about TIER_BLOCKS_SM
blocks an SM (tier_plan), and the cold tier's spans walk the demoted
blocks alone.
Cold rows are read as the reference's dequant gives them, bf16(q *
scale), formed in registers at the read; a hot int8 pool keeps row 5's
arithmetic (the K scale on the score, the V scale on p). A span of a slot
under a policy runs on the tensor cores (bf16 q, at most 8 heads a
block); full-policy slots keep decode_split's spans and row 3/5's SIMT
arithmetic, so full-policy sentinels give row 3/5's output bit for bit. Tiered launches count apart
(`ragged_decode_paged_tier`, `ragged_decode_q8_paged_tier`).

On the card every kernel takes any GQA group size G = H/KVH and a head_dim
D that is a multiple of 16 up to MAX_HEAD_DIM (256): decode splits a KV
head's G query heads into blocks of at most 1024/D heads, prefill runs D
above 128 on two warpgroups.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback. Each launch adds one
to the wrapper's count in LAUNCHES (and nothing else does), so a run can
show that its main path went through the kernels; the paged launches count
apart (`ragged_decode_paged`, `ragged_decode_q8_paged`). The paged plain
versions are ops/paged.paged_view followed by the dense plain version.

The plain versions follow the kernels' math: f32 scores scaled by
D**-0.5, masks, softmax in f32, the 1e-30 floor on the denominator, and —
for int8 — the K scale on the score columns and the V scale on p before
the value product.
"""
from __future__ import annotations

import functools

import torch

from localai_tpu_torch.ops.attention import NEG_INF
from localai_tpu_torch.ops.kernels import _build
from localai_tpu_torch.ops.kvcache import QuantKV, dequant
from localai_tpu_torch.ops.paged import BLOCK, paged_view, tiered_positions

LAUNCHES = {"flash_prefill": 0, "ragged_decode": 0, "ragged_decode_q8": 0,
            "ragged_decode_paged": 0, "ragged_decode_q8_paged": 0,
            "ragged_decode_paged_tier": 0, "ragged_decode_q8_paged_tier": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Largest head_dim of the prefill and decode kernels: the tensor-core
# prefill stages 256 columns, the decode combine holds 2 outputs of 128
# threads, and the bf16 decode ring takes 135 KB of shared memory at 256.
MAX_HEAD_DIM = 256


def _window(sliding_window) -> int:
    return int(sliding_window) if sliding_window else 0


def _check_cuda(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if dt is not None and t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _on(t, dtype, device):
    """t as a contiguous `dtype` tensor on `device`. One that already is
    comes back as it is, without the conversion calls' host cost (a decode
    step hands every layer the same int32 lengths, table and targets)."""
    if t.dtype is dtype and t.device == device and t.is_contiguous():
        return t
    return t.to(device=device, dtype=dtype).contiguous()


def _stream(device):
    """The raw handle of PyTorch's current stream on `device` (the call
    torch's own generated kernels make; torch.cuda.current_stream builds a
    Stream object first, several microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


DECODE_TILE = 32   # tokens per tile of the split pass (SK_BK in the .cu)


@functools.lru_cache(maxsize=None)
def decode_split(T: int, rows: int, sms: int) -> tuple[int, int]:
    """(nsplit, split) of split-KV decode over a T-token cache (dense, or
    paged with T = MAXB*128) for rows = B*KVH (slot, KV head) rows on a
    card with `sms` SMs: about 16 blocks per SM over all rows at full
    length — rows are mostly shorter than T, and a block past its row's
    length exits at once — so a long row's spans stay a few tiles deep,
    but at least two tiles, which a block has in flight together. Shapes
    only, never the lengths, so a decode step needs no device sync (and
    each shape is computed once). nsplit * split >= T > (nsplit - 1) *
    split."""
    tiles = -(-T // DECODE_TILE)
    want = min(max(1, -(-16 * sms // rows)), -(-tiles // 2))
    split = -(-tiles // want) * DECODE_TILE
    return -(-T // split), split


# the tiered decode's spans (tier_plan), in tiles of DECODE_TILE tokens: a
# slot under a sink_window policy reads its live rows (sinks + window + a
# block, at most the compact table's MAXB*128) in about TIER_BLOCKS_SM
# blocks an SM over all (slot, KV head) rows (TIER_BLOCKS_SM_Q8 over an
# int8 hot pool, whose ring stages are half the bytes), at least
# TIER_MIN_TILES a span; the cold tier its demoted blocks in spans of
# COLD_SPAN_TILES; a full-policy slot (sb >= MAXB) keeps decode_split's
# spans, so its output stays row 3/5's bit for bit. At phase 2's tiered
# shape (64 rows, 152 tiles) that is 31 and 16 tiles a span, the
# optima of chip_tier_sweep.py's 4–64 (PERF.md §6)
TIER_BLOCKS_SM = 2.5
TIER_BLOCKS_SM_Q8 = 5.0
TIER_MIN_TILES = 4
COLD_SPAN_TILES = 32


@functools.lru_cache(maxsize=None)
def tier_split(T: int, tiles: int) -> tuple[int, int]:
    """(nsplit, split) of a tiered view of at most T live tokens in spans
    of `tiles` tiles (one span when T is shorter). Shapes only: a span past
    a slot's live tiles exits at once, so a decode step needs no device
    sync. nsplit * split >= T."""
    split = min(tiles, -(-T // DECODE_TILE)) * DECODE_TILE
    return -(-T // split), split


def tier_span_tiles(maxb: int, rows: int, sms: int, q8: bool) -> int:
    """Tiles a hot span of a slot under a policy: its live tiles (at most
    maxb*128 tokens) cut in about TIER_BLOCKS_SM (q8: TIER_BLOCKS_SM_Q8)
    x SMs / rows splits, at least TIER_MIN_TILES a span."""
    want = max(1, round((TIER_BLOCKS_SM_Q8 if q8 else TIER_BLOCKS_SM)
                        * sms / rows))
    return max(TIER_MIN_TILES, -(-maxb * BLOCK // DECODE_TILE // want))


def tier_plan(maxb: int, mbc: int, rows: int, sms: int,
              q8: bool = False) -> dict:
    """The tiered launch's spans over a compact table of maxb columns and
    (mbc > 0) a cold table of mbc, for rows = B*KVH (slot, KV head) rows:
    {"nsplit", "split"} of the hot view in spans of tier_span_tiles (the
    workspace's hot splits cover both span kinds), "split_f" (full-policy
    slots: decode_split's), and {"nsplit_c", "split_c"} of the cold view
    in spans of COLD_SPAN_TILES (0 without it). Shapes only."""
    T = maxb * BLOCK
    nsplit_f, split_f = decode_split(T, rows, sms)
    nsplit_t, split_t = tier_split(T, tier_span_tiles(maxb, rows, sms, q8))
    nsplit_c, split_c = (tier_split(mbc * BLOCK, COLD_SPAN_TILES) if mbc
                         else (0, 0))
    return dict(nsplit=max(nsplit_f, nsplit_t), split=split_t,
                split_f=split_f, nsplit_c=nsplit_c, split_c=split_c)


def _split_workspace(T, B, H, KVH, D, device):
    """(nsplit, split, workspace) of one split-KV call: the spans of
    decode_split and the f32 partials [B*H*nsplit*(D+2)] they write."""
    nsplit, split = decode_split(T, B * KVH, _sm_count(device))
    ws = torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                     device=device)
    return nsplit, split, ws


def _raise_rc(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {rc})")


# ----------------------------------------------------------------- prefill

def flash_prefill_plain(q, k, v, lengths, sliding_window=None):
    """Plain version of flash_prefill. q: [B, S, H, D]; k/v: [B, S, KVH, D];
    lengths: [B]. Returns [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    qg = (q.float() * (D ** -0.5)).reshape(B, S, KVH, H // KVH, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    pos = torch.arange(S, device=q.device)
    ln = lengths.to(q.device)
    mask = ((pos[None, None, :] <= pos[None, :, None])
            & (pos[None, None, :] < ln[:, None, None]))        # [B,S,T]
    if sliding_window:
        mask = mask & (pos[None, None, :] > pos[None, :, None]
                       - int(sliding_window))
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.float())
    o = o / torch.clamp_min(l, 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def _head_dim_check(name, D):
    if D % 16 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 16 "
                         f"and at most {MAX_HEAD_DIM}")


def _prefill_checks(q, k, v):
    """Shapes and dtype flash_prefill's kernel takes: q [B, S, H, D], k/v
    [B, S, KVH, D], any G = H/KVH, D % 16 == 0 up to MAX_HEAD_DIM.
    Returns (B, S, H, KVH, D)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_prefill: unsupported dtype {q.dtype}")
    if k.shape != (B, S, KVH, D) or v.shape != k.shape or H % KVH:
        raise ValueError(f"flash_prefill: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    _head_dim_check("flash_prefill", D)
    return B, S, H, KVH, D


def flash_prefill(q, k, v, lengths, sliding_window=None):
    """Causal GQA flash attention. q: [B, S, H, D]; k/v: [B, S, KVH, D]
    (bf16 or f32, same dtype); lengths: [B]. Returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, lengths, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, S, H, KVH, D = _prefill_checks(q, k, v)
    _check_cuda("flash_prefill", (q, k, v), (None, q.dtype, q.dtype))
    lens = _on(lengths, torch.int32, q.device)
    out = torch.empty_like(q)
    lib = _build.load("flash_prefill")
    rc = lib.flash_prefill_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr(), out.data_ptr(), B, S, H, KVH, D,
        _window(sliding_window), D ** -0.5, _stream(q.device))
    _raise_rc("flash_prefill", rc)
    LAUNCHES["flash_prefill"] += 1
    return out


# ----------------------------------------------------------------- decode

def ragged_decode_plain(q, k_cache, v_cache, lengths, sliding_window=None,
                        table=None, kvt=None, cold_kv=None):
    """Plain version of ragged_decode. q: [B, 1, H, D]; caches [B, KVH, T,
    D]; lengths: [B] valid entries INCLUDING the new token. With `table`
    [B, MAXB]: caches are block pools [NB, KVH, 128, D], read through
    paged_view (T = MAXB*128); with `kvt` (and `cold_kv`), the KV tier's
    read (_tier_plain)."""
    if kvt is not None:
        return _tier_plain(q, k_cache, v_cache, None, None, lengths, table,
                           kvt, cold_kv)
    if table is not None:
        k_cache, v_cache = paged_view(k_cache, table), paged_view(v_cache,
                                                                  table)
    return _decode_plain(q, k_cache.float(), v_cache.float(), None, None,
                         lengths, sliding_window)


def ragged_decode_q8_plain(q, k_q, k_s, v_q, v_s, lengths,
                           sliding_window=None, table=None, kvt=None):
    """Plain version of ragged_decode_q8. k_q/v_q: [B, KVH, T, D] int8;
    k_s/v_s: [B, KVH, T//128, 128] f32 (token t's scale at [t//128,
    t%128]). With `table` [B, MAXB]: int8 pools [NB, KVH, 128, D] with
    scales [NB, KVH, 1, 128], read through paged_view; with `kvt`, the KV
    tier's read (_tier_plain; no cold tier over an int8 pool)."""
    if kvt is not None:
        return _tier_plain(q, k_q, v_q, k_s, v_s, lengths, table, kvt, None)
    if table is not None:
        kv = paged_view(QuantKV(k_q, k_s), table)
        vv = paged_view(QuantKV(v_q, v_s), table)
        k_q, k_s, v_q, v_s = kv.q, kv.s, vv.q, vv.s
    B, KVH, T, _ = k_q.shape
    return _decode_plain(q, k_q.float(), v_q.float(),
                         k_s.float().reshape(B, KVH, T),
                         v_s.float().reshape(B, KVH, T), lengths,
                         sliding_window)


def _decode_plain(q, kf, vf, ks, vs, lengths, sliding_window):
    T = kf.shape[2]
    pos = torch.arange(T, device=q.device)
    ln = lengths.to(q.device)
    mask = pos[None, :] < ln[:, None]
    if sliding_window:
        mask = mask & (pos[None, :] >= ln[:, None] - int(sliding_window))
    return _masked_plain(q, kf, vf, ks, vs, mask)


def _tier_plain(q, kp, vp, ks, vs, lengths, table, kvt, cold_kv):
    """The tiered paged read (the reference's _decode_dq tier branch, with
    the kernel's arithmetic): the resident ring view of the pools at true
    positions (ops/paged.tiered_positions), masked by pos < L and (pos >=
    L - window or pos < sinks); with kvt["cold_tab"], demoted blocks drop
    out of it and the cold view — cold_kv's int8 pools through the cold
    table, each row bf16(q * scale) as the reference's dequant gives it —
    joins it under pos < L alone. ks/vs: a hot int8 pool's scales (then K
    and V are the int8 values, scaled as the kernel scales them)."""
    ln = lengths.to(q.device)
    ctab = kvt.get("cold_tab")
    pos, ok, posc, okc = tiered_positions(table.shape[1], kvt["sb"],
                                          kvt["rw"], ln, ctab)
    if ks is not None:
        kv, vv = paged_view(QuantKV(kp, ks), table), paged_view(
            QuantKV(vp, vs), table)
        B, KVH, T, _ = kv.q.shape
        kf, vf = kv.q.float(), vv.q.float()
        ks, vs = kv.s.float().reshape(B, KVH, T), vv.s.float().reshape(
            B, KVH, T)
    else:
        kf, vf = paged_view(kp, table).float(), paged_view(vp, table).float()
    if ctab is None:
        mask = ok & ((pos >= (ln - kvt["window"].to(q.device))[:, None])
                     | (pos < kvt["sinks"].to(q.device)[:, None]))
    else:
        ck, cv = cold_kv
        kf = torch.cat([kf, dequant(paged_view(ck, ctab)).float()], dim=2)
        vf = torch.cat([vf, dequant(paged_view(cv, ctab)).float()], dim=2)
        mask = torch.cat([ok, okc], dim=1)
    return _masked_plain(q, kf, vf, ks, vs, mask)


def _masked_plain(q, kf, vf, ks, vs, mask):
    """The decode kernels' arithmetic under a row mask [B, T]: f32 scores
    from the pre-scaled query (times the K scale for int8), softmax in f32,
    p (times the V scale) into the value product, the 1e-30 floor."""
    B, _, H, D = q.shape
    KVH = kf.shape[1]
    qg = (q.float() * (D ** -0.5)).reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bkgd,bktd->bkgt", qg, kf)
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p * vs[:, :, None, :] if vs is not None else p
    o = torch.einsum("bkgt,bktd->bkgd", pv, vf) / torch.clamp_min(l, 1e-30)
    return o.reshape(B, 1, H, D).to(q.dtype)


def _decode_checks(name, q, kshape, T):
    B, S1, H, D = q.shape
    KVH = kshape[1]
    if S1 != 1 or kshape[0] != B or kshape[3] != D or H % KVH:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"cache{tuple(kshape)}")
    _head_dim_check(name, D)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    return B, H, KVH, T, D


def _table_i32(name, table, q, pool_shape):
    """Checks of the paged mode: pool [NB, KVH, 128, D], table [B, MAXB] →
    the table as contiguous int32 on q's device, and MAXB."""
    B = q.shape[0]
    if len(pool_shape) != 4 or pool_shape[2] != BLOCK:
        raise ValueError(f"{name}: paged pool must be [NB, KVH, {BLOCK}, D], "
                         f"got {tuple(pool_shape)}")
    if table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"{name}: table must be [B={B}, MAXB], got "
                         f"{tuple(table.shape)}")
    return _on(table, torch.int32, q.device), table.shape[1]


def ragged_decode(q, k_cache, v_cache, lengths, sliding_window=None,
                  table=None, kvt=None, cold_kv=None):
    """Decode-step GQA attention. q: [B, 1, H, D]; caches [B, KVH, T, D]
    in q's dtype; lengths: [B] valid entries incl. the newly written token.
    Paged mode (`table` [B, MAXB] int): the caches are block pools [NB,
    KVH, 128, D] and virtual block v of slot b is pool block table[b, v]
    (T = MAXB*128). Returns [B, 1, H, D].

    KV tier (paged only): `kvt` {"sb", "rw", "sinks", "window"} [B] int
    (and "cold_tab" [B, MBC] with `cold_kv` = (k, v) QuantKV cold pools
    [NBc, KVH, 128, D] of this layer); sliding_window is then ignored.

    On the card both modes are split-KV: two CUDA launches (the split pass
    over `decode_split` spans into an f32 workspace, then the combine),
    counted as one launch of "ragged_decode" (paged mode:
    "ragged_decode_paged", tiered "ragged_decode_paged_tier")."""
    if q.device.type == "cpu":
        return ragged_decode_plain(q, k_cache, v_cache, lengths,
                                   sliding_window, table=table, kvt=kvt,
                                   cold_kv=cold_kv)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode: unsupported device {q.device}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("ragged_decode: k/v cache shapes differ")
    if kvt is not None:
        return _decode_tier(q, (k_cache, None, v_cache, None), lengths,
                            table, kvt, cold_kv)
    if table is not None:
        return _ragged_decode_paged(q, k_cache, v_cache, lengths,
                                    sliding_window, table)
    B, H, KVH, T, D = _decode_checks("ragged_decode", q, k_cache.shape,
                                     k_cache.shape[2])
    _check_cuda("ragged_decode", (q, k_cache, v_cache),
                (None, q.dtype, q.dtype))
    lens = _on(lengths, torch.int32, q.device)
    out = torch.empty_like(q)
    nsplit, split, ws = _split_workspace(T, B, H, KVH, D, q.device)
    lib = _build.load("decode_attention")
    rc = lib.decode_attention_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, H, KVH, T, D, _window(sliding_window), D ** -0.5, nsplit, split,
        _stream(q.device))
    _raise_rc("ragged_decode", rc)
    LAUNCHES["ragged_decode"] += 1
    return out


def _ragged_decode_paged(q, k_pool, v_pool, lengths, sliding_window, table):
    tab, maxb = _table_i32("ragged_decode", table, q, k_pool.shape)
    B, H, KVH, T, D = _decode_checks("ragged_decode", q,
                                     (q.shape[0],) + tuple(k_pool.shape[1:]),
                                     maxb * BLOCK)
    _check_cuda("ragged_decode", (q, k_pool, v_pool),
                (None, q.dtype, q.dtype))
    lens = _on(lengths, torch.int32, q.device)
    out = torch.empty_like(q)
    nsplit, split, ws = _split_workspace(T, B, H, KVH, D, q.device)
    lib = _build.load("decode_attention")
    rc = lib.decode_attention_paged_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tab.data_ptr(), lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, H, KVH, maxb, D, _window(sliding_window),
        D ** -0.5, nsplit, split, _stream(q.device))
    _raise_rc("ragged_decode (paged)", rc)
    LAUNCHES["ragged_decode_paged"] += 1
    return out


def ragged_decode_q8(q, k_q, k_s, v_q, v_s, lengths, sliding_window=None,
                     table=None, kvt=None):
    """Decode-step GQA attention over an int8 cache (ops/kvcache.py layout).
    k_q/v_q: [B, KVH, T, D] int8 with T % 128 == 0; k_s/v_s: [B, KVH,
    T//128, 128] f32. Paged mode (`table` [B, MAXB] int): int8 pools [NB,
    KVH, 128, D] with scales [NB, KVH, 1, 128] (ops/paged.py). Returns
    [B, 1, H, D] in q's dtype.

    KV tier (paged only): `kvt` as ragged_decode's, without a cold tier
    (the reference keeps it to dense hot pools).

    On the card both modes are split-KV as ragged_decode's (the split
    pass's int8 flag), counted as one launch of "ragged_decode_q8" (paged
    mode: "ragged_decode_q8_paged", tiered "ragged_decode_q8_paged_tier")."""
    if q.device.type == "cpu":
        return ragged_decode_q8_plain(q, k_q, k_s, v_q, v_s, lengths,
                                      sliding_window, table=table, kvt=kvt)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_q8: unsupported device {q.device}")
    if kvt is not None:
        if "cold_tab" in kvt:
            raise ValueError("ragged_decode_q8: the cold tier needs a dense "
                             "hot pool")
        return _decode_tier(q, (k_q, k_s, v_q, v_s), lengths, table, kvt,
                            None)
    if table is not None:
        return _ragged_decode_q8_paged(q, k_q, k_s, v_q, v_s, lengths,
                                       sliding_window, table)
    T = k_q.shape[2]
    if T % 128:
        raise ValueError("int8 KV cache length must be a multiple of 128")
    B, H, KVH, T, D = _decode_checks("ragged_decode_q8", q, k_q.shape, T)
    if (v_q.shape != k_q.shape or k_s.shape != (B, KVH, T // 128, 128)
            or v_s.shape != k_s.shape):
        raise ValueError("ragged_decode_q8: bad cache/scale shapes")
    _check_cuda("ragged_decode_q8", (q, k_q, k_s, v_q, v_s),
                (None, torch.int8, torch.float32, torch.int8, torch.float32))
    lens = _on(lengths, torch.int32, q.device)
    out = torch.empty_like(q)
    nsplit, split, ws = _split_workspace(T, B, H, KVH, D, q.device)
    lib = _build.load("decode_attention")
    rc = lib.decode_attention_q8_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(),
        v_q.data_ptr(), v_s.data_ptr(), lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, H, KVH, T, D, _window(sliding_window), D ** -0.5,
        nsplit, split, _stream(q.device))
    _raise_rc("ragged_decode_q8", rc)
    LAUNCHES["ragged_decode_q8"] += 1
    return out


def _ragged_decode_q8_paged(q, k_q, k_s, v_q, v_s, lengths, sliding_window,
                            table):
    tab, maxb = _table_i32("ragged_decode_q8", table, q, k_q.shape)
    NB = k_q.shape[0]
    B, H, KVH, T, D = _decode_checks("ragged_decode_q8", q,
                                     (q.shape[0],) + tuple(k_q.shape[1:]),
                                     maxb * BLOCK)
    if (v_q.shape != k_q.shape or k_s.shape != (NB, KVH, 1, BLOCK)
            or v_s.shape != k_s.shape):
        raise ValueError("ragged_decode_q8: bad paged pool/scale shapes")
    _check_cuda("ragged_decode_q8", (q, k_q, k_s, v_q, v_s),
                (None, torch.int8, torch.float32, torch.int8, torch.float32))
    lens = _on(lengths, torch.int32, q.device)
    out = torch.empty_like(q)
    nsplit, split, ws = _split_workspace(T, B, H, KVH, D, q.device)
    lib = _build.load("decode_attention")
    rc = lib.decode_attention_q8_paged_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(),
        v_q.data_ptr(), v_s.data_ptr(), tab.data_ptr(), lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), B, H, KVH, maxb, D,
        _window(sliding_window), D ** -0.5, nsplit, split, _stream(q.device))
    _raise_rc("ragged_decode_q8 (paged)", rc)
    LAUNCHES["ragged_decode_q8_paged"] += 1
    return out


def _decode_tier(q, pools, lengths, table, kvt, cold_kv):
    """The tiered paged launch (decode_attention_tier_launch): pools (k,
    ks, v, vs) with ks/vs None for a bf16/f32 pool; the spans of
    tier_plan."""
    kp, ks, vp, vs = pools
    q8 = ks is not None
    name = "ragged_decode_q8" if q8 else "ragged_decode"
    if table is None:
        raise ValueError(f"{name}: the KV tier reads a paged pool (table)")
    tab, maxb = _table_i32(name, table, q, kp.shape)
    B, H, KVH, T, D = _decode_checks(name, q,
                                     (q.shape[0],) + tuple(kp.shape[1:]),
                                     maxb * BLOCK)
    dev = q.device
    geo = [_on(kvt[k], torch.int32, dev) for k in ("sb", "rw", "sinks",
                                                   "window")]
    for g in geo:
        if g.shape != (B,):
            raise ValueError(f"{name}: kvt geometry must be [B={B}]")
    if q8:
        NB = kp.shape[0]
        if (vp.shape != kp.shape or ks.shape != (NB, KVH, 1, BLOCK)
                or vs.shape != ks.shape):
            raise ValueError(f"{name}: bad paged pool/scale shapes")
        _check_cuda(name, (q, kp, ks, vp, vs),
                    (None, torch.int8, torch.float32, torch.int8,
                     torch.float32))
    else:
        _check_cuda(name, (q, kp, vp), (None, q.dtype, q.dtype))
    ctab = kvt.get("cold_tab")
    cold = (None, 0, None, None, None, None)
    if ctab is not None:
        if cold_kv is None:
            raise ValueError(f"{name}: kvt['cold_tab'] needs cold_kv")
        ck, cv = cold_kv
        ctab = _on(ctab, torch.int32, dev)
        if ctab.dim() != 2 or ctab.shape[0] != B:
            raise ValueError(f"{name}: cold_tab must be [B={B}, MBC]")
        nbc = ck.q.shape[0]
        if (ck.q.shape != (nbc, KVH, BLOCK, D) or cv.q.shape != ck.q.shape
                or ck.s.shape != (nbc, KVH, 1, BLOCK)
                or cv.s.shape != ck.s.shape):
            raise ValueError(f"{name}: bad cold pool shapes")
        _check_cuda(name, (q, ck.q, ck.s, cv.q, cv.s),
                    (None, torch.int8, torch.float32, torch.int8,
                     torch.float32))
        cold = (ctab, ctab.shape[1], ck.q, ck.s, cv.q, cv.s)
    ctab_t, mbc, ckq, cks, cvq, cvs = cold
    plan = tier_plan(maxb, mbc, B * KVH, _sm_count(dev), q8)
    lens = _on(lengths, torch.int32, dev)
    out = torch.empty_like(q)
    ws = torch.empty(B * H * (plan["nsplit"] + plan["nsplit_c"]) * (D + 2),
                     dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load("decode_attention")
    rc = lib.decode_attention_tier_launch(
        _DTYPE_CODE[q.dtype], int(q8), q.data_ptr(), kp.data_ptr(), ptr(ks),
        vp.data_ptr(), ptr(vs), tab.data_ptr(), lens.data_ptr(),
        *(g.data_ptr() for g in geo), ptr(ctab_t), mbc, ptr(ckq), ptr(cks),
        ptr(cvq), ptr(cvs), out.data_ptr(), ws.data_ptr(), B, H, KVH, maxb,
        D, D ** -0.5, plan["nsplit"], plan["split"], plan["split_f"],
        plan["nsplit_c"], plan["split_c"], _stream(dev))
    _raise_rc(f"{name} (tiered)", rc)
    LAUNCHES[name + "_paged_tier"] += 1
    return out
