"""Weight GEMMs that read the weights as they are stored, with their plain
PyTorch versions (counterparts of three products the reference leaves to
XLA, which fuses each weight's convert into its dot:
localai_tpu/ops/quant.py:78-80, localai_tpu/models/llama.py:347-364 and
the quantized expert einsums of localai_tpu/models/llama.py:383-409), for
int8 weights and for packed int4 weights.

Packed int4 (the int4/q4 recipe): q uint8 [..., K/2, N], byte (j, n)
holding element (2j, n) in its low nibble and (2j + 1, n) in its high
nibble, each a two's-complement value in [-7, 7]; scales f32 [..., 1, N]
as for int8. pack_int4 / unpack_int4 are the one place that knows the
layout (ops/quant quantizes through them). Each int8 wrapper has an int4
twin that computes the same function on the unpacked values:
w4a16_matmul (w8a16_matmul's), moe_w4_matmul (moe_w8_matmul's), and
head_matmul on a packed head (the int8 head's; counted apart, as
head_matmul_int4). K must be even.

Three int8 wrappers, each beside its plain version with the same
signature:
- w8a16_matmul / _plain — x [..., K] (bf16, f16 or f32) @ int8 q [K, N],
  then * s [1, N]: the int8 recipe's projections (ops/quant.qmatmul). The
  sum is taken in f32 and rounds once to x's dtype, the scale rounds to
  x's dtype, and their product rounds again — the reference's order.
- head_matmul / _plain — the f32 vocabulary projection
  (models/llama._lm_head): x32 [..., K] f32 against a bf16/f16 head [K, V],
  a tied embedding passed as `embed.T` (the transpose of a row-major
  [V, K]), or an int8 head (q [K, V], s [1, V]), for which x32 rounds to
  bf16 and the exact bf16 x int8 products sum in f32. An f32 head is a
  plain product (`x32 @ head`) on any device: there is no cast to save.
- moe_w8_matmul / _plain — Mixtral's int8 experts (models/llama._moe_mlp):
  x [M, K] shared by every expert (w1, w3) or [M, E, K], expert e's own
  rows (w2), against the stack q int8 [E, K, N] with scales s [E, 1, N] →
  [M, E, N] in x's dtype. Its rounding is the reference's dequantize then
  einsum: each weight element T(f32(q) * s) in x's dtype T, T x T
  products summed in f32, rounded once (not w8a16_matmul's scale after
  the sum). One launch a projection, the expert a grid axis; bf16
  activations on the card (the int8 recipe's; f16 and f32 raise), no
  split-K.

On the card all three run csrc/weight_gemm.cu. bf16/f16 activations
(the int8 head and the expert stacks too) take one of two tensor-core
routes, by M alone: up to 16 rows (decode) `mma.sync` with the weight
converted in registers, above that `wgmma` fed by TMA (a tensor map of
each weight is encoded once and kept here, x's is encoded at each call).
f32 activations run f32 FMAs, except a bf16 head above HEAD_SIMT_ROWS
rows (head_plan): x32 splits into three bf16 terms whose sum is x32
(split_bf16_terms, a kernel and a launch count of its own) and `wgmma`
multiplies the head with each, f32 sums — the same exact products as
the FMAs, in another order. Split-K (not for the expert stacks),
with a workspace and an ordered combine by the tile's last split inside
the same launch, where the output tiles alone would not fill the card. No
weight is cast or copied per call: a weight that is not contiguous (or,
for the head, the transpose of a contiguous tensor) or not 16-byte
aligned raises. K and N must be multiples of 16.

The int4 twins run the same routes from a second build of
csrc/weight_gemm.cu (library "weight_gemm4", WG_INT4): the decode route
over K tiles of 128 (the bytes of int8's 64), the large-M route over TMA
tiles of [32][128] packed bytes; no SIMT route (f32 activations on int4
weights raise on the card; no recipe serves them). The int4 expert
stacks at decode have a route of their own (moe4_plan): blocks of equal
ranges of (expert, column tile, K tile) units, each nibble converted
through f32 in fewer instructions, the tiles its blocks cut combined in
block order through a workspace and counters. The int4 projection and
head at decode run the decode route as a programmatic dependent launch
(_launch_w4, w4_plan's spans of W4_SPLIT_KT K tiles): a kernel's first
weight tile streams in under the previous kernel's tail, before it waits
for that grid and reads x. The plans stand as
int8's: the decode route's split counts its deeper tiles (w8_plan's
`bits`), the large-M route's row tile and split keep wgmma_cost, whose
terms (rows of x and the conversion a weight element, per K tile of 64)
do not change with the width, and whose bytes it does not count.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — no size threshold, probe or switch sends a
CUDA tensor elsewhere. Each launch adds one to its count in LAUNCHES, and
nothing else does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from localai_tpu_torch.ops.kernels import _build
from localai_tpu_torch.ops.kernels.flash_attention import (
    _raise_rc, _sm_count, _stream,
)

LAUNCHES = {"w8a16_matmul": 0, "head_matmul": 0, "moe_w8_matmul": 0,
            "w4a16_matmul": 0, "head_matmul_int4": 0, "moe_w4_matmul": 0,
            "split_bf16_terms": 0}

# csrc/weight_gemm.cu's dtype codes
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
         torch.int8: 3}
# the library of each weight storage: int8, or packed int4 (uint8)
_LIB = {torch.int8: "weight_gemm", torch.uint8: "weight_gemm4"}

# (rows, columns, K depth) of a block's tile on each route of
# csrc/weight_gemm.cu: the decode route takes all M <= GEMV_ROWS rows, the
# large-M route BM of WGMMA_ROWS rows a block (x's row tile), and the f32
# SIMT route 8 rows
GEMV_ROWS = 16
GEMV = (GEMV_ROWS, 128, 64)
GEMV4 = (GEMV_ROWS, 128, 128)  # int4: K tiles of the same bytes
WGMMA_ROWS = (64, 128, 192, 256)
WGMMA_BN, WGMMA_BK = 128, 64
SIMT = (8, 512, 16)
# blocks an SM takes in a split call's wave on each route: one of three
# warpgroups with a 200 KB ring (wgmma); two of the four-warp decode
# blocks, the split count nearest that (fewer leave SMs idle or unevenly
# loaded, more add split-K tails), and two SIMT blocks (a head's 251
# column tiles then take no split, whose combine cost more than it
# gained); chip timings in PERF.md §6
PER_SM = {"gemv": 2, "wgmma": 1, "simt": 2}
# the large-M route's cost model (w8_plan), in rows of x times K tiles: a
# block converts each weight element of its K tiles once, which costs about
# as much as CONVERT_ROWS more rows; with split-K, the tile's last split
# reads every split's partials, about COMBINE_ROWS rows a row a split
CONVERT_ROWS = 32
COMBINE_ROWS = 4
# K rows a split takes at least
SPLIT_MIN_K = 256
# the bf16 head (head_plan): up to HEAD_SIMT_ROWS rows of x the SIMT route
# (f32 FMAs, at 91% of its bytes bound at M = 4; its 8-row tiles read the
# head once a tile), above them the tensor cores on x's three bf16 terms,
# one of HEAD_ROWS rows of x a block (head_bn). The tensor cores took 0.391
# ms at M = 9 against SIMT's 0.617, 44.3 ms at M = 8192 against 283.8;
# SIMT 0.341 at M = 4 against 0.545. 64 rows a block against 128: 0.391
# against 0.633 ms at M = 9, 0.381 against 0.582 at 40, 1.01 against 1.33
# at 192; 0.756 against 0.620 at 65, 10.8 against 10.1 at 2048 (PERF.md
# §6, chip_gemm_sweep.py)
HEAD_SIMT_ROWS = 8
HEAD_ROWS = (64, 128)
HEAD_BN, HEAD_BK = 128, 64
# the int4 expert GEMM at decode (moe4_plan): units of 128 channels x
# MOE4_BK K rows of one expert (csrc MS_BK), over a grid of at least a
# block a tile and MOE4_PER_SM blocks an SM (one fewer above 8 rows,
# whose accumulators double)
MOE4_BK = 64
MOE4_PER_SM = 4
# the int4 projection and head at decode (w4_plan, _launch_w4): the decode
# route as a programmatic dependent launch (its first weight tile streams
# in under the previous kernel's tail), K split in spans of W4_SPLIT_KT
# tiles of 128 — small blocks, which start on the SMs the previous kernel
# frees — up to W4_BLOCKS_SM blocks an SM (the head's 1002 column tiles
# take no split). More blocks (4 an SM) were faster where projections
# follow each other, and slower after an elementwise kernel, the order of
# the 8B's w_gate, w_up and w_down; chip_gemm_sweep.py (PERF.md §6)
W4_SPLIT_KT = 4
W4_BLOCKS_SM = 2
# the card's counters: the split calls' (max(PER_SM) x SMs at most, one a
# block of a one-wave call) and one an (expert, column tile) of an int4
# expert stack at decode, up to MOE4_TILES (Mixtral-8x7B: 8 x 112)
MOE4_TILES = 4096


@functools.lru_cache(maxsize=None)
def gemm_split(M: int, N: int, K: int, tile: tuple, sms: int, per_sm: int,
               nearest: bool = False):
    """(splits, K tiles a split) of an [M, K] @ [K, N] call on `tile`'s
    route, whose blocks run per_sm to an SM: as many splits as keep all
    (row tile, column tile, split) blocks in one wave of per_sm * sms
    blocks (with `nearest`, the count nearest that), each split at least
    SPLIT_MIN_K deep, and none empty. Shapes only, so a call needs no
    device sync."""
    bm, bn, bk = tile
    blocks = -(-M // bm) * -(-N // bn)
    nk = -(-K // bk)
    want = max(1, (2 * per_sm * sms + blocks) // (2 * blocks) if nearest
               else per_sm * sms // blocks)
    per = max(-(-nk // want), min(nk, max(1, SPLIT_MIN_K // bk)))
    return -(-nk // per), per


def wgmma_cost(M: int, N: int, K: int, bm: int, sms: int) -> int:
    """The large-M route's cost of row tile bm (w8_plan's model): waves of
    blocks times a block's K tiles times its rows plus the conversion, and
    the last split's reads of every split's partials."""
    splits, per = gemm_split(M, N, K, (bm, WGMMA_BN, WGMMA_BK), sms,
                             PER_SM["wgmma"])
    blocks = -(-M // bm) * -(-N // WGMMA_BN) * splits
    cost = -(-blocks // sms) * per * (bm + CONVERT_ROWS)
    return cost + (splits * COMBINE_ROWS * bm if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def w8_plan(M: int, N: int, K: int, sms: int, bits: int = 8):
    """(route, tile, splits, K tiles a split) of an int8 (or, bits=4,
    packed int4) projection x [M, K] @ q [K, N] on the tensor cores. The
    route is a rule of M alone: "gemv" (mma.sync, the weight converted in
    registers) up to GEMV_ROWS rows, "wgmma" above. On the wgmma route
    the row tile is the one of WGMMA_ROWS that wgmma_cost puts lowest, the
    larger on a tie."""
    if M <= GEMV_ROWS:
        tile = GEMV4 if bits == 4 else GEMV
        return ("gemv", tile) + gemm_split(M, N, K, tile, sms,
                                           PER_SM["gemv"], nearest=True)
    bm = min(WGMMA_ROWS, key=lambda b: (wgmma_cost(M, N, K, b, sms), -b))
    tile = (bm, WGMMA_BN, WGMMA_BK)
    return ("wgmma", tile) + gemm_split(M, N, K, tile, sms, PER_SM["wgmma"])


@functools.lru_cache(maxsize=None)
def moe_plan(M: int, N: int, K: int, E: int, sms: int) -> int:
    """The expert GEMM's route, as a row tile: 0 (the decode route,
    mma.sync; a packed int4 stack takes moe4_plan's instead) up to
    GEMV_ROWS rows, else the one of WGMMA_ROWS that puts
    waves of (row tile, column tile, expert) blocks times (rows + the
    conversion) lowest, the larger on a tie. No split-K."""
    if M <= GEMV_ROWS:
        return 0

    def cost(bm):
        blocks = -(-M // bm) * -(-N // WGMMA_BN) * E
        return -(-blocks // sms) * (bm + CONVERT_ROWS)

    return min(WGMMA_ROWS, key=lambda b: (cost(b), -b))


def head_bn(M: int) -> int:
    """Rows of x a block of the bf16 head's tensor-core route: the one of
    HEAD_ROWS that pads M's rows least (the tensor cores' work), the
    larger on a tie (fewer reads of the head)."""
    return min(HEAD_ROWS, key=lambda b: (-(-M // b) * b, -b))


def head_route(route: str, M: int, V: int, K: int, sms: int):
    """(route, tile, splits, K tiles a split) of x32 [M, K] against a bf16
    or f16 head [K, V] on `route`: "simt" (f32 FMAs, 8 rows a block) or
    "wgmma" (x's three bf16 terms on the tensor cores, head_bn(M) rows a
    block, K tiles of 64); the split as gemm_split puts it for the route's
    blocks an SM."""
    if route == "simt":
        return ("simt", SIMT) + gemm_split(M, V, K, SIMT, sms,
                                           PER_SM["simt"])
    tile = (head_bn(M), HEAD_BN, HEAD_BK)
    return ("wgmma", tile) + gemm_split(M, V, K, tile, sms, PER_SM["wgmma"])


@functools.lru_cache(maxsize=None)
def head_plan(M: int, V: int, K: int, sms: int, dtype=torch.bfloat16):
    """The route of head_matmul on a bf16 or f16 head [K, V] (head_route's
    tuple), a rule of shapes and dtypes alone: a bf16 head above
    HEAD_SIMT_ROWS rows takes "wgmma", every other "simt". An f16 head
    stays on "simt" at every M: its product on the tensor cores would need
    x in f16 terms, and an f32 value outside f16's range (above 65504, or
    under its least subnormal 2^-24) has none. An int8 or packed int4 head
    is not this plan's: it takes w8_plan's routes (row 13's)."""
    route = "wgmma" if dtype == torch.bfloat16 and M > HEAD_SIMT_ROWS \
        else "simt"
    return head_route(route, M, V, K, sms)


@functools.lru_cache(maxsize=None)
def moe4_plan(M: int, N: int, K: int, E: int, sms: int):
    """(blocks, units, tiles) of the int4 expert GEMM at decode (M <= 16):
    units of (expert, 128 columns, MOE4_BK K rows), tiles of (expert, 128
    columns). Block b takes units [b*U/G, (b+1)*U/G) (csrc
    moe_w4_stream_kernel) of G blocks: a block a tile, or where the tiles
    are fewer than the card's MOE4_PER_SM slots an SM (one fewer above 8
    rows), a block a slot (w2's 256 tiles on 132 SMs: 528 blocks, each
    tile in parts); never more blocks than units. Mixtral-8x7B's w1/w3
    (896 tiles) took 0.115 ms on a block a tile, 0.120 on 528 blocks; w2
    0.118 on 528, 0.137 on a block a tile (PERF.md §6)."""
    tiles = E * -(-N // WGMMA_BN)
    units = tiles * -(-K // MOE4_BK)
    slots = (MOE4_PER_SM - (M > 8)) * sms
    return min(units, max(tiles, slots)), units, tiles


@functools.lru_cache(maxsize=None)
def w4_plan(N: int, K: int, sms: int):
    """(splits, K tiles a split) of the int4 projection or head at decode
    (M <= GEMV_ROWS) on the decode route's (column tile of 128, split)
    grid over K tiles of 128: spans of W4_SPLIT_KT tiles, as few more as
    keep the blocks within W4_BLOCKS_SM an SM, and no split where the
    column tiles alone exceed it. Shapes only, so a call needs no device
    sync."""
    tiles, nk = -(-N // GEMV4[1]), -(-K // GEMV4[2])
    splits = max(1, min(-(-nk // W4_SPLIT_KT), W4_BLOCKS_SM * sms // tiles))
    per = -(-nk // splits)
    return -(-nk // per), per


# --------------------------------------------------------- int4 packing

def pack_int4(q):
    """int8 values in [-8, 7] [..., K, N] (K even) -> the packed uint8
    [..., K/2, N]: K row 2j in the low nibble of byte row j, 2j + 1 in the
    high one, each as its two's-complement nibble."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 weights need an even K (input rows), got "
                         f"{q.shape[-2]}")
    u = (q.to(torch.int16) & 15).to(torch.uint8)
    return u[..., 0::2, :] | (u[..., 1::2, :] << 4)


def unpack_int4(p):
    """The packed uint8 [..., K/2, N] -> int8 values [..., K, N]."""
    lo = (p & 15).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    q = torch.stack([lo, hi], dim=-2)       # [..., K/2, 2, N]
    q = torch.where(q >= 8, q - 16, q)
    return q.reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1])


# ------------------------------------------------------------------ plain

def w8a16_matmul_plain(x, q, s):
    """Plain version of w8a16_matmul: the int8 weight cast to x's dtype,
    the product, then the scale in x's dtype (the reference's order)."""
    y = x @ q.to(x.dtype)
    return y * s.reshape((1,) * (y.ndim - 1) + (-1,)).to(y.dtype)


def w4a16_matmul_plain(x, q, s):
    """Plain version of w4a16_matmul: the packed weight unpacked to int8,
    then w8a16_matmul_plain's arithmetic."""
    return w8a16_matmul_plain(x, unpack_int4(q), s)


def moe_w4_matmul_plain(x, q, s):
    """Plain version of moe_w4_matmul: the packed stack unpacked to int8,
    then moe_w8_matmul_plain's arithmetic."""
    return moe_w8_matmul_plain(x, unpack_int4(q), s)


def moe_w8_matmul_plain(x, q, s):
    """Plain version of moe_w8_matmul: the reference's dequantize, (q in
    f32 * s) rounded to x's dtype, then its einsum over the experts."""
    w = (q.float() * s).to(x.dtype)
    if x.dim() == 2:
        return torch.einsum("mk,ekn->men", x, w)
    return torch.einsum("mek,ekn->men", x, w)


def split_bf16_terms_plain(x32):
    """Plain version of split_bf16_terms: x32 [..., K] f32 -> [3, ..., K]
    bf16 (hi, mid, lo). hi is x's f32 bits cut to their top 16 (a bf16:
    sign, exponent, 7 mantissa bits), mid the same cut of x - hi, lo of x
    - hi - mid; each difference is exact in f32. So hi + mid + lo == x
    exactly for every finite x whose bits lie at or above 2^-133 (bf16's
    least subnormal; every |x| >= 2^-110 and every zero, whose hi keeps
    its sign), and for smaller x the bits below 2^-133, which no bf16
    holds, are dropped (an error under 2^-133). A non-finite x: hi is x
    (+-inf, or NaN as 0x7fc0), mid = lo = 0, so the sum is x again. Bit for
    bit the card's split_terms_kernel."""
    mask = -65536                               # 0xffff0000 as int32
    b = x32.contiguous().view(torch.int32)
    finite = (b & 0x7f800000) != 0x7f800000
    hi = b & mask
    r1 = x32 - hi.view(torch.float32)           # exact
    b1 = r1.view(torch.int32)
    r2 = r1 - (b1 & mask).view(torch.float32)   # exact
    nan = 0x7fc00000
    hi = torch.where(finite, hi, torch.where((b & 0x007fffff) != 0,
                                             torch.full_like(b, nan), b))
    zero = torch.zeros_like(b)
    terms = [hi, torch.where(finite, b1, zero),
             torch.where(finite, r2.view(torch.int32), zero)]
    return torch.stack([(t >> 16).to(torch.int16).view(torch.bfloat16)
                        for t in terms])


def head_matmul_plain(x32, w, s=None):
    """Plain version of head_matmul: f32 logits of x32 against the head's
    f32 values; with `s` (an int8 or packed int4 head) x32 rounds to bf16
    first."""
    if s is not None:
        if w.dtype == torch.uint8:
            w = unpack_int4(w)
        y = x32.to(torch.bfloat16).float() @ w.float()
        return y * s.float()
    return x32 @ w.float()


# ------------------------------------------------------------ the checks

_ACT = (torch.bfloat16, torch.float16, torch.float32)


def _weight_checks(name, x, w, s, dtypes, qdtype=torch.int8):
    """(K, N, nk) of the weight w [K, N] (nk: w is the transpose of a
    row-major [N, K]); with scales s, w must be a contiguous `qdtype`
    weight: int8 [K, N], or uint8 [K/2, N] packed int4. Raises, naming the
    limit, on what the kernels do not take. Shapes, dtypes and layouts
    only (a meta tensor will do). Nothing is copied: a weight is used as
    it lies in memory."""
    if w.dim() != 2:
        raise ValueError(f"{name}: the weight must be 2-D [K, N], got "
                         f"{tuple(w.shape)}")
    if s is not None and (w.dtype != qdtype or not w.is_contiguous()):
        raise ValueError(
            f"{name}: the weight must be a contiguous "
            + ("packed int4 uint8 [K/2, N]" if qdtype == torch.uint8
               else "int8 [K, N]") + f", got {w.dtype}")
    K, N = w.shape
    if s is not None and qdtype == torch.uint8:
        K *= 2
    if x.shape[-1] != K:
        raise ValueError(f"{name}: x has {x.shape[-1]} features, the weight "
                         f"{K} rows")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: activations must be one of "
                        f"{[str(d) for d in dtypes]}, got {x.dtype}")
    if K % 16 or N % 16:
        raise ValueError(f"{name}: K ({K}) and N ({N}) must be multiples of "
                         f"16 (16-byte weight rows)")
    if s is not None:
        if s.dtype != torch.float32 or s.numel() != N \
                or not s.is_contiguous():
            raise ValueError(f"{name}: scales must be a contiguous f32 "
                             f"[1, {N}], got {s.dtype} {tuple(s.shape)}")
        return K, N, False
    if w.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: the weight must be bf16 or f16 (or int8 "
                        f"with scales), got {w.dtype}")
    nk = not w.is_contiguous()
    if nk and not w.t().is_contiguous():
        raise ValueError(f"{name}: the weight must be a row-major [K, N] or "
                         f"the transpose of a row-major [N, K]")
    return K, N, nk


def _moe_checks(name, x, q, s, qdtype=torch.int8):
    """(E, K, N) of the expert GEMM's stack q: int8 [E, K, N], or (qdtype
    uint8) packed int4 [E, K/2, N]; raises, naming the limit, on what its
    kernel does not take."""
    if q.dim() != 3 or q.dtype != qdtype or not q.is_contiguous():
        raise ValueError(
            f"{name}: the experts must be a contiguous "
            + ("packed int4 uint8 [E, K/2, N]" if qdtype == torch.uint8
               else "int8 [E, K, N]") + f", got {q.dtype} "
            f"{tuple(q.shape)}")
    E, K, N = q.shape
    if qdtype == torch.uint8:
        K *= 2
    if x.dim() not in (2, 3) or x.shape[-1] != K or (
            x.dim() == 3 and x.shape[1] != E):
        raise ValueError(f"{name}: x must be [M, {K}] or [M, {E}, {K}], "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: activations must be bf16 on the card, "
                        f"got {x.dtype}")
    if K % 16 or N % 16:
        raise ValueError(f"{name}: K ({K}) and N ({N}) must be multiples of "
                         f"16 (16-byte weight rows)")
    if s.dtype != torch.float32 or tuple(s.shape) != (E, 1, N) \
            or not s.is_contiguous():
        raise ValueError(f"{name}: scales must be a contiguous f32 "
                         f"[{E}, 1, {N}], got {s.dtype} {tuple(s.shape)}")
    return E, K, N


def _placement_checks(name, x, tensors):
    """The weights lie on x's card, 16-byte aligned (16-byte loads, TMA)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: weights must be 16-byte aligned")


def _rows(x, K):
    """x as a contiguous, 16-byte aligned [M, K] (an activation; a view
    that is neither is copied)."""
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    return x2


def _workspace(splits, M, N, device):
    return torch.empty(splits * M * N, dtype=torch.float32, device=device) \
        if splits > 1 else None


_COUNTERS: dict = {}


def counters_size(sms: int) -> int:
    """The counters a card holds: one an output tile of a split call
    (gemm_split splits only calls of at most max(PER_SM) x SMs blocks) and
    one an (expert, column tile) of an int4 expert stack at decode, whose
    cut tiles combine as split tiles do (at most MOE4_TILES)."""
    return max(max(PER_SM.values()) * sms, MOE4_TILES)


def _counters(device):
    """The card's split-K counters (counters_size): int32 zeros, made at
    the card's first launch and left at zero by every launch (a tile's
    last split resets its counter). Made outside any CUDA graph capture,
    which would record the zeroing instead of doing it. Launches that
    overlap on two streams of one card would share them: the port runs
    its GEMMs on one stream at a time."""
    c = _COUNTERS.get(device.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("weight GEMMs: a card's first launch makes "
                               "its split-K counters and must not be "
                               "captured in a CUDA graph")
        c = _COUNTERS[device.index] = torch.zeros(
            counters_size(_sm_count(device)), dtype=torch.int32,
            device=device)
    return c


@functools.lru_cache(maxsize=4096)
def _weight_map(ptr: int, shape: tuple, dtype) -> ctypes.Array:
    """The large-route tensor map (128 bytes, host memory) of the weight at
    ptr of `shape` (K, N) in elements: int8 [K, N], or packed int4 (dtype
    uint8) [K/2, N]. A weight lives for the process, so its map is encoded
    once. The map holds only the address, the shape and the width, so a
    key names one map."""
    buf = ctypes.create_string_buffer(128)
    rc = _build.load(_LIB[dtype]).weight_gemm_tmap(
        ptr, shape[0], shape[1], ctypes.addressof(buf))
    _raise_rc("weight tensor map", rc)
    return buf


@functools.lru_cache(maxsize=4096)
def _moe_map(ptr: int, shape: tuple, dtype) -> ctypes.Array:
    """The large-route tensor map of the expert stack at ptr of `shape`
    (E, K, N) in elements (int8, or packed int4 [E, K/2, N]), encoded once
    a stack (as _weight_map)."""
    buf = ctypes.create_string_buffer(128)
    rc = _build.load(_LIB[dtype]).weight_gemm_moe_tmap(
        ptr, shape[0], shape[1], shape[2], ctypes.addressof(buf))
    _raise_rc("expert tensor map", rc)
    return buf


@functools.lru_cache(maxsize=4096)
def _head_map(ptr: int, shape: tuple, nk: bool) -> ctypes.Array:
    """The tensor-core route's map of the bf16 head at ptr of `shape` (K,
    V): a row-major [K, V], or (nk) the transpose of a row-major [V, K]
    tied embedding; encoded once a head (as _weight_map)."""
    buf = ctypes.create_string_buffer(128)
    rc = _build.load("weight_gemm").weight_gemm_head_tmap(
        ptr, int(nk), shape[0], shape[1], ctypes.addressof(buf))
    _raise_rc("head tensor map", rc)
    return buf


def _launch_head(name, x2, w, out, nk, plan):
    """A bf16/f16 head on `plan`'s route (head_route): x2 [M, K] f32, w
    [K, V] (nk: the transpose of a row-major [V, K])."""
    route, tile, splits, per = plan
    if route == "simt":
        _launch_simt(name, x2, w, None, out, nk)
        return
    if w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the tensor-core route takes a bf16 head, "
                        f"got {w.dtype}")
    M, K = x2.shape
    V = w.shape[1]
    xs = split_bf16_terms(x2)
    hmap = _head_map(w.data_ptr(), (K, V), bool(nk))
    ws = _workspace(splits, M, V, x2.device)
    rc = _build.load("weight_gemm").weight_gemm_head_launch(
        int(nk), tile[0], xs.data_ptr(), ctypes.addressof(hmap),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        _counters(x2.device).data_ptr(), M, V, K, splits, per,
        _stream(x2.device))
    _raise_rc(name, rc)


def _launch_w4(name, x2, q, s, out, epi):
    """The int4 projection (epi 0) or head (epi 1) at decode: x2 [M, K]
    bf16/f16 (M <= GEMV_ROWS), q packed int4 [K/2, N], s [N] f32, on the
    decode route's kernel over w4_plan's (column tile, split) grid, as a
    programmatic dependent launch. Its first weight tile is read before
    the previous kernel on the stream has finished, so that kernel must
    not write q (a weight packed on the card needs another kernel, or a
    synchronize, between its packing and its first projection)."""
    M, K = x2.shape
    N = q.shape[1]
    nsp, per = w4_plan(N, K, _sm_count(x2.device))
    ws = _workspace(nsp, M, N, x2.device)
    rc = _build.load("weight_gemm4").weight_gemm_w4_launch(
        _CODE[x2.dtype], epi, x2.data_ptr(), q.data_ptr(), s.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        _counters(x2.device).data_ptr(), M, N, K, nsp, per,
        _stream(x2.device))
    _raise_rc(name, rc)


def _launch_w8(name, x2, q, s, out, epi):
    """Tensor-core routes: x2 [M, K] bf16/f16, q int8 [K, N] or packed
    int4 uint8 [K/2, N], s [N] f32. Packed int4 at decode takes
    _launch_w4."""
    M, K = x2.shape
    N = q.shape[1]
    if q.dtype == torch.uint8 and M <= GEMV_ROWS:
        _launch_w4(name, x2, q, s, out, epi)
        return
    route, tile, splits, per = w8_plan(M, N, K, _sm_count(x2.device),
                                       4 if q.dtype == torch.uint8 else 8)
    ws = _workspace(splits, M, N, x2.device)
    wsp = None if ws is None else ws.data_ptr()
    cnt = _counters(x2.device).data_ptr()
    lib = _build.load(_LIB[q.dtype])
    if route == "gemv":
        rc = lib.weight_gemm_gemv_launch(
            _CODE[x2.dtype], epi, x2.data_ptr(), q.data_ptr(), s.data_ptr(),
            out.data_ptr(), wsp, cnt, M, N, K, splits, per,
            _stream(x2.device))
    else:
        qmap = _weight_map(q.data_ptr(), (K, N), q.dtype)
        rc = lib.weight_gemm_wgmma_launch(
            _CODE[x2.dtype], epi, tile[0], x2.data_ptr(),
            ctypes.addressof(qmap), s.data_ptr(), out.data_ptr(), wsp, cnt,
            M, N, K, splits, per, _stream(x2.device))
    _raise_rc(name, rc)


def _launch_simt(name, x2, w, s, out, nk):
    """SIMT route: x2 [M, K] f32; w int8/bf16/f16 [K, N] (nk: the
    transpose of a row-major [N, K]); s [N] f32 or None."""
    M, K = x2.shape
    N = w.shape[1]
    splits, per = gemm_split(M, N, K, SIMT, _sm_count(x2.device),
                             PER_SM["simt"])
    ws = _workspace(splits, M, N, x2.device)
    rc = _build.load("weight_gemm").weight_gemm_simt_launch(
        _CODE[w.dtype], int(nk), x2.data_ptr(), w.data_ptr(),
        None if s is None else s.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        _counters(x2.device).data_ptr(), M, N, K, splits, per,
        _stream(x2.device))
    _raise_rc(name, rc)


# --------------------------------------------------------------- wrappers

def w8a16_matmul(x, q, s):
    """x [..., K] (bf16, f16 or f32) @ int8 q [K, N] with per-output-
    channel scales s [1, N] f32 → [..., N] in x's dtype, computed as
    w8a16_matmul_plain computes it: f32 sums, rounded once to x's dtype,
    times s in x's dtype."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, q, s)
    name = "w8a16_matmul"
    K, N, _ = _weight_checks(name, x, q, s, _ACT)
    _placement_checks(name, x, (q, s))
    x2 = _rows(x, K)
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        if x.dtype == torch.float32:
            _launch_simt(name, x2, q, s, out, nk=False)
        else:
            _launch_w8(name, x2, q, s, out, epi=0)
        LAUNCHES[name] += 1
    return out.reshape(*x.shape[:-1], N)


def w4a16_matmul(x, q, s):
    """x [..., K] (bf16 or f16; f32 on the CPU only) @ packed int4 q uint8
    [K/2, N] with per-output-channel scales s [1, N] f32 → [..., N] in x's
    dtype, computed as w4a16_matmul_plain computes it (w8a16_matmul's
    function on the unpacked values). On the card, up to GEMV_ROWS rows
    of x launch as a programmatic dependent launch that reads q before
    the previous kernel on the stream has finished: that kernel must not
    write q (_launch_w4)."""
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, q, s)
    name = "w4a16_matmul"
    K, N, _ = _weight_checks(name, x, q, s, _ACT[:2], qdtype=torch.uint8)
    _placement_checks(name, x, (q, s))
    x2 = _rows(x, K)
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        _launch_w8(name, x2, q, s, out, epi=0)
        LAUNCHES[name] += 1
    return out.reshape(*x.shape[:-1], N)


def split_bf16_terms(x32):
    """x32 [M, K] f32 -> [3, M, K] bf16, the terms hi, mid, lo of each
    value as split_bf16_terms_plain defines them (their sum is x32). On
    the card one launch of split_terms_kernel (csrc/weight_gemm.cu), into
    a buffer allocated on the stream; x32 contiguous and 16-byte aligned,
    K a multiple of 4."""
    if x32.device.type == "cpu":
        return split_bf16_terms_plain(x32)
    name = "split_bf16_terms"
    if x32.dtype != torch.float32 or x32.dim() != 2 \
            or not x32.is_contiguous() or x32.data_ptr() % 16 \
            or x32.shape[1] % 4:
        raise ValueError(f"{name}: x32 must be a contiguous, 16-byte "
                         f"aligned f32 [M, K] with K % 4 == 0, got "
                         f"{x32.dtype} {tuple(x32.shape)}")
    M, K = x32.shape
    xs = torch.empty((3, M, K), dtype=torch.bfloat16, device=x32.device)
    if M:
        rc = _build.load("weight_gemm").weight_gemm_split_launch(
            x32.data_ptr(), xs.data_ptr(), M, K, _stream(x32.device))
        _raise_rc(name, rc)
        LAUNCHES[name] += 1
    return xs


def head_matmul(x32, w, s=None):
    """f32 logits [..., V] of x32 [..., K] f32 against the head w [K, V]:
    bf16/f16 (row-major, or `embed.T` of a tied row-major [V, K]
    embedding), int8 [K, V] or packed int4 uint8 [K/2, V] with scales s
    [1, V] f32 (counted as head_matmul_int4), or f32 (a plain product).
    On the card a bf16 or f16 head takes head_plan's route: f32 FMAs, or
    above HEAD_SIMT_ROWS rows of a bf16 head the tensor cores on x32's
    three bf16 terms (split_bf16_terms, one more launch, counted apart).
    An int4 head at up to GEMV_ROWS rows reads w as w4a16_matmul does,
    before the previous kernel on the stream (x32's cast) has finished."""
    if x32.device.type == "cpu":
        return head_matmul_plain(x32, w, s)
    if s is None and w.dtype == torch.float32:
        return x32 @ w
    packed = s is not None and w.dtype == torch.uint8
    name = "head_matmul_int4" if packed else "head_matmul"
    K, V, nk = _weight_checks(name, x32, w, s, (torch.float32,),
                              qdtype=torch.uint8 if packed else torch.int8)
    _placement_checks(name, x32, (w,) if s is None else (w, s))
    x2 = _rows(x32, K)
    out = torch.empty((x2.shape[0], V), dtype=torch.float32,
                      device=x32.device)
    if x2.shape[0]:
        if s is not None:
            _launch_w8(name, x2.to(torch.bfloat16), w, s, out, epi=1)
        else:
            _launch_head(name, x2, w, out, nk, head_plan(
                x2.shape[0], V, K, _sm_count(x32.device), w.dtype))
        LAUNCHES[name] += 1
    return out.reshape(*x32.shape[:-1], V)


def moe_w8_matmul(x, q, s):
    """Every expert's product with Mixtral's int8 stack: x [M, K] (one x
    for every expert) or [M, E, K] (expert e's rows) against q int8 [E, K,
    N] with scales s f32 [E, 1, N] → [M, E, N] in x's dtype, computed as
    moe_w8_matmul_plain computes it: each weight element rounded to x's
    dtype as T(f32(q) * s), f32 sums rounded once. One launch for every
    expert."""
    if x.device.type == "cpu":
        return moe_w8_matmul_plain(x, q, s)
    return _moe_launch("moe_w8_matmul", x, q, s, torch.int8)


def moe_w4_matmul(x, q, s):
    """moe_w8_matmul's function on Mixtral's packed int4 stack q uint8 [E,
    K/2, N] (scales s f32 [E, 1, N]), computed as moe_w4_matmul_plain
    computes it. One launch for every expert."""
    if x.device.type == "cpu":
        return moe_w4_matmul_plain(x, q, s)
    return _moe_launch("moe_w4_matmul", x, q, s, torch.uint8)


def _launch_moe4(name, x, q, s, out, blocks):
    """The int4 expert GEMM at decode on a grid of `blocks`
    (moe4_plan): x [M, K] or [M, E, K] bf16, q [E, K/2, N] packed, s [E,
    1, N]; its cut tiles' parts in a workspace of 2 x M x 128 f32 a block,
    a counter an (expert, column tile)."""
    E, _, N = q.shape
    M, K = x.shape[0], x.shape[-1]
    tiles = E * -(-N // WGMMA_BN)
    cnt = _counters(x.device)
    if tiles > cnt.numel():
        raise ValueError(f"{name}: {tiles} (expert, column tile) tiles "
                         f"exceed the card's {cnt.numel()} counters")
    ws = torch.empty(blocks * 2 * M * WGMMA_BN, dtype=torch.float32,
                     device=x.device)
    rc = _build.load("weight_gemm4").weight_gemm_moe4_launch(
        x.data_ptr(), 1 if x.dim() == 2 else E, q.data_ptr(), s.data_ptr(),
        out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), M, N, K, E, blocks,
        _stream(x.device))
    _raise_rc(name, rc)


def _moe_launch(name, x, q, s, qdtype):
    """The expert GEMM on the card for an int8 or packed int4 stack."""
    E, K, N = _moe_checks(name, x, q, s, qdtype)
    _placement_checks(name, x, (q, s))
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    M = x.shape[0]
    out = torch.empty((M, E, N), dtype=x.dtype, device=x.device)
    if not M:
        return out
    if qdtype == torch.uint8 and M <= GEMV_ROWS:
        _launch_moe4(name, x, q, s, out, moe4_plan(
            M, N, K, E, _sm_count(x.device))[0])
    else:
        bm = moe_plan(M, N, K, E, _sm_count(x.device))
        qmap = _moe_map(q.data_ptr(), (E, K, N), qdtype) if bm else None
        rc = _build.load(_LIB[qdtype]).weight_gemm_moe_launch(
            _CODE[x.dtype], bm, x.data_ptr(), 1 if x.dim() == 2 else E,
            q.data_ptr(), None if qmap is None else ctypes.addressof(qmap),
            s.data_ptr(), out.data_ptr(), M, N, K, E, _stream(x.device))
        _raise_rc(name, rc)
    LAUNCHES[name] += 1
    return out
