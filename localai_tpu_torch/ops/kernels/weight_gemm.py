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
f32 activations run f32 FMAs. Split-K (not for the expert stacks),
with a workspace and an ordered combine by the tile's last split inside
the same launch, where the output tiles alone would not fill the card. No
weight is cast or copied per call: a weight that is not contiguous (or,
for the head, the transpose of a contiguous tensor) or not 16-byte
aligned raises. K and N must be multiples of 16.

The int4 twins run the same routes from a second build of
csrc/weight_gemm.cu (library "weight_gemm4", WG_INT4): the decode route
over K tiles of 128 (the bytes of int8's 64), the large-M route over TMA
tiles of [32][128] packed bytes; no SIMT route (f32 activations on int4
weights raise on the card; no recipe serves them). The plans stand as
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
            "w4a16_matmul": 0, "head_matmul_int4": 0, "moe_w4_matmul": 0}

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
    mma.sync) up to GEMV_ROWS rows, else the one of WGMMA_ROWS that puts
    waves of (row tile, column tile, expert) blocks times (rows + the
    conversion) lowest, the larger on a tie. No split-K."""
    if M <= GEMV_ROWS:
        return 0

    def cost(bm):
        blocks = -(-M // bm) * -(-N // WGMMA_BN) * E
        return -(-blocks // sms) * (bm + CONVERT_ROWS)

    return min(WGMMA_ROWS, key=lambda b: (cost(b), -b))


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


def _counters(device):
    """The card's split-K counters, one an output tile of a split call
    (gemm_split splits only calls of fewer tiles than the card's SMs hold
    blocks): int32 zeros, made at the card's first launch and left at zero
    by every launch (a tile's last split resets its counter). Made outside
    any CUDA graph capture, which would record the zeroing instead of
    doing it. Launches that overlap on two streams of one card would share
    them: the port runs its GEMMs on one stream at a time."""
    c = _COUNTERS.get(device.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("weight GEMMs: a card's first launch makes "
                               "its split-K counters and must not be "
                               "captured in a CUDA graph")
        c = _COUNTERS[device.index] = torch.zeros(
            max(PER_SM.values()) * _sm_count(device), dtype=torch.int32,
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


def _launch_w8(name, x2, q, s, out, epi):
    """Tensor-core routes: x2 [M, K] bf16/f16, q int8 [K, N] or packed
    int4 uint8 [K/2, N], s [N] f32."""
    M, K = x2.shape
    N = q.shape[1]
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
    function on the unpacked values)."""
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


def head_matmul(x32, w, s=None):
    """f32 logits [..., V] of x32 [..., K] f32 against the head w [K, V]:
    bf16/f16 (row-major, or `embed.T` of a tied row-major [V, K]
    embedding), int8 [K, V] or packed int4 uint8 [K/2, V] with scales s
    [1, V] f32 (counted as head_matmul_int4), or f32 (a plain product)."""
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
            _launch_simt(name, x2, w, None, out, nk=nk)
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


def _moe_launch(name, x, q, s, qdtype):
    """The expert GEMM on the card for an int8 or packed int4 stack."""
    E, K, N = _moe_checks(name, x, q, s, qdtype)
    _placement_checks(name, x, (q, s))
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    M = x.shape[0]
    out = torch.empty((M, E, N), dtype=x.dtype, device=x.device)
    if M:
        bm = moe_plan(M, N, K, E, _sm_count(x.device))
        qmap = _moe_map(q.data_ptr(), (E, K, N), qdtype) if bm else None
        rc = _build.load(_LIB[qdtype]).weight_gemm_moe_launch(
            _CODE[x.dtype], bm, x.data_ptr(), 1 if x.dim() == 2 else E,
            q.data_ptr(), None if qmap is None else ctypes.addressof(qmap),
            s.data_ptr(), out.data_ptr(), M, N, K, E, _stream(x.device))
        _raise_rc(name, rc)
        LAUNCHES[name] += 1
    return out
