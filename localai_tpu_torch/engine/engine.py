"""Slot-based continuous-batching serving engine (counterpart of
localai_tpu/engine/engine.py), main-path slice.

What this slice serves, as the reference does:
- a dense per-slot KV cache (kv_pages=0), or the paged block pool
  (kv_pages > 0, ops/paged.py): a host-side allocator hands 128-token
  blocks to slots through a [B, MAXB] table, reserving prompt + max_tokens
  at admission (admission defers, FIFO, while the pool is exhausted),
  retaining a released slot's cached blocks as a warm prefix and sharing
  full blocks across slots through a content-hash prefix index with
  copy-on-write;
- bucketed, batched burst admission (one prefill pass per same-bucket
  group) and chunked prefill through `extend` for prompts longer than the
  largest bucket;
- three decode dispatch paths: the single step (sample, then decode), the
  `decode_block` path stop-string slots keep, and the fused decode loop
  (decode_loop=64) with per-slot EOS / max_tokens / context-margin stops
  on the device, frozen slots and a [steps, B] token ring. The fused
  loops run in segments of 8 steps over fixed tensors (LoopState), each
  segment on the card one CUDA graph replay (engine/graphs.py);
- ragged continuous batching (ragged_token_budget > 0, paged only): every
  admission is chunked, and a tick with prefill work packs every decode
  slot plus prefill-chunk windows into one flat token stream served by one
  `ragged_forward` — as the fused ragged loop (ragged_loop_steps=16: the
  pack, then decode steps until a slot finishes, prefill is pending or the
  step cap) or, for stop-string slots, a single step; pure-decode ticks
  take the same loop without a pack;
- speculative decoding (draft=(draft_cfg, draft_params), engine/spec.py):
  every step the draft proposes ec.gamma tokens a slot from its own dense
  cache and the target verifies each slot's window in one forward — an
  `extend` on a dense or paged cache, or, on a ragged engine, gamma+1 rows
  of the flat stream beside other slots' prefill chunks (spec-as-ragged,
  which also carries table-backed grammars); the first token is sampled
  at admission. Draft engines take no prefix cache, no batched admission
  and no fused loop;
- grammar-constrained decoding (GenRequest.grammar, a GBNF string; the
  native matcher in functions/matcher.py): a grammar whose automaton fits
  the shared device tables (grammar_table_states rows: masks
  [S, ceil(V/32)] and transitions [S, V], allocated once and written in
  place at each install) rides the fused loops and the ragged loop, the
  device gathering each step's mask row and advancing the slot's state; a
  grammar that overflows them is host-masked and takes the single step or
  the block path (sampled under the block-start masks, rolled back at the
  first token the matcher rejects — _repair), which bars both loops;
- the host KV spill tier (kv_host_bytes > 0 or Engine(kvhost=pool), paged
  only, engine/kvhost.py): a registered block the device pool is about to
  lose (its last reference dropped, a reclaimed slot's chain, a block
  about to be rewritten) is copied to host memory in int8 first, and an
  admission extends its device prefix-cache match with host hits, written
  back into fresh pages ahead of the suffix's prefill;
- the KV lifecycle tier (kv_policy "sink_window(sinks=N, window=W[,
  quantize_cold=true])", paged only, engine/kvtier.py): a windowed slot
  holds sink blocks plus a ring of blocks reused in place, so its
  residency is O(sinks + window) for any length; blocks whose tokens leave
  the window are dropped (kv_evictions) or, with quantize_cold, demoted to
  an int8 cold pool (kv_cold_blocks) that attention keeps reading. The
  per-slot geometry (full-policy sentinels for the others) lives in fixed
  device tensors written in place before each dispatch (_kvt), so one set
  of kernels and captured graphs serves any mix of policies;
- preemption and resume (Engine.preempt, GenRequest.resume,
  engine/resume.py): preempt freezes every live slot at a tick boundary,
  force-spills its full KV blocks, reads back its RNG key and ends its
  stream with a terminal "preempted" StepOutput carrying a ResumeToken; a
  resume is a normal request over prompt + emitted that installs the key
  and replays the grammar and the detokenizer, sending no text twice;
- context shift (GenRequest.context_shift, llama.cpp's ctx_shift): at
  the context cap a shifting slot keeps its sink tokens, evicts the next
  stretch and slides the rest left in place, K re-rotated to its new
  positions (models/llama.cache_shift; paged engines permute the slot's
  table row and rotate only K's tail blocks, cache_shift_paged), and
  decodes on; every length the host keeps subtracts the slot's shifted
  tokens, and a shifted slot is never retained, registered, spilled or
  saved;
- the disk prompt cache (GenRequest.prompt_cache_path / prompt_cache_ro,
  dense engines): a prompt's KV rows are saved at release in the
  reference's file format and restored at a later admission whose prompt
  shares the file's prefix (the suffix takes the chunked extend path);
- multimodal prompts (GenRequest.mm_embeds / mm_positions: image
  features from models/llava.py): the feature rows replace their token
  embeddings through an (extra, is_embed) inject pair on the dense
  admission's prefill, the chunked extend and the ragged packs (spec-as-
  ragged included; a ragged pack with feature rows takes the single-step
  dispatch, not the fused loop); such a prompt takes no slot, block, host
  or disk prefix reuse and registers, records, spills and saves nothing;
- host side: pipelined dispatch with an async device→host fetch of the
  token ring (pinned memory + a CUDA event), stop strings with holdback,
  logprobs, EOS, deadline, cancel, and the in-memory slot prompt cache;
- tensor parallelism on the `model` axis (EngineConfig.mesh, a
  parallel/mesh.Mesh; params sharded on it by models/llama.shard_params
  or the loader): one process a rank, each holding its shards and its
  num_kv_heads // tp heads of the cache, on the dense, paged and ragged
  paths in f32/bf16 and the int8 recipe. Rank 0 runs this engine with a
  `replicator` (parallel/distributed.Replicator) and broadcasts (op, host
  args) before every device dispatch (`_bcast`: the reference's op names
  and keys, plus the paged block table the followers' engines do not
  allocate); every other rank runs `follow(channel)`, replaying the same
  dispatches on its shards, so the ranks' kernels and collectives stay in
  lockstep. On a mesh the fused loops' segments run eagerly
  (graphs.EagerSegments: a gloo collective cannot be captured in a CUDA
  graph). The speculative draft, the KV retention and host tiers,
  preemption and resume, context shift, the disk prompt cache, grammars,
  multimodal prompts and Mixtral's experts raise under a mesh, naming the
  parallel slice.

Every EngineConfig/GenRequest/StepOutput field of the reference is kept.
Those this slice does not serve are rejected with NotImplementedError
naming the slice they wait for; none is silently ignored. The engine runs
on the CUDA device unless `device="cpu"` is passed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import queue
import threading
import time
import weakref
from typing import Any, Iterator

import numpy as np
import torch

from localai_tpu_torch import not_ported
from localai_tpu_torch.device import resolve_device, torch_dtype
from localai_tpu_torch.engine import kvtier
from localai_tpu_torch.engine.graphs import EagerSegments, GraphRunner
from localai_tpu_torch.models.llama import (
    LlamaConfig,
    LoopState,
    build_decode_loop,
    build_ragged_loop,
    cache_shift,
    cache_shift_paged,
    decode_step,
    extend,
    init_kv_cache,
    kv_heads,
    loop_segment,
    prefill,
    ragged_forward,
    segment_lengths,
    shift_rotation,
)
from localai_tpu_torch.ops.kernels import QBLK, demote_targets, paged_demote_q8
from localai_tpu_torch.ops.kvcache import QuantKV, quantize_tokens
from localai_tpu_torch.ops.paged import BLOCK, blocks_needed, init_paged
from localai_tpu_torch.ops.rope import rope_table
from localai_tpu_torch.ops.sampling import (
    FIELD_DTYPES,
    SamplerState,
    SamplingParams,
    sample,
    sampler_row,
    threefry_seed,
)
from localai_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape knobs — the reference's fields and defaults."""
    max_slots: int = 4            # n_parallel — concurrent sequences
    max_context: int = 1024       # n_ctx per slot
    prefill_buckets: tuple[int, ...] = (64, 256, 1024)
    prefill_chunk: int = 256      # chunked-prefill window (tokens/engine tick)
    pipeline: bool = True         # keep one decode dispatch in flight
    decode_block: int = 16        # decode steps fused per block dispatch
    decode_loop: int = 64         # fused decode loop steps (0/1 disables)
    dtype: str | None = None      # KV dtype (default: model dtype)
    cache_type: str = ""          # ""|bf16 dense; int8|q8_0 quantized KV
    mesh: Any | None = None       # tensor parallelism: this rank's
                                  # parallel/mesh.Mesh (model axis only)
    shift_keep: int = 4           # context shift: sink tokens always kept
                                  # (paged: rounded up to whole blocks)
    replicator: Any | None = None  # rank 0 of a mesh: the dispatch
                                   # broadcaster (parallel/distributed)
    gamma: int = 4                # speculative: draft tokens per step
    prompt_cache: bool = True     # reuse a freed slot's KV prefix
    prompt_cache_min: int = 16    # minimum shared prefix worth reusing
    sampling_topk_width: int = 64  # sort-free decode sampling width
    admit_per_tick: int = 4       # admission/prefill units per engine tick
    kv_pages: int = 0             # paged KV: physical 128-token blocks in the
                                  # pool, trash block 0 included (0 = dense)
    ragged_token_budget: int = 0  # ragged batching: flat-stream rows per
                                  # mixed tick (paged KV only; 0 = off)
    ragged_loop_steps: int = 16   # fused ragged ticks: steps per ragged
                                  # dispatch (0/1 = single step; only read
                                  # on ragged engines)
    grammar_table_states: int = 256  # device grammar tables: shared rows
                                     # (automaton states across live
                                     # grammars; 0 = every grammar slot is
                                     # host-masked)
    kv_policy: str = "full"       # KV lifecycle tier (engine/kvtier.py):
                                  # "full" keeps every block hot (the
                                  # untiered engine); "sink_window(sinks=N,
                                  # window=W[, quantize_cold=true])" switches
                                  # the paged table to COMPACT ring geometry
                                  # — O(sinks+window) resident blocks per
                                  # slot for any context length. Requires
                                  # kv_pages; per-request policies
                                  # (GenRequest.kv_policy) may only shrink it
    kv_cold_pages: int = 0        # quantize_cold: 128-token blocks of the
                                  # int8 cold pool (index 0 = "not demoted"
                                  # included); a full cold pool falls back
                                  # to eviction (kv_evictions)
    kv_host_bytes: int = 0        # host KV spill tier: byte budget of the
                                  # HostKVPool (int8 blocks keyed by the
                                  # prefix cache's chain hashes; paged KV
                                  # only; 0 = off)
    max_restarts: int = 2         # fatal step() errors survived (none
                                  # on a mesh)


@dataclasses.dataclass
class GenRequest:
    """One generation request — the reference's fields."""
    prompt_ids: list[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    max_tokens: int = 128
    stop: tuple[str, ...] = ()
    ignore_eos: bool = False
    logprobs: bool = False
    grammar: str = ""             # GBNF; enforced through the matcher
    context_shift: bool = False   # evict-and-continue past max_context
                                  # (llama.cpp's ctx_shift)
    prompt_cache_path: str = ""   # persist and reuse this prompt's KV on
                                  # disk (dense engines)
    prompt_cache_ro: bool = False  # reuse only; never rewrite the file
    trace_id: str = ""            # request id from the HTTP layer
    trace_parent: int = 0
    deadline: float = 0.0         # absolute time.monotonic(); 0 = none
    kv_policy: str = ""           # per-request KV retention ("" = the
                                  # engine's): "full" or "sink_window(
                                  # sinks=N, window=W)"; a windowed request
                                  # needs a windowed engine and may only
                                  # shrink its geometry
                                  # (kvtier.resolve_policy)
    mm_embeds: Any = None         # [K, H] f32 image-feature rows that
                                  # replace the token embeddings at
    mm_positions: Any = None      # [K] strictly increasing prompt
                                  # positions (models/llava.py)
    queued_t: float = 0.0         # time.monotonic() at submit()
    resume: dict | None = None    # ResumeToken.payload(): prompt_ids is
                                  # prompt + emitted; "emitted" counts the
                                  # trailing checkpoint tokens, "key"
                                  # restores the slot's RNG key,
                                  # "sent_chars" the text already sent


@dataclasses.dataclass
class StepOutput:
    """One streamed chunk."""
    request_id: int
    text: str
    token_id: int
    logprob: float
    finished: bool
    finish_reason: str | None = None   # stop | length | eos | ...
    generated_tokens: int = 0
    prompt_tokens: int = 0
    timings: dict | None = None        # telemetry slice (None here)
    resume: dict | None = None         # ResumeToken.to_dict() on the
                                       # terminal "preempted" chunk


@dataclasses.dataclass
class _Slot:
    request_id: int
    req: GenRequest
    out: queue.Queue
    detok: Any                       # _IncrementalDecoder | None
    pending_text: str = ""           # holdback buffer for stop-string scan
    sent_chars: int = 0              # detok chars released downstream since
                                     # the ORIGINAL prompt boundary (across
                                     # resume segments; pending_text, which
                                     # a resume replays, excluded)
    resume_base: int = 0             # emitted-chain tokens replayed into the
                                     # prompt at resume admission; a second
                                     # preempt folds them back into the
                                     # checkpoint's emitted list
    generated: int = 0
    gen_ids: list[int] = dataclasses.field(default_factory=list)
    start_time: float = 0.0
    first_token_time: float | None = None
    prompt_len: int = 0
    prefilled: bool = True           # False while chunked prefill in progress
    prefill_pos: int = 0             # prompt tokens already written to KV
    row: Any = None                  # sampler row (installed at final chunk)
    counts_row: Any = None
    fast_w: int | None = None        # narrowest sort-free top-k width
    inflight: int = 0                # tokens reserved by in-flight dispatches
    matcher: Any = None              # grammar MatcherState | None
    gbase: int | None = None         # base row of this slot's grammar in the
                                     # device tables; None = host-masked
                                     # (the automaton overflowed them, or
                                     # grammar_table_states is 0)
    shifted: int = 0                 # tokens evicted by context shifts
    disk_prefix: int = 0             # prefix length loaded from the disk
                                     # prompt cache


def _check_config(ec: EngineConfig):
    if ec.ragged_token_budget > 0 and ec.kv_pages <= 0:
        # the flat-stream KV writes resolve through block tables
        raise ValueError(
            "ragged_token_budget requires paged KV (set kv_pages)")
    if ec.mesh is not None:
        if not isinstance(ec.mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(ec.mesh).__name__}")
        for field, what in (
                ("kv_host_bytes", "the host KV tier"),
                ("kv_cold_pages", "the KV retention tier's cold pool")):
            if getattr(ec, field):
                raise not_ported(f"{what} under a mesh", "parallel")
        if kvtier.parse_policy(ec.kv_policy).windowed:
            raise not_ported("the KV retention tier under a mesh",
                             "parallel")
    elif ec.replicator is not None:
        # a replicator drives ranks that shard one model; ranks that each
        # hold the whole model are replicas (the data axis)
        raise not_ported("a replicator without a mesh (data-parallel "
                         "replicas)", "parallel")


class _AsyncFetch:
    """Async device→host fetch of a dispatch's small outputs: each tensor's
    copy into pinned host memory (new, or the buffers `out`) is enqueued
    the moment the dispatch is, with a CUDA event behind it, so block N's
    tokens land while block N+1 computes; `wait()` syncs on the event
    only. CPU tensors are already on the host."""

    __slots__ = ("_host", "_event", "_extra")

    def __init__(self, tensors, extra=(), out=None):
        self._extra = tuple(extra)
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = list(out) if out is not None else [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.clone() for t in tensors]

    def wait(self):
        """Host numpy arrays in input order (plus any extra host values)."""
        return tuple(h.numpy() for h in self.tensors()) + self._extra

    def tensors(self) -> list:
        """The host tensors in input order (pinned when fetched from the
        card), once their copies have landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host


class _PinnedBlocks:
    """Pinned host buffers for spilled blocks, allocated up front and
    reused. Page-locking memory costs ~2 ms a block against ~0.3 ms for
    the copy itself, so a spill copies into a free (kq, ks, vq, vs) set;
    the set returns to the free list when the block holding it is dropped
    (evicted, refused, or its pool discarded). Past the sets made up
    front a spill pins a new one."""

    def __init__(self, shapes, count: int):
        self._shapes = shapes            # [(shape, dtype)] in block order
        self._free = [self._new() for _ in range(count)]

    def _new(self):
        return tuple(torch.empty(shape, dtype=dtype, pin_memory=True)
                     for shape, dtype in self._shapes)

    def take(self):
        return self._free.pop() if self._free else self._new()

    def lend(self, blk, bufs):
        """`blk` holds `bufs` now: they come back when it is dropped."""
        weakref.finalize(blk, self._free.append, bufs)


class Engine:
    """Continuous-batching engine over one loaded model."""

    _ADMIT_GROUP_SIZES = (2, 4, 8)

    def __init__(self, cfg: LlamaConfig, params, tokenizer=None,
                 econfig: EngineConfig | None = None, draft: tuple | None = None,
                 kvhost=None, device=None):
        """`draft=(draft_cfg, draft_params)` enables speculative decoding.
        `kvhost`: an existing engine/kvhost.HostKVPool to adopt instead of
        building one from ec.kv_host_bytes — host memory outlives device
        state, so a restarted worker readmits the previous engine's
        spilled blocks."""
        self.cfg = cfg
        self.tok = tokenizer
        self.ec = econfig or EngineConfig()
        _check_config(self.ec)
        self.mesh = self.ec.mesh
        if getattr(params, "mesh", None) is not self.mesh:
            raise ValueError("the params are not sharded on the engine's "
                             "mesh (models/llama.shard_params, or the "
                             "loader's mesh=)")
        if self.mesh is not None:
            for cond, what in ((draft is not None, "speculative decoding"),
                               (kvhost is not None, "the host KV tier"),
                               (cfg.num_experts > 0, "expert parallelism "
                                "(Mixtral's experts)")):
                if cond:
                    raise not_ported(f"{what} under a mesh", "parallel")
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        # speculative decoding: (draft_cfg, draft_params) — the draft keeps
        # a dense cache of its own beside the target's (engine/spec.py)
        self._draft = None
        if draft is not None:
            if draft[0].vocab_size != cfg.vocab_size:
                raise ValueError("draft vocab differs from target")
            self._draft = (draft[0], draft[1].to(self.device))
        if self.ec.max_context > cfg.max_position:
            raise ValueError("max_context exceeds model max_position")
        for b in self.ec.prefill_buckets:
            if b > self.ec.max_context:
                raise ValueError("prefill bucket larger than max_context")
        self._kv_dtype = (torch_dtype(self.ec.dtype) if self.ec.dtype
                          else cfg.tdtype)
        # paged KV (ops/paged.py): block pool + per-slot tables instead of a
        # dense [B, T] product. The host owns allocation; the device sees a
        # [B, MAXB] table per dispatch (_tab).
        self._paged = self.ec.kv_pages > 0
        if self._paged:
            if self.ec.kv_pages < 2:
                raise ValueError("kv_pages must be >= 2 (block 0 is trash)")
            if self.ec.max_slots > BLOCK:
                # inactive slots write to the trash block at row b % 128;
                # beyond 128 slots those rows would collide
                raise ValueError(f"paged KV serves at most {BLOCK} slots "
                                 f"(max_slots={self.ec.max_slots})")
        # ragged continuous batching: one flat-stream dispatch for mixed
        # prefill+decode ticks (models/llama.ragged_forward); _check_config
        # made sure the pool is paged
        self._ragged = self.ec.ragged_token_budget > 0
        if self._ragged:
            rows = max(self.ec.ragged_token_budget, 2 * QBLK)
            if self._draft is not None:
                # spec-as-ragged: every verifying slot takes gamma+1 window
                # rows (QBLK-aligned); a full slot population plus one
                # prefill block always fits
                winb = -(-(self.ec.gamma + 1) // QBLK)
                rows = max(rows, (self.ec.max_slots * winb + 1) * QBLK)
            self._ragged_rows = -(-rows // QBLK) * QBLK
        # the verify window writes up to gamma+1 rows past `lengths`: a
        # spec step never writes past the cache end
        self._ctx_reserve = (self.ec.gamma + 1) if self._draft else 0
        # the KV lifecycle tier (engine/kvtier.py): a windowed engine policy
        # switches the paged table to COMPACT geometry — sink_blocks identity
        # columns plus a ring reused in place, so decode reads O(sinks +
        # window) rows however long the sequence runs. kv_policy "full"
        # keeps kvt None on every path (the untiered engine)
        self._kv_policy = kvtier.parse_policy(self.ec.kv_policy)
        self._tiered = self._kv_policy.windowed
        self._cold = self._tiered and self._kv_policy.quantize_cold
        if self._tiered:
            if not self._paged:
                raise ValueError(
                    "kv_policy sink_window requires paged KV (set kv_pages)")
            if self._draft is not None:
                raise ValueError(
                    "kv_policy sink_window is incompatible with a draft "
                    "model (the dense draft cache has no ring geometry)")
            if self._ragged and self._cold:
                raise ValueError(
                    "quantize_cold is incompatible with ragged continuous "
                    "batching (the flat-stream program has no cold-tier "
                    "lane); drop quantize_cold or ragged_token_budget")
            self._kv_margin = kvtier.engine_margin_tokens(self.ec)
            self._kv_ring = kvtier.ring_blocks(self._kv_policy.window,
                                               self._kv_margin)
            self._kv_resident = kvtier.resident_blocks(self._kv_policy,
                                                       self._kv_margin)
            if self._kv_resident > self.ec.kv_pages - 1:
                raise ValueError(
                    f"kv_policy {self._kv_policy.describe()} needs "
                    f"{self._kv_resident} resident blocks per slot but the "
                    f"pool has {self.ec.kv_pages - 1}; raise kv_pages or "
                    f"shrink sinks/window")
            if self._cold:
                if self.ec.kv_cold_pages < 2:
                    raise ValueError(
                        "quantize_cold needs kv_cold_pages >= 2 (cold "
                        "block 0 is the not-demoted sentinel)")
                from localai_tpu_torch.ops.kvcache import is_quant_kind

                if is_quant_kind(self.ec.cache_type):
                    raise ValueError(
                        "quantize_cold requires a dense hot cache "
                        "(cache_type=''): the cold tier is already int8")
        elif self.ec.kv_cold_pages:
            raise ValueError(
                "kv_cold_pages needs kv_policy sink_window(..., "
                "quantize_cold=true)")
        # the host KV spill tier (engine/kvhost.py): catches the blocks the
        # device pool loses, keyed by the prefix cache's chain hashes. None
        # without a budget or an adopted pool — every hook is one branch
        self._kvhost = None
        self._host_pending: list = []    # in-flight spills (hash, fetch)
        self._readmits: list = []        # (hash, event) of H2D copies
        self._spill_group: bytes | None = None
        if kvhost is not None or self.ec.kv_host_bytes > 0:
            if not self._paged:
                raise ValueError(
                    "kv_host_bytes requires paged KV (set kv_pages)")
            if self._draft is not None:
                raise ValueError(
                    "kv_host_bytes is incompatible with a draft model "
                    "(draft engines never consult the prefix cache)")
            from localai_tpu_torch.engine.kvhost import HostKVPool

            self._kvhost = (kvhost if kvhost is not None
                            else HostKVPool(self.ec.kv_host_bytes))
        # on the card, spills copy into pinned sets made here for the
        # pool's budget (a block's int8 form: q [L, KVH, 128, D], scales
        # [L, KVH, 1, 128], for K and V)
        self._pinned = None
        if self._kvhost is not None and self.device.type == "cuda":
            L, KVH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
            q, sc = ((L, KVH, BLOCK, D), torch.int8), \
                ((L, KVH, 1, BLOCK), torch.float32)
            nbytes = 2 * (L * KVH * BLOCK * D + 4 * L * KVH * BLOCK)
            self._pinned = _PinnedBlocks(
                [q, sc, q, sc], max(self._kvhost.budget_bytes, 0) // nbytes)
        self._init_device_state()
        if self.ec.prefill_chunk < 8:
            raise ValueError("prefill_chunk must be >= 8")
        self._chunk = min(self.ec.prefill_chunk, self.ec.max_context)
        small = tuple(b for b in self.ec.prefill_buckets if b <= self._chunk)
        dropped = tuple(b for b in self.ec.prefill_buckets if b > self._chunk)
        if dropped:
            import warnings

            warnings.warn(
                f"prefill buckets {dropped} exceed prefill_chunk="
                f"{self._chunk}; prompts longer than "
                f"{max(small) if small else self._chunk} tokens will prefill "
                f"in {self._chunk}-token chunks instead of single-shot",
                stacklevel=2)
        self._small_buckets = small or (self._chunk,)
        self._small_max = max(self._small_buckets)
        self._prefillq: list[int] = []   # slot indices mid-prefill, FIFO
        self._pending = None             # in-flight decode (pipeline depth 1)
        self._inflight_steps = 0
        self._queue: "queue.Queue[tuple[int, GenRequest, queue.Queue]]" = \
            queue.Queue()
        self._next_id = 0
        self._cancelled: set[int] = set()
        self._live: set[int] = set()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._running = False
        self._dead = False
        self._thread: threading.Thread | None = None
        self._admitting: tuple | None = None
        self._grammar_lock = threading.Lock()
        self._grammar_cache = None
        # preemption handshake: preempt() arms the request and the grace
        # deadline from any thread; the engine thread runs _spill_drain at
        # a tick boundary and signals done
        self._preempt_req = threading.Event()
        self._preempt_done = threading.Event()
        self._preempt_t = 0.0
        self._preempt_manifest: list[dict] = []

        self.metrics = {
            "requests_completed": 0,
            "tokens_generated": 0,
            "prompt_tokens_processed": 0,
            "prompt_tokens_reused": 0,
            "prompt_cache_hits": 0,
            "ttft_ms_last": 0.0,
            "tokens_per_second_last": 0.0,
            "decode_dispatches": 0,
            "decode_steps_dispatched": 0,
            "admit_dispatches": 0,
            # chunked prefill (extend) dispatches: non-final chunks (no
            # logits) and final chunks (last-token logits)
            "prefill_chunks_mid": 0,
            "prefill_chunks_final": 0,
            "host_sync_wait_ms": 0.0,
            "tokens_by_path__loop": 0,
            "tokens_by_path__dense": 0,
            "tokens_by_path__rloop": 0,
            "tokens_by_path__ragged": 0,
            "tokens_by_path__spec": 0,
            # grammar: device table rows in use (the identity row 0
            # included), grammars whose automaton did not fit them, and
            # fused blocks rolled back to a grammar slot's accepted prefix
            "grammar_table_states": 0,
            "grammar_table_overflows": 0,
            "grammar_rollbacks": 0,
            # preemption: spill-drains run, blocks force-spilled, and
            # resume admissions by outcome (every full prefix block covered
            # by the device or host cache, or a re-prefill)
            "preempts": 0,
            "preempt_spilled_blocks": 0,
            "resume_readmits": 0,
            "resume_reprefills": 0,
        }
        if self._ragged:
            # flat-stream packing: dispatches, live rows packed (decode +
            # prefill), the prefill share of them, and the budget
            # utilization (packed / (dispatches * rows)); the fused ragged
            # loop's exits by cause
            self.metrics.update(
                ragged_dispatches=0, ragged_tokens_packed=0,
                ragged_prefill_tokens=0, budget_utilization=0.0,
                rloop_exit_steps_cap=0, rloop_exit_finish=0,
                rloop_exit_prefill=0, rloop_exit_host_arbitration=0,
                spec_ragged_dispatches=0)
        if self._draft is not None:
            # draft tokens proposed (gamma a verifying slot a step) and
            # accepted by the target's verify
            self.metrics.update(draft_proposed=0, draft_accepted=0)
        if self._paged:
            # pool occupancy (blocks held by live and retained slots), and
            # the allocator's pressure events: admissions deferred on an
            # exhausted pool, released slots whose retained blocks were
            # reclaimed, blocks swapped by the copy-on-write pass
            self.metrics.update(kv_blocks_in_use=0, kv_blocks_peak=0,
                                kv_admissions_deferred=0,
                                kv_slots_reclaimed=0, kv_cow_swaps=0)
        if self._tiered:
            # the KV tier: cold demotions, evictions (window-exited blocks
            # dropped: the ring's overwrite, or a full cold pool), prefix
            # blocks re-prefilled because ring columns cannot be borrowed,
            # and admission-time full -> window demotions
            self.metrics.update(kv_cold_blocks=0, kv_evictions=0,
                                kv_recomputes=0, kv_policy_demotions=0)
        if self._kvhost is not None:
            # the host tier: occupancy refreshed from the pool at each
            # _host_drain; hits/spills/evictions are the pool's cumulative
            # counters (shared by every engine adopting the pool)
            self.metrics.update(
                kv_host_blocks=0, kv_host_bytes=0, kv_host_bytes_peak=0,
                kv_host_hits=0, kv_host_spills=0, kv_host_evictions=0)
        self._build_shift()
        self._build_fns()

    def _build_shift(self):
        """The context shift's geometry, fixed per engine, and its rotation
        (cos, sin of discard·inv_freq) on the device. Paged: keep the sink
        block(s) and drop half the context's remaining blocks; the slide is
        a permutation of the slot's table row. A shift must leave a tail
        block to slide: on a context of keep + discard blocks or fewer
        (`_shift_ok` False) submit refuses context_shift. Dense: keep
        shift_keep rows and drop half of the rest."""
        if self._paged:
            self._shift_keepb = max(1, -(-self.ec.shift_keep // BLOCK))
            self._shift_discb = max(1, (self._maxb - self._shift_keepb) // 2)
            self._shift_discard = self._shift_discb * BLOCK
            self._shift_ok = self._maxb > (self._shift_keepb
                                           + self._shift_discb)
        else:
            self._shift_discard = max(
                1, (self.ec.max_context - self.ec.shift_keep) // 2)
        self._shift_rot = shift_rotation(self.cfg, self._shift_discard,
                                         self.device)

    # ------------------------------------------------------------ state

    def _init_device_state(self):
        """(Re)create the device-held serving state: KV caches (or the paged
        pool and its host allocator), sampler, logits, lengths, and the host
        slot table."""
        cfg, B, T = self.cfg, self.ec.max_slots, self.ec.max_context
        V, dev = cfg.vocab_size, self.device
        if self._paged:
            # a tiered engine's table is COMPACT: the resident columns of a
            # slot (sinks + ring), not ceil(max_context/128)
            self._maxb = (self._kv_resident if self._tiered
                          else blocks_needed(T))
            self._table = np.zeros((B, self._maxb), np.int32)
            self._kv_free: list[int] = list(range(1, self.ec.kv_pages))
            self._slot_blocks: list[list[int]] = [[] for _ in range(B)]
            self._released_lru: list[int] = []
            # block-level prefix cache: refcounted shared pages. A block's
            # refcount is the number of slot block-lists (live or released-
            # retained) holding it; the chain-hash index maps a full
            # 128-token content prefix to the physical block still storing
            # its K/V, so a new admission can map another tenant's pages
            # into its own table (copy-on-write: borrowed pages are never
            # written — see _alloc_slot).
            self._block_ref = np.zeros(self.ec.kv_pages, np.int64)
            self._block_ref[0] = 1          # trash block: pinned forever
            self._hash_index: dict[bytes, int] = {}
            self._block_hash_of: dict[int, bytes] = {}
        if self._tiered:
            # per-slot tier geometry (full-policy sentinels: sb = the table
            # width makes the ring map the identity, sinks/window at
            # max_context keep the retention mask all-true), and the next raw
            # block eligible for demotion/eviction (_kv_tick)
            self._kv_sb = np.full((B,), self._maxb, np.int32)
            self._kv_rw = np.ones((B,), np.int32)
            self._kv_sinks = np.full((B,), T, np.int32)
            self._kv_window = np.full((B,), T, np.int32)
            self._slot_policy: list = [None] * B
            self._demote_next = np.zeros((B,), np.int64)
            if self._cold:
                self._cold_maxb = blocks_needed(T)
                self._cold_table = np.zeros((B, self._cold_maxb), np.int32)
                self._cold_free: list[int] = list(
                    range(1, self.ec.kv_cold_pages))
                self._slot_cold: list[list[int]] = [[] for _ in range(B)]
        self._deferred: tuple | None = None   # admission waiting on blocks
        self._blocks_freed = False
        # in-flight spills and readmits die with the old state: their pool
        # claims are abandoned and their pins released, or the chain pins
        # they hold would leak
        if self._kvhost is not None:
            for h, _fetch in self._host_pending:
                self._kvhost.end_spill(h, None)
            for h, _event in self._readmits:
                self._kvhost.unpin(h)
        self._host_pending, self._readmits = [], []
        self._cos, self._sin = rope_table(cfg.rope, T, device=dev)
        if self._paged:
            self._kc, self._vc = init_paged(
                cfg.num_layers, self.ec.kv_pages, kv_heads(cfg, self.mesh),
                cfg.head_dim, self._kv_dtype, cache_type=self.ec.cache_type,
                device=dev)
        else:
            self._kc, self._vc = init_kv_cache(cfg, B, T, self._kv_dtype,
                                               cache_type=self.ec.cache_type,
                                               device=dev, mesh=self.mesh)
        self._kvt_dev = None
        if self._tiered:
            # the tier's geometry in one int32 buffer written in place before
            # each dispatch (_kvt) — [sb B | rw B | sinks B | window B
            # (| cold table B*MBC)] — so the captured graphs read the current
            # geometry; the int8 cold pools [L, NBc, KVH, 128, D] beside it
            nc = B * self._cold_maxb if self._cold else 0
            buf = torch.zeros((4 * B + nc,), dtype=torch.int32, device=dev)
            self._kvt_buf = buf
            self._kvt_dev = {k: buf[j * B:(j + 1) * B] for j, k in
                             enumerate(("sb", "rw", "sinks", "window"))}
            if self._cold:
                self._ck, self._cv = init_paged(
                    cfg.num_layers, self.ec.kv_cold_pages, cfg.num_kv_heads,
                    cfg.head_dim, cache_type="int8", device=dev)
                self._kvt_dev.update(
                    cold_tab=buf[4 * B:].view(B, self._cold_maxb),
                    cold_k=self._ck, cold_v=self._cv)
                self._demote_rows = torch.arange(
                    cfg.num_kv_heads * BLOCK, dtype=torch.int32, device=dev)
        self._sampler = SamplerState.init(B, V, device=dev)
        self._last_logits = torch.zeros((B, V), dtype=torch.float32,
                                        device=dev)
        self._lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
        eos = sorted(self.tok.eos_ids) if (
            self.tok is not None and getattr(self.tok, "eos_ids", None)
        ) else []
        self._eos_dev = torch.tensor(eos or [-1], dtype=torch.int32,
                                     device=dev)
        if self._draft is not None:
            dcfg = self._draft[0]
            self._cos_d, self._sin_d = rope_table(dcfg.rope, T, device=dev)
            self._kcd, self._vcd = init_kv_cache(dcfg, B, T, self._kv_dtype,
                                                 device=dev)
            # the sampled, emitted token each slot's next verify window
            # starts with (its K/V not yet written)
            self._next_tokens = torch.zeros((B,), dtype=torch.int32,
                                            device=dev)
        self._init_grammar_state()
        # the fused loops' fixed tensors (models/llama.LoopState; the first
        # dispatch binds the state above to them), with each dispatch's
        # inputs in one int32 buffer that one host→device copy fills —
        # [table B*MAXB (paged) | active B | remaining B | check_eos B |
        # gstate B]
        nt = B * self._maxb if self._paged else 0
        inp = torch.zeros((nt + 4 * B,), dtype=torch.int32, device=dev)
        self._loop_inp = inp
        no = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._loop_st = LoopState.start(
            self._sampler, self._last_logits, self._lengths, no,
            inp[nt + B:nt + 2 * B], no, self._eos_dev,
            inp[:nt].view(B, self._maxb) if self._paged else None,
            gmasks=self._gmasks, gtrans=self._gtrans, kvt=self._kvt_dev)
        # the loop segments' CUDA graphs (on the card); they hold the
        # addresses of the tensors made here, so a new state gets new graphs.
        # On a mesh the segments run eagerly: their collectives cannot be
        # captured (gloo stages them through the host)
        self.graphs = (GraphRunner(dev) if self.mesh is None
                       else EagerSegments(dev))
        self._slots: list[_Slot | None] = [None] * B
        self._free: list[int] = list(range(B))
        self._ragged_rr = 0   # ragged decode-row round-robin offset
        # prompt cache: per slot, the token ids whose K/V rows are still
        # valid in that slot's cache region (recorded at release)
        self._slot_kv_tokens: list[list[int]] = [[] for _ in range(B)]

    def _init_grammar_state(self):
        """The grammar state: per slot a host mask row (all-ones =
        unconstrained) and an automaton state, and, with
        grammar_table_states > 0, ONE shared pair of device tables for
        every live grammar — masks [cap, ceil(V/32)] (u32 words as int32,
        LSB-first allowed-token rows) and trans [cap, V] int32 (absolute
        next state per token). Row 0 is the identity state every
        unconstrained slot sits in: an all-ones mask (torch.where over an
        all-true mask is the logits exactly, so constrained and
        unconstrained slots share one segment) and a self-loop. Grammars
        get base rows in _grammar_table_entry; the numpy mirrors are
        authoritative (_emit advances _gstate through _gtrans_np). The
        device tables are allocated here once and each install writes its
        rows in place, so the captured graphs keep reading them."""
        B, V, dev = self.ec.max_slots, self.cfg.vocab_size, self.device
        self._mask_nbytes = (V + 7) // 8
        self._mask_nwords = (V + 31) // 32
        self._mask_host = np.full((B, self._mask_nbytes), 0xFF, np.uint8)
        self._grammar_slots = 0
        self._grammar_hostonly = 0   # grammar slots WITHOUT device tables:
                                     # they keep the per-token host masks
                                     # and bar the fused loops
        self._gstate = np.zeros((B,), np.int32)
        # without a tokenizer no grammar compiles (submit rejects it), so
        # such an engine keeps no tables and captures no grammar segments
        self._gtab_cap = (max(int(self.ec.grammar_table_states), 0)
                          if self.tok is not None else 0)
        self._gtab_base: dict[str, int | None] = {}
        self._gtab_used = 1
        self._gmasks = self._gtrans = None
        if self._gtab_cap:
            self._gmasks_np = np.zeros((self._gtab_cap, self._mask_nwords),
                                       np.uint32)
            self._gmasks_np[0] = 0xFFFFFFFF
            self._gtrans_np = np.zeros((self._gtab_cap, V), np.int32)
            self._gmasks = torch.tensor(self._gmasks_np.view(np.int32),
                                        device=dev)
            self._gtrans = torch.zeros((self._gtab_cap, V),
                                       dtype=torch.int32, device=dev)

    def _build_fns(self):
        cfg = self.cfg

        def _decode(params, cos, sin, kc, vc, sampler, last_logits, lengths,
                    active, fast_width=None, table=None, mask_bits=None,
                    kvt=None):
            """sample(prev logits) → decode → next logits, for all slots
            (under `mask_bits`, a grammar mask row a slot, if given; through
            the KV tier's geometry `kvt`, if given). The caches and token
            counts update in place."""
            tokens, keys, logprobs = sample(last_logits, sampler, mask_bits,
                                            topk_width=fast_width)
            logits = decode_step(params, cfg, tokens, lengths, cos, sin, kc,
                                 vc, active, table, kvt=kvt)
            act = active.to(torch.int32)
            rows = torch.arange(tokens.shape[0], device=tokens.device)
            sampler.token_counts.index_put_((rows, tokens.long()), act,
                                            accumulate=True)
            sampler = dataclasses.replace(sampler, key=keys)
            return tokens, logprobs, sampler, logits, lengths + act

        self._decode_fn = _decode
        if self._draft is not None:
            self._build_spec_fns()
        # the fused loops run on the loop's fixed tensors (_loop_begin),
        # each segment through the graph runner (_run_segment); draft
        # engines never take the fused ragged loop: a verify window returns
        # to the host every tick (accept arbitration)
        rloop_on = (self._ragged and self.ec.ragged_loop_steps > 1
                    and self._draft is None)
        self._loop_path = ("rloop" if rloop_on
                           else "paged" if self._paged else "dense")
        hooks = dict(limit=self.ec.max_context - 2, start=self._loop_begin,
                     run=self._run_segment)
        self._decode_loop_fn = None
        if self.ec.decode_loop > 1:
            self._decode_loop_fn = build_decode_loop(
                _decode, max_steps=self.ec.decode_loop, **hooks)

        self._ragged_loop_fn = None
        if not self._ragged:
            return

        def _ragged_step(params, cos, sin, kc, vc, sampler, last_logits,
                         lengths, pack, is_decode, table, mask_bits=None,
                         kvt=None):
            """The mixed tick: sample every slot from last_logits (full
            sampler, topk_width=None — the draw is width-independent, so
            per-slot streams equal the dense paths' — under `mask_bits`,
            the grammar masks, if given), splice the sampled tokens into
            the flat stream at the decode rows, one ragged_forward over
            decode rows and prefill chunks; decode slots and final chunks
            take their new last-token logits, set_len commits a final
            chunk's length. pack["inject"], if present, carries a
            multimodal chunk's feature rows (ragged_forward's inject)."""
            sampled, keys, logprobs = sample(last_logits, sampler, mask_bits,
                                             topk_width=None)
            ds = pack["decode_slot"]
            toks = torch.where(ds >= 0, sampled[ds.clamp_min(0)],
                               pack["tokens"])
            logits = ragged_forward(
                params, cfg, toks, cos, sin, kc, vc, pack["block_seq"],
                pack["qstart"], pack["qlen"], pack["kvlen"], table,
                pack["logit_rows"], kvt=kvt, inject=pack.get("inject"))
            act = is_decode.to(torch.int32)
            rows = torch.arange(sampled.shape[0], device=sampled.device)
            sampler.token_counts.index_put_((rows, sampled.long()), act,
                                            accumulate=True)
            sampler = dataclasses.replace(sampler, key=keys)
            last_logits = torch.where(pack["logit_set"][:, None], logits,
                                      last_logits)
            set_len = pack["set_len"]
            lengths = torch.where(set_len >= 0, set_len, lengths + act)
            return sampled, logprobs, sampler, last_logits, lengths

        self._ragged_fn = _ragged_step
        if rloop_on:
            self._ragged_loop_fn = build_ragged_loop(
                _ragged_step, _decode, max_steps=self.ec.ragged_loop_steps,
                **hooks)

    def _build_spec_fns(self):
        """The speculative programs (engine/spec.py): the extend-verify
        step for dense and paged engines, spec-as-ragged for ragged ones,
        the admission tail and the draft ingest."""
        from localai_tpu_torch.engine.spec import (
            build_draft_ingest, build_spec_admit_tail, build_spec_decode,
            build_spec_ragged,
        )

        cfg, dcfg, G = self.cfg, self._draft[0], self.ec.gamma
        if self._paged and self.ec.max_slots * (G + 1) > BLOCK:
            import logging

            logging.getLogger("localai_tpu_torch").warning(
                "paged spec verify: %d slots x (gamma+1)=%d trash offsets "
                "exceed one %d-token block, so inactive windows share trash "
                "rows; lower max_slots or gamma to keep them distinct",
                self.ec.max_slots, G + 1, BLOCK)
        self._spec_fn = self._spec_ragged_fn = None
        if self._ragged:
            self._spec_ragged_fn = build_spec_ragged(cfg, dcfg, G)
        else:
            self._spec_fn = build_spec_decode(cfg, dcfg, G)
        self._spec_admit_tail_fn = build_spec_admit_tail(cfg)
        self._draft_ingest_fn = build_draft_ingest(dcfg)

    def _install_rows(self, slots, rows: dict, counts_rows):
        """Install K sampler rows at `slots` [K] (stacked [K, ...] fields);
        absent logit_bias / counts rows are zeroed."""
        s = self._sampler
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        for f in dataclasses.fields(SamplerState):
            cur = getattr(s, f.name)
            if f.name == "token_counts":
                if counts_rows is None:
                    cur[idx] = 0
                else:
                    cur[idx] = torch.as_tensor(counts_rows,
                                               device=self.device).to(cur.dtype)
            elif f.name == "logit_bias" and "logit_bias" not in rows:
                cur[idx] = 0.0
            else:
                val = np.asarray(rows[f.name])
                if f.name == "key":
                    val = val.astype(np.int64)
                cur[idx] = torch.as_tensor(val, device=self.device).to(
                    FIELD_DTYPES[f.name])

    # ------------------------------------------------------ device dispatch
    # On a mesh the rank-0 engine broadcasts (op, host args) over its
    # replicator before each dispatch; follower ranks replay the identical
    # sequence through follow(), so every rank's kernels and collectives
    # run in lockstep (parallel/distributed.py).

    def _bcast(self, op: str, **kw):
        """Ship `op` and its host args to the follower ranks (rank 0 of a
        mesh; a no-op otherwise). Arrays go as numpy (a CUDA tensor raises:
        host args only); a paged engine adds its block table, which the
        followers' engines, allocating nothing, take from here."""
        rep = self.ec.replicator
        if rep is None:
            return
        msg = {k: (np.asarray(v) if hasattr(v, "shape") or isinstance(
            v, (list, tuple)) else v) for k, v in kw.items()}
        if self._paged:
            msg["table"] = self._table.copy()
        rep.broadcast(op, msg)

    def _tab(self):
        """Device copy of the block table for this dispatch (paged KV only).
        The host allocator rewrites rows of self._table while a pipelined
        dispatch is in flight (_release_slot, _alloc_slot), so each dispatch
        gets its own snapshot: a fresh host copy (np.copy) moved to the
        device by a blocking copy, never a view of self._table that a
        pending non-blocking copy could still read."""
        if not self._paged:
            return None
        return torch.from_numpy(self._table.copy()).to(self.device)

    def _kvt(self):
        """The KV tier's geometry for this dispatch (None untiered): the host
        mirrors (per-slot sb, rw, sinks, window and the cold table) copied
        into the fixed device tensors in one host→device copy — on the card
        from a pinned snapshot, non-blocking, so it lands after every
        dispatch already on the stream (they read the geometry of their own
        time) and before this one. The tensors stay where they are: the
        captured graphs replay any mix of policies and demotion state."""
        if not self._tiered:
            return None
        parts = [self._kv_sb, self._kv_rw, self._kv_sinks, self._kv_window]
        if self._cold:
            parts.append(self._cold_table.ravel())
        src = torch.from_numpy(np.concatenate(parts).astype(np.int32))
        if self._kvt_buf.is_cuda:
            self._kvt_buf.copy_(src.pin_memory(), non_blocking=True)
        else:
            self._kvt_buf.copy_(src)
        return self._kvt_dev

    def _note_pool(self):
        """Refresh the pool-occupancy gauges (paged engines)."""
        used = self.ec.kv_pages - 1 - len(self._kv_free)
        self.metrics["kv_blocks_in_use"] = used
        if used > self.metrics["kv_blocks_peak"]:
            self.metrics["kv_blocks_peak"] = used

    def _dev_admit(self, ids, n, slot, row, counts_row, inject=None):
        self._dev_admit_many(
            np.asarray(ids, np.int32), np.asarray([n], np.int32),
            np.asarray([slot], np.int32),
            {k: np.asarray(v)[None] for k, v in row.items()},
            None if counts_row is None else np.asarray(counts_row)[None],
            inject)

    def _inj(self, inject):
        """A host inject pair (extra [..., H] f32, is_embed [...] bool) on
        the device, or None. A multimodal request never reaches a mesh
        (submit), so the pair is never broadcast."""
        if inject is None:
            return None
        extra, is_embed = inject
        return (torch.from_numpy(np.asarray(extra, np.float32)).to(
                    self.device),
                torch.from_numpy(np.asarray(is_embed, bool)).to(self.device))

    def _dev_admit_many(self, ids, lens, slots, rows, counts_rows,
                        inject=None):
        """Admission burst: prefill K same-bucket requests in ONE pass
        (`inject`: one multimodal request's feature rows, _mm_inject)."""
        self._bcast("admit_many", ids=ids, lens=lens, slots=slots,
                    rows={k: np.asarray(v) for k, v in rows.items()},
                    counts_rows=counts_rows)
        self.metrics["admit_dispatches"] += 1
        dev = self.device
        tokens = torch.as_tensor(ids, device=dev)
        lens_t = torch.as_tensor(lens, device=dev)
        slots_t = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        with torch.no_grad():
            logits = prefill(self.params, self.cfg, tokens, lens_t, self._cos,
                             self._sin, self._kc, self._vc, slots_t,
                             self._tab(), inject=self._inj(inject),
                             kvt=self._kvt())
            self._last_logits[slots_t] = logits
            self._lengths[slots_t] = lens_t
            self._install_rows(slots, rows, counts_rows)

    def _dev_extend_mid(self, buf, pos, idx, inject=None):
        """One non-final prefill chunk: KV writes only."""
        self._bcast("extend_mid", buf=buf, pos=pos, idx=idx)
        self.metrics["prefill_chunks_mid"] += 1
        dev = self.device
        with torch.no_grad():
            extend(self.params, self.cfg, torch.as_tensor(buf, device=dev),
                   torch.tensor([pos], device=dev), self._cos, self._sin,
                   self._kc, self._vc,
                   slot_map=torch.tensor([idx], device=dev),
                   with_logits=False, table=self._tab(),
                   inject=self._inj(inject), kvt=self._kvt())

    def _dev_extend_final(self, buf, pos, nvalid, idx, row, counts_row,
                          inject=None):
        """Final prefill chunk: KV writes + last-token logits + the sampler
        row install (deferred to here so the request's RNG stream does not
        depend on how many ticks the prefill spanned)."""
        self._bcast("extend_final", buf=buf, pos=pos, nvalid=nvalid, idx=idx,
                    row={k: np.asarray(v) for k, v in row.items()},
                    counts_row=counts_row)
        self.metrics["prefill_chunks_final"] += 1
        dev = self.device
        with torch.no_grad():
            logits = extend(
                self.params, self.cfg, torch.as_tensor(buf, device=dev),
                torch.tensor([pos], device=dev), self._cos, self._sin,
                self._kc, self._vc, slot_map=torch.tensor([idx], device=dev),
                last_pos=torch.tensor([max(nvalid - 1, 0)], device=dev),
                table=self._tab(), inject=self._inj(inject), kvt=self._kvt())
            self._last_logits[idx] = logits[0]
            self._lengths[idx] = pos + nvalid
            self._install_rows(
                [idx], {k: np.asarray(v)[None] for k, v in row.items()},
                None if counts_row is None else np.asarray(counts_row)[None])

    def _step_args(self, active):
        return (self.params, self._cos, self._sin, self._kc, self._vc,
                self._sampler, self._last_logits, self._lengths,
                torch.as_tensor(active, device=self.device))

    def _mask_dev(self, mask_host):
        """The host grammar mask rows [B, ceil(V/8)] u8 on the device (None
        passes through)."""
        if mask_host is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(mask_host)).to(
            self.device)

    def _dev_decode(self, active, fast_width=None, mask_host=None):
        self._bcast("decode", active=active, mask=mask_host,
                    fast_width=fast_width)
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_steps_dispatched"] += 1
        with torch.no_grad():
            (tokens, logprobs, self._sampler, self._last_logits,
             self._lengths) = self._decode_fn(
                *self._step_args(active), fast_width, table=self._tab(),
                mask_bits=self._mask_dev(mask_host), kvt=self._kvt())
            return _AsyncFetch((tokens, logprobs))

    def _dev_decode_block(self, active, steps: int, fast_width=None,
                          mask_host=None):
        """`steps` fused sample→decode iterations in one dispatch (a grammar
        slot samples every step under its block-start mask row)."""
        self._bcast("decode_block", active=active, steps=steps,
                    fast_width=fast_width, mask=mask_host)
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_steps_dispatched"] += steps
        toks, lps = [], []
        with torch.no_grad():
            act = torch.as_tensor(active, device=self.device)
            table = self._tab()
            mask = self._mask_dev(mask_host)
            kvt = self._kvt()
            for _ in range(steps):
                (tokens, logprobs, self._sampler, self._last_logits,
                 self._lengths) = self._decode_fn(
                    self.params, self._cos, self._sin, self._kc, self._vc,
                    self._sampler, self._last_logits, self._lengths, act,
                    fast_width, table=table, mask_bits=mask, kvt=kvt)
                toks.append(tokens)
                lps.append(logprobs)
            return _AsyncFetch((torch.stack(toks), torch.stack(lps)))

    def _loop_begin(self, sampler, last_logits, lengths, active, remaining,
                    check_eos, eos_ids, table, gstate=None, gmasks=None,
                    gtrans=None, kvt=None):
        """The fused loops' `start`: a dispatch on the loop's fixed tensors.
        The engine's state goes into them (what an eager path rebound to
        new tensors is copied back) and the engine is bound to them; this
        dispatch's host inputs — a snapshot of the block table, the active
        slots, budgets, EOS flags and grammar states (the host mirror
        _gstate; zeros without grammar slots) — go in one host→device copy,
        on the card from pinned memory: it waits for nothing and lands
        after the previous dispatch's work on the stream. `eos_ids` and the
        grammar tables are the state's own (_eos_dev, _gmasks, _gtrans), and
        so is the KV tier's geometry (`kvt`, _kvt's fixed tensors)."""
        st = self._loop_st
        assert eos_ids is st.eos_ids and kvt is st.kvt
        assert gstate is None or (gmasks is st.gmasks
                                  and gtrans is st.gtrans)
        st.adopt(sampler, last_logits, lengths)
        self._sampler, self._last_logits, self._lengths = (
            st.sampler, st.last_logits, st.lengths)
        B = self.ec.max_slots
        parts = ([table] if self._paged else []) + [
            active, remaining, check_eos,
            np.zeros((B,), np.int32) if gstate is None else gstate]
        src = torch.from_numpy(np.concatenate(
            [np.asarray(p, np.int32).ravel() for p in parts]))
        inp = self._loop_inp
        if inp.is_cuda:
            inp.copy_(src.pin_memory(), non_blocking=True)
        else:
            inp.copy_(src)
        nt = inp.shape[0] - 4 * B
        st.done.copy_(inp[nt:nt + B] == 0)
        st.check_eos.copy_(inp[nt + 2 * B:nt + 3 * B] != 0)
        st.gstate.copy_(inp[nt + 3 * B:])
        st.n_out.zero_()
        return st

    def _segment(self, n: int, fast_width, grammar: bool):
        """n iterations of the decode body over the loop's tensors (the
        grammar variant gathers masks from and steps through the device
        tables)."""
        st, limit = self._loop_st, self.ec.max_context - 2
        return lambda: loop_segment(self._decode_fn, st, n, limit,
                                    self.params, self._cos, self._sin,
                                    self._kc, self._vc, fast_width, grammar)

    def _run_segment(self, st, n: int, fast_width, grammar: bool):
        """The fused loops' `run`: a segment through the runner — on the
        card the replay of its CUDA graph, keyed (path, length, width,
        grammar)."""
        self.graphs.run((self._loop_path, n, fast_width, grammar), n,
                        self._segment(n, fast_width, grammar), st.frozen,
                        self._loop_addresses())

    def _loop_addresses(self) -> tuple:
        """Where a loop segment's tensors live: the loop state's (the
        grammar state and tables included), the KV caches' and the rope
        tables' (the weights never move)."""
        kv = [t for c in (self._kc, self._vc)
              for t in ((c.q, c.s) if isinstance(c, QuantKV) else (c,))]
        return self._loop_st.addresses() + tuple(
            t.data_ptr() for t in kv + [self._cos, self._sin])

    def _gkw(self, gstate) -> dict:
        """A fused dispatch's grammar arguments: `gstate` [B] (the host
        mirror's snapshot) with the shared device tables, or none."""
        if gstate is None:
            return {}
        return dict(gstate=gstate, gmasks=self._gmasks, gtrans=self._gtrans)

    def _dev_decode_loop(self, active, remaining, check_eos, fast_width=None,
                         gstate=None):
        """ONE fused-loop dispatch of up to ec.decode_loop steps with the
        per-slot stop conditions on the device. `gstate` [B] int32 (or
        None) selects the grammar variant: each iteration gathers the
        slots' mask rows from the device tables and advances their
        automaton states on the device, so table-backed grammar slots ride
        the loop with no per-token host round trip. The steps actually run
        ride the fetch; decode_steps_dispatched is credited at consume
        time. _dispatch_loop dispatches it only with a live slot."""
        self._bcast("decode_loop", active=active, remaining=remaining,
                    check_eos=check_eos, fast_width=fast_width,
                    gstate=gstate)
        self.metrics["decode_dispatches"] += 1
        with torch.no_grad():
            (toks, lps, n_out, steps, self._sampler, self._last_logits,
             self._lengths) = self._decode_loop_fn(
                self.params, self._cos, self._sin, self._kc, self._vc,
                self._sampler, self._last_logits, self._lengths, active,
                remaining, check_eos, self._eos_dev, fast_width=fast_width,
                table=self._loop_table(), kvt=self._kvt(),
                **self._gkw(gstate))
            return _AsyncFetch((toks, lps, n_out), extra=(steps,))

    def _loop_table(self):
        """The host block table for a fused dispatch's snapshot (None for
        a dense cache)."""
        return self._table if self._paged else None

    # ---------------------------------------------------- ragged dispatch

    _PACK_FIELDS = ("tokens", "decode_slot", "set_len", "logit_set",
                    "logit_rows", "block_seq", "qstart", "qlen", "kvlen",
                    "is_decode")

    def _pack_dev(self, pack, fields=_PACK_FIELDS):
        """The host pack's arrays `fields` on the device, in ONE host→device
        copy (int32, split back into views of their shapes there; the bool
        fields compare)."""
        arrs = [np.asarray(pack[k]) for k in fields]
        flat = np.concatenate([a.astype(np.int32).ravel() for a in arrs])
        dev_flat = torch.from_numpy(flat).to(self.device)
        out, i = {}, 0
        for k, a in zip(fields, arrs):
            t = dev_flat[i:i + a.size].view(a.shape)
            out[k] = t != 0 if a.dtype == np.bool_ else t
            i += a.size
        return out

    def _note_ragged(self, packed: int, decode_rows: int):
        """The ragged packing counters of one dispatch: `packed` live rows,
        `decode_rows` of them decode (or verify) rows, the rest prefill-
        chunk tokens."""
        m = self.metrics
        m["ragged_dispatches"] += 1
        m["ragged_tokens_packed"] += packed
        m["ragged_prefill_tokens"] += packed - decode_rows
        m["budget_utilization"] = m["ragged_tokens_packed"] / max(
            m["ragged_dispatches"] * self._ragged_rows, 1)

    def _dev_ragged(self, pack):
        """ONE flat-stream dispatch for a mixed tick: every packed decode
        slot (one sampled token each, under its current grammar mask row
        `pack["mask"]` when grammar slots are live) plus the packed
        chunked-prefill windows run a single ragged forward (see
        _ragged_tick)."""
        self._bcast("ragged", **pack)
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_steps_dispatched"] += 1
        self._note_ragged(int(pack["packed"]), int(np.sum(pack["is_decode"])))
        with torch.no_grad():
            dp = self._pack_dev(pack)
            dp["inject"] = self._inj(pack.get("inject"))
            (tokens, logprobs, self._sampler, self._last_logits,
             self._lengths) = self._ragged_fn(
                self.params, self._cos, self._sin, self._kc, self._vc,
                self._sampler, self._last_logits, self._lengths, dp,
                dp["is_decode"], self._tab(),
                mask_bits=self._mask_dev(pack.get("mask")), kvt=self._kvt())
            return _AsyncFetch((tokens, logprobs))

    def _dev_ragged_loop(self, pack, remaining, check_eos, prefill_pending,
                         gstate=None):
        """ONE fused ragged dispatch: the mixed pack as iteration 0, then up
        to ragged_loop_steps-1 decode steps for every live decode slot —
        the pack eagerly (it changes every tick), the decode steps as loop
        segments (CUDA graph replays on the card). `prefill_pending` (host
        bool) ends the dispatch after iteration 0, so TTFT stays at
        single-step ragged levels. `gstate` selects the grammar variant,
        as in _dev_decode_loop. Steps run and the exit code ride the
        fetch."""
        self._bcast("ragged_loop", remaining=remaining, check_eos=check_eos,
                    prefill_pending=bool(prefill_pending), gstate=gstate,
                    **pack)
        self.metrics["decode_dispatches"] += 1
        self._note_ragged(int(pack["packed"]), int(np.sum(pack["is_decode"])))
        with torch.no_grad():
            (toks, lps, n_out, steps, code, self._sampler, self._last_logits,
             self._lengths) = self._ragged_loop_fn(
                self.params, self._cos, self._sin, self._kc, self._vc,
                self._sampler, self._last_logits, self._lengths,
                pack["is_decode"], remaining, check_eos, self._eos_dev,
                bool(prefill_pending), pack=self._pack_dev(pack),
                table=self._loop_table(), fast_width=None, kvt=self._kvt(),
                has_pack=True, **self._gkw(gstate))
            return _AsyncFetch((toks, lps, n_out, code), extra=(steps,))

    def _dev_rloop_decode(self, active, remaining, check_eos,
                          fast_width=None, gstate=None):
        """The fused ragged loop without a pack: a pure-decode tick on a
        ragged engine, with the loop's first-finish exit (grammar variant
        with `gstate`, as in _dev_decode_loop)."""
        self._bcast("rloop_decode", active=active, remaining=remaining,
                    check_eos=check_eos, fast_width=fast_width, gstate=gstate)
        self.metrics["decode_dispatches"] += 1
        with torch.no_grad():
            (toks, lps, n_out, steps, code, self._sampler, self._last_logits,
             self._lengths) = self._ragged_loop_fn(
                self.params, self._cos, self._sin, self._kc, self._vc,
                self._sampler, self._last_logits, self._lengths, active,
                remaining, check_eos, self._eos_dev, False,
                table=self._loop_table(), fast_width=fast_width,
                kvt=self._kvt(), has_pack=False, **self._gkw(gstate))
            return _AsyncFetch((toks, lps, n_out, code), extra=(steps,))

    def _dev_install(self, idx, row, counts_row):
        """Sampler-row install for a ragged final prefill chunk (the dense
        path installs inside _dev_extend_final; the ragged dispatch leaves
        it to here, after the pack)."""
        self._bcast("install", idx=idx,
                    row={k: np.asarray(v) for k, v in row.items()},
                    counts_row=counts_row)
        with torch.no_grad():
            self._install_rows(
                [idx], {k: np.asarray(v)[None] for k, v in row.items()},
                None if counts_row is None else np.asarray(counts_row)[None])

    def follow(self, channel) -> None:
        """Follower-rank loop (rank > 0 of a mesh): replay the rank-0
        engine's device dispatches on this rank's shards. Blocks until
        rank 0 sends `stop` or the channel drops. A failed op ends the
        follower: it reports the failure to rank 0 (whose next dispatch
        then raises, ending its engine) and raises. Nothing resets a
        world: an op that failed part-way leaves the ranks' collectives
        unpaired."""
        while True:
            try:
                op, kw = channel.recv()
            except (ConnectionError, EOFError):
                return
            if op == "stop":
                return
            try:
                self._follow_op(op, kw)
            except Exception as e:
                channel.report(op, e)
                raise

    def _follow_op(self, op: str, kw: dict) -> None:
        kw = dict(kw)
        table = kw.pop("table", None)
        if table is not None:
            self._table[...] = table
        if op == "admit_many":
            self._dev_admit_many(kw["ids"], kw["lens"], kw["slots"],
                                 kw["rows"], kw["counts_rows"])
        elif op == "extend_mid":
            self._dev_extend_mid(kw["buf"], kw["pos"], kw["idx"])
        elif op == "extend_final":
            self._dev_extend_final(kw["buf"], kw["pos"], kw["nvalid"],
                                   kw["idx"], kw["row"], kw["counts_row"])
        elif op == "decode":
            self._dev_decode(kw["active"], kw.get("fast_width"), kw["mask"])
        elif op == "decode_block":
            self._dev_decode_block(kw["active"], int(kw["steps"]),
                                   kw.get("fast_width"), kw.get("mask"))
        elif op == "decode_loop":
            self._dev_decode_loop(kw["active"], kw["remaining"],
                                  kw["check_eos"], kw.get("fast_width"),
                                  kw.get("gstate"))
        elif op == "ragged":
            self._dev_ragged(kw)
        elif op == "ragged_loop":
            self._dev_ragged_loop(kw, kw.pop("remaining"),
                                  kw.pop("check_eos"),
                                  kw.pop("prefill_pending"),
                                  gstate=kw.pop("gstate"))
        elif op == "rloop_decode":
            self._dev_rloop_decode(kw["active"], kw["remaining"],
                                   kw["check_eos"], kw.get("fast_width"),
                                   kw.get("gstate"))
        elif op == "install":
            self._dev_install(kw["idx"], kw["row"], kw["counts_row"])
        else:
            raise ValueError(f"follower: unknown op {op!r}")

    def _dev_demote(self, pb: int, ci: int):
        """Copy hot physical block `pb` into cold-pool block `ci` (int8,
        per-token scales): each layer's K and V block through the
        quantizing row kernel (paged_demote_q8), bit for bit what the
        reference's _demote writes with quantize_tokens. Enqueued on the
        stream behind any in-flight dispatch, so it reads the block's final
        hot content; the ring's slack blocks (kvtier.ring_blocks) keep every
        later write off the block until it has run."""
        KVH = self.cfg.num_kv_heads
        with torch.no_grad():
            targets = demote_targets(ci, KVH, self._demote_rows)
            for i in range(self.cfg.num_layers):
                paged_demote_q8(self._ck.q[i], self._ck.s[i], self._cv.q[i],
                                self._cv.s[i], self._kc[i, pb],
                                self._vc[i, pb], targets)

    def _dev_shift(self, idx: int):
        """Context-shift slot `idx` (_emit, at the cap), enqueued behind
        the dispatch whose token triggered it and any pipelined one after
        it: that in-flight step wrote at a pre-shift position and is part
        of the device state the shift moves. Everything is written in
        place — the caches, the pool and `_lengths` keep their storage, so
        the fused loops' CUDA graphs go on replaying over them. Paged: K's
        tail blocks rotate in place through the PRE-permutation row, then
        the host row is permuted (sink blocks stay, discarded blocks
        re-append as tail capacity; the reservation is unchanged) and
        reaches the device with the next dispatch's table snapshot."""
        with torch.no_grad():
            if self._paged:
                row = torch.from_numpy(self._table[idx].astype(np.int64))
                if self.device.type == "cuda":
                    row = row.pin_memory().to(self.device, non_blocking=True)
                cache_shift_paged(self.cfg, self._kc, row,
                                  keep_blocks=self._shift_keepb,
                                  discard_blocks=self._shift_discb,
                                  rot=self._shift_rot)
                self._lengths[idx] -= self._shift_discard
                blocks = self._slot_blocks[idx]
                kb, db = self._shift_keepb, self._shift_discb
                if len(blocks) > kb + db:   # a shift fires at the cap, where
                    # the reservation spans the whole context
                    newb = blocks[:kb] + blocks[kb + db:] + blocks[kb:kb + db]
                    self._slot_blocks[idx] = newb
                    self._table[idx, :len(newb)] = newb
            else:
                cache_shift(self.cfg, self._kc, self._vc, self._lengths, idx,
                            keep=self.ec.shift_keep,
                            discard=self._shift_discard, rot=self._shift_rot)

    # ------------------------------------------------------- host KV tier

    def _spill_arrays(self, pb: int) -> list:
        """Physical block `pb` of both pools as [kq, ks, vq, vs] on the
        device: an int8 pool's bytes as stored (its round trip is
        byte-exact), a dense pool through quantize_tokens (the scales in
        the [L, KVH, 1, 128] tile layout)."""
        out = []
        for c in (self._kc, self._vc):
            if isinstance(c, QuantKV):
                out += [c.q[:, pb], c.s[:, pb]]
            else:
                q, scale = quantize_tokens(c[:, pb])
                out += [q, scale[:, :, None, :]]
        return out

    def _spill_block(self, pb: int, h: bytes | None = None,
                     group: bytes | None = None):
        """Spill physical block `pb` to the host tier before its content
        dies (freed or rewritten). The slice and the copy into pinned host
        memory (on the card a reused set, _PinnedBlocks) are enqueued on
        the stream NOW, ahead of any later dispatch that could rewrite the
        page; _host_drain lands the block in the pool once the copy's event
        has passed."""
        if self._kvhost is None:
            return
        if h is None:
            h = self._block_hash_of.get(pb)
        gkey = group if group is not None else self._spill_group
        # begin_spill claims the hash AND pins the group's resident chain
        # until _host_drain lands it: an LRU eviction racing the copy can
        # not free the chain head under its in-flight tail
        if h is None or not self._kvhost.begin_spill(h, group=gkey):
            return
        out = self._pinned.take() if self._pinned is not None else None
        with torch.no_grad():
            self._host_pending.append(
                (h, _AsyncFetch(self._spill_arrays(pb), out=out)))
        self.metrics["kv_host_spills"] += 1

    def _host_drain(self):
        """Release the pool pins of readmits whose host→device copies have
        run, and land every in-flight spill in the HostKVPool (each waits on
        its copy's event, normally passed: the copy was enqueued at spill
        time, ahead of the dispatches since)."""
        if self._readmits:
            left = []
            for h, event in self._readmits:
                if event.query():
                    self._kvhost.unpin(h)
                else:
                    left.append((h, event))
            self._readmits = left
        if not self._host_pending:
            return
        from localai_tpu_torch.engine.kvhost import HostKVBlock

        pending, self._host_pending = self._host_pending, []
        for h, fetch in pending:
            bufs = tuple(fetch.tensors())
            blk = HostKVBlock(*bufs)
            if self._pinned is not None:
                self._pinned.lend(blk, bufs)
            self._kvhost.end_spill(h, blk)
        self._host_note()

    def _host_note(self):
        """Refresh the kv_host_* metrics from the pool (which engines may
        share — a restarted engine keeps the pool's history)."""
        st = self._kvhost.stats()
        self.metrics["kv_host_blocks"] = st["blocks"]
        self.metrics["kv_host_bytes"] = st["bytes"]
        self.metrics["kv_host_bytes_peak"] = st["peak_bytes"]
        self.metrics["kv_host_spills"] = st["spills"]
        self.metrics["kv_host_hits"] = st["hits"]
        self.metrics["kv_host_evictions"] = st["evictions"]

    def _readmit_block(self, pb: int, h: bytes, blk):
        """Write one host-tier block into physical page `pb`: host→device
        copies (non-blocking from pinned memory) enqueued ahead of the
        suffix's prefill on the same stream, then the page written in
        place (a dense pool dequantizes, (q * s).to(dtype)). On the card
        the block stays pinned in the pool until its copies have run
        (_host_drain)."""
        dev = self.device
        with torch.no_grad():
            for c, q, sc in ((self._kc, blk.kq, blk.ks),
                             (self._vc, blk.vq, blk.vs)):
                q = q.to(dev, non_blocking=True)
                sc = sc.to(dev, non_blocking=True)
                if isinstance(c, QuantKV):
                    c.q[:, pb] = q
                    c.s[:, pb] = sc
                else:
                    c[:, pb] = (q.float() * sc[:, :, 0, :, None]).to(c.dtype)
            if dev.type == "cuda" and self._kvhost.pin(h):
                event = torch.cuda.Event()
                event.record()
                self._readmits.append((h, event))

    def _host_extend(self, slot: int, req: GenRequest, shared, shtok: int):
        """Extend a device prefix-cache match with host-tier blocks.

        Called from _admit_one right after _match_prefix_blocks: for each
        chain hash past the device hit, a host hit is readmitted into a
        fresh page (registered in the hash index, so the NEXT tenant finds
        it on the device); the first miss on both tiers ends the run —
        everything after it is prefilled. Returns the updated
        (shared, shtok); readmitted blocks are ref'd like matched ones."""
        if self._kvhost is None:
            return shared, shtok
        self._host_drain()   # a block spilled this tick is admissible now
        limit = self.ec.max_context - 2 - self._ctx_reserve
        nfull = min(len(req.prompt_ids) - 1, limit - 1) // BLOCK
        base = len(shared) if shared is not None else 0
        if nfull <= base:
            return shared, shtok
        chain = self._chain_hashes(req.prompt_ids[:nfull * BLOCK])
        added: list[int] = []
        for vb in range(base, nfull):
            blk = self._kvhost.get(chain[vb])
            if blk is None:
                break
            got = self._take_blocks(1, keep_slot=slot)
            if got is None:
                break
            pb = got[0]
            self._readmit_block(pb, chain[vb], blk)
            # register: this page now holds the chain's content on device
            self._drop_hash(pb)
            self._hash_index[chain[vb]] = pb
            self._block_hash_of[pb] = chain[vb]
            added.append(pb)
        if added:
            shared = (list(shared) if shared is not None else []) + added
            shtok = len(shared) * BLOCK
        self._host_note()
        return shared, shtok

    def kvhost_snapshot(self) -> dict:
        """Host-tier stats ({} when the tier is off)."""
        if self._kvhost is None:
            return {}
        st = self._kvhost.stats()
        st["pending"] = len(self._host_pending)
        return st

    # ------------------------------------------------- speculative dispatch

    def _dev_draft_ingest(self, buf, pos, idx):
        """Write a prompt window into the draft's cache (K/V only)."""
        dev = self.device
        with torch.no_grad():
            self._draft_ingest_fn(
                self._draft[1], self._cos_d, self._sin_d, self._kcd,
                self._vcd, torch.as_tensor(buf, device=dev),
                torch.tensor(pos, device=dev), torch.tensor(idx, device=dev))

    def _dev_spec_admit_tail(self, idx, mask=None):
        """Sample slot `idx`'s first token at admission (a grammar slot
        under its start state's mask); it becomes the slot's carried
        next_token. Returns (token, logprob) on the host."""
        if mask is None:
            s = self._slots[idx]
            if s is not None and s.matcher is not None:
                mask = self._mask_host[idx:idx + 1].copy()
        with torch.no_grad():
            tok, lp, self._sampler = self._spec_admit_tail_fn(
                self._sampler, self._last_logits, idx, self._mask_dev(mask))
            self._next_tokens[idx] = tok
            # the emitted first token is needed now: one sync a request
            return int(tok), float(lp)

    def _dev_spec_decode(self, active):
        """ONE speculative step for every active slot: gamma draft decode
        steps and the target's verify of each window (engine/spec.py
        build_spec_decode)."""
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_steps_dispatched"] += self.ec.gamma + 1
        with torch.no_grad():
            (tokens_out, n_out, logprobs_out, self._next_tokens,
             self._sampler, self._lengths, n_extra) = self._spec_fn(
                self.params, self._draft[1], self._cos, self._sin,
                self._cos_d, self._sin_d, self._kc, self._vc, self._kcd,
                self._vcd, self._sampler, self._lengths, self._next_tokens,
                torch.as_tensor(active, device=self.device), self._tab())
            return _AsyncFetch((tokens_out, n_out, logprobs_out, n_extra))

    _SPEC_PACK_FIELDS = ("verify", "tokens", "spec_rows", "set_len",
                         "logit_set", "logit_rows", "block_seq", "qstart",
                         "qlen", "kvlen")

    def _dev_spec_ragged(self, pack):
        """ONE spec-as-ragged dispatch: gamma draft steps and one ragged
        target forward over every verifying slot's (gamma+1)-row window
        plus the packed prefill chunks (engine/spec.py build_spec_ragged);
        table-backed grammar slots verify under the device tables
        (pack["gstate"])."""
        m = self.metrics
        m["decode_dispatches"] += 1
        m["decode_steps_dispatched"] += self.ec.gamma + 1
        m["spec_ragged_dispatches"] += 1
        self._note_ragged(int(pack["packed"]), int(np.sum(pack["verify"]))
                          * (self.ec.gamma + 1))
        d = self._pack_dev(pack, self._SPEC_PACK_FIELDS)
        gkw = {}
        if pack.get("gstate") is not None:
            gkw = dict(gstate=torch.as_tensor(
                np.asarray(pack["gstate"], np.int32), device=self.device),
                gmasks=self._gmasks, gtrans=self._gtrans)
        with torch.no_grad():
            (tokens_out, n_out, logprobs_out, self._next_tokens,
             self._sampler, self._last_logits, self._lengths,
             n_extra) = self._spec_ragged_fn(
                self.params, self._draft[1], self._cos, self._sin,
                self._cos_d, self._sin_d, self._kc, self._vc, self._kcd,
                self._vcd, self._sampler, self._last_logits, self._lengths,
                self._next_tokens, d["verify"], d["tokens"],
                d["spec_rows"], d["set_len"], d["logit_set"],
                d["logit_rows"], d["block_seq"], d["qstart"], d["qlen"],
                d["kvlen"], self._tab(), inject=self._inj(pack.get("inject")),
                **gkw)
            return _AsyncFetch((tokens_out, n_out, logprobs_out, n_extra))

    # ------------------------------------------------------------ grammar

    def _dev_gtable(self, base: int, masks, trans):
        """Install one grammar's rows at `base` in the shared tables: the
        numpy mirrors, and the device tables IN PLACE (copy_ into the rows
        of the tensors allocated once, so every captured graph keeps
        reading them; the rows are new, so no dispatch in flight reads
        them)."""
        n = masks.shape[0]
        self._gmasks_np[base:base + n] = masks
        self._gtrans_np[base:base + n] = trans
        with torch.no_grad():
            self._gmasks[base:base + n].copy_(
                torch.from_numpy(np.ascontiguousarray(masks).view(np.int32)))
            self._gtrans[base:base + n].copy_(
                torch.from_numpy(np.ascontiguousarray(trans)))

    def _grammar_table_entry(self, grammar: str) -> int | None:
        """Base row of this grammar's states in the shared device tables,
        building and installing them (off the decode hot path) at its
        first use. None = the automaton does not fit (it overflows the
        cap, or the rows left, or the tables are off): the slot keeps the
        per-token host masks."""
        if not self._gtab_cap:
            return None
        if grammar in self._gtab_base:
            return self._gtab_base[grammar]
        tbl = self._compile_grammar(grammar).table(self._gtab_cap)
        base = None
        if tbl is not None and self._gtab_used + tbl.n_states <= self._gtab_cap:
            base = self._gtab_used
            masks = tbl.masks.copy()
            # local -1 (token masked off — never sampled) → absolute 0, the
            # identity row; live states → base-relative absolute rows
            trans = np.where(tbl.trans < 0, 0,
                             tbl.trans + base).astype(np.int32)
            # EOS policy is the tokenizer's, injected here (the raw table
            # has no EOS bits, as matcher.mask_bits): accepting states
            # allow EOS and self-loop on it, as the host matcher never
            # advances past EOS
            V = self.cfg.vocab_size
            eos = [e for e in (self.tok.eos_ids if self.tok else ())
                   if 0 <= e < V]
            for st in range(tbl.n_states):
                if tbl.accepting[st]:
                    for e in eos:
                        masks[st, e >> 5] |= np.uint32(1) << np.uint32(e & 31)
                        trans[st, e] = base + st
            self._dev_gtable(base, masks, trans)
            self._gtab_used = base + tbl.n_states
            self.metrics["grammar_table_states"] = self._gtab_used
        else:
            self.metrics["grammar_table_overflows"] += 1
        self._gtab_base[grammar] = base
        return base

    def _compile_grammar(self, grammar: str):
        """Compile (or fetch the cached) GBNF → CompiledGrammar; a malformed
        grammar raises ValueError. Called from request threads (submit)
        and the engine loop. Only the lazy GrammarCache init (it walks the
        whole vocabulary once) holds _grammar_lock; the cache is itself
        thread-safe, and a slow compile holds none of the engine's locks."""
        cache = self._grammar_cache
        if cache is None:
            with self._grammar_lock:
                if self._grammar_cache is None:
                    if self.tok is None:
                        raise ValueError(
                            "grammar constraint requires a tokenizer")
                    from localai_tpu_torch.functions.matcher import \
                        GrammarCache

                    self._grammar_cache = GrammarCache(self.tok)
                cache = self._grammar_cache
        return cache.get(grammar)

    def _matcher_for(self, grammar: str):
        return self._compile_grammar(grammar).state()

    def _mask_row(self, st: int) -> np.ndarray:
        """Table state `st`'s mask row as the host's u8 bytes (LSB-first
        u32 words read as LSB-first bytes)."""
        return self._gmasks_np[st].view(np.uint8)[:self._mask_nbytes]

    # ------------------------------------------------------------ requests

    def submit(self, req: GenRequest) -> tuple[int, queue.Queue]:
        """Enqueue a request; returns (request_id, output queue of StepOutput)."""
        if self._dead:
            raise RuntimeError("engine loop has terminated; no new requests")
        if len(req.prompt_ids) == 0:
            raise ValueError("empty prompt")
        limit = self.ec.max_context - 2 - self._ctx_reserve
        if len(req.prompt_ids) > limit:
            raise ValueError(
                f"prompt length {len(req.prompt_ids)} exceeds {limit} "
                f"(max_context minus the decode margin); longer prompts "
                f"need a larger context window")
        if self.mesh is not None:
            for cond, what in (
                    (req.mm_embeds is not None,
                     "multimodal prompts (mm_embeds)"),
                    (req.context_shift, "context shift"),
                    (req.prompt_cache_path, "the disk prompt cache"),
                    (req.grammar, "grammar-constrained decoding"),
                    (req.resume is not None, "resume (the host tier's "
                     "checkpoints)")):
                if cond:
                    raise not_ported(f"{what} under a mesh", "parallel")
        if req.context_shift and self._draft is not None:
            raise ValueError(
                "context_shift is not supported with a draft model "
                "(the draft cache would need shifting too)")
        if req.context_shift and self._paged and not self._shift_ok:
            raise ValueError(
                "context_shift with paged KV needs max_context spanning "
                "more than keep+discard blocks (128-token granularity); "
                "raise max_context or use a dense cache")
        if req.context_shift and self._tiered:
            raise ValueError(
                "context_shift is not supported under a sink_window "
                "kv_policy (the ring geometry already bounds residency; "
                "long sequences decode in place up to max_context)")
        if req.kv_policy:
            # a malformed or oversized policy fails THIS call (gRPC
            # INVALID_ARGUMENT), not in-band at admission
            kvtier.resolve_policy(req.kv_policy, self._kv_policy)
        if self._paged and self._blocks_for(req) > self.ec.kv_pages - 1:
            raise ValueError(
                f"request needs {self._blocks_for(req)} KV blocks under "
                f"kv_policy {self._req_policy(req).describe()} (prompt "
                f"{len(req.prompt_ids)} + max_tokens {req.max_tokens}) but "
                f"the pool has {self.ec.kv_pages - 1}; raise kv_pages or "
                f"lower max_tokens")
        V = self.cfg.vocab_size
        if any(not (0 <= t < V) for t in req.prompt_ids):
            raise ValueError(f"prompt token id outside [0, {V})")
        if req.grammar and self._draft is not None:
            if not self._ragged:
                raise ValueError(
                    "grammar-constrained decoding with a draft model needs "
                    "ragged continuous batching (the spec-as-ragged verify "
                    "threads the device grammar tables; the dense spec "
                    "step has no grammar lane)")
            # the verify masks come from the device tables (the host cannot
            # resync inside the draft+verify step): the automaton must fit
            if not self._gtab_cap or self._compile_grammar(
                    req.grammar).table(self._gtab_cap) is None:
                raise ValueError(
                    "grammar automaton exceeds grammar_table_states; "
                    "speculative verify needs the precompiled device "
                    "grammar table (raise grammar_table_states or drop "
                    "the draft model for this grammar)")
        if req.mm_embeds is not None:
            if self._draft is not None and not self._ragged:
                raise ValueError(
                    "multimodal prompts with a draft model need ragged "
                    "continuous batching (feature rows pack into the flat "
                    "stream; the bucketed dense prefill has no draft-side "
                    "path). The draft itself ingests token ids only.")
            emb = np.asarray(req.mm_embeds, np.float32)
            pos = np.asarray(req.mm_positions, np.int64)
            if emb.ndim != 2 or emb.shape[1] != self.cfg.hidden_size:
                raise ValueError(
                    f"mm_embeds must be [K, {self.cfg.hidden_size}], got "
                    f"{emb.shape}")
            if pos.shape != (emb.shape[0],):
                raise ValueError("mm_positions must match mm_embeds rows")
            if len(pos) and (pos.min() < 0
                             or pos.max() >= len(req.prompt_ids)):
                raise ValueError("mm_positions outside the prompt")
            if len(pos) > 1 and (np.diff(pos) <= 0).any():
                raise ValueError("mm_positions must be strictly increasing")
            req.mm_embeds, req.mm_positions = emb, pos
        if req.grammar:
            # compile now (cached) so a malformed GBNF rejects THIS call
            # with ValueError (gRPC INVALID_ARGUMENT) instead of failing
            # later at admission; and enumerate its automaton for the
            # device tables here (memoized per grammar): the caller's
            # thread pays the seconds a new grammar's states take at a
            # full vocabulary, not the engine loop every stream waits on
            cg = self._compile_grammar(req.grammar)
            if self._gtab_cap:
                cg.table(self._gtab_cap)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._live.add(rid)
        out: queue.Queue = queue.Queue()
        req.queued_t = time.monotonic()
        self._queue.put((rid, req, out))
        self._wake.set()
        return rid, out

    def cancel(self, rid: int):
        """Mark a submitted request for eviction (finish "cancelled" at its
        next token; queued requests terminate at admission)."""
        with self._lock:
            if rid in self._live:
                self._cancelled.add(rid)
        self._wake.set()

    def _finish_rid(self, rid: int):
        with self._lock:
            self._live.discard(rid)
            self._cancelled.discard(rid)

    # ------------------------------------------------------------ admission

    def _bucket(self, n: int) -> int:
        for b in self._small_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt too long for single-shot prefill: {n}")

    def _admit_one(self, rid: int, req: GenRequest, out: queue.Queue,
                   batch: list | None = None) -> bool:
        # host-side per-request failures (a grammar that no longer
        # compiles, no tokenizer) reject THIS request only and never stop
        # the loop, which would strand every other stream
        try:
            matcher = self._matcher_for(req.grammar) if req.grammar else None
            # the device tables: installed once per grammar; None = the
            # automaton overflowed them → per-token host masks
            gbase = (self._grammar_table_entry(req.grammar)
                     if req.grammar else None)
            if req.grammar and gbase is None and self._draft is not None:
                # the tables filled up after submit's check: the spec
                # verify cannot fall back to host masks
                raise ValueError("grammar table capacity exhausted")
        except Exception:
            import traceback

            traceback.print_exc()
            self._finish_rid(rid)
            out.put(StepOutput(
                request_id=rid, text="", token_id=-1, logprob=0.0,
                finished=True, finish_reason="error",
                prompt_tokens=len(req.prompt_ids)))
            return False
        n = len(req.prompt_ids)
        chunked = n > self._small_max
        bucket = None if chunked else self._bucket(n)
        mm = req.mm_embeds is not None
        if self._ragged:
            # ragged admissions are always chunked: admission is host-only
            # slot bookkeeping and the prompt packs unpadded into mixed
            # ragged ticks — no bucket padding, no admission dispatch. A
            # multimodal prompt packs too: its feature rows ride the flat
            # stream as per-row embedding overrides (ragged_forward's
            # inject)
            chunked, bucket = True, None
        pol = self._req_policy(req) if self._tiered else None
        if self._tiered and not pol.windowed:
            # admission-time policy demotion: a full-policy request that
            # does not fit the compact table (its identity map would write
            # past the resident columns), or that lands while the free pool
            # runs low, rides the engine's window instead of being rejected
            margin = 2 * self.ec.decode_block + 1
            base = blocks_needed(min(n + max(req.max_tokens, 0) + margin,
                                     self.ec.max_context))
            if base > self._maxb or base > len(self._kv_free):
                pol = self._kv_policy
                self.metrics["kv_policy_demotions"] += 1
        # multimodal: an id-level prefix match would take the repeated
        # image token for a hit while the injected features differ — no
        # slot, block, host or disk reuse
        slot, lcp = self._pick_slot([] if mm else req.prompt_ids)
        if self._paged:
            shared = None
            if req.context_shift:
                # a shift rotates this slot's pages IN PLACE — never over
                # pages other tenants read: no borrowed pages, and lcp 0
                # makes _alloc_slot's copy-on-write pass swap every
                # externally shared retained block before the prefill
                lcp = 0
            elif self.ec.prompt_cache and self._draft is None and not mm:
                # block-level prefix cache: another tenant's pages beat the
                # slot-retained token match when they cover more prefix
                shared, shtok = self._match_prefix_blocks(req.prompt_ids)
                if self._kvhost is not None:
                    # device miss → host tier: readmit spilled blocks before
                    # falling back to prefill; the uploads enqueue ahead of
                    # the suffix's prefill chunks
                    shared, shtok = self._host_extend(slot, req, shared,
                                                      shtok)
                if shtok > lcp:
                    lcp = shtok
                else:
                    self._unref_blocks(shared)
                    shared = None
            if pol is not None and pol.windowed and lcp:
                # a windowed slot borrows or keeps prefix pages ONLY for
                # whole sink blocks: past the sinks its blocks live in ring
                # columns whose position map is its own, so those cached
                # blocks are prefilled again (kv_recomputes)
                keep = min(lcp // BLOCK, self._kv_policy.sink_blocks)
                self.metrics["kv_recomputes"] += max(0, lcp // BLOCK - keep)
                if shared is not None:
                    if keep < len(shared):
                        self._unref_blocks(shared[keep:])
                        shared = shared[:keep]
                    if not shared:
                        shared = None
                lcp = keep * BLOCK
            eff = self._alloc_slot(slot, req, shared=shared, lcp=lcp)
            if eff is None:
                # pool exhausted even after reclaim: defer (FIFO) until
                # blocks free — the caller re-attempts on later ticks
                self._free.append(slot)
                self._deferred = (rid, req, out)
                self.metrics["kv_admissions_deferred"] += 1
                return None
            lcp = eff
            if self._tiered:
                self._set_tier_slot(slot, pol)
            self._note_pool()
        self._slot_kv_tokens[slot] = []
        disk_prefix = 0
        if not lcp and req.prompt_cache_path and not mm:
            lcp = disk_prefix = self._load_prompt_cache(slot, req)
        if lcp:
            # shared prefix already in this slot's cache: prefill only the
            # suffix via the chunked-extend path (start offset = lcp)
            chunked = True
            self.metrics["prompt_cache_hits"] += 1
            self.metrics["prompt_tokens_reused"] += lcp
        if req.resume is not None:
            # resume outcome: every full prefix block covered by the device
            # or host cache = a readmit; any uncovered full block pays the
            # prefill of prompt + emitted
            if self._paged:
                full = (min(n - 1, self.ec.max_context - 2
                            - self._ctx_reserve - 1) // BLOCK) * BLOCK
                fast = full > 0 and lcp >= full
            else:
                fast = lcp > 0
            self.metrics["resume_readmits" if fast
                         else "resume_reprefills"] += 1
        p = req.params.normalized()
        heavy = bool(p.logit_bias) or p.repeat_penalty != 1.0 \
            or p.presence_penalty != 0.0 or p.frequency_penalty != 0.0
        row = sampler_row(req.params, self.cfg.vocab_size,
                          fallback_seed=rid + 1, include_bias=heavy)
        if req.resume is not None and req.resume.get("key") is not None:
            # the preempted slot's RNG key, read back at the spill-drain,
            # continues its exact split sequence (greedy ignores it)
            row = dict(row, key=np.asarray(req.resume["key"], np.uint32))
        if heavy:
            counts_row = np.zeros((self.cfg.vocab_size,), np.int32)
            pid, pcnt = np.unique(np.asarray(req.prompt_ids, np.int64),
                                  return_counts=True)
            counts_row[pid] = pcnt
        else:
            counts_row = None
        if not chunked:
            if batch is not None and self._draft is None and not mm:
                # defer the device call: _flush_admits batches same-bucket
                # admissions from this tick into one prefill pass
                batch.append(dict(slot=slot, n=n, bucket=bucket,
                                  prompt_ids=req.prompt_ids, row=row,
                                  counts_row=counts_row, heavy=heavy))
            else:
                ids = self._pad_ids([dict(n=n, prompt_ids=req.prompt_ids)],
                                    bucket)
                inject = self._mm_inject(req, 0, bucket) if mm else None
                self._dev_admit(ids, n, slot, row, counts_row, inject)
                if self._draft is not None:
                    self._dev_draft_ingest(ids, 0, slot)

        W = self.ec.sampling_topk_width
        fast_w = None
        if W and not req.grammar and (p.typical_p is None
                                      or p.typical_p >= 1.0):
            V = self.cfg.vocab_size
            tk = min(p.top_k or 0, V)
            if p.greedy:
                fast_w = min(W, V)
            elif 0 < tk <= min(W, V):
                fast_w = min(W, V)
            elif 0 < tk <= min(8 * W, V):
                fast_w = min(8 * W, V)
        slot_obj = self._slots[slot] = _Slot(
            request_id=rid, req=req, out=out,
            detok=self.tok.stream_decoder() if self.tok else None,
            start_time=time.monotonic(), prompt_len=n,
            prefilled=not chunked, row=row, counts_row=counts_row,
            prefill_pos=lcp, fast_w=fast_w, matcher=matcher, gbase=gbase,
            disk_prefix=disk_prefix,
        )
        if chunked:
            self._prefillq.append(slot)
        if matcher is not None:
            # the first token samples under the start state's mask, as every
            # later one: a table-backed slot starts at its grammar's state 0
            # (its mask row straight from the table mirror, no V-trial
            # matcher walk for the life of the request); a host-only slot
            # under the matcher's mask
            self._grammar_slots += 1
            if gbase is not None:
                self._gstate[slot] = gbase
                self._mask_host[slot] = self._mask_row(gbase)
            else:
                self._grammar_hostonly += 1
                self._mask_host[slot] = matcher.mask_bits(
                    self.tok.eos_ids if self.tok else ())
            if req.resume is not None:
                # replay the emitted tokens through the automaton, so the
                # matcher (and the table state) resumes mid-grammar where
                # the preempted slot stopped
                eos = self.tok.eos_ids if self.tok else ()
                for t in req.prompt_ids[n - int(req.resume.get(
                        "emitted", 0)):]:
                    if not matcher.accept(t):
                        break
                    if gbase is not None:
                        st = int(self._gtrans_np[self._gstate[slot], t])
                        self._gstate[slot] = st
                        self._mask_host[slot] = self._mask_row(st)
                    else:
                        self._mask_host[slot] = matcher.mask_bits(eos)
        if req.resume is not None:
            # detokenizer replay: the emitted chain through the fresh
            # incremental decoder (the preempted run's stream), the chars
            # the client already has suppressed, and the remainder — text
            # produced but never released (stop-string holdback, chars past
            # the last chunk sent) — to the stream or the holdback buffer
            cut = n - int(req.resume.get("emitted", 0))
            slot_obj.resume_base = n - cut
            replay = ""
            if slot_obj.detok is not None:
                for t in req.prompt_ids[cut:]:
                    replay += slot_obj.detok.push(t)
            sent = max(0, int(req.resume.get("sent_chars", 0)))
            leftover = replay[sent:]
            slot_obj.sent_chars = sent
            if req.stop:
                slot_obj.pending_text = leftover
            elif leftover:
                slot_obj.sent_chars += len(leftover)
                out.put(StepOutput(
                    request_id=rid, text=leftover, token_id=-1,
                    logprob=0.0, finished=False,
                    generated_tokens=0, prompt_tokens=n))
        self.metrics["prompt_tokens_processed"] += n - lcp
        if not chunked and self._draft is not None:
            # the first token is sampled (and emitted) at admission; it is
            # the slot's carried next_token
            tok, lp = self._dev_spec_admit_tail(slot)
            self._emit(slot, self._slots[slot], tok, lp, time.monotonic(),
                       path="spec")
        return True

    def _prefill_tick(self):
        """Admission work for one tick: continue chunked prefills (oldest
        first) and admit queued requests, up to `admit_per_tick` units while
        decodes run; an idle engine drains freely."""
        budget = max(1, self.ec.admit_per_tick)
        if not any(s is not None and s.prefilled for s in self._slots):
            budget = max(budget, self.ec.max_slots)
        pending: list = []
        try:
            self._prefill_drain(budget, pending)
        finally:
            self._flush_admits(pending)

    def _prefill_drain(self, budget: int, pending: list):
        for _ in range(budget):
            # ragged engines pack ALL prefill into mixed ragged ticks
            # (_ragged_tick); nothing takes the dense chunked path here
            if self._prefillq and not self._ragged:
                idx = self._prefillq[0]
                slot = self._slots[idx]
                if self._tiered:
                    self._kv_tick_slot(idx, slot)
                ids = slot.req.prompt_ids
                pos = slot.prefill_pos
                nvalid = min(len(ids) - pos, self._chunk)
                buf = np.zeros((1, self._chunk), np.int32)
                buf[0, :nvalid] = ids[pos:pos + nvalid]
                final = pos + nvalid == len(ids)
                inject = (self._mm_inject(slot.req, pos, self._chunk)
                          if slot.req.mm_embeds is not None else None)
                if final:
                    self._dev_extend_final(buf, pos, nvalid, idx, slot.row,
                                           slot.counts_row, inject)
                else:
                    self._dev_extend_mid(buf, pos, idx, inject)
                if self._draft is not None:
                    self._dev_draft_ingest(buf, pos, idx)
                slot.prefill_pos = pos + nvalid
                if final:
                    slot.prefilled = True
                    self._prefillq.remove(idx)
                    if self._draft is not None:
                        tok, lp = self._dev_spec_admit_tail(idx)
                        self._emit(idx, slot, tok, lp, time.monotonic(),
                                   path="spec")
                continue
            if not self._free:
                return
            if self._deferred is not None:
                # a paged admission waiting on KV blocks retries only after
                # something released (head-of-line, preserving FIFO)
                if not self._blocks_freed:
                    return
                self._blocks_freed = False
                rid, req, out = self._deferred
                self._deferred = None
            else:
                try:
                    rid, req, out = self._queue.get_nowait()
                except queue.Empty:
                    return
            # dead on arrival (cancelled, or deadline spent in the queue)
            if (rid in self._cancelled
                    or (req.deadline and time.monotonic() > req.deadline)):
                reason = "cancelled" if rid in self._cancelled else "timeout"
                self._finish_rid(rid)
                out.put(StepOutput(
                    request_id=rid, text="", token_id=-1, logprob=0.0,
                    finished=True, finish_reason=reason,
                    prompt_tokens=len(req.prompt_ids)))
                continue
            self._admitting = (rid, req, out)
            ok = self._admit_one(rid, req, out, batch=pending)
            self._admitting = None
            if ok is None:
                return

    @staticmethod
    def _mm_inject(req: GenRequest, start: int, width: int):
        """(extra [1, width, H] f32, mask [1, width] bool) for the prompt
        window [start, start + width): image-feature rows from
        req.mm_embeds land at their expanded positions, everything else
        stays a token."""
        pos, emb = req.mm_positions, req.mm_embeds
        lo = int(np.searchsorted(pos, start))
        hi = int(np.searchsorted(pos, start + width))
        extra = np.zeros((1, width, emb.shape[1]), np.float32)
        mask = np.zeros((1, width), bool)
        sel = (pos[lo:hi] - start).astype(np.int64)
        extra[0, sel] = emb[lo:hi]
        mask[0, sel] = True
        return (extra, mask)

    @classmethod
    def _pack_inject(cls, s, pos: int, nvalid: int, row: int, T: int, inj):
        """Add slot `s`'s feature rows of the chunk [pos, pos + nvalid),
        packed at flat row `row`, to the pack's inject pair `inj` (made at
        the first chunk with feature rows of a tick: a text-only tick
        ships none). Returns the pair, or None."""
        if s.req.mm_embeds is None:
            return inj
        extra, mask = cls._mm_inject(s.req, pos, nvalid)
        if not mask.any():
            return inj
        if inj is None:
            inj = (np.zeros((T, extra.shape[2]), np.float32),
                   np.zeros((T,), bool))
        inj[0][row:row + nvalid] = extra[0]
        inj[1][row:row + nvalid] = mask[0]
        return inj

    @staticmethod
    def _pad_ids(plans: list, bucket: int) -> np.ndarray:
        ids = np.zeros((len(plans), bucket), np.int32)
        for i, p in enumerate(plans):
            ids[i, :p["n"]] = p["prompt_ids"]
        return ids

    def _flush_admits(self, pending: list):
        """Run this tick's deferred admissions: group by (bucket, heavy),
        one batched prefill per group, group size padded up to the next of
        _ADMIT_GROUP_SIZES by repeating the last plan (identical rows)."""
        groups: dict = {}
        for plan in pending:
            groups.setdefault((plan["bucket"], plan["heavy"]),
                              []).append(plan)
        for (bucket, heavy), g in groups.items():
            while g:
                if len(g) == 1:
                    p = g.pop()
                    self._dev_admit(self._pad_ids([p], bucket), p["n"],
                                    p["slot"], p["row"], p["counts_row"])
                    continue
                k = min(len(g), self._ADMIT_GROUP_SIZES[-1])
                size = next(s for s in self._ADMIT_GROUP_SIZES if s >= k)
                batch, g = g[:k], g[k:]
                batch = batch + [batch[-1]] * (size - k)
                ids = self._pad_ids(batch, bucket)
                lens = np.asarray([p["n"] for p in batch], np.int32)
                slots = np.asarray([p["slot"] for p in batch], np.int32)
                rows = {f: np.stack([np.asarray(p["row"][f]) for p in batch])
                        for f in batch[0]["row"]}
                counts = (np.stack([p["counts_row"] for p in batch])
                          if heavy else None)
                self._dev_admit_many(ids, lens, slots, rows, counts)

    # ------------------------------------------------------------ decode

    def _active_mask(self) -> np.ndarray:
        return np.array([s is not None and s.prefilled for s in self._slots],
                        bool)

    def _block_steps(self) -> int:
        """Steps the next block dispatch may fuse: 1 while a per-token host
        decision is live (pending admissions/prefills, a slot near its
        context limit); a slot near max_tokens steps the batch down a
        power-of-two ladder."""
        G = self.ec.decode_block
        if (G <= 1 or not self.ec.pipeline or self._prefillq
                or (self._free and not self._queue.empty())):
            return 1
        limit = self.ec.max_context - 2 - self._ctx_reserve
        steps = G
        for s in self._slots:
            if s is None or not s.prefilled:
                continue
            if s.prompt_len + s.generated - s.shifted + 2 * G >= limit:
                return 1
            stale = self._inflight_steps if self._pending is not None else 0
            rem = s.req.max_tokens - s.generated - stale
            while steps > 1 and steps * 2 > max(rem, 1):
                steps //= 2
            if steps == 1:
                return 1
        return steps

    def _loop_block_reason(self, entries) -> str | None:
        """None when this dispatch can take the fused loop; otherwise why
        the block/ladder path runs instead."""
        if self._decode_loop_fn is None:
            return "loop_disabled"
        if self._draft is not None:
            return "draft_engine"
        # table-backed grammar slots ride the loop (the device gathers each
        # step's mask row and advances the state); only automata that
        # overflowed the tables need per-token host masks
        if self._grammar_hostonly > 0:
            return "grammar_hostonly"
        if self._prefillq:
            return "pending_prefill"
        if self._free and not self._queue.empty():
            return "pending_admission"
        if any(self._slots[i].req.stop for i, _ in entries):
            return "stop_string"
        return None

    def _dispatch_loop(self, active, entries, fast):
        """Dispatch the fused loop with per-slot budgets net of the pending
        dispatch's reservation, so two pipelined loops never overshoot."""
        G = (self.ec.ragged_loop_steps if self._ragged_loop_fn is not None
             else self.ec.decode_loop)
        B = self.ec.max_slots
        remaining = np.zeros((B,), np.int32)
        check_eos = np.zeros((B,), bool)
        live = []
        for i, rid in entries:
            s = self._slots[i]
            rem = s.req.max_tokens - s.generated - s.inflight
            if rem <= 0:
                active[i] = False
                continue
            remaining[i] = rem
            check_eos[i] = self.tok is not None and not s.req.ignore_eos
            live.append((i, rid))
        if not live:
            return None
        res = {}
        for i, _ in live:
            res[i] = int(min(G, remaining[i]))
            self._slots[i].inflight += res[i]
        self._inflight_steps = G
        gstate = self._gstate.copy() if self._grammar_slots > 0 else None
        if self._ragged_loop_fn is not None:
            # ragged engines: pure-decode dispatches take the pack-free
            # ragged loop — the decode loop's stops plus the first-finish
            # exit, so a freed slot admits without waiting out the loop
            fetch = self._dev_rloop_decode(active, remaining, check_eos,
                                           fast, gstate=gstate)
            return ("rloop", fetch, live, res)
        fetch = self._dev_decode_loop(active, remaining, check_eos, fast,
                                      gstate=gstate)
        return ("loop", fetch, live, res)

    def _dispatch(self):
        """Dispatch one decode step, a fused block, or a fused loop for the
        active slots; returns a tagged pend (without waiting for the
        device) or None when nothing can run."""
        active = self._active_mask()
        if not active.any():
            return None
        entries = [(int(i), self._slots[i].request_id)
                   for i in np.where(active)[0]]
        # sort-free sampling only while no grammar slot is live: a grammar
        # mask needs the full sampler
        fast = None
        if self._grammar_slots == 0:
            ws = [self._slots[i].fast_w for i, _ in entries]
            fast = max(ws) if all(w is not None for w in ws) else None
        if self._loop_block_reason(entries) is None:
            return self._dispatch_loop(active, entries, fast)
        steps = self._block_steps()
        # the dispatch-time masks: _consume compares each slot's refreshed
        # mask with what the device sampled under, to catch the allowed set
        # GROWING within a block
        gmask = self._mask_host.copy() if self._grammar_slots > 0 else None
        self._inflight_steps = steps
        res = {}
        for i, _ in entries:
            res[i] = steps
            self._slots[i].inflight += steps
        if steps > 1:
            fetch = self._dev_decode_block(active, steps, fast, gmask)
        else:
            fetch = self._dev_decode(active, fast, gmask)
        return ("block", fetch, entries, gmask, res)

    def _release_reservations(self, entries, res):
        for i, rid in entries:
            s = self._slots[i]
            if s is not None and s.request_id == rid:
                s.inflight = max(0, s.inflight - res.get(i, 0))

    # device exit codes of the fused ragged loop (models/llama.py
    # RLOOP_EXIT_*) → the reference's metric names; host_arbitration is
    # recorded host-side when a tick declines the loop (_ragged_tick)
    _RLOOP_EXIT_REASON = {0: "steps_cap", 1: "finish", 2: "prefill"}

    def _rloop_exit(self, code: int, reason: str | None = None) -> None:
        """Count one fused-ragged-loop exit as rloop_exit_<cause>."""
        reason = reason or self._RLOOP_EXIT_REASON.get(code, "steps_cap")
        self.metrics["rloop_exit_" + reason] += 1

    def _emit_ring(self, entries, tokens, logprobs, n_out, steps, now,
                   path):
        """Commit a [steps, B] token ring in device order: slot b's valid
        tokens are rows 0..n_out[b]-1. The host re-derives every finish in
        _emit; a slot finished earlier (cancel/deadline) drops the rest."""
        for g in range(steps):
            for i, rid in entries:
                if g >= int(n_out[i]):
                    continue
                slot = self._slots[i]
                if slot is None or slot.request_id != rid:
                    continue
                self._emit(i, slot, int(tokens[g, i]), float(logprobs[g, i]),
                           now, path=path)

    def _consume_loop(self, pend):
        """Finish a fused loop's fetch, credit the steps actually run and
        commit slot b's n_out[b] tokens in device order. The pack-free
        ragged loop ("rloop") also carries its exit code."""
        tag, fetch, entries, res = pend
        t0 = time.perf_counter()
        out = fetch.wait()
        self.metrics["host_sync_wait_ms"] += (time.perf_counter() - t0) * 1e3
        if tag == "rloop":
            tokens, logprobs, n_out, code, steps = out
            self._rloop_exit(int(code))
        else:
            tokens, logprobs, n_out, steps = out
        self.metrics["decode_steps_dispatched"] += int(steps)
        self._release_reservations(entries, res)
        self._emit_ring(entries, tokens, logprobs, n_out, int(steps),
                        time.monotonic(), tag)

    def _consume(self, pend):
        """Block on a dispatch's results and run the host-side token
        handling for every slot that was active at dispatch time and still
        serves the same request. Grammar slots in a fused block sampled
        under their block-START mask: the first token a slot's matcher
        rejects marks it for rollback — its accepted prefix stands, the
        rest of its block is dropped, and _repair restores the device
        state."""
        if pend[0] in ("loop", "rloop"):
            self._consume_loop(pend)
            return
        _, fetch, entries, gmask, res = pend
        t0 = time.perf_counter()
        tokens, logprobs = fetch.wait()
        self.metrics["host_sync_wait_ms"] += (time.perf_counter() - t0) * 1e3
        self._release_reservations(entries, res)
        now = time.monotonic()
        if tokens.ndim == 1:
            tokens, logprobs = tokens[None], logprobs[None]
        steps = tokens.shape[0]
        rolled: list[int] = []
        for g in range(steps):
            for i, rid in entries:
                slot = self._slots[i]
                if slot is None or slot.request_id != rid or i in rolled:
                    continue  # finished earlier in this block
                if not self._emit(i, slot, int(tokens[g, i]),
                                  float(logprobs[g, i]), now,
                                  fresh_mask=(g == 0)):
                    rolled.append(i)
                    continue
                # mask-growth check: rollback at a matcher reject makes
                # in-block sampling exact rejection sampling while the
                # allowed set only shrinks; if this token OPENED tokens the
                # dispatch mask forbade, the rest of the block was drawn
                # from a wrongly restricted distribution and is dropped
                if (gmask is not None and g + 1 < steps
                        and self._slots[i] is slot
                        and slot.matcher is not None
                        and np.any(self._mask_host[i] & ~gmask[i])):
                    rolled.append(i)
        for i in rolled:
            slot = self._slots[i]
            if slot is not None:
                self._repair(i, slot)

    def _repair(self, idx: int, slot: _Slot):
        """Roll a grammar slot back to its last accepted token after a
        fused block sampled past a stale mask (_consume): run the model on
        that token again through the extend path — rewriting the same KV
        row with the same values, restoring last_logits and the slot's
        length to the accepted position — and install the sampler row with
        a fresh deterministic key, PRNGKey(request_id * 1000003 +
        generated) (the admission key would replay the block's draws). The
        rows the block wrote past the accepted position are unreadable
        (attention masks by length) and later steps overwrite them."""
        self.metrics["grammar_rollbacks"] += 1
        n = slot.prompt_len + slot.generated - slot.shifted  # valid rows
        seq = list(slot.req.prompt_ids) + slot.gen_ids
        buf = np.zeros((1, self._chunk), np.int32)
        buf[0, 0] = seq[-1]
        seed = (slot.request_id * 1000003 + slot.generated) & 0x7FFFFFFF
        row = dict(slot.row, key=threefry_seed(seed))
        slot.row = row
        counts = slot.counts_row
        if counts is not None:
            counts = counts.copy()
            for t in slot.gen_ids:
                counts[t] += 1
        self._dev_extend_final(buf, n - 1, 1, idx, row, counts)

    def _kv_tick(self):
        """Advance the hot → cold → evicted lifecycle of windowed slots.

        A raw block is eligible once its LAST token has left the window of
        the oldest position any in-flight or later query can hold (the host
        length only lags the device, so eligibility here is conservative).
        quantize_cold copies the block into the int8 cold pool (_dev_demote,
        enqueued behind any in-flight dispatch; the ring's slack blocks land
        it before the ring wraps over the block). A full cold pool, or a
        drop-policy slot, counts the block evicted: the ring's overwrite IS
        the eviction. With the host tier, an evicted block that ends inside
        the first window span — every token of it computed with its full
        history — is spilled first, under its chain hash."""
        for i, s in enumerate(self._slots):
            if s is not None:
                self._kv_tick_slot(i, s)

    def _kv_tick_slot(self, i: int, s: _Slot):
        """_kv_tick for slot i. The chunked prefill also runs it before each
        chunk of a slot (_prefill_drain): an idle engine's tick runs up to
        max_slots chunks of one slot, more than the ring's margin of one
        chunk, so a tick-start demotion alone would copy blocks the later
        chunks had already overwritten through the ring."""
        pol = self._slot_policy[i]
        if pol is None or not pol.windowed:
            return
        n = (s.prompt_len + s.generated - s.shifted if s.prefilled
             else s.prefill_pos)
        sb = int(self._kv_sb[i])
        lim = n - int(self._kv_window[i])
        while True:
            raw = int(self._demote_next[i])
            if raw < sb or (raw + 1) * BLOCK > lim:
                break
            self._demote_next[i] = raw + 1
            col = sb + (raw - sb) % max(int(self._kv_rw[i]), 1)
            if not self._cold or not self._cold_free:
                self.metrics["kv_evictions"] += 1
                if (self._kvhost is not None and s.shifted == 0
                        and s.req.mm_embeds is None
                        and (raw + 1) * BLOCK
                        <= int(self._kv_window[i])):
                    # ring content sits at TRUE positions; a block ending
                    # inside the first window span is prefix-cache
                    # content for any tenant (later ones saw truncated
                    # attention and are not)
                    ids = list(s.req.prompt_ids) + s.gen_ids
                    if len(ids) >= (raw + 1) * BLOCK:
                        chain = self._chain_hashes(
                            ids[:(raw + 1) * BLOCK])
                        self._spill_block(int(self._table[i, col]),
                                          h=chain[raw], group=chain[0])
                continue
            ci = self._cold_free.pop()
            self._cold_table[i, raw] = ci
            self._slot_cold[i].append(ci)
            self.metrics["kv_cold_blocks"] += 1
            self._dev_demote(int(self._table[i, col]), ci)

    # ------------------------------------------------------------ the loop

    def step(self) -> bool:
        """One engine iteration. In pipelined mode one decode dispatch stays
        in flight: dispatch N+1 is enqueued before N's tokens are read.
        Returns True while work remains."""
        if self._preempt_req.is_set() and (
                time.monotonic() >= self._preempt_t
                or not any(s is not None for s in self._slots)):
            # grace expired (or nothing left decoding): freeze and spill
            # every live slot, manifest the queue, keep serving — the
            # caller owns what happens to the process next
            self._spill_drain()
        if self._draft is not None:
            # draft + ragged = spec-as-ragged: every tick is ONE dispatch
            # of verify windows and prefill chunks
            return (self._step_spec_ragged() if self._ragged
                    else self._step_spec())
        if self._tiered:
            self._kv_tick()
        if self._host_pending or self._readmits:
            # land last tick's spills (their copies have arrived by now),
            # so the pool's occupancy metrics stay current
            self._host_drain()
        if self._ragged and self._step_ragged():
            # mixed tick: decode + prefill ran as one ragged dispatch,
            # consumed synchronously (no pending survives a ragged tick)
            return (any(s is not None for s in self._slots)
                    or not self._queue.empty() or self._pending is not None
                    or self._deferred is not None)
        # grammar batches run synchronously: a sampled token must update
        # the slot's mask (or its state) before the next dispatch
        sync = self._grammar_slots > 0 or not self.ec.pipeline
        if sync and self._pending is not None:
            self._consume(self._pending)
            self._pending = None
        cur = self._dispatch()
        self._prefill_tick()
        if cur is None:
            if self._pending is not None:
                self._consume(self._pending)
                self._pending = None
        elif sync:
            self._consume(cur)
        else:
            prev, self._pending = self._pending, cur
            if prev is not None:
                self._consume(prev)
        return (any(s is not None for s in self._slots)
                or not self._queue.empty() or self._pending is not None
                or self._deferred is not None)

    # ------------------------------------------------- speculative steps

    def _busy(self) -> bool:
        return (any(s is not None for s in self._slots)
                or not self._queue.empty() or self._deferred is not None)

    def _emit_windows(self, entries, tokens_out, n_out, logprobs_out,
                      n_extra):
        """Commit each verifying slot's 1..gamma+1 tokens, counting its
        proposals and acceptances."""
        now = time.monotonic()
        G = self.ec.gamma
        for i, rid in entries:
            slot = self._slots[i]
            if slot is None or slot.request_id != rid:
                continue
            self.metrics["draft_proposed"] += G
            self.metrics["draft_accepted"] += int(n_extra[i])
            for j in range(int(n_out[i])):
                slot = self._slots[i]
                if slot is None or slot.request_id != rid:
                    break  # finished mid-window (EOS/length/stop)
                self._emit(i, slot, int(tokens_out[i, j]),
                           float(logprobs_out[i, j]), now, path="spec")

    def _step_spec(self) -> bool:
        """Spec-mode iteration on a dense or paged engine: one batched
        draft+verify step for every active slot, the admission work
        overlapping it."""
        active = self._active_mask()
        if active.any():
            entries = [(int(i), self._slots[i].request_id)
                       for i in np.where(active)[0]]
            pend = self._dev_spec_decode(active)
            self._prefill_tick()
            t0 = time.perf_counter()
            out = pend.wait()
            self.metrics["host_sync_wait_ms"] += (
                time.perf_counter() - t0) * 1e3
            self._emit_windows(entries, *out)
        else:
            self._prefill_tick()
        return self._busy()

    def _step_spec_ragged(self) -> bool:
        """Draft+ragged iteration: ONE spec-as-ragged dispatch a tick,
        holding every verifying slot's window and the packed prefill
        chunks (admissions land first: they are host-only bookkeeping, so
        new arrivals pack into this tick)."""
        self._prefill_tick()
        active = self._active_mask()
        if active.any() or self._ragged_chunkable():
            self._spec_ragged_tick(active, self._ragged_chunkable())
        return self._busy()

    def _spec_ragged_tick(self, active, chunkable: list[int]):
        """Pack verify windows and prefill chunks into one flat [T] stream
        and dispatch one spec-as-ragged step. The layout is _ragged_tick's
        (QBLK-aligned q blocks, sequence index = slot), except that a
        verifying slot spans ceil((gamma+1)/QBLK) blocks whose rows the
        device fills with the window (the host ships zeros)."""
        B = self.ec.max_slots
        T = self._ragged_rows
        G = self.ec.gamma
        winb = -(-(G + 1) // QBLK)
        block_seq = np.full((T // QBLK,), -1, np.int32)
        tokens = np.zeros((T,), np.int32)
        verify = np.zeros((B,), bool)
        spec_rows = np.zeros((B,), np.int32)
        qstart = np.zeros((B,), np.int32)
        qlen = np.zeros((B,), np.int32)
        kvlen = np.zeros((B,), np.int32)
        set_len = np.full((B,), -1, np.int32)
        logit_set = np.zeros((B,), bool)
        logit_rows = np.zeros((B, G + 1), np.int32)
        row = 0
        cap = T - QBLK   # one q block always reserved for prefill
        entries = []
        order = [(self._ragged_rr + j) % B for j in range(B)]
        self._ragged_rr = (self._ragged_rr + 1) % max(B, 1)
        for i in order:
            if not active[i]:
                continue
            s = self._slots[i]
            if row + winb * QBLK > cap:
                break
            # the window starts at the carried next_token, which is
            # emitted (counted in `generated`) but not yet written: its
            # position is prompt_len + generated - 1, the device length
            n = s.prompt_len + s.generated - s.shifted - 1
            qstart[i], qlen[i], kvlen[i] = row, G + 1, n + G + 1
            block_seq[row // QBLK:row // QBLK + winb] = i
            spec_rows[i] = row
            verify[i] = True
            logit_rows[i] = row + np.arange(G + 1)
            entries.append((i, s.request_id))
            row += winb * QBLK
        packed = len(entries) * (G + 1)
        chunks = []
        inj = None
        for idx in chunkable:
            if T - row < QBLK:
                break
            s = self._slots[idx]
            ids = s.req.prompt_ids
            pos = s.prefill_pos
            nvalid = min(len(ids) - pos, T - row, self._chunk)
            tokens[row:row + nvalid] = ids[pos:pos + nvalid]
            nb = -(-nvalid // QBLK)
            block_seq[row // QBLK:row // QBLK + nb] = idx
            final = pos + nvalid == len(ids)
            qstart[idx], qlen[idx] = row, nvalid
            kvlen[idx] = pos + nvalid
            if final:
                set_len[idx] = pos + nvalid
                logit_set[idx] = True
                # every logit row points at the final prompt row, so the
                # last_logits merge takes the admission logits
                logit_rows[idx, :] = row + nvalid - 1
            inj = self._pack_inject(s, pos, nvalid, row, T, inj)
            chunks.append((idx, pos, nvalid, final))
            packed += nvalid
            row += nb * QBLK
        pack = dict(verify=verify, tokens=tokens, spec_rows=spec_rows,
                    set_len=set_len, logit_set=logit_set,
                    logit_rows=logit_rows, block_seq=block_seq,
                    qstart=qstart, qlen=qlen, kvlen=kvlen, packed=packed,
                    # the verify masks come from the device tables, keyed
                    # by each slot's automaton state
                    gstate=(self._gstate.copy()
                            if self._grammar_slots > 0 else None),
                    inject=inj)
        fetch = self._dev_spec_ragged(pack)
        # chunk bookkeeping overlaps the device step; the draft ingests
        # each chunk's tokens through its own extend
        for idx, pos, nvalid, final in chunks:
            s = self._slots[idx]
            s.prefill_pos = pos + nvalid
            buf = np.zeros((1, self._chunk), np.int32)
            buf[0, :nvalid] = s.req.prompt_ids[pos:pos + nvalid]
            self._dev_draft_ingest(buf, pos, idx)
            if final:
                self._dev_install(idx, s.row, s.counts_row)
                s.prefilled = True
                self._prefillq.remove(idx)
                tok, lp = self._dev_spec_admit_tail(idx)
                self._emit(idx, s, tok, lp, time.monotonic(), path="spec")
        t0 = time.perf_counter()
        out = fetch.wait()
        self.metrics["host_sync_wait_ms"] += (time.perf_counter() - t0) * 1e3
        self._emit_windows(entries, *out)

    # ------------------------------------------------------ ragged scheduling

    def _ragged_chunkable(self) -> list[int]:
        """Prefill-queue slots whose next chunk can ride the flat stream."""
        return [i for i in self._prefillq if self._slots[i] is not None]

    def _step_ragged(self) -> bool:
        """Run one mixed ragged tick if there is prefill work to pack with
        the running decodes. Returns False to fall through to the dense
        tick: pure decode keeps the pipelined loop dispatch."""
        admissible = ((not self._queue.empty() and bool(self._free))
                      or (self._deferred is not None and self._blocks_freed))
        if not self._ragged_chunkable() and not admissible:
            return False
        # host lengths must be exact before packing (loop dispatches have
        # data-dependent step counts): consume the in-flight dispatch first.
        # The ragged dispatch below is consumed in-tick, so the pipeline
        # resumes cleanly on the next pure-decode tick.
        if self._pending is not None:
            self._consume(self._pending)
            self._pending = None
        self._prefill_tick()   # ragged admissions land chunked (host-only)
        chunkable = self._ragged_chunkable()
        if not chunkable:
            return False
        self._ragged_tick(chunkable)
        return True

    def _ragged_tick(self, chunkable: list[int]):
        """Pack every live decode slot plus as many prefill-chunk tokens as
        fit into ONE flat [T] token stream and dispatch one ragged forward.
        Layout (ops/kernels/ragged_attention.py): each QBLK-row q block
        belongs to one sequence; a decode slot takes one live row plus
        QBLK-1 padding rows; a prefill chunk spans ceil(n/QBLK) blocks. The
        sequence index is the engine slot, so the device derives every
        row's position and page target from the engine's own block table."""
        B = self.ec.max_slots
        T = self._ragged_rows
        block_seq = np.full((T // QBLK,), -1, np.int32)
        tokens = np.zeros((T,), np.int32)
        decode_slot = np.full((T,), -1, np.int32)
        qstart = np.zeros((B,), np.int32)
        qlen = np.zeros((B,), np.int32)
        kvlen = np.zeros((B,), np.int32)
        set_len = np.full((B,), -1, np.int32)
        logit_set = np.zeros((B,), bool)
        is_decode = np.zeros((B,), bool)
        logit_rows = np.zeros((B,), np.int32)
        row = 0
        entries = []
        inj = None
        # decode rows, QBLK-aligned, one per prefilled slot; the last QBLK
        # is reserved for prefill so admission is never starved, and the
        # rotating start keeps a budget overflow fair across ticks
        cap = T - QBLK
        order = [(self._ragged_rr + j) % B for j in range(B)]
        self._ragged_rr = (self._ragged_rr + 1) % max(B, 1)
        for i in order:
            s = self._slots[i]
            if s is None or not s.prefilled:
                continue
            if row + QBLK > cap:
                break
            n = s.prompt_len + s.generated - s.shifted
            qstart[i], qlen[i], kvlen[i] = row, 1, n + 1
            block_seq[row // QBLK] = i
            decode_slot[row] = i
            is_decode[i] = True
            logit_set[i] = True
            logit_rows[i] = row
            entries.append((i, s.request_id))
            row += QBLK
        packed = len(entries)
        chunks = []
        for idx in chunkable:
            if T - row < QBLK:
                break
            s = self._slots[idx]
            ids = s.req.prompt_ids
            pos = s.prefill_pos
            nvalid = min(len(ids) - pos, T - row, self._chunk)
            tokens[row:row + nvalid] = ids[pos:pos + nvalid]
            nb = -(-nvalid // QBLK)
            block_seq[row // QBLK:row // QBLK + nb] = idx
            final = pos + nvalid == len(ids)
            qstart[idx], qlen[idx] = row, nvalid
            kvlen[idx] = pos + nvalid
            if final:
                # the device length is set only by the final chunk (a mid
                # chunk leaves it, so the slot cannot be decoded early)
                set_len[idx] = pos + nvalid
                logit_set[idx] = True
                logit_rows[idx] = row + nvalid - 1
            # a multimodal chunk's feature rows land at their flat rows
            inj = self._pack_inject(s, pos, nvalid, row, T, inj)
            chunks.append((idx, pos, nvalid, final))
            packed += nvalid
            row += nb * QBLK
        pack = dict(tokens=tokens, decode_slot=decode_slot,
                    is_decode=is_decode, set_len=set_len,
                    logit_set=logit_set, logit_rows=logit_rows,
                    block_seq=block_seq, qstart=qstart, qlen=qlen,
                    kvlen=kvlen, packed=packed,
                    # grammar decode slots sample under their CURRENT mask
                    # rows (the tick is consumed in it, so never stale)
                    mask=(self._mask_host.copy()
                          if self._grammar_slots > 0 else None),
                    inject=inj)
        # the fused loop: the pack is iteration 0 and every decode slot
        # keeps advancing on the device until a slot finishes, host work
        # appears, or the step cap. Host-only grammar slots and stop-string
        # slots need a host decision per token (host arbitration): they
        # keep the single step, and so does a pack with feature rows
        # (they sit mid-prefill, where the loop would stop after the pack
        # anyway).
        res: dict[int, int] = {}
        arbitration = (self._grammar_hostonly > 0
                       or any(self._slots[i].req.stop for i, _ in entries))
        use_loop = (self._ragged_loop_fn is not None and bool(entries)
                    and inj is None and not arbitration)
        if use_loop:
            remaining = np.zeros((B,), np.int32)
            check_eos = np.zeros((B,), bool)
            for i, _ in entries:
                s = self._slots[i]
                remaining[i] = max(1, s.req.max_tokens - s.generated
                                   - s.inflight)
                check_eos[i] = self.tok is not None and not s.req.ignore_eos
                res[i] = int(min(self.ec.ragged_loop_steps, remaining[i]))
                s.inflight += res[i]
            # chunk work left after this pack (mid chunks, budget-capped
            # slots) or queued/deferred admissions end the loop after the
            # pack, so TTFT stays at single-step ragged levels
            left = set(self._prefillq) - {
                idx for idx, _pos, _nv, fin in chunks if fin}
            prefill_pending = (bool(left) or self._deferred is not None
                               or not self._queue.empty())
            fetch = self._dev_ragged_loop(
                pack, remaining, check_eos, prefill_pending,
                gstate=(self._gstate.copy()
                        if self._grammar_slots > 0 else None))
        else:
            if self._ragged_loop_fn is not None and entries and arbitration:
                self._rloop_exit(-1, reason="host_arbitration")
            fetch = self._dev_ragged(pack)
        for idx, pos, nvalid, final in chunks:
            s = self._slots[idx]
            s.prefill_pos = pos + nvalid
            if final:
                # the request's sampler row goes in after the pack, so its
                # RNG stream does not depend on how many ticks it spanned
                self._dev_install(idx, s.row, s.counts_row)
                s.prefilled = True
                self._prefillq.remove(idx)
        t0 = time.perf_counter()
        if use_loop:
            tokens_out, logprobs, n_out, code, steps = fetch.wait()
            self.metrics["decode_steps_dispatched"] += int(steps)
            self._rloop_exit(int(code))
            self._release_reservations(entries, res)
        else:
            tokens_out, logprobs = fetch.wait()
            steps, n_out = 1, np.ones((B,), np.int32)
            tokens_out, logprobs = tokens_out[None], logprobs[None]
        self.metrics["host_sync_wait_ms"] += (time.perf_counter() - t0) * 1e3
        self._emit_ring(entries, tokens_out, logprobs, n_out, int(steps),
                        time.monotonic(), "ragged")

    def _emit(self, idx: int, slot: _Slot, token_id: int, logprob: float,
              now: float, path: str = "dense", fresh_mask: bool = True) -> bool:
        """Commit one sampled token to `slot` (grammar advance, detok, stop
        scan, stream, maybe finish). Returns False — with NO state changed
        — when the slot's grammar rejects a token sampled under a STALE
        block mask (fresh_mask=False); the caller then rolls the device
        back (_repair). A reject under a FRESH mask means mask and matcher
        disagree (it should not happen): the request finishes "stop"
        rather than resample the same token forever."""
        finish = None
        shift = False
        cache_len = slot.prompt_len + slot.generated + 1 - slot.shifted
        is_eos = self.tok is not None and token_id in self.tok.eos_ids
        if is_eos and not slot.req.ignore_eos:
            finish = "eos"
        elif slot.generated + 1 >= slot.req.max_tokens:
            finish = "length"
        elif cache_len >= self.ec.max_context - 2 - self._ctx_reserve:
            if slot.req.context_shift:
                # evict-and-continue: slide the cache left, re-rotating K;
                # the fused loops froze the slot at the cap, and a
                # pipelined step already in flight wrote at a pre-shift
                # position (submit refused context_shift with a draft)
                shift = True
            else:
                finish = "length"
        if finish is None and slot.request_id in self._cancelled:
            finish = "cancelled"
        elif finish is None and slot.req.deadline \
                and now > slot.req.deadline:
            finish = "timeout"

        # grammar: check and advance the matcher BEFORE changing anything,
        # so a stale-mask reject leaves the slot at its accepted prefix
        if slot.matcher is not None:
            eos = self.tok.eos_ids if self.tok else ()
            if is_eos:
                # EOS never advances the matcher; it is legal exactly when
                # the grammar is complete (mask_bits sets the EOS bits
                # then). A stale block mask can offer EOS mid-grammar
                if not slot.matcher.done:
                    if not fresh_mask:
                        return False
                    if finish is None:
                        finish = "stop"  # mask/matcher disagreement
                elif finish is None:
                    # ignore_eos and a completed grammar: the model stopped,
                    # and a rollback would resample the same EOS forever
                    finish = "stop"
            elif finish is None:
                if slot.matcher.accept(token_id):
                    if slot.gbase is not None:
                        # table-backed: step the host mirror of the device
                        # automaton and take the mask row from the table;
                        # the matcher stays the arbiter of done/continue
                        st = int(self._gtrans_np[self._gstate[idx], token_id])
                        self._gstate[idx] = st
                        self._mask_host[idx] = self._mask_row(st)
                    else:
                        self._mask_host[idx] = slot.matcher.mask_bits(eos)
                    if (slot.matcher.done and not slot.matcher.can_continue
                            and not eos):
                        finish = "stop"  # complete and nothing can follow
                elif not fresh_mask:
                    return False
                else:
                    finish = "stop"  # mask/matcher disagreement

        if slot.first_token_time is None:
            slot.first_token_time = now
            self.metrics["ttft_ms_last"] = \
                (now - (slot.req.queued_t or slot.start_time)) * 1e3
        slot.generated += 1
        slot.gen_ids.append(token_id)
        self.metrics["tokens_generated"] += 1
        self.metrics["tokens_by_path__" + path] += 1
        if shift:
            self._dev_shift(idx)
            slot.shifted += self._shift_discard

        text = ""
        if slot.detok is not None:
            if finish != "eos":
                text = slot.detok.push(token_id)
            if finish is not None:
                text += slot.detok.flush()

        # stop-string scan with holdback
        emit_text = text
        if slot.req.stop:
            slot.pending_text += text
            hold = max(len(s) for s in slot.req.stop) - 1
            matched = None
            for s in slot.req.stop:
                j = slot.pending_text.find(s)
                if j != -1 and (matched is None or j < matched[0]):
                    matched = (j, s)
            if matched is not None:
                emit_text = slot.pending_text[: matched[0]]
                slot.pending_text = ""
                finish = "stop"
            elif finish is not None:
                emit_text = slot.pending_text
                slot.pending_text = ""
            else:
                stable = len(slot.pending_text) - hold
                emit_text = slot.pending_text[:stable] if stable > 0 else ""
                slot.pending_text = slot.pending_text[max(stable, 0):]

        slot.sent_chars += len(emit_text)
        slot.out.put(StepOutput(
            request_id=slot.request_id, text=emit_text, token_id=token_id,
            logprob=logprob, finished=finish is not None,
            finish_reason=finish, generated_tokens=slot.generated,
            prompt_tokens=slot.prompt_len,
        ))
        if finish is not None:
            dur = now - slot.start_time
            if dur > 0:
                self.metrics["tokens_per_second_last"] = slot.generated / dur
            self.metrics["requests_completed"] += 1
            self._release_slot(idx, slot)
        return True

    def _pick_slot(self, prompt_ids: list[int]) -> tuple[int, int]:
        """A free slot, preferring the one whose cached tokens share the
        longest prefix with the prompt (llama.cpp's slot prompt cache).
        Returns (slot, reusable_prefix_len); 0 = cold prefill."""
        limit = self.ec.max_context - 2 - self._ctx_reserve

        def common(cached: list[int]) -> int:
            m = min(len(cached), len(prompt_ids) - 1, limit - 1)
            i = 0
            while i < m and cached[i] == prompt_ids[i]:
                i += 1
            return i

        best_slot, best_lcp = None, 0
        if self.ec.prompt_cache and self._draft is None:
            for s in self._free:
                lcp = common(self._slot_kv_tokens[s])
                if lcp > best_lcp:
                    best_slot, best_lcp = s, lcp
        if best_slot is not None and best_lcp >= self.ec.prompt_cache_min:
            self._free.remove(best_slot)
            return best_slot, best_lcp
        # cold admission: the free slot with the LEAST useful cached record
        cold = min(self._free, key=lambda s: len(self._slot_kv_tokens[s]))
        self._free.remove(cold)
        return cold, 0

    # ------------------------------------------------ disk prompt cache
    # (llama.cpp's prompt_cache_path / prompt_cache_ro: a prompt's KV
    # persists in a file and is restored across restarts). The file is the
    # reference's np.savez — `tokens` int64 [n] and, from a dense cache,
    # `k`/`v` f32 [L, KVH, n, D] (a bf16 cache's too), from an int8 one
    # `kq`/`vq` int8 [L, KVH, n, D] with the slot's whole scale rows
    # `ks`/`vs` [L, KVH, T // 128, 128] — so a file written by either
    # package loads in the other. Dense engines without a draft only.

    def _load_prompt_cache(self, slot: int, req: GenRequest) -> int:
        """Restore a saved KV prefix into `slot` if the file's tokens prefix
        this prompt. Returns the reusable length (0 = cold prefill: an
        unreadable file, too short a match, or leaves that do not fit this
        engine's cache)."""
        if self._draft is not None or self._paged:
            return 0
        try:
            with np.load(req.prompt_cache_path, allow_pickle=False) as z:
                tokens = z["tokens"].tolist()
                leaves = {k: z[k] for k in z.files if k != "tokens"}
        except Exception:
            # corrupt, truncated or foreign files raise a zoo (BadZipFile,
            # zlib.error, ValueError, OSError, KeyError...): all of them
            # mean a cold prefill, never a dead engine
            return 0
        if not isinstance(tokens, list):      # a 0-d `tokens`
            return 0
        limit = self.ec.max_context - 2 - self._ctx_reserve
        m = min(len(tokens), len(req.prompt_ids) - 1, limit - 1)
        lcp = 0
        while lcp < m and tokens[lcp] == req.prompt_ids[lcp]:
            lcp += 1
        if lcp < self.ec.prompt_cache_min or not self._cache_fits(leaves,
                                                                   lcp):
            return 0
        self._cache_inject(slot, leaves, lcp)
        return lcp

    def _cache_fits(self, leaves: dict, n: int) -> bool:
        """Whether a file's leaves hold n rows of this engine's cache: the
        keys of its kind, [L, KVH, >= n, D] rows of the right type and, for
        int8, scale rows of the slot's shape."""
        cfg = self.cfg
        L, KVH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

        def rows(a, kinds):
            return (a is not None and a.ndim == 4 and a.dtype.kind in kinds
                    and a.shape[0] == L and a.shape[1] == KVH
                    and a.shape[2] >= n and a.shape[3] == D)

        if isinstance(self._kc, QuantKV):
            srow = tuple(self._kc.s.shape[2:])
            return (all(rows(leaves.get(k), "i") for k in ("kq", "vq"))
                    and all(leaves.get(k) is not None
                            and leaves[k].dtype.kind == "f"
                            and tuple(leaves[k].shape) == (L,) + srow
                            for k in ("ks", "vs")))
        return all(rows(leaves.get(k), "f") for k in ("k", "v"))

    def _cache_inject(self, slot: int, leaves: dict, n: int):
        """Write saved rows [L, KVH, n, D] into slot's cache region, in
        place (an int8 cache takes the file's whole scale rows)."""
        def put(dst, a, dtype):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(dtype))

        with torch.no_grad():
            if isinstance(self._kc, QuantKV):
                for c, q, sc in ((self._kc, "kq", "ks"),
                                 (self._vc, "vq", "vs")):
                    put(c.q[:, slot, :, :n], leaves[q][:, :, :n], torch.int8)
                    put(c.s[:, slot], leaves[sc], c.s.dtype)
            else:
                for c, k in ((self._kc, "k"), (self._vc, "v")):
                    put(c[:, slot, :, :n], leaves[k][:, :, :n], c.dtype)

    def _save_prompt_cache(self, idx: int, slot: _Slot):
        """Persist the slot's prompt rows and token ids to the request's
        cache file, through `path.tmp` and os.replace (skipped for RO
        requests, paged and draft engines, shifted or mid-prefill slots,
        and when the loaded file already covers the prompt)."""
        req = slot.req
        if (not req.prompt_cache_path or req.prompt_cache_ro
                or self._draft is not None or self._paged or slot.shifted
                or not slot.prefilled or req.mm_embeds is not None):
            # (multimodal: no reuse path loads it, and its repeated
            # image-token ids could match a text prompt)
            return
        n = min(slot.prompt_len, self.ec.max_context - 2)
        if slot.disk_prefix >= n - 1:
            return
        try:
            if isinstance(self._kc, QuantKV):
                leaves = {k: t.cpu().numpy() for k, t in (
                    ("kq", self._kc.q[:, idx, :, :n]),
                    ("ks", self._kc.s[:, idx]),
                    ("vq", self._vc.q[:, idx, :, :n]),
                    ("vs", self._vc.s[:, idx]))}
            else:
                # f32 on disk: npz keeps no bfloat16
                leaves = {k: c[:, idx, :, :n].float().cpu().numpy()
                          for k, c in (("k", self._kc), ("v", self._vc))}
            tmp = req.prompt_cache_path + ".tmp"
            with open(tmp, "wb") as f:   # a file object: savez adds no .npz
                np.savez(f, tokens=np.asarray(req.prompt_ids[:n], np.int64),
                         **leaves)
            os.replace(tmp, req.prompt_cache_path)
        except Exception:
            # best effort, as the reference's: a full disk or a faulted
            # device must not break the release (or _fail_active's loop)
            import logging

            logging.getLogger("localai_tpu_torch").warning(
                "failed to write prompt cache %s", req.prompt_cache_path,
                exc_info=True)

    # ------------------------------------------------------------ paged KV

    def _req_policy(self, req: GenRequest):
        """The request's retention policy before pressure demotion (the
        engine's on a malformed request policy: submit already rejected
        those; this keeps _blocks_for total)."""
        try:
            return kvtier.resolve_policy(req.kv_policy, self._kv_policy)
        except ValueError:
            return self._kv_policy

    def _blocks_for(self, req: GenRequest) -> int:
        margin = 2 * self.ec.decode_block + 1   # in-flight pipelined writes
        if self._draft is not None:
            # the verify window writes up to gamma+1 rows past the sampled
            # length: the reservation covers the overshoot
            margin = max(margin, self.ec.gamma + 1)
        tokens = min(len(req.prompt_ids) + max(req.max_tokens, 0) + margin,
                     self.ec.max_context)
        need = blocks_needed(tokens)
        if self._tiered:
            # retention bounds residency: the compact table holds at most
            # sink + ring columns a slot however long the sequence runs, and
            # a full-policy request larger than the table demotes to the
            # engine's window at admission
            need = min(need, self._maxb)
        return need

    def _ref_blocks(self, blocks):
        for pb in blocks:
            self._block_ref[pb] += 1

    def _unref_blocks(self, blocks):
        """Drop one reference from each block; blocks reaching zero return
        to the free pool (their content is dead — any hash entry with it)."""
        freed = False
        for pb in blocks:
            self._block_ref[pb] -= 1
            if self._block_ref[pb] <= 0:
                self._block_ref[pb] = 0
                if self._kvhost is not None:
                    # last reference on registered content: catch it in the
                    # host tier before the page returns to the free pool
                    self._spill_block(pb)
                self._drop_hash(pb)
                self._kv_free.append(pb)
                freed = True
        if freed:
            self._blocks_freed = True

    def _drop_hash(self, pb: int):
        """Forget a block's registered content (freed or about to be
        rewritten) so the prefix index can never serve stale pages."""
        h = self._block_hash_of.pop(pb, None)
        if h is not None and self._hash_index.get(h) == pb:
            del self._hash_index[h]

    @staticmethod
    def _chain_hashes(ids) -> list[bytes]:
        """Chain content hashes of consecutive full 128-token blocks: the
        hash of block v commits to every token before it, so equal hash ⇒
        equal whole prefix AND equal absolute positions (K rows are stored
        post-RoPE, so a flat per-block hash would be wrong)."""
        h = b""
        out = []
        for vb in range(len(ids) // BLOCK):
            blk = np.asarray(ids[vb * BLOCK:(vb + 1) * BLOCK], np.int64)
            h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
            out.append(h)
        return out

    def _match_prefix_blocks(self, prompt_ids) -> tuple[list[int], int]:
        """Block-level prefix cache lookup: the longest run of leading full
        128-token blocks whose chain hash is registered. Matched blocks are
        ref'd for the caller — commit them via _alloc_slot(shared=...) or
        return them with _unref_blocks on any bail-out.
        Returns (physical blocks, tokens covered)."""
        limit = self.ec.max_context - 2 - self._ctx_reserve
        nfull = min(len(prompt_ids) - 1, limit - 1) // BLOCK
        blocks: list[int] = []
        for h in self._chain_hashes(prompt_ids[:nfull * BLOCK]):
            pb = self._hash_index.get(h)
            if pb is None:
                break
            blocks.append(pb)
        self._ref_blocks(blocks)
        return blocks, len(blocks) * BLOCK

    def _take_blocks(self, k: int, keep_slot: int):
        """Pop k free blocks (ref'd for the caller), reclaiming released
        slots' retained blocks (oldest first, never `keep_slot` — its prefix
        is being reused). A victim's pages that other tenants still share
        stay alive (refcount) — only its last reference frees a block.
        Returns None when the pool genuinely cannot satisfy k."""
        while len(self._kv_free) < k:
            victim = next((s for s in self._released_lru if s != keep_slot),
                          None)
            if victim is None:
                return None
            self._released_lru.remove(victim)
            self.metrics["kv_slots_reclaimed"] += 1
            if self._kvhost is not None and self._slot_blocks[victim]:
                # the victim's retained chain dies as one session: group
                # its spills under the chain-head hash, so the host tier's
                # LRU evicts whole conversations, tail first
                self._spill_group = self._block_hash_of.get(
                    self._slot_blocks[victim][0])
            self._unref_blocks(self._slot_blocks[victim])
            self._spill_group = None
            self._slot_blocks[victim] = []
            self._slot_kv_tokens[victim] = []
            self._table[victim, :] = 0
        out = self._kv_free[:k]
        del self._kv_free[:k]
        self._ref_blocks(out)
        return out

    def _alloc_slot(self, slot: int, req: GenRequest, shared=None,
                    lcp: int = 0):
        """Size `slot`'s block list for `req`; update the table row.

        `shared`: already-ref'd physical blocks from _match_prefix_blocks —
        they become the slot's head (the borrowed prefix pages). `lcp`: the
        token prefix the request will NOT rewrite (slot-retained or shared
        reuse). Returns the EFFECTIVE reusable prefix length (may shrink —
        see the copy-on-write pass), or None when the pool is exhausted
        (defer; `shared` refs are returned here on that path)."""
        need = self._blocks_for(req)
        have = self._slot_blocks[slot]
        if shared is not None:
            fresh = self._take_blocks(need - len(shared), keep_slot=slot) \
                if need > len(shared) else []
            if fresh is None:
                self._unref_blocks(shared)
                return None
            self._unref_blocks(have)
            have = list(shared) + fresh
            self._slot_blocks[slot] = have
        else:
            old_len = len(have)
            if len(have) < need:
                got = self._take_blocks(need - len(have), keep_slot=slot)
                if got is None:
                    return None
                have.extend(got)
            elif len(have) > need:
                self._unref_blocks(have[need:])
                del have[need:]
            # copy-on-write: every block from the first written one onward
            # gets rewritten by this request. A page another tenant still
            # reads (ref > 1) must not be written in place — swap in a
            # fresh block.
            j0 = lcp // BLOCK
            swap = [j for j in range(j0, len(have))
                    if self._block_ref[have[j]] > 1]
            if swap:
                got = self._take_blocks(len(swap), keep_slot=slot)
                if got is None:
                    # roll the extension back: a deferred slot must not sit
                    # on fresh blocks the retry (or another request) needs
                    if len(have) > old_len:
                        self._unref_blocks(have[old_len:])
                        del have[old_len:]
                    return None
                self.metrics["kv_cow_swaps"] += len(swap)
                for j, nb in zip(swap, got):
                    self._unref_blocks([have[j]])
                    have[j] = nb
                if swap[0] == j0:
                    # the partially-reused block itself was swapped: the
                    # rows [j0*BLOCK, lcp) went with it
                    lcp = j0 * BLOCK
        # the to-be-written blocks' old content is dead the moment the
        # first new row lands — their hash entries must go now, or the
        # index would hand out pages mid-rewrite. The host tier catches
        # each registered block on the way out (its copy is enqueued before
        # this request's first prefill dispatch can rewrite the page)
        for j in range(lcp // BLOCK, len(have)):
            if self._kvhost is not None:
                self._spill_block(
                    have[j], group=self._block_hash_of.get(have[0]))
            self._drop_hash(have[j])
        self._table[slot, :] = 0
        self._table[slot, :len(have)] = have
        if slot in self._released_lru:
            self._released_lru.remove(slot)
        return lcp

    def _set_tier_slot(self, idx: int, pol):
        """Slot `idx`'s tier geometry for `pol` (None: released). The
        RESIDENCY (sb/rw) is always the engine's (the ring was sized for
        it); a request's narrower policy changes only the retention mask,
        so every policy mix shares the table layout and the kernels. A
        full-policy or released slot carries the sentinels; its cold blocks
        return to the cold pool."""
        T = self.ec.max_context
        if pol is not None and pol.windowed:
            self._kv_sb[idx] = self._kv_policy.sink_blocks
            self._kv_rw[idx] = self._kv_ring
            self._kv_sinks[idx] = pol.sinks
            self._kv_window[idx] = pol.window
        else:
            self._kv_sb[idx] = self._maxb
            self._kv_rw[idx] = 1
            self._kv_sinks[idx] = T
            self._kv_window[idx] = T
        self._slot_policy[idx] = pol
        self._demote_next[idx] = (self._kv_policy.sink_blocks
                                  if pol is not None else 0)
        if self._cold:
            self._cold_free.extend(self._slot_cold[idx])
            self._slot_cold[idx] = []
            self._cold_table[idx, :] = 0

    def _release_slot(self, idx: int, slot: _Slot, retain: bool = True):
        """Free `slot`; with `retain` (and the prompt cache on) its cached
        rows stay as a warm prefix. A preempted mid-prefill slot passes
        retain=False: its blocks are only partly written, so none is
        registered in the prefix index. A shifted slot retains nothing: its
        rows moved, so their mapping is no longer positional."""
        self._finish_rid(slot.request_id)
        self._save_prompt_cache(idx, slot)
        if slot.matcher is not None:
            self._mask_host[idx] = 0xFF
            self._grammar_slots -= 1
            self._gstate[idx] = 0    # row 0 = identity (all-ones, self-loop)
            if slot.gbase is None:
                self._grammar_hostonly -= 1
        windowed = False
        if self._tiered:
            pol = self._slot_policy[idx]
            windowed = pol is not None and pol.windowed
        # a windowed slot's ring columns hold position-rotated content no
        # other tenant can address: it retains nothing and registers nothing
        retain = (retain and self.ec.prompt_cache and self._draft is None
                  and slot.shifted == 0 and not windowed)
        if self._paged:
            if retain:
                # retain ONLY the blocks holding cached rows as the warm
                # prefix cache (reclaimable oldest-first, _take_blocks); the
                # unused tail of the reservation returns to the pool now.
                # Safe against the in-flight pipelined step: it writes
                # through the table snapshot of ITS dispatch (_tab), and
                # stream order runs it before any later admission's prefill.
                kept = min(slot.prompt_len + slot.generated,
                           self.ec.max_context - 2)
                keep = blocks_needed(kept)
                blocks = self._slot_blocks[idx]
                if len(blocks) > keep:
                    self._unref_blocks(blocks[keep:])
                    del blocks[keep:]
                    self._table[idx, keep:] = 0
                # register every FULL block in the content-hash index: a
                # future admission sharing the prefix maps these pages into
                # its own table (block-level prefix cache). Multimodal
                # rows are not registered: identical image-token ids,
                # different KV
                if slot.req.mm_embeds is None:
                    ids = (list(slot.req.prompt_ids) + slot.gen_ids)[:kept]
                    for vb, h in enumerate(self._chain_hashes(ids)):
                        pb = blocks[vb]
                        if h not in self._hash_index:
                            self._drop_hash(pb)
                            self._hash_index[h] = pb
                            self._block_hash_of[pb] = h
                self._released_lru.append(idx)
            else:
                self._unref_blocks(self._slot_blocks[idx])
                self._slot_blocks[idx] = []
                self._table[idx, :] = 0
            self._blocks_freed = True
            if self._tiered:
                self._set_tier_slot(idx, None)
            self._note_pool()
        # record what the slot's cache still holds (rows 0..len-1) so a
        # later prompt sharing the prefix skips that part of its prefill
        # (not a multimodal prompt's: its image-token ids all look alike
        # while the features differ per image)
        if retain and slot.req.mm_embeds is None:
            self._slot_kv_tokens[idx] = (list(slot.req.prompt_ids)
                                         + slot.gen_ids)[
                : self.ec.max_context - 2]
        else:
            self._slot_kv_tokens[idx] = []
        self._slots[idx] = None
        self._free.append(idx)

    # ------------------------------------------------------------ run modes

    def warmup(self):
        """Run the single-step decode once per sampling tier with all slots
        inactive (every cache write goes to the trash row and no slot state
        is consumed), so the kernels are built and the first requests pay no
        first-use cost; on the card, also capture the fused loops' CUDA
        graphs (_prepare_graphs). A draft engine runs its speculative step
        instead (spec-as-ragged with and without the grammar tables). Must
        run before any request is admitted; dispatch metrics are restored
        afterwards."""
        if any(s is not None for s in self._slots):
            raise RuntimeError("warmup() requires an idle engine")
        B, V = self.ec.max_slots, self.cfg.vocab_size
        snap = {k: self.metrics[k] for k in (
            "decode_dispatches", "decode_steps_dispatched",
            "host_sync_wait_ms") + (
            ("ragged_dispatches", "ragged_tokens_packed",
             "budget_utilization", "spec_ragged_dispatches")
            if self._ragged else ())}
        idle = np.zeros((B,), bool)
        try:
            if self._draft is not None:
                self._warm_spec(idle)
                return
            widths = [None]
            W = self.ec.sampling_topk_width
            if W:
                widths.append(min(W, V))
                if min(8 * W, V) != min(W, V):
                    widths.append(min(8 * W, V))
            for w in widths:
                self._dev_decode(idle, w).wait()
            # the masked step every grammar configuration can take
            self._dev_decode(idle, mask_host=np.full(
                (B, self._mask_nbytes), 0xFF, np.uint8)).wait()
            self._prepare_graphs(widths)
        finally:
            self.metrics.update(snap)

    def _warm_spec(self, idle):
        """All-inactive speculative dispatches (warmup)."""
        if self._spec_ragged_fn is None:
            self._dev_spec_decode(idle).wait()
            return
        B, T, G = self.ec.max_slots, self._ragged_rows, self.ec.gamma
        base = dict(verify=idle, tokens=np.zeros((T,), np.int32),
                    spec_rows=np.zeros((B,), np.int32),
                    set_len=np.full((B,), -1, np.int32),
                    logit_set=np.zeros((B,), bool),
                    logit_rows=np.zeros((B, G + 1), np.int32),
                    block_seq=np.full((T // QBLK,), -1, np.int32),
                    qstart=np.zeros((B,), np.int32),
                    qlen=np.zeros((B,), np.int32),
                    kvlen=np.zeros((B,), np.int32), packed=0, gstate=None)
        self._dev_spec_ragged(base).wait()
        if self._gtab_cap > 0:
            self._dev_spec_ragged(
                dict(base, gstate=np.zeros((B,), np.int32))).wait()

    def _prepare_graphs(self, widths):
        """Capture, with every slot frozen, the graph of each loop segment
        the fused dispatches run: each segment length of the pure-decode
        loop (segment_lengths) at each sampling width, and each of the
        ragged mixed tick's continuation (from iteration 1, full sampler);
        with the grammar tables on, the grammar variant of each (full
        sampler)."""
        if not self.graphs.graphed:
            return
        keys = []
        rloop_on = self._ragged_loop_fn is not None
        grammar = [False, True] if self._gtab_cap > 0 else [False]
        if self._decode_loop_fn is not None:
            M = (self.ec.ragged_loop_steps if rloop_on
                 else self.ec.decode_loop)
            keys += [(n, w, False) for w in widths
                     for n in segment_lengths(0, M)]
            if self._gtab_cap > 0:
                keys += [(n, None, True) for n in segment_lengths(0, M)]
        if rloop_on:
            keys += [(n, None, g) for g in grammar
                     for n in segment_lengths(1, self.ec.ragged_loop_steps)]
        if not keys:
            return
        B = self.ec.max_slots
        idle = np.zeros((B,), bool)
        with torch.no_grad():
            st = self._loop_begin(
                self._sampler, self._last_logits, self._lengths, idle,
                np.zeros((B,), np.int32), idle, self._eos_dev,
                self._loop_table(), kvt=self._kvt())
            for n, w, g in dict.fromkeys(keys):
                self.graphs.prepare((self._loop_path, n, w, g), n,
                                    self._segment(n, w, g), st.frozen,
                                    self._loop_addresses())

    def start(self):
        """Run the engine loop in a background thread (serving mode)."""
        if self._running:
            return
        self._running = True
        self._dead = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        was_serving = self._thread is not None
        self._running = False
        self._dead = True
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                return
            self._thread = None
        if was_serving:
            self._fail_active("cancelled")

    def preempt(self, grace: float = 0.0) -> list[dict]:
        """Preemption notice: freeze every in-flight request, force-spill
        its KV chain to the host tier, and return a resume manifest (one
        ResumeToken dict a live or queued request).

        For up to `grace` seconds the engine keeps decoding — slots that
        finish stream their normal terminal chunk — then the spill-drain
        runs at a tick boundary: each surviving slot gets a terminal
        StepOutput with finish_reason "preempted" carrying its checkpoint.

        Safe from any thread; with no loop thread running (generate() or
        tests) the drain runs inline. The engine stays serviceable — a
        resume may be submitted right back into it."""
        if self._dead:
            return []
        if self.mesh is not None:
            raise not_ported("preemption under a mesh (the host tier)",
                             "parallel")
        self._preempt_manifest = []
        self._preempt_done.clear()
        self._preempt_t = time.monotonic() + max(float(grace), 0.0)
        if self._thread is not None and self._thread.is_alive():
            self._preempt_req.set()
            self._wake.set()
            self._preempt_done.wait(timeout=max(float(grace), 0.0) + 60.0)
        else:
            self._preempt_req.set()
            while (self._preempt_req.is_set()
                   and time.monotonic() < self._preempt_t
                   and any(s is not None for s in self._slots)):
                self.step()
            if self._preempt_req.is_set():
                self._spill_drain()
        return list(self._preempt_manifest)

    def _spill_drain(self):
        """The engine-thread half of preempt(): consume the in-flight
        dispatch, checkpoint, spill and release every live slot, manifest
        the queued, deferred and mid-admission requests, and land the
        spills in the host pool."""
        from localai_tpu_torch.engine.resume import ResumeToken

        self._preempt_req.clear()
        if self._pending is not None:
            self._consume(self._pending)
            self._pending = None
        self._prefillq.clear()
        manifest: list[dict] = []
        live = [i for i, s in enumerate(self._slots) if s is not None]
        # the per-slot RNG keys as the device advanced them (the fused
        # loops' fixed tensors included: self._sampler is bound to them) —
        # a sampled resume continues from these, not from the seed
        keys = self._sampler.key.cpu().numpy() if live else None
        now = time.monotonic()
        spilled_total = 0
        frozen: set[int] = set()
        for idx in live:
            slot = self._slots[idx]
            frozen.add(slot.request_id)
            tok, spilled = self._freeze_slot(idx, slot, keys, now)
            spilled_total += spilled
            manifest.append(tok.to_dict())
            slot.out.put(StepOutput(
                request_id=slot.request_id, text="", token_id=-1,
                logprob=0.0, finished=True, finish_reason="preempted",
                generated_tokens=slot.generated,
                prompt_tokens=slot.prompt_len, resume=tok.to_dict()))
            # a mid-prefill slot's blocks are only partly written: none of
            # them may enter the prefix index
            self._release_slot(idx, slot, retain=slot.prefilled)
        # queued / deferred / mid-admission requests have no device state:
        # their manifest entries are plain resubmits (emitted=[])
        waiting = []
        if self._deferred is not None:
            waiting.append(self._deferred)
            self._deferred = None
        if self._admitting is not None:
            rid, req, out = self._admitting
            self._admitting = None
            if rid not in frozen:   # died before reaching a slot
                waiting.append((rid, req, out))
        while True:
            try:
                waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for rid, req, out in waiting:
            tok = ResumeToken(
                prompt_ids=list(req.prompt_ids), emitted=[],
                deadline_left=(max(req.deadline - now, 0.0)
                               if req.deadline else 0.0),
                request_id=req.trace_id or f"rid-{rid}")
            manifest.append(tok.to_dict())
            self._finish_rid(rid)
            out.put(StepOutput(
                request_id=rid, text="", token_id=-1, logprob=0.0,
                finished=True, finish_reason="preempted",
                prompt_tokens=len(req.prompt_ids), resume=tok.to_dict()))
        if self._kvhost is not None:
            self._host_drain()
        self.metrics["preempts"] += 1
        self.metrics["preempt_spilled_blocks"] += spilled_total
        self._preempt_manifest = manifest
        self._preempt_done.set()

    def _freeze_slot(self, idx: int, slot: _Slot, keys, now: float):
        """Checkpoint one live slot into a ResumeToken, force-spilling its
        full KV chain blocks to the host tier (the retention rules of
        _release_slot: a prefilled slot, prompt cache on, no multimodal
        rows, no shift, no draft, no window).
        Returns (token, blocks spilled)."""
        from localai_tpu_torch.engine.resume import ResumeToken

        req = slot.req
        spilled = 0
        chain_hex: list[str] = []
        windowed = self._tiered and self._slot_policy[idx] is not None \
            and self._slot_policy[idx].windowed
        if (self._paged and self.ec.prompt_cache and self._kvhost is not None
                and slot.prefilled and slot.shifted == 0
                and req.mm_embeds is None and self._draft is None
                and not windowed):
            kept = min(slot.prompt_len + slot.generated,
                       self.ec.max_context - 2)
            ids = (list(req.prompt_ids) + slot.gen_ids)[:kept]
            chain = self._chain_hashes(ids)
            blocks = self._slot_blocks[idx]
            group = chain[0] if chain else None
            for vb, h in enumerate(chain):
                if vb >= len(blocks):
                    break
                self._spill_block(blocks[vb], h=h, group=group)
                spilled += 1
                chain_hex.append(h.hex())
        key = None
        if keys is not None and not req.params.normalized().greedy:
            key = [int(k) for k in np.asarray(keys[idx]).astype(np.uint32)]
        # a slot that is itself a resume carries replayed emitted tokens in
        # its prompt (resume_base): fold them back into the checkpoint's
        # emitted list, so the ORIGINAL prompt boundary — and with it the
        # detokenizer replay and the sent_chars cursor — stays fixed across
        # any number of preempt/resume rounds
        cut = slot.prompt_len - slot.resume_base
        return ResumeToken(
            prompt_ids=list(req.prompt_ids[:cut]),
            emitted=list(req.prompt_ids[cut:]) + list(slot.gen_ids),
            key=key,
            sent_chars=int(slot.sent_chars),
            chain=chain_hex,
            deadline_left=(max(req.deadline - now, 0.0)
                           if req.deadline else 0.0),
            request_id=req.trace_id or f"rid-{slot.request_id}",
        ), spilled

    def _fail_active(self, reason: str):
        """Send a terminal StepOutput to every in-flight slot, deferred and
        queued request so no consumer blocks forever on its output queue."""
        self._pending = None
        self._prefillq.clear()
        failed = set()
        if self._deferred is not None:
            rid, req, out = self._deferred
            self._deferred = None
            self._finish_rid(rid)
            out.put(StepOutput(request_id=rid, text="", token_id=-1,
                               logprob=0.0, finished=True,
                               finish_reason=reason))
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            failed.add(slot.request_id)
            slot.out.put(StepOutput(
                request_id=slot.request_id, text="", token_id=-1, logprob=0.0,
                finished=True, finish_reason=reason,
                generated_tokens=slot.generated,
                prompt_tokens=slot.prompt_len))
            self._release_slot(i, slot)
        if self._admitting is not None:
            rid, req, out = self._admitting
            self._admitting = None
            if rid not in failed:
                self._finish_rid(rid)
                out.put(StepOutput(request_id=rid, text="", token_id=-1,
                                   logprob=0.0, finished=True,
                                   finish_reason=reason))
        while True:
            try:
                rid, req, out = self._queue.get_nowait()
            except queue.Empty:
                break
            self._finish_rid(rid)
            out.put(StepOutput(request_id=rid, text="", token_id=-1,
                               logprob=0.0, finished=True,
                               finish_reason=reason))

    def _loop(self):
        restarts = 0
        while self._running:
            try:
                busy = self.step()
            except Exception:  # device OOM, kernel fault, ...
                import traceback

                traceback.print_exc()
                self._fail_active("error")
                # on a mesh a failed step may leave the ranks' collectives
                # unpaired: no restart
                if restarts >= self.ec.max_restarts or self.mesh is not None:
                    self._running = False
                    self._dead = True
                    return
                restarts += 1
                try:
                    self._init_device_state()
                except Exception:
                    traceback.print_exc()
                    self._running = False
                    self._dead = True
                    self._fail_active("error")
                    return
                continue
            if not busy:
                self._wake.clear()
                self._wake.wait(timeout=0.05)

    def generate(self, req: GenRequest) -> Iterator[StepOutput]:
        """Synchronous convenience: submit + drive the loop until finished.
        Only valid when the background thread is NOT running."""
        if self._running:
            raise RuntimeError("use submit() while the engine loop is running")
        rid, out = self.submit(req)
        done = False
        while not done:
            self.step()
            while True:
                try:
                    o = out.get_nowait()
                except queue.Empty:
                    break
                yield o
                if o.finished:
                    done = True

    def generate_text(self, req: GenRequest) -> str:
        return "".join(o.text for o in self.generate(req))
