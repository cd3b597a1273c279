"""Host-RAM KV spill tier (counterpart of localai_tpu/engine/kvhost.py).

The device block pool (ops/paged.py) is the only place KV lives: when a
retained slot is reclaimed or a prefix-cache block rewritten, its content
is gone and the next turn of that conversation re-prefills from token
zero. This module is the storage tier between the device pool and
re-prefill:

    device pool  --spill (D2H into pinned memory, int8)-->  HostKVPool
    HostKVPool   --readmit (H2D, ahead of the suffix's prefill)-->  device

Blocks are keyed by the chained content hashes the prefix cache uses
(Engine._chain_hashes), so a host hit is a prefix-cache hit one tier
further away. Storage is int8 with one f32 scale a token (the
ops/kvcache.quantize_tokens layout): a block spilled from an int8 pool
round-trips byte-exact; from a dense pool it pays quantize_tokens' error.

The pool is host-side bookkeeping only (dicts and host tensors), so it
can be tested in milliseconds and handed to a fresh Engine to model a
worker restart (``Engine(..., kvhost=survivor_pool)``). Its byte
accounting, eviction order and digest are the reference pool's.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["HostKVBlock", "HostKVPool"]


# --------------------------------------------------------------------------
# spilled block payload
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class HostKVBlock:
    """One 128-token KV block in int8 form, on the host (CPU tensors, in
    pinned memory when spilled from the card).

    kq/vq: int8  [L, KVH, BLOCK, D]
    ks/vs: f32   [L, KVH, 1, BLOCK]   (quantize_tokens scale tile layout)
    """

    kq: Any
    ks: Any
    vq: Any
    vs: Any

    @property
    def nbytes(self) -> int:
        return (self.kq.nbytes + self.ks.nbytes
                + self.vq.nbytes + self.vs.nbytes)


@dataclass
class _Entry:
    block: HostKVBlock
    group: bytes
    pins: int = 0


@dataclass
class _Group:
    # chain-ordered hashes; tail blocks are useless without their head, so
    # budget eviction inside a group strips from the tail first
    hashes: list = field(default_factory=list)


@dataclass
class _SpillBatch:
    # one in-flight spill of a chain group: hashes claimed by begin_spill
    # but not yet landed or abandoned, and every hash this batch pinned
    # (residents at claim time and blocks landed while the batch was open).
    # Pins release only when the batch's last claim ends, so an LRU
    # eviction racing the spill never frees a chain head under its
    # still-in-flight tail.
    claims: set = field(default_factory=set)
    pinned: list = field(default_factory=list)


# --------------------------------------------------------------------------
# the pool
# --------------------------------------------------------------------------

class HostKVPool:
    """Refcounted, byte-budgeted host store of spilled KV blocks.

    Keys are the engine's chained content hashes (16-byte blake2b). Blocks
    belong to a *group* (the chain-head hash of the session that spilled
    them); eviction is LRU over groups — the least recently touched
    session first, and within it tail blocks before head blocks, since a
    chain is only usable as a leading run.

    ``budget_bytes <= 0`` disables admission (every ``put`` is dropped), so
    callers keep one unconditional code path.

    Thread-safe: the engine thread spills and readmits while a gRPC thread
    reads ``stats()``/``digest()``.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: dict[bytes, _Entry] = {}
        # insertion/touch order == LRU order (oldest first)
        self._groups: "OrderedDict[bytes, _Group]" = OrderedDict()
        self.used_bytes = 0
        # counters (cumulative; the engine's kv_host_* metrics)
        self.spills = 0          # blocks admitted
        self.hits = 0            # blocks readmitted via get()
        self.misses = 0          # probes that found nothing
        self.evictions = 0       # blocks dropped to respect the budget
        self.rejects = 0         # puts refused (dup / zero budget / pinned)
        self.peak_bytes = 0
        # in-flight spills (begin_spill/end_spill): hash -> group key
        self._pending_h: dict[bytes, bytes] = {}
        self._spilling: dict[bytes, _SpillBatch] = {}

    # -- admission ---------------------------------------------------------

    def accepts(self, h: bytes) -> bool:
        """Would ``put`` store this hash? Lets the engine skip the
        device→host copy for duplicates and a zero budget."""
        if self.budget_bytes <= 0:
            return False
        with self._lock:
            return h not in self._entries and h not in self._pending_h

    def put(self, h: bytes, block: HostKVBlock,
            group: Optional[bytes] = None) -> int:
        """Admit one block; returns the number of blocks evicted for budget.

        A duplicate hash is refused (first copy wins — content-addressed,
        so the bytes are the same anyway). A block larger than the whole
        budget is refused rather than flushing the pool for it.
        """
        if self.budget_bytes <= 0 or block.nbytes > self.budget_bytes:
            self.rejects += 1
            return 0
        gkey = group if group is not None else h
        with self._lock:
            if h in self._entries or h in self._pending_h:
                self.rejects += 1
                return 0
            self._land_locked(h, block, gkey)
            return self._evict_to_budget_locked()

    def _land_locked(self, h: bytes, block: HostKVBlock,
                     gkey: bytes) -> None:
        self._entries[h] = _Entry(block=block, group=gkey)
        g = self._groups.get(gkey)
        if g is None:
            g = self._groups[gkey] = _Group()
        g.hashes.append(h)
        self._groups.move_to_end(gkey)     # MRU
        self.used_bytes += block.nbytes
        self.spills += 1
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    # -- in-flight spill claims --------------------------------------------

    def begin_spill(self, h: bytes, group: Optional[bytes] = None) -> bool:
        """Claim ``h`` for a device→host spill that lands later through
        ``end_spill``. Returns False (and counts a reject) when the pool
        would refuse the block anyway (zero budget, duplicate, or the same
        spill already in flight), so the caller can skip the copy.

        A claim opens (or joins) the group's spill batch and pins every
        block of the group already resident; blocks landed while the batch
        is open are born pinned too. All of it unpins when the batch's last
        claim ends.
        """
        if self.budget_bytes <= 0:
            self.rejects += 1
            return False
        gkey = group if group is not None else h
        with self._lock:
            if h in self._entries or h in self._pending_h:
                self.rejects += 1
                return False
            batch = self._spilling.get(gkey)
            if batch is None:
                batch = self._spilling[gkey] = _SpillBatch()
                g = self._groups.get(gkey)
                if g is not None:
                    for rh in g.hashes:
                        self._entries[rh].pins += 1
                        batch.pinned.append(rh)
            batch.claims.add(h)
            self._pending_h[h] = gkey
            return True

    def end_spill(self, h: bytes,
                  block: Optional[HostKVBlock] = None) -> int:
        """Land (``block`` given) or abandon (``block=None``) a claim made
        by ``begin_spill``; returns blocks evicted for budget. Ending a
        hash that was never claimed degrades to a plain ``put`` or a
        no-op, so callers keep one unconditional drain path."""
        with self._lock:
            gkey = self._pending_h.pop(h, None)
            if gkey is None:
                if block is None:
                    return 0
                if (self.budget_bytes <= 0
                        or block.nbytes > self.budget_bytes
                        or h in self._entries):
                    self.rejects += 1
                    return 0
                self._land_locked(h, block, h)
                return self._evict_to_budget_locked()
            batch = self._spilling[gkey]
            batch.claims.discard(h)
            evicted = 0
            if block is not None:
                if block.nbytes > self.budget_bytes:
                    self.rejects += 1
                else:
                    self._land_locked(h, block, gkey)
                    self._entries[h].pins += 1     # born pinned
                    batch.pinned.append(h)
                    evicted = self._evict_to_budget_locked()
            if not batch.claims:
                del self._spilling[gkey]
                for ph in batch.pinned:
                    e = self._entries.get(ph)
                    if e is not None and e.pins > 0:
                        e.pins -= 1
                # the pins may have deferred evictions the budget needs
                evicted += self._evict_to_budget_locked()
            return evicted

    def _evict_to_budget_locked(self) -> int:
        evicted = 0
        while self.used_bytes > self.budget_bytes:
            victim = None
            for gkey in self._groups:          # oldest group first
                g = self._groups[gkey]
                # tail-first inside the group; skip pinned blocks
                for h in reversed(g.hashes):
                    if self._entries[h].pins == 0:
                        victim = (gkey, h)
                        break
                if victim:
                    break
            if victim is None:                 # everything pinned
                break
            gkey, h = victim
            e = self._entries.pop(h)
            self._groups[gkey].hashes.remove(h)
            if not self._groups[gkey].hashes:
                del self._groups[gkey]
            self.used_bytes -= e.block.nbytes
            self.evictions += 1
            evicted += 1
        return evicted

    # -- lookup ------------------------------------------------------------

    def get(self, h: bytes) -> Optional[HostKVBlock]:
        """Non-destructive lookup; a hit touches the block's group (MRU) so
        live sessions outlast idle ones."""
        with self._lock:
            e = self._entries.get(h)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            self._groups.move_to_end(e.group)
            return e.block

    def contains(self, h: bytes) -> bool:
        with self._lock:
            return h in self._entries

    def pin(self, h: bytes) -> bool:
        with self._lock:
            e = self._entries.get(h)
            if e is None:
                return False
            e.pins += 1
            return True

    def unpin(self, h: bytes) -> None:
        with self._lock:
            e = self._entries.get(h)
            if e is not None and e.pins > 0:
                e.pins -= 1

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": len(self._entries),
                "groups": len(self._groups),
                "bytes": self.used_bytes,
                "peak_bytes": self.peak_bytes,
                "budget_bytes": self.budget_bytes,
                "spills": self.spills,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejects": self.rejects,
                "pending_spills": len(self._pending_h),
            }

    def digest(self, k: int = 128) -> list:
        """Top-k most recent block ids (hex): MRU groups first, chain order
        inside a group."""
        out: list = []
        with self._lock:
            for gkey in reversed(self._groups):      # MRU first
                for h in self._groups[gkey].hashes:
                    out.append(h.hex())
                    if len(out) >= k:
                        return out
        return out
