"""KV lifecycle tier — per-request retention policy over the paged pool
(counterpart of localai_tpu/engine/kvtier.py; the port keeps its own copy,
with the same policies, geometry and error texts).

Under `sink_window(sinks=N, window=W)` a slot holds O(sinks + window)
blocks for its whole life instead of O(context):

  hot      — resident in the bf16/int8 hot pool. Sink blocks ([0, N) tokens)
             are identity-mapped and stay hot; window blocks live in a RING
             of ceil(W/128)+margin physical blocks that the write path
             reuses in place as the sequence grows.
  cold     — (quantize_cold only) a block whose tokens fully left the window
             is copied into a parallel int8 cold pool (per-token scales)
             before the ring wraps over it; attention keeps reading it at
             int8 precision through the cold table.
  evicted  — without quantize_cold the ring overwrite IS the eviction: the
             block's tokens leave the attention set. With quantize_cold,
             eviction happens only when the cold pool is full (counted in
             kv_evictions).

The device-side ring arithmetic lives in ops/paged.py (ring_block_map,
resident_block_positions). The per-slot geometry (sink blocks, ring width,
sinks, window) is runtime data with full-policy sentinels, so any mix of
full and windowed slots runs through the same kernels and CUDA graphs.
"""
from __future__ import annotations

import dataclasses
import re

from localai_tpu_torch.ops.paged import blocks_needed


@dataclasses.dataclass(frozen=True)
class KVPolicy:
    """Retention policy for one request's KV blocks.

    kind: "full" (keep everything hot — the default, identical to the
    untiered engine) or "sink_window" (attention sinks + sliding window).
    sinks/window are token counts; quantize_cold keeps exited-window blocks
    readable at int8 instead of dropping them."""
    kind: str = "full"
    sinks: int = 0
    window: int = 0
    quantize_cold: bool = False

    @property
    def windowed(self) -> bool:
        return self.kind == "sink_window"

    @property
    def sink_blocks(self) -> int:
        return blocks_needed(self.sinks) if self.sinks > 0 else 0

    def describe(self) -> str:
        if not self.windowed:
            return "full"
        s = f"sink_window(sinks={self.sinks}, window={self.window}"
        if self.quantize_cold:
            s += ", quantize_cold=true"
        return s + ")"


_POLICY_RE = re.compile(r"^\s*sink_window\s*\((?P<args>[^)]*)\)\s*$")


def parse_policy(text: str) -> KVPolicy:
    """Parse a policy string: "full" | "sink_window(sinks=N, window=W[,
    quantize_cold=true])". Raises ValueError on anything else."""
    t = (text or "").strip()
    if t in ("", "full"):
        return KVPolicy()
    m = _POLICY_RE.match(t)
    if not m:
        raise ValueError(
            f"unknown kv_policy {text!r}: expected 'full' or "
            f"'sink_window(sinks=N, window=W[, quantize_cold=true])'")
    kw: dict[str, int | bool] = {}
    for part in m.group("args").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"kv_policy argument {part!r} is not k=v")
        k, v = (x.strip() for x in part.split("=", 1))
        if k in ("sinks", "window"):
            kw[k] = int(v)
        elif k == "quantize_cold":
            kw[k] = v.lower() in ("1", "true", "yes", "on")
        else:
            raise ValueError(f"unknown kv_policy argument {k!r}")
    if "window" not in kw or int(kw["window"]) <= 0:
        raise ValueError("sink_window needs window=W > 0")
    pol = KVPolicy(kind="sink_window", sinks=int(kw.get("sinks", 0)),
                   window=int(kw["window"]),
                   quantize_cold=bool(kw.get("quantize_cold", False)))
    if pol.sinks < 0:
        raise ValueError("sink_window sinks must be >= 0")
    return pol


def ring_blocks(window: int, margin_tokens: int) -> int:
    """Physical blocks in the sliding-window ring: blocks_needed(window)
    for the window span, the margin for tokens written ahead of the host's
    confirmed length, and +2 for a partially filled current block and one
    block of slack between "tokens exited the window" (demotion
    eligibility) and "the ring wraps over their block", so a quantize_cold
    copy always runs first."""
    return blocks_needed(window) + blocks_needed(max(margin_tokens, 1)) + 2


def resident_blocks(pol: KVPolicy, margin_tokens: int) -> int:
    """Total table columns a windowed slot holds resident: identity-mapped
    sink blocks + the ring."""
    return pol.sink_blocks + ring_blocks(pol.window, margin_tokens)


def engine_margin_tokens(ec) -> int:
    """Tokens the serving paths may write past the host's confirmed length:
    a full prefill chunk, a full fused decode-loop dispatch, or the
    pipelined block (2*decode_block+1, the _blocks_for margin)."""
    return max(ec.prefill_chunk, ec.decode_loop, 2 * ec.decode_block + 1)


def resolve_policy(req_policy: str, engine_policy: KVPolicy) -> KVPolicy:
    """Resolve a request's effective policy at admission.

    The engine policy fixes the geometry (table width, cold pool), so a
    request may only pick "full" (identity residency, capped at the
    engine's resident width) or a sink_window no LARGER than the engine's —
    a wider window would not fit the ring."""
    if not req_policy:
        return engine_policy
    pol = parse_policy(req_policy)
    if not pol.windowed:
        return pol
    if not engine_policy.windowed:
        raise ValueError(
            "request kv_policy sink_window needs an engine configured with "
            "a windowed kv_policy (the table geometry is fixed at load)")
    if (pol.sink_blocks > engine_policy.sink_blocks
            or blocks_needed(pol.window) > blocks_needed(
                engine_policy.window)):
        raise ValueError(
            f"request kv_policy {pol.describe()} exceeds the engine policy "
            f"{engine_policy.describe()} (per-request windows may only "
            f"shrink the resident geometry)")
    # quantize_cold is an engine-level capability (the cold pool either
    # exists or it doesn't); a windowed request on a cold engine rides it
    return dataclasses.replace(
        pol, quantize_cold=engine_policy.quantize_cold)
