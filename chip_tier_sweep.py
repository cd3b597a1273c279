"""Span sweep of the tiered paged decode (rows 3t, 5t and 3t cold of
PERF.md §6) on one NVIDIA card:

    python3 chip_tier_sweep.py

At phase 2's tiered shape (chip_smoke.TIER_LENS: 8 slots up to 32768
tokens, sinks 256, window 4096, the Llama-3.1-8B's H 32, KVH 8, D 128),
times decode_tier_kernel through chip_smoke's check_tier_decode on span
plans other than tier_plan's (set through flash_attention's span
constants, span_plan): the bf16 hot pool (3t) and the int8 hot pool
(5t) at HOT_TILES tiles of 32 tokens a span, and the cold view (3t cold:
the middle of each slot demoted to the int8 cold pool) at COLD_TILES tiles
a cold span, each checked against its plain version with its planted
faults; then the plan the source holds, with the untiered read of the full
lengths beside it; and 3t/5t at phase 10's shape (4 slots of about 6200
tokens, sinks 128, window 1024) at 2–32 tiles a span and the source's
plan. Prints `TIER {...}` with the card's name and power
limit: ms (warm and cold L2), ms_graph and bound_ms of each plan. A
one-off study, apart from the pass/fail smoke; the port launches with
flash_attention.tier_plan's spans. It imports nothing of JAX or
localai_tpu.
"""
from __future__ import annotations

import contextlib
import json

import chip_smoke as smoke

HOT_TILES = (4, 8, 16, 24, 32, 48, 64)
COLD_TILES = (8, 16, 32, 64)
# phase 10's tiered legs mid-decode: 4 slots past their 6000-token prompts
PHASE10_LENS = [6100, 6150, 6200, 6256]
PHASE10_TILES = (2, 4, 6, 8, 16, 32, "plan")
# flash_attention's span constants, which tier_plan reads at each launch
SPAN_CONSTANTS = ("TIER_BLOCKS_SM", "TIER_BLOCKS_SM_Q8", "TIER_MIN_TILES",
                  "COLD_SPAN_TILES")


@contextlib.contextmanager
def span_plan(hot=None, cold=None):
    """Launch the tiered kernel on `hot` tiles a hot span of a slot under a
    policy (tier_span_tiles: at least TIER_MIN_TILES, and about as many
    blocks an SM as it takes to reach one tile) and `cold` tiles a cold
    span (COLD_SPAN_TILES); None keeps the source's plan. The constants
    are restored on exit."""
    from localai_tpu_torch.ops.kernels import flash_attention as fa

    saved = {k: getattr(fa, k) for k in SPAN_CONSTANTS}
    try:
        if hot is not None:
            fa.TIER_BLOCKS_SM = fa.TIER_BLOCKS_SM_Q8 = 1e9
            fa.TIER_MIN_TILES = hot
        if cold is not None:
            fa.COLD_SPAN_TILES = cold
        yield
    finally:
        for k, v in saved.items():
            setattr(fa, k, v)


def timed(hot_tiles, cold_tiles, **kw):
    """chip_smoke.check_tier_decode(**kw) on span_plan(hot_tiles,
    cold_tiles), its timings without the untiered read."""
    with span_plan(hot_tiles, cold_tiles):
        return smoke.check_tier_decode(untiered=False, **kw)


def main():
    import torch

    from localai_tpu_torch.ops.kernels import flash_attention as fa

    smi = smoke.phase_device()
    smoke.phase_build()
    bf16 = torch.bfloat16
    keep = ("ms", "ms_cold", "ms_graph", "bound_ms", "max_abs_err",
            "untiered_ms")
    out = {"card": smi, "source_plan": {k: getattr(fa, k)
                                        for k in SPAN_CONSTANTS}}
    for label, q8 in (("3t bf16 hot", False), ("5t int8 hot", True)):
        out[label] = {t: {k: r.get(k) for k in keep} for t, r in (
            (t, timed(t, 32, dtype=bf16, q8=q8)) for t in HOT_TILES)}
    out["3t cold"] = {f"hot 32 cold {c}": {
        k: r.get(k) for k in keep} for c, r in (
            (c, timed(32, c, dtype=bf16, cold=True)) for c in COLD_TILES)}
    # phase 10's shape: 4 slots of 6000-odd tokens, sinks 128, window 1024
    out["phase 10 shape"] = {f"{label} {t}": {k: r.get(k) for k in keep}
                             for label, q8 in (("3t", False), ("5t", True))
                             for t, r in (
        (t, timed(None if t == "plan" else t, None, dtype=bf16, q8=q8,
                  lens=PHASE10_LENS, sinks=128, window=1024))
        for t in PHASE10_TILES)}
    out["source"] = {label: {k: r.get(k) for k in keep + ("plan",)}
                     for label, r in (
                         ("3t", smoke.check_tier_decode(bf16)),
                         ("5t", smoke.check_tier_decode(bf16, q8=True)),
                         ("3t cold", smoke.check_tier_decode(bf16,
                                                             cold=True)))}
    print("TIER " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
