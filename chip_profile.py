"""Device-time breakdown of the port's main path on one NVIDIA card.

    python3 chip_profile.py [bf16|int8] [dense|paged|ragged]

Serves chip_smoke.py's synthetic Llama-3.1-8B through the port's gRPC
backend in bf16 and then in the int8 recipe (int8 weights + int8 KV), or
in the recipes named; each first dense (chip_smoke phase 4's
configuration and four requests), then paged (phase 5's configuration
and its first wave of six requests), then ragged through the port's
Engine in-process (phase 6's configuration and its two waves of eight
requests), or only the paths named, each with chip_smoke's checks; then
drives the same requests again with fresh prompt ids (no prompt-cache or
prefix reuse), first unprofiled, then under torch.profiler with CUDA
activity. Prints one JSON line per path: the unprofiled and profiled
wall times and tok/s, device busy time by kernel class (the port's
weight GEMMs and the casts, `direct_copy_kernel`, each a class of its
own), the casts' count and longest call, the top kernels, the device's
idle share of the profiled window, its idle and busy ms per decode step,
the fused loops' graph-runner counters gained in the window (captures,
replays, steps replayed, warm-up steps), and the path's peak device
memory (`max_memory_allocated`) since its model began to load and while
serving (the two unchecked drives). Kernels run on one stream, so their
summed device time is the busy time. A one-off study, apart from the
pass/fail smoke; it imports nothing of JAX or localai_tpu.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import chip_smoke as smoke


def _kernel_class(key: str) -> str:
    # the port's weight GEMMs, before cuBLAS's "gemm" below; the casts,
    # apart from the other elementwise kernels
    if "weight_gemm_" in key:
        return "weight GEMMs (port kernels)"
    if "direct_copy_kernel" in key:
        return "casts (direct_copy)"
    # ragged attention's kernels: one before the split-KV redesign, its
    # split pass (tensor-core or SIMT) and combine since
    if any(t in key for t in ("ragged_kernel", "ragged_tc_kernel",
                              "ragged_simt_kernel", "ragged_combine_kernel")):
        return "ragged attention (port kernels)"
    if any(t in key for t in ("decode_", "prefill_")):
        return "attention (port kernels)"
    if "scatter_rows" in key or "scatter_q8_rows" in key:
        return "kv scatter (port kernel)"
    if any(t in key.lower() for t in ("gemm", "xmma", "nvjet", "cutlass")):
        return "gemm (cuBLAS)"
    if key.startswith(("Memcpy", "Memset")):
        return "memcpy/memset"
    return "other (elementwise, reductions, sort, sampling)"


def _casts(p):
    """(calls, longest call in µs) of the casts (direct_copy_kernel) on the
    card: a weight's cast would take tens of µs (w_gate's int8 → bf16 copy
    moves 176 MB, about 52 µs at 3.35 TB/s)."""
    from torch.autograd import DeviceType

    durs = [e.time_range.elapsed_us() for e in p.events()
            if e.device_type == DeviceType.CUDA and "direct_copy" in e.name]
    return len(durs), max(durs, default=0.0)


def _summary(p, wall_s, steps, tokens):
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in p.key_averages() if e.self_device_time_total > 0]
    casts, longest = _casts(p)
    busy = sum(ms for _, _, ms in rows)
    by_class: dict = {}
    for key, _, ms in rows:
        c = _kernel_class(key)
        by_class[c] = by_class.get(c, 0.0) + ms
    top = sorted(rows, key=lambda r: -r[2])[:8]
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy,
        "idle_share": (1 - busy / (wall_s * 1e3)) if busy else None,
        "idle_ms_per_step": ((wall_s * 1e3 - busy) / steps) if steps
        else None,
        "busy_ms_per_step": (busy / steps) if steps else None,
        "decode_steps": int(steps), "tokens": int(tokens),
        "tok_s": tokens / wall_s, "by_class_ms": by_class,
        "casts": casts, "longest_cast_us": longest,
        "top_kernels": [{"name": k[:90], "count": c, "ms": ms}
                        for k, c, ms in top],
    }


def _readings_peak(readings) -> float:
    """The peak device memory (GiB) serve_recipe read after its first wave
    (or the last of its waves)."""
    last = readings[-1] if isinstance(readings, list) else readings
    return last["peak_mem_gb"]


def profile_window(label, requests=None):
    """A serve_recipe hook: drive `requests` (default chip_smoke's four)
    with fresh prompt ids unprofiled, then again profiled, and print the
    profiled window's summary."""

    def hook(client, servicer, readings):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.reset_peak_memory_stats()
        u0 = client.metrics()
        _, plain_wall = smoke.drive_requests(client, salt=101,
                                             requests=requests)
        m0 = client.metrics()
        g0 = servicer.engine.graphs.counters()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            smoke.drive_requests(client, salt=202, requests=requests)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        m1 = client.metrics()
        out = _summary(p, wall, m1["decode_steps_dispatched"]
                       - m0["decode_steps_dispatched"],
                       m1["tokens_generated"] - m0["tokens_generated"])
        out["graphs"] = smoke.graph_delta(
            g0, servicer.engine.graphs.counters())
        out["unprofiled_wall_ms"] = plain_wall * 1e3
        out["unprofiled_tok_s"] = (m0["tokens_generated"]
                                   - u0["tokens_generated"]) / plain_wall
        out["serving_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out["peak_mem_gb"] = max(out["serving_peak_mem_gb"],
                                 _readings_peak(readings))
        smoke.log(f"profile {label} " + json.dumps(out))

    return hook


def profile_engine(label):
    """A serve_ragged hook: drive chip_smoke's ragged waves with fresh
    prompt ids unprofiled, then again profiled, and print the profiled
    window's summary."""

    def hook(eng):
        import torch
        from torch.profiler import ProfilerActivity, profile

        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        n0 = eng.metrics["tokens_generated"]
        _, plain_wall = smoke.drive_engine(eng, salt=101)
        s0 = eng.metrics["decode_steps_dispatched"]
        t_0 = eng.metrics["tokens_generated"]
        g0 = eng.graphs.counters()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            smoke.drive_engine(eng, salt=202)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = _summary(p, wall, eng.metrics["decode_steps_dispatched"] - s0,
                       eng.metrics["tokens_generated"] - t_0)
        out["graphs"] = smoke.graph_delta(g0, eng.graphs.counters())
        out["unprofiled_wall_ms"] = plain_wall * 1e3
        out["unprofiled_tok_s"] = (t_0 - n0) / plain_wall
        out["serving_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out["peak_mem_gb"] = max(out["serving_peak_mem_gb"], peak)
        smoke.log(f"profile {label} " + json.dumps(out))

    return hook


# recipe: (LoadModel options, engine dtype, engine KV cache type)
RECIPES = {
    "bf16": (dict(dtype="bfloat16"), "bfloat16", ""),
    "int8": (dict(dtype="int8", cache_type_key="int8",
                  cache_type_value="int8"), "int8", "int8"),
}


def main():
    """For each recipe: the dense path (chip_smoke phase 4's configuration
    and four requests), the paged path (phase 5's configuration and its
    first wave of six requests), then the ragged path (phase 6's); only
    the recipes and paths named, where any are."""
    paths = ("dense", "paged", "ragged")
    recipes = [a for a in sys.argv[1:] if a in RECIPES] or list(RECIPES)
    chosen = [a for a in sys.argv[1:] if a in paths] or list(paths)
    bad = [a for a in sys.argv[1:] if a not in RECIPES and a not in paths]
    if bad:
        raise SystemExit(f"chip_profile.py: unknown arguments {bad}")
    import torch

    smoke.phase_device()
    smoke.phase_build()
    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(smoke.CFG_8B, localai_synthetic=True), f)
        for name in recipes:
            load_kw, dtype, kv = RECIPES[name]
            if "dense" in chosen:
                torch.cuda.reset_peak_memory_stats()
                smoke.serve_recipe(name, d, load_kw,
                                   then=profile_window(f"{name} dense"))
            if "paged" in chosen:
                torch.cuda.reset_peak_memory_stats()
                smoke.serve_recipe(name, d, load_kw, phase="phase5",
                                   load_opts=smoke.PAGED_LOAD,
                                   waves=[smoke.PAGED_WAVE1],
                                   then=profile_window(f"{name} paged",
                                                       smoke.PAGED_WAVE1))
            if "ragged" in chosen:
                smoke.serve_ragged(name, d, dtype, kv,
                                   then=profile_engine(f"{name} ragged"))


if __name__ == "__main__":
    main()
