"""Phase 2's main-shape kernel rows, timed alone, to compare two trees on
one NVIDIA card.

    python3 chip_rows.py LABEL [--e2e | --w4-tier]

Builds the port's kernels and runs chip_smoke.py's checks of rows 1–11
and, where the tree has them, 13–15 and 13i4–15i4 (PERF.md §6) at the
Llama-3.1-8B shapes — row 13 at every projection geometry for M = 4, 192
and 2048, row 14 with the bf16 and the int8 head, row 15 at
Mixtral-8x7B's experts (M = 4), the int4 rows at w_gate (M = 4, 192,
2048), the 8B head and w1/w3 and w2 (M = 4), and, where the tree has
them, row 14's two routes on the bf16 head at M = 40 and 8192 — each
against its plain version with its planted faults, then prints one line
`ROWS LABEL {row:
{ms, ms_cold, ms_host, ms_graph}}` (device ms warm and with a cold L2,
the host-inclusive reading, and the device ms of a call inside a CUDA
graph of 20 calls; rows 13 and 14 also `host_us`, the host's µs a call
with the card busy), with the same readings of an empty kernel, the
harness's launch floor, under "0 empty kernel". It also prints a `DIVISION` line: how many of
4,194,304 random f32 values PyTorch's CUDA division by the Python number
127.0 gives otherwise than division by a device tensor, and how many of
the latter differ from the CPU's quotients (ops/kvcache.quantize_tokens
divides by a device tensor on the card for this reason).

It also times the tiered decode (rows 3t, 5t, 3t cold at phase 2's
tiered shape, with the untiered read of the full lengths) and row 13i4
through w4a16_matmul at every served projection shape for M = 1, 4, 8 and
16 (ms, ms_cold, ms_graph, and ms_graph_cold: a graph cycling copies of
the weight beyond the L2, as a served decode step streams it, the calls
back to back and, apart, each after an elementwise kernel that writes
x). `--w4-tier` times those two groups alone. With `--e2e` it instead
runs chip_smoke.py's phases 13 and 10 as the tree has them and prints
`E2E LABEL {...}`: each leg's busy ms a decode step.

To compare commits, unpack the other with `git archive` into
`_archive_check/` (git-ignored), copy this script beside its
chip_smoke.py, and run it from each root in turns (parent, change,
change, parent) in one chip call. A one-off study, apart from the smoke;
it imports nothing of JAX or localai_tpu.
"""
from __future__ import annotations

import json
import sys

import chip_smoke as smoke

# the 8B projections (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
W8_GEOMETRIES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def host_us(fn, calls=200):
    """The host's µs a call of fn: `calls` calls enqueued behind a spin
    kernel that keeps the card busy longer than the host takes to enqueue
    them, so no call waits for the card, timed on the host clock."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100 * smoke.SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def weight_gemm_host_us():
    """host_us of rows 13 and 14 at chip_rows' shapes: the wrappers'
    Python, ctypes and launch cost (and, on a large-M route, the tensor
    map of x) a call."""
    import torch

    from localai_tpu_torch.ops.kernels import head_matmul, w8a16_matmul

    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for K, N in W8_GEOMETRIES:
        qw = smoke._int8_weight(K, N, g)
        for M in (4, 192, 2048):
            x = torch.randn(M, K, device="cuda", generator=g).to(
                torch.bfloat16)
            res[f"13 w8a16_matmul M={M} K={K} N={N}"] = host_us(
                lambda: w8a16_matmul(x, qw.q, qw.s))
    x32 = torch.randn(4, 4096, device="cuda", generator=g)
    qw = smoke._int8_weight(4096, 128256, g)
    res["14 head_matmul int8"] = host_us(lambda: head_matmul(x32, qw.q,
                                                             qw.s))
    w = qw.q.to(torch.bfloat16)
    res["14 head_matmul"] = host_us(lambda: head_matmul(x32, w))
    torch.cuda.empty_cache()
    return res


# 13i4 at decode: the served projection shapes (K, N) — the 8B's (and
# Mixtral's attention) wq/wo, wk/wv, w_gate/w_up, w_down, Qwen2-7B's wk/wv
W4_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (3584, 512)]
L2_BYTES = 50 << 20


def graph_ms(calls):
    """Device ms a call of a CUDA graph of `calls` (a list of callables),
    as chip_smoke's _graph_ms times one (behind a spin, median of 25)."""
    import torch

    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    ms = smoke._time_ms(graph.replay, warm=2)
    del graph
    return ms / len(calls)


def w4_graph_cold(x, copies, s, interleave=False):
    """Device ms of one w4a16_matmul(x, w, s) in a CUDA graph cycling
    through the weight copies (at least 20 calls): back to back, each call
    right after the last (wk after wq, wv after wk in a served layer), or,
    with `interleave`, each after a plain elementwise kernel that writes
    x, as the norm, attention, silu or the multiply precede the other 5
    of a layer's 7 projections. Returns (ms a projection, ms of the
    elementwise kernel alone in a graph of as many calls); interleaved,
    the first is the pair's time less the second."""
    import torch

    from localai_tpu_torch.ops.kernels import w4a16_matmul

    ws = copies * max(1, -(-20 // len(copies)))
    proj = [(lambda w=w: w4a16_matmul(x, w, s)) for w in ws]
    if not interleave:
        return graph_ms(proj), None
    x0 = x.clone()

    def ew():
        torch.mul(x0, 1.0, out=x)

    ew_ms = graph_ms([ew] * len(ws))
    pair = 2 * graph_ms([f for p in proj for f in (ew, p)])
    return pair - ew_ms, ew_ms


def w4_decode_rows():
    """13i4 through the public wrapper (w4a16_matmul, bf16 x) at every
    served shape for M = 1, 4, 8 and 16: ms (warm L2), ms_cold, ms_graph
    (20 calls on one weight), ms_graph_cold (a graph cycling copies of
    the weight whose bytes exceed twice the L2: the served condition, the
    calls back to back) and ms_graph_cold_interleaved (the same with an
    elementwise kernel before each call, its own time, ew_ms_graph, taken
    off: w4_graph_cold)."""
    import torch

    from localai_tpu_torch.ops.kernels import w4a16_matmul
    from localai_tpu_torch.ops.quant import quantize

    g = torch.Generator(device="cuda").manual_seed(7)
    res = {}
    for K, N in W4_SHAPES:
        qw = quantize(torch.randn(K, N, device="cuda", generator=g)
                      * K ** -0.5, bits=4)
        n = max(4, -(-2 * L2_BYTES // (K * N // 2)))
        copies = [qw.q.clone() for _ in range(n)]
        for M in (1, 4, 8, 16):
            x = torch.randn(M, K, device="cuda", generator=g).to(
                torch.bfloat16)

            def fn():
                return w4a16_matmul(x, qw.q, qw.s)

            inter, ew = w4_graph_cold(x, copies, qw.s, interleave=True)
            res[f"13i4 w4a16_matmul M={M} K={K} N={N}"] = {
                "ms": smoke._time_ms(fn),
                "ms_cold": smoke._time_ms(fn, cold=True),
                "ms_graph": graph_ms([fn] * 20),
                "ms_graph_cold": w4_graph_cold(x, copies, qw.s)[0],
                "ms_graph_cold_interleaved": inter,
                "ew_ms_graph": ew,
                "bound_ms": (K * N / 2 + 2 * M * K + 2 * M * N + 4 * N)
                / smoke.PEAK_BYTES * 1e3}
        del qw, copies
        torch.cuda.empty_cache()
    return res


def w4_tier(label, smi):
    """Rows 3t, 5t and 3t cold (chip_smoke.check_tier_decode at phase 2's
    tiered shape, with the untiered read) and w4_decode_rows alone, then
    `ROWS LABEL {...}` as main prints it."""
    import torch

    bf16 = torch.bfloat16
    out = {}
    for name, kw in (("3t ragged_decode_paged_tier", {}),
                     ("5t ragged_decode_q8_paged_tier", {"q8": True}),
                     ("3t cold", {"cold": True})):
        r = smoke.check_tier_decode(bf16, **kw)
        out[name] = {k: r.get(k) for k in ("ms", "ms_cold", "ms_graph",
                                           "untiered_ms", "bound_ms")}
    out.update(w4_decode_rows())
    print(f"ROWS {label} " + json.dumps(
        {"card": smi, **out}), flush=True)


def e2e(label):
    """Phases 13 and 10 of chip_smoke.py as they stand in this tree (the
    int4 recipe's legs at 32 layers; the KV tier's legs at SERVE_LAYERS),
    their summary lines printed as the smoke prints them, then `E2E LABEL
    {...}` with each leg's busy ms a decode step."""
    import re
    import tempfile

    import torch

    smi = smoke.phase_device()
    lines = []
    log = smoke.log

    def keep(*a):
        text = " ".join(str(x) for x in a)
        if text.startswith(("phase13 summary", "phase10 summary")):
            lines.append(text)
        log(*a)

    smoke.log = keep
    try:
        smoke.phase_int4(smi)
        demote = smoke.check_demote(torch.bfloat16)
        with tempfile.TemporaryDirectory() as d:
            tok = smoke.grammar_setup(d)
            smoke.phase_kv_tier(d, smi, tok, demote)
    finally:
        smoke.log = log
    busy = {}
    for text in lines:
        m = re.match(r"(phase1[03]) summary (\{.*\})", text)
        body = json.JSONDecoder().raw_decode(m.group(2))[0]
        if m.group(1) == "phase13":
            busy.update({f"13 {k}": v.get("busy_ms_step")
                         for k, v in body.items()})
        else:
            busy.update({f"10 {k}": v
                         for k, v in body["busy_ms_step"].items()})
    print(f"E2E {label} " + json.dumps({"card": smi, "busy_ms_step": busy}),
          flush=True)


def main():
    import torch

    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    smi = smoke.phase_device()
    smoke.phase_build()
    if "--e2e" in sys.argv[2:]:
        e2e(label)
        return
    if "--w4-tier" in sys.argv[2:]:
        w4_tier(label, smi)
        return
    H, KVH, D = 32, 8, 128
    bf16 = torch.bfloat16
    lens4 = [1, 129, 1000, 2048]
    lens8 = [33, 49, 332, 732, 1532, 672, 712, 4095]
    rd, rc = smoke.RAGGED_DECODE, smoke.RAGGED_CHUNK
    rows = {
        "1 flash_prefill": lambda: smoke.check_prefill(
            4, 512, H, KVH, D, bf16, [512, 300, 17, 1], cold=True),
        "2 ragged_decode": lambda: smoke.check_decode(
            4, H, KVH, 2048, D, bf16, lens4, cold=True),
        "4 ragged_decode_q8": lambda: smoke.check_decode(
            4, H, KVH, 2048, D, bf16, lens4, q8=True, cold=True),
        "3 ragged_decode_paged": lambda: smoke.check_paged_decode(
            8, H, KVH, D, bf16, lens8, 32, nb=129, cold=True),
        "5 ragged_decode_q8_paged": lambda: smoke.check_paged_decode(
            8, H, KVH, D, bf16, lens8, 32, q8=True, nb=129, cold=True),
        "6 paged_scatter_append": lambda: smoke.check_paged_scatter(
            8, KVH, D, bf16),
        "7 paged_scatter_append_q8": lambda: smoke.check_paged_scatter(
            8, KVH, D, bf16, q8=True),
        "8 ragged_paged_attention": lambda: smoke.check_ragged_attention(
            H, KVH, D, bf16, rd, rc, 32, nb=129),
        "9 ragged_paged_attention_q8": lambda: smoke.check_ragged_attention(
            H, KVH, D, bf16, rd, rc, 32, q8=True, nb=129),
        "10 ragged_scatter_append": lambda: smoke.check_ragged_scatter(
            KVH, D, bf16, rd, rc, 32, nb=129),
        "11 ragged_scatter_append_q8": lambda: smoke.check_ragged_scatter(
            KVH, D, bf16, rd, rc, 32, q8=True, nb=129),
    }
    # rows 13 and 14, the weight GEMMs: row 13 at every 8B projection
    # geometry for M = 4 (decode), 192 (phase 6's pack) and 2048 (a
    # prefill batch), the bf16 and int8 heads at M = 4 (a parent tree may
    # predate them)
    if hasattr(smoke, "check_w8a16"):
        for K, N in W8_GEOMETRIES:
            for M in (4, 192, 2048):
                rows[f"13 w8a16_matmul M={M} K={K} N={N}"] = (
                    lambda M=M, K=K, N=N: smoke.check_w8a16(M, K, N, bf16))
        rows["14 head_matmul"] = lambda: smoke.check_head(
            4, 4096, 128256, "bf16")
        rows["14 head_matmul int8"] = lambda: smoke.check_head(
            4, 4096, 128256, "int8")
    # row 15, the int8 expert GEMM at Mixtral-8x7B's experts (M = 4), and
    # the int4 rows 13i4-15i4 at their main shapes, where the tree has them
    if hasattr(smoke, "check_moe"):
        rows["15 moe_w8_matmul M=4 w1/w3"] = lambda: smoke.check_moe(
            4, 4096, 14336, True)
        rows["15 moe_w8_matmul M=4 w2"] = lambda: smoke.check_moe(
            4, 14336, 4096, False)
    # the tiered decode (rows 3t, 5t, 3t cold) at phase 2's tiered shape
    if hasattr(smoke, "check_tier_decode"):
        rows["3t ragged_decode_paged_tier"] = lambda: \
            smoke.check_tier_decode(bf16)
        rows["5t ragged_decode_q8_paged_tier"] = lambda: \
            smoke.check_tier_decode(bf16, q8=True)
        rows["3t cold"] = lambda: smoke.check_tier_decode(bf16, cold=True)
    if hasattr(smoke, "check_w4a16"):
        for M in (4, 192, 2048):
            rows[f"13i4 w4a16_matmul M={M} K=4096 N=14336"] = (
                lambda M=M: smoke.check_w4a16(M, 4096, 14336, cold=True))
        rows["14i4 head_matmul int4"] = lambda: smoke.check_head4(
            4, 4096, 128256, cold=True)
        rows["15i4 moe_w4_matmul M=4 w1/w3"] = lambda: smoke.check_moe4(
            4, 4096, 14336, True, cold=True)
        rows["15i4 moe_w4_matmul M=4 w2"] = lambda: smoke.check_moe4(
            4, 14336, 4096, False, cold=True)
    # a parent tree's chip_smoke.py may predate the in-graph readings
    out = {"0 empty kernel": smoke.launch_floor()} \
        if hasattr(smoke, "launch_floor") else {}
    for name, check in rows.items():
        r = check()
        out[name] = {k: r.get(k) for k in ("ms", "ms_cold", "ms_host",
                                           "ms_graph", "untiered_ms")
                     if k in r}
    if hasattr(smoke, "check_w4a16"):
        out.update(w4_decode_rows())
    # row 14's two routes (a tree with the tensor-core route): the
    # speculative verify's M and the scorer's
    if hasattr(smoke, "check_head_routes"):
        for M in (40, 8192):
            r = smoke.check_head_routes(M, "bf16")
            for route in ("simt", "wgmma"):
                out[f"14 head_matmul bf16 M={M} {route}"] = {
                    k: r[route].get(k) for k in ("ms", "ms_cold", "ms_host",
                                                 "ms_graph")}
    if hasattr(smoke, "check_w8a16"):
        for name, us in weight_gemm_host_us().items():
            out[name]["host_us"] = us
    print(f"ROWS {label} " + json.dumps(out), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(1 << 22, device="cuda", generator=g) * 100 + 1e-3
    by_number = x / 127.0
    by_tensor = x / torch.tensor(127.0, device="cuda")
    print(f"DIVISION {label} " + json.dumps({
        "values": x.numel(),
        "python_number_vs_device_tensor": int((by_number != by_tensor).sum()),
        "device_tensor_vs_cpu": int((by_tensor.cpu() != x.cpu() / 127.0)
                                    .sum())}), flush=True)


if __name__ == "__main__":
    main()
