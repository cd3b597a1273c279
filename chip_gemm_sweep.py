"""Plan sweep of the two weight GEMMs that weight_gemm.py routes by shape
alone, on one NVIDIA card:

    python3 chip_gemm_sweep.py [--cu=PATH ...] [--only=regs,w4,moe4,head]

1. Registers and spills (`nvcc -Xptxas -v`) of the bf16 head's kernels
   (tensor-core, split, SIMT) and of the int4 expert decode kernel, from
   csrc/weight_gemm.cu's int8 and int4 builds and from the int4 build of
   each --cu source (another commit's weight_gemm.cu, say, from `git
   archive`; it is compiled against this tree's headers), one nvcc each,
   started together; and, from `cuobjdump -sass`, each int4 build's
   expert decode kernel at 8 rows: its main loop (first mma.sync to last)
   in instructions a mma.sync (each mma.sync takes four converted pairs)
   and by opcode.
2. moe_w4_matmul at M = 4 on Mixtral-8x7B's w1/w3 and w2 stacks (E = 8)
   on grids of a block a tile, twice that, 3 and 4 blocks an SM and
   moe4_plan's, each against its plain version (MOE_TOL, W8_SHARE).
3. head_matmul on a bf16 and a tied head (K = 4096, V = 128256): the SIMT
   route at HEAD_CROSS_ROWS (head_plan's HEAD_SIMT_ROWS) and the tensor-
   core route with each row tile of HEAD_ROWS at HEAD_CROSS_ROWS and
   HEAD_BIG_ROWS (head_bn's choice), each against the plain version
   within HEAD_TOL.
4. w4a16_matmul at decode (row 13i4) at M = 4 and 16 on every served
   projection shape (W4_SHAPES), on w4_plan's split count and on others
   (set through weight_gemm's W4_SPLIT_KT and W4_BLOCKS_SM, w4_splits;
   1 split has no split-K combine), and the int4 head at decode on 1–8
   splits: ms, ms_graph and ms_graph_cold (a graph cycling weight copies
   beyond the L2), back to back and after an elementwise kernel, each
   case against its plain version.

Prints `SWEEP {...}` with the card's name and power limit. The port
launches with weight_gemm.py's plans; this script times the choices they
make. It imports nothing of JAX or localai_tpu.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
from collections import Counter

import chip_smoke as smoke

HEAD_CROSS_ROWS = (4, 8, 9, 12, 16, 17, 24, 32, 40, 64)
# 13i4 at decode: the served projection shapes (K, N) — the 8B's (and
# Mixtral's attention) wq/wo, wk/wv, w_gate/w_up, w_down, and Qwen2-7B's
# wk/wv — the rows, and the split counts besides w4_plan's
W4_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (3584, 512)]
W4_ROWS = (1, 4, 8, 16)
W4_SPLITS = (1, 2, 4, 8, 16)
W4_SPLIT_ROWS = (4, 16)
HEAD_BIG_ROWS = (65, 128, 192, 2048, 8192)
# the kernels whose registers are printed, and the int4 expert decode
# kernel at 8 rows (the source's moe_w4_stream_kernel<1>; before it, the
# int4 build's weight_gemm_gemv_kernel<bf16, 1, EPI_MOE>)
REGS = (r"moe_w4_stream|weight_gemm_gemv_kernelI13__nv_bfloat16Li[12]ELi2E|"
        r"head_gemm|split_terms|weight_gemm_simt")
MOE4_DECODE = (r"moe_w4_stream_kernelILi1E|"
               r"weight_gemm_gemv_kernelI13__nv_bfloat16Li1ELi2E")
# the int4 projection's decode route at 8 rows (bf16, EPI_ROUND)
W4_DECODE = r"weight_gemm_gemv_kernelI13__nv_bfloat16Li1ELi0E"


def build(sources):
    """{tag: (path of the .so, ptxas's log)} of {tag: (source path, int4)},
    one nvcc each, started together, under csrc/build/gemm_sweep/."""
    from localai_tpu_torch.ops.kernels import _build

    out = os.path.join(_build.BUILD_DIR, "gemm_sweep")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for tag, (cu, int4) in sources.items():
        so = os.path.join(out, f"weight_gemm_{tag}.so")
        procs[tag] = so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS,
             *(("-DWG_INT4=1",) if int4 else ()), "-Xptxas", "-v",
             "-I", _build.CSRC, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    res = {}
    for tag, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        res[tag] = (so, log)
    return res


def ptxas_regs(log, pattern):
    """{kernel: "N registers, S spill bytes"} for the entries whose
    mangled name matches `pattern`."""
    res, name, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and re.search(pattern, name):
            res[name] = f"{m.group(1)} registers, {spill} spill bytes"
    return res


def sass_counts(so, pattern):
    """{kernel: {instructions, mma, a_mma, loop}} of the kernels whose
    mangled name matches `pattern`, from cuobjdump's SASS: the main loop
    is the run from the first mma.sync (HMMA) to the last, a_mma its
    instructions a mma, loop its opcodes by count."""
    from localai_tpu_torch.ops.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    res, ops, name = {}, [], None
    for line in text.splitlines() + ["Function : END"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            idx = [i for i, o in enumerate(ops) if o.startswith("HMMA")]
            if name and idx and re.search(pattern, name):
                loop = ops[idx[0]:idx[-1] + 1]
                res[name] = {"instructions": len(ops), "mma": len(idx),
                             "a_mma": len(loop) / len(idx),
                             "loop": dict(Counter(
                                 o if o.startswith("F2FP")
                                 else o.split(".")[0]
                                 for o in loop).most_common(12))}
            name, ops = m.group(1), []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)", line)
        if m:
            ops.append(m.group(2))
    return res


def moe4_grids(sms):
    """{case: {grid: ms}}: moe_w4_matmul's decode kernel at M = 4 on
    Mixtral-8x7B's stacks, on each grid."""
    import torch

    from localai_tpu_torch.ops.kernels import moe_w4_matmul_plain
    from localai_tpu_torch.ops.kernels import weight_gemm as wg
    from localai_tpu_torch.ops.quant import quantize

    res = {}
    for label, K, N, shared in (("w1/w3 M=4", 4096, 14336, True),
                                ("w2 M=4", 14336, 4096, False)):
        M, E = 4, 8
        g = torch.Generator(device="cuda").manual_seed(K + N)
        qw = quantize(torch.randn(E, K, N, device="cuda", generator=g)
                      * K ** -0.5, bits=4)
        x = torch.randn((M, K) if shared else (M, E, K), device="cuda",
                        generator=g).to(torch.bfloat16)
        ref = moe_w4_matmul_plain(x, qw.q, qw.s)
        out = torch.empty(M, E, N, dtype=torch.bfloat16, device="cuda")
        plan, units, tiles = wg.moe4_plan(M, N, K, E, sms)
        row = {}
        for blocks in sorted({min(b, units) for b in (
                tiles, 2 * tiles, 3 * sms, 4 * sms, plan)}):
            def fn(blocks=blocks):
                wg._launch_moe4("moe_w4_matmul", x, qw.q, qw.s, out, blocks)

            fn()
            torch.cuda.synchronize()
            smoke._check_close(f"sweep moe4 {label} {blocks}", out, ref,
                               smoke.MOE_TOL, share=smoke.W8_SHARE)
            row[f"blocks={blocks}" + (" (plan)" if blocks == plan
                                      else "")] = smoke._time_ms(fn)
        res[label] = row
        print(f"SWEEP moe4 {label} " + json.dumps(row), flush=True)
        del qw, x, ref, out
        torch.cuda.empty_cache()
    return res


def head_sweep(sms):
    """{kind M=..: {plan: {ms, max_abs_err}}}: the bf16 head's routes and
    row tiles."""
    import torch

    from localai_tpu_torch.ops.kernels import head_matmul_plain
    from localai_tpu_torch.ops.kernels import weight_gemm as wg

    K, V = 4096, 128256
    g = torch.Generator(device="cuda").manual_seed(20)
    e = (torch.randn(V, K, device="cuda", generator=g)
         * K ** -0.5).to(torch.bfloat16)
    heads = {"bf16": (e.T.contiguous(), False), "tied": (e.T, True)}
    res = {}
    for kind, (w, nk) in heads.items():
        for M in HEAD_CROSS_ROWS + HEAD_BIG_ROWS:
            x32 = torch.randn(M, K, device="cuda", generator=g)
            ref = head_matmul_plain(x32, w)
            out = torch.empty(M, V, device="cuda")
            plans = {"simt": wg.head_route("simt", M, V, K, sms)} \
                if M in HEAD_CROSS_ROWS else {}
            for bn in wg.HEAD_ROWS:
                tile = (bn, wg.HEAD_BN, wg.HEAD_BK)
                plans[f"wgmma bn={bn}"] = ("wgmma", tile) + wg.gemm_split(
                    M, V, K, tile, sms, wg.PER_SM["wgmma"])
            row = {"plan": f"{wg.head_plan(M, V, K, sms)[0]} bn="
                           f"{wg.head_bn(M)}"}
            for label, plan in plans.items():
                def fn(plan=plan):
                    wg._launch_head("head_matmul", x32, w, out, nk, plan)

                fn()
                torch.cuda.synchronize()
                r = smoke._check_close(f"sweep head {kind} {label} M={M}",
                                       out, ref, smoke.HEAD_TOL)
                row[label] = {"ms": smoke._time_ms(
                    fn, **(dict(reps=3, warm=1) if M > 192 else {})),
                    "max_abs_err": r["max_abs_err"]}
            res[f"{kind} M={M}"] = row
            print(f"SWEEP head {kind} M={M} " + json.dumps(row), flush=True)
            del x32, ref, out
            torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def w4_splits(nk, splits):
    """Launch the int4 decode route on `splits` splits of nk K tiles
    (w4_plan's K spans of ceil(nk / splits) tiles, no cap of blocks an SM)
    by setting weight_gemm's W4_SPLIT_KT and W4_BLOCKS_SM; restored, with
    w4_plan's cache cleared, on exit."""
    from localai_tpu_torch.ops.kernels import weight_gemm as wg

    saved = wg.W4_SPLIT_KT, wg.W4_BLOCKS_SM
    wg.W4_SPLIT_KT, wg.W4_BLOCKS_SM = -(-nk // splits), 1 << 20
    wg.w4_plan.cache_clear()
    try:
        yield
    finally:
        wg.W4_SPLIT_KT, wg.W4_BLOCKS_SM = saved
        wg.w4_plan.cache_clear()


def w4_sweep(sms):
    """13i4 at decode: w4a16_matmul on w4_plan's split count and on
    W4_SPLITS (1: no split-K combine) at W4_SPLIT_ROWS rows of every
    served shape — ms, ms_graph, ms_graph_cold back to back and
    interleaved with an elementwise kernel (chip_rows.w4_graph_cold) —
    and the int4 head at decode on 1, 2, 4 and 8 splits (w4_plan: 1),
    each case against its plain version."""
    import torch

    from chip_rows import w4_graph_cold
    from localai_tpu_torch.ops.kernels import head_matmul, \
        head_matmul_plain, w4a16_matmul, w4a16_matmul_plain
    from localai_tpu_torch.ops.kernels import weight_gemm as wg

    res = {"splits": {}, "head": {}}
    g = torch.Generator(device="cuda").manual_seed(40)
    for K, N in W4_SHAPES:
        qw = smoke._int4_weight(K, N, g)
        nk = -(-K // wg.GEMV4[2])
        n = max(4, -(-2 * smoke.L2_BYTES // (K * N // 2)))
        copies = [qw.q.clone() for _ in range(n)]
        for Ms in W4_SPLIT_ROWS:
            x = torch.randn(Ms, K, device="cuda", generator=g).to(
                torch.bfloat16)
            ref = w4a16_matmul_plain(x, qw.q, qw.s)
            plan = wg.w4_plan(N, K, sms)[0]
            for want in sorted({plan, *W4_SPLITS}):
                with w4_splits(nk, want):
                    splits = wg.w4_plan(N, K, sms)[0]
                    label = (f"M={Ms} K={K} N={N} splits={splits}"
                             f"{' (plan)' if splits == plan else ''}")
                    out = w4a16_matmul(x, qw.q, qw.s)
                    torch.cuda.synchronize()
                    r = smoke._check_close(
                        f"sweep w4 {label}", out, ref,
                        smoke.W8_TOL["bfloat16"], share=smoke.W8_SHARE)
                    fn = lambda: w4a16_matmul(x, qw.q, qw.s)  # noqa: E731
                    inter, ew = w4_graph_cold(x, copies, qw.s, True)
                    res["splits"][label] = {
                        "ms": smoke._time_ms(fn),
                        "ms_graph": smoke._graph_ms(fn),
                        "ms_graph_cold": w4_graph_cold(x, copies,
                                                       qw.s)[0],
                        "ms_graph_cold_interleaved": inter,
                        "ew_ms_graph": ew,
                        "max_abs_err": r["max_abs_err"]}
                print(f"SWEEP w4 {label} "
                      + json.dumps(res["splits"][label]), flush=True)
        del qw, copies
        torch.cuda.empty_cache()
    K, V = 4096, 128256
    qw = smoke._int4_weight(K, V, g)
    for M in W4_ROWS:
        x32 = torch.randn(M, K, device="cuda", generator=g)
        ref = head_matmul_plain(x32, qw.q, qw.s)
        row = {}
        for want in (1, 2, 4, 8):
            with w4_splits(-(-K // wg.GEMV4[2]), want):
                fn = lambda: head_matmul(x32, qw.q, qw.s)  # noqa: E731
                r = smoke._check_close(f"sweep head4 splits={want} M={M}",
                                       fn(), ref, smoke.HEAD_TOL)
                row[f"splits={want}"] = {
                    "ms": smoke._time_ms(fn),
                    "ms_cold": smoke._time_ms(fn, cold=True),
                    "ms_graph": smoke._graph_ms(fn),
                    "max_abs_err": r["max_abs_err"]}
        res["head"][f"M={M}"] = row
        print(f"SWEEP head4 M={M} " + json.dumps(row), flush=True)
    del qw
    torch.cuda.empty_cache()
    return res


def main():
    import torch

    from localai_tpu_torch.ops.kernels import _build

    only = {p for a in sys.argv[1:] if a.startswith("--only=")
            for p in a.split("=", 1)[1].split(",")}
    run = (lambda part: not only or part in only)  # noqa: E731
    smi = smoke.phase_device()
    smoke.phase_build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"card": smi}
    if run("regs"):
        src = os.path.join(_build.CSRC, "weight_gemm.cu")
        sources = {"int8": (src, False), "int4": (src, True)}
        for i, a in enumerate(a for a in sys.argv[1:]
                              if a.startswith("--cu=")):
            sources[f"cu{i}_int4"] = (os.path.abspath(a.split("=", 1)[1]),
                                      True)
        builds = build(sources)
        regs = {tag: ptxas_regs(log, REGS)
                for tag, (_, log) in builds.items()}
        sass = {tag: sass_counts(so, MOE4_DECODE + "|" + W4_DECODE)
                for tag, (so, _) in builds.items() if tag != "int8"}
        print("SWEEP sources " + json.dumps(
            {t: p for t, (p, _) in sources.items()}), flush=True)
        print("SWEEP registers " + json.dumps(regs), flush=True)
        print("SWEEP sass " + json.dumps(sass), flush=True)
    if run("w4"):
        out["w4"] = w4_sweep(sms)
    if run("moe4"):
        out["moe4"] = moe4_grids(sms)
    if run("head"):
        out["head"] = head_sweep(sms)
    print("SWEEP " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
