"""Ring-depth sweep of the int8 split-KV decode pass on one NVIDIA card.

    python3 chip_stage_sweep.py

Builds csrc/decode_attention.cu once for each int8 ring depth in STAGES
(the source's SK_NS_Q8 replaced in a scratch copy under csrc/build/, one
nvcc each, started together), then times paged `ragged_decode_q8` with
each build through chip_smoke's check_paged_decode at phase 2's main shape
(B=8, MAXB=32 over the 129-block pool, the Llama-3.1-8B geometry), warm
and cold L2, each checked against its plain version. Prints one JSON line
with the card's name and power limit. A one-off study, apart from the
pass/fail smoke; the port launches with the depth the source holds.
"""
from __future__ import annotations

import json
import os
import re
import subprocess

import chip_smoke as smoke

STAGES = (4, 6, 8)


def build_variants(stages=STAGES) -> dict:
    """{depth: path of a decode_attention build with SK_NS_Q8 = depth}."""
    from localai_tpu_torch.ops.kernels import _build

    with open(os.path.join(_build.CSRC, "decode_attention.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "stage_sweep")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for n in stages:
        text, subs = re.subn(r"constexpr int SK_NS_Q8 = \d+;",
                             f"constexpr int SK_NS_Q8 = {n};", src)
        if subs != 1:
            raise RuntimeError("SK_NS_Q8 not found once in the source")
        cu, so = (os.path.join(out, f"decode_attention_ns{n}{ext}")
                  for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(text)
        procs[n] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for n, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed at {n} stages:\n{log}")
    return {n: so for n, (so, _) in procs.items()}


def main():
    import torch

    from localai_tpu_torch.ops.kernels import _build

    smi = smoke.phase_device()
    smoke.phase_build()
    kept = _build.load("decode_attention")
    sweep = {}
    try:
        for n, so in build_variants().items():
            _build._libs["decode_attention"] = _build.bind(
                so, "decode_attention")
            r = smoke.check_paged_decode(
                8, 32, 8, 128, torch.bfloat16,
                [33, 49, 332, 732, 1532, 672, 712, 4095], 32, q8=True,
                nb=129, cold=True)
            if r["stages"] != n:
                raise RuntimeError(f"build for {n} stages reports "
                                   f"{r['stages']}")
            sweep[n] = {k: r[k] for k in ("ms", "ms_cold", "ms_host",
                                          "max_abs_err")}
    finally:
        _build._libs["decode_attention"] = kept
    print(json.dumps({"card": smi, "ragged_decode_q8_paged_stages": sweep,
                      "source_stages": kept.decode_split_stages(1, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
