"""Phase 9's host-tier leg of chip_smoke.py timed alone, on the card, to
compare two trees in one call (one-off; not part of the smoke).

    python3 chip_host_tier.py LABEL

Run from a tree's root (copy this file beside another tree's
chip_smoke.py to run it there), in turns: A, B, B, A. It builds the
kernels, writes the grammar leg's checkpoint, and for bf16 then the int8
recipe times an Engine's construction with and without the host tier
and runs `host_tier_leg` (waves A1, A2, A3 with and without the tier,
with its checks). Prints one line a recipe:

    HOST LABEL RECIPE {engine_init_ms_tier, engine_init_ms_no_tier,
                       a3_host_ms, a3_ttft_p50_ms_tier, ...} card NAME, W
"""
from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

KEYS = ("a3_host_ms", "a3_ttft_p50_ms_tier", "a3_ttft_p50_ms_no_tier",
        "a3_tok_s_tier", "a3_tok_s_no_tier", "transfer")


def main(label: str):
    import torch

    import chip_smoke as c
    from localai_tpu_torch.engine.loader import load_config, load_params

    smi = c.phase_device()
    c.phase_build()
    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    with tempfile.TemporaryDirectory() as d:
        tok = c.grammar_setup(d)
        for name, dtype, kv in c.RECIPES:
            cfg = load_config(d, dtype=dtype)
            params = load_params(d, cfg, dtype=dtype, device="cuda")
            init = {}
            for key, host_bytes in (("tier", c.HOST_BYTES), ("no_tier", 0)):
                t0 = time.perf_counter()
                eng = c.host_engine(cfg, params, tok, kv, host_bytes)
                init[f"engine_init_ms_{key}"] = \
                    (time.perf_counter() - t0) * 1e3
                del eng
            out, _ = c.host_tier_leg(name, cfg, params, tok, kv, smi)
            print(f"HOST {label} {name} " + json.dumps(
                {**init, **{k: out.get(k) for k in KEYS}}) + f" card {smi}",
                flush=True)
            del params
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 chip_host_tier.py LABEL")
    main(sys.argv[1])
