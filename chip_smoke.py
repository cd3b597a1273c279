"""Chip smoke test of the PyTorch/CUDA port (localai_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure raises
and the script exits non-zero:
  0. device: requires CUDA; prints the card's name and power limit
     (nvidia-smi), the torch and CUDA versions; turns TF32 off.
  1. build: compiles the port's CUDA sources (csrc/*.cu, one nvcc each, in
     parallel) and prints the build seconds.
  2. kernels vs plain at the main path's shapes (Llama-3.1-8B geometry:
     H=32, KVH=8, D=128): max abs error against each kernel's plain
     PyTorch version with its tolerance, and the error of a planted fault
     that the tolerance must reject; kernel/plain/library times (CUDA
     events, median of 25 after warmup) and the least time the card could
     take (bound_ms).
  3. card vs CPU: an f32 model with the 8B widths and 2 layers, weights
     made once on the CPU from a fixed seed; the same greedy request for 16
     tokens through the port on the CPU (plain versions) and on the card
     (kernels) gives the same tokens and first-step logits within
     tolerance.
  4. the main path: a synthetic Llama-3.1-8B checkpoint served by the
     port's gRPC backend on 127.0.0.1 in bf16 and in the int8 recipe
     (int8 weights + int8 KV), four concurrent PredictStream requests each;
     the kernels' launch counters are zeroed just before and read just
     after.
The second line from the end is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. It imports nothing of JAX or localai_tpu.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Llama-3.1-8B geometry (bench.py's 8b model; HF config of
# meta-llama/Llama-3.1-8B)
CFG_8B = {
    "architectures": ["LlamaForCausalLM"],
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
}

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores,
# f32 outside the tensor cores (the port's f32 paths never use TF32), HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version: both compute in f32 and round once to the output
# dtype, so they differ by the f32 summation order, which moves an output by
# at most one rounding step: |out - ref| <= atol + rtol * |ref|. bf16: rtol
# 2**-7 (one bf16 ulp, relative) plus atol 1e-3; f32: 2e-5 absolute.
TOL = {"bfloat16": (1e-3, 2 ** -7), "float32": (2e-5, 0.0)}


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ phase 0

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs an NVIDIA card")
    if not os.path.isdir(os.path.join(HERE, "localai_tpu_torch")):
        raise SystemExit("chip_smoke: localai_tpu_torch/ not found beside "
                         "this script")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ------------------------------------------------------------------ phase 1

def phase_build():
    from localai_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    for name, s in built.items():
        log(f"build {name}: {s:.1f} s")
    log(f"phase1 build: {secs:.1f} s wall for {sorted(built) or 'cached'}")
    for name in _build.SOURCES:
        _build.load(name)
    return secs


# ------------------------------------------------------------------ phase 2

def _time_ms(fn, reps=25, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _prefill_case(B, S, H, KVH, D, dtype, lengths, window=None, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, S, KVH, D, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, S, KVH, D, device="cuda", generator=g).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens, window


def _decode_case(B, H, KVH, T, D, dtype, lengths, q8=False, seed=0):
    import torch

    from localai_tpu_torch.ops.kvcache import quantize_tokens

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, 1, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, KVH, T, D, device="cuda", generator=g)
    v = torch.randn(B, KVH, T, D, device="cuda", generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if not q8:
        return q, k.to(dtype), v.to(dtype), lens
    kq, ks = quantize_tokens(k)
    vq, vs = quantize_tokens(v)
    return (q, kq, ks.reshape(B, KVH, T // 128, 128), vq,
            vs.reshape(B, KVH, T // 128, 128), lens)


def _compare(out, ref, tol, lengths=None):
    """(max |out - ref|, max of |out - ref| - rtol * |ref|) with tol =
    (atol, rtol); the pair passes when the second is at most atol. With
    `lengths`, only query rows below each row's length count (prefill:
    padding rows are don't-care by the kernels' contract)."""
    _, rtol = tol
    if lengths is not None:
        pairs = [(out[b, :n], ref[b, :n]) for b, n in enumerate(lengths)
                 if n > 0]
    else:
        pairs = [(out, ref)]
    err = excess = float("-inf")
    for o, r in pairs:
        d = (o.float() - r.float()).abs()
        err = max(err, float(d.max()))
        excess = max(excess, float((d - rtol * r.float().abs()).max()))
    return err, excess


def _check_close(name, out, ref, tol, lengths=None, fault=None):
    """Raise unless out agrees with ref within tol. With `fault` (a plain
    result of a deliberately wrong computation), also raise unless the
    same limit rejects it, and report its error."""
    err, excess = _compare(out, ref, tol, lengths)
    if not excess <= tol[0]:
        raise AssertionError(f"{name}: max_abs_err {err}, excess over rtol "
                             f"{excess} > atol {tol[0]}")
    res = {"max_abs_err": err, "tol": f"atol {tol[0]:g} + rtol {tol[1]:g}"}
    if fault is not None:
        f_err, f_excess = _compare(out, fault, tol, lengths)
        if f_excess <= tol[0]:
            raise AssertionError(f"{name}: the limit does not reject the "
                                 f"planted fault ({f_err})")
        res["planted_fault_err"] = f_err
    return res


def check_prefill(B, S, H, KVH, D, dtype, lengths, window=None,
                  timed=True):
    """With timed=True also plants a fault — the 64 keys furthest back
    dropped for the query rows that have more than S - 64 (a window of
    S - 64) — and checks that the tolerance rejects it."""
    import torch
    import torch.nn.functional as F

    from localai_tpu_torch.ops.kernels import flash_prefill, \
        flash_prefill_plain

    q, k, v, lens, window = _prefill_case(B, S, H, KVH, D, dtype, lengths,
                                          window)
    out = flash_prefill(q, k, v, lens, sliding_window=window)
    torch.cuda.synchronize()
    ref = flash_prefill_plain(q, k, v, lens, sliding_window=window)
    fault = flash_prefill_plain(q, k, v, lens, sliding_window=S - 64) \
        if timed and window is None else None
    name = f"flash_prefill {str(dtype).split('.')[-1]} B={B} S={S} " \
           f"H={H} KVH={KVH} D={D} lengths={lengths} window={window}"
    res = _check_close(name, out, ref, TOL[str(dtype).split(".")[-1]],
                       lengths, fault)
    if timed:
        es = q.element_size()
        # only the rows below each length are work: q and out over those
        # rows, k and v over the same rows, lengths once
        rows = sum(min(n, S) for n in lengths)
        pairs = sum(min(i + 1, window or S) for n in lengths
                    for i in range(min(n, S)))
        flops = 4.0 * pairs * H * D
        nbytes = es * rows * (2 * H * D + 2 * KVH * D) + 4 * B
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res.update(
            ms=_time_ms(lambda: flash_prefill(q, k, v, lens,
                                              sliding_window=window)),
            plain_ms=_time_ms(lambda: flash_prefill_plain(
                q, k, v, lens, sliding_window=window)),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_formula=(f"max({flops:.4g} flop / "
                           f"{peak / 1e12:.0f} TFLOP/s, {nbytes:.4g} B / "
                           f"3.35 TB/s)"))
        if window is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            res["library_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        else:
            res["library_ms"] = None
    log(name + " " + json.dumps(res))
    return res


def check_decode(B, H, KVH, T, D, dtype, lengths, q8=False, window=None,
                 timed=True):
    """With timed=True also plants a fault — the last 32-token tile dropped
    from each row longer than 512, where one tile moves the output least —
    and checks that the tolerance rejects it."""
    import torch
    import torch.nn.functional as F

    from localai_tpu_torch.ops.kernels import (
        ragged_decode, ragged_decode_plain, ragged_decode_q8,
        ragged_decode_q8_plain,
    )

    case = _decode_case(B, H, KVH, T, D, dtype, lengths, q8=q8)
    kernel, plain_fn = (ragged_decode_q8, ragged_decode_q8_plain) if q8 \
        else (ragged_decode, ragged_decode_plain)
    fn = lambda: kernel(*case, sliding_window=window)  # noqa: E731
    plain = lambda: plain_fn(*case, sliding_window=window)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    fault = None
    if timed:
        short = torch.tensor([n - 32 if n > 512 else n for n in lengths],
                             dtype=torch.int32, device="cuda")
        fault = plain_fn(*case[:-1], short, sliding_window=window)
    kname = "ragged_decode_q8" if q8 else "ragged_decode"
    name = f"{kname} {str(dtype).split('.')[-1]} B={B} T={T} H={H} " \
           f"KVH={KVH} D={D} lengths={lengths[:8]}{'...' if B > 8 else ''}" \
           f" window={window}"
    res = _check_close(name, out, ref, TOL[str(dtype).split(".")[-1]],
                       fault=fault)
    if timed:
        es = case[0].element_size()
        read = sum(min(n, T) if not window else min(n, T, window)
                   for n in lengths)
        kv_es = 1 if q8 else es
        # K/V (and int8 scales) of the tokens read, q and out, lengths
        nbytes = (read * KVH * D * 2 * kv_es + (read * KVH * 2 * 4 if q8
                                                else 0)
                  + 2 * B * H * D * es + 4 * B)
        flops = 4.0 * read * H * D
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res.update(ms=_time_ms(fn), plain_ms=_time_ms(plain),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_formula=(f"max({nbytes:.4g} B of K/V read + q/out "
                                  f"/ 3.35 TB/s, {flops:.4g} flop / "
                                  f"{peak / 1e12:.0f} TFLOP/s)"))
        if not q8 and window is None:
            q, k, v, lens = case
            qt = q.transpose(1, 2)                        # [B, H, 1, D]
            mask = (torch.arange(T, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]   # [B, 1, 1, T]
            res["library_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, k, v, attn_mask=mask, enable_gqa=True))
        else:
            res["library_ms"] = None
    log(name + " " + json.dumps(res))
    return res


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes
    (plus small f32 / GQA / window cases for the algorithm)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    H, KVH, D = 32, 8, 128
    main = {}
    # main-path shapes: 4 slots, 512-token prefill bucket, 2048 context
    main["flash_prefill"] = check_prefill(4, 512, H, KVH, D, bf16,
                                          [512, 300, 17, 1])
    check_prefill(2, 256, H, KVH, D, bf16, [256, 200], window=64,
                  timed=False)
    check_prefill(3, 64, 8, 1, 64, f32, [64, 40, 1], timed=False)
    check_prefill(2, 96, 4, 4, 128, f32, [96, 50], window=16, timed=False)
    lens4 = [1, 129, 1000, 2048]
    lens16 = lens4 + [7, 64, 255, 256, 511, 700, 1024, 1500, 1777, 2000,
                      2047, 300]
    main["ragged_decode"] = check_decode(4, H, KVH, 2048, D, bf16, lens4)
    check_decode(16, H, KVH, 2048, D, bf16, lens16)
    check_decode(3, 8, 2, 256, 64, f32, [5, 200, 256], timed=False)
    check_decode(2, H, KVH, 2048, D, bf16, [1500, 40], window=256,
                 timed=False)
    main["ragged_decode_q8"] = check_decode(4, H, KVH, 2048, D, bf16, lens4,
                                            q8=True)
    check_decode(16, H, KVH, 2048, D, bf16, lens16, q8=True)
    check_decode(3, 8, 1, 256, 64, f32, [5, 200, 256], q8=True,
                 timed=False)
    log("phase2 kernels: all within tolerance")
    return main


# ------------------------------------------------------------------ phase 3

def phase_card_vs_cpu():
    """f32, 8B widths, depth 2: the same greedy request through the port on
    the CPU (plain versions) and on the card (kernels). Tokens must be
    equal; first-step logits within 2e-3 (f32 GEMMs over K up to 14336
    summed in another order on the two devices)."""
    import torch

    from localai_tpu_torch.engine.engine import (
        Engine, EngineConfig, GenRequest,
    )
    from localai_tpu_torch.engine.loader import load_config
    from localai_tpu_torch.models.llama import (
        init_kv_cache, init_params, prefill,
    )
    from localai_tpu_torch.ops.rope import rope_table
    from localai_tpu_torch.ops.sampling import SamplingParams

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_8B, num_hidden_layers=2), f)
        cfg = load_config(d, dtype="float32")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    log(f"phase3: f32 weights (8B widths, 2 layers) made on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = [(i * 7919) % cfg.vocab_size for i in range(1, 24)]
    ec = EngineConfig(max_slots=1, max_context=128, prefill_buckets=(32,),
                      prefill_chunk=32)

    def run(device):
        m = model.to(device)
        ids = torch.zeros((1, 32), dtype=torch.int32, device=device)
        ids[0, :len(prompt)] = torch.tensor(prompt)
        cos, sin = rope_table(cfg.rope, 128, device=device)
        kc, vc = init_kv_cache(cfg, 1, 128, device=device)
        with torch.no_grad():
            logits = prefill(m, cfg, ids, torch.tensor([len(prompt)],
                                                       device=device),
                             cos, sin, kc, vc,
                             torch.zeros((1,), dtype=torch.int64,
                                         device=device))
        eng = Engine(cfg, m, None, ec, device=device)
        toks = [o.token_id for o in eng.generate(GenRequest(
            prompt, SamplingParams(temperature=0.0), max_tokens=16,
            ignore_eos=True))]
        return logits.float().cpu(), toks

    t0 = time.perf_counter()
    cpu_logits, cpu_toks = run("cpu")
    t1 = time.perf_counter()
    gpu_logits, gpu_toks = run("cuda")
    t2 = time.perf_counter()
    err = float((cpu_logits - gpu_logits).abs().max())
    log(f"phase3 cpu tokens  {cpu_toks} ({t1 - t0:.1f} s)")
    log(f"phase3 card tokens {gpu_toks} ({t2 - t1:.1f} s)")
    log(f"phase3 first-step logits max_abs_err {err:.3g} (tol 2e-3), "
        f"|logits| max {float(cpu_logits.abs().max()):.3g}")
    if cpu_toks != gpu_toks or len(gpu_toks) != 16:
        raise AssertionError("card and CPU greedy tokens differ")
    if not err <= 2e-3:
        raise AssertionError(f"first-step logits differ by {err}")
    model.to("cpu")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 4

class _Client:
    """Minimal gRPC client of the backend proto (the port's messages)."""

    def __init__(self, addr):
        import grpc

        from localai_tpu_torch.backend import pb

        self.pb = pb
        self.channel = grpc.insecure_channel(addr)
        grpc.channel_ready_future(self.channel).result(timeout=60)

    def _rpc(self, name, req_cls, resp_cls, stream=False):
        make = self.channel.unary_stream if stream \
            else self.channel.unary_unary
        return make(f"/{self.pb.SERVICE_NAME}/{name}",
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString)

    def load(self, **kw):
        return self._rpc("LoadModel", self.pb.ModelOptions, self.pb.Result)(
            self.pb.ModelOptions(**kw), timeout=1800)

    def stream(self, **kw):
        return self._rpc("PredictStream", self.pb.PredictOptions,
                         self.pb.Reply, stream=True)(
            self.pb.PredictOptions(**kw), timeout=600)

    def metrics(self):
        r = self._rpc("GetMetrics", self.pb.MetricsRequest,
                      self.pb.MetricsResponse)(self.pb.MetricsRequest())
        return dict(r.metrics)

    def close(self):
        self.channel.close()


REQUESTS = [  # (prompt length, sampling) — 700 prefills in 512-token chunks
    (1, dict(temperature=0.0)),
    (17, dict(temperature=0.8, top_k=40, seed=11)),
    (300, dict(temperature=0.0)),
    (700, dict(temperature=0.9, top_p=0.9, seed=5)),
]
NEW_TOKENS = 64


def drive_requests(client, salt=0):
    """The four REQUESTS at once over `client`. Returns ([(ttft_s, token
    ids, logprobs, last reply)], wall seconds). The prompt ids depend on
    `salt`, so a new salt misses the prompt cache."""
    import threading

    vocab = CFG_8B["vocab_size"]
    results = [None] * len(REQUESTS)

    def one(i, n, sp):
        ids = [(7 * i + 13 * j + salt) % (vocab - 1) + 1 for j in range(n)]
        ts = time.perf_counter()
        ttft, toks, lps, last = None, [], [], None
        for c in client.stream(prompt_ids=ids, tokens=NEW_TOKENS,
                               ignore_eos=True, logprobs=True, **sp):
            if c.token_ids and ttft is None:
                ttft = time.perf_counter() - ts
            toks += list(c.token_ids)
            lps += list(c.logprobs)
            last = c
        results[i] = (ttft, toks, lps, last)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i, n, sp))
               for i, (n, sp) in enumerate(REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def serve_recipe(name, model_dir, load_kw, then=None):
    """Start the port's gRPC backend on 127.0.0.1, load the model, drive
    the four requests and check them. `then(client)`, if given, runs after
    the checks and before the server stops."""
    import torch

    from localai_tpu_torch.backend.server import serve
    from localai_tpu_torch.ops.kernels import launch_counts

    vocab = CFG_8B["vocab_size"]
    server, servicer, port = serve("127.0.0.1:0", device="cuda")
    client = _Client(f"127.0.0.1:{port}")
    try:
        t0 = time.perf_counter()
        r = client.load(model=model_dir, parallel=4, context_size=2048,
                        **load_kw)
        if not r.success:
            raise RuntimeError(f"{name}: LoadModel failed: {r.message}")
        log(f"phase4 {name}: LoadModel (weights + warmup) "
            f"{time.perf_counter() - t0:.1f} s")
        before = launch_counts()
        m0 = client.metrics()
        results, wall = drive_requests(client)
        m1 = client.metrics()
        after = launch_counts()
        for i, res in enumerate(results):
            if res is None:
                raise RuntimeError(f"{name}: request {i} failed")
            ttft, toks, lps, last = res
            if (last.finish_reason != "length" or last.tokens != NEW_TOKENS
                    or len(toks) != NEW_TOKENS):
                raise AssertionError(
                    f"{name} request {i}: finish {last.finish_reason!r} "
                    f"tokens {last.tokens}/{len(toks)}")
            if not all(0 <= t < vocab for t in toks):
                raise AssertionError(f"{name}: token id out of vocab")
            if not all(x == x and abs(x) < 1e30 for x in lps):
                raise AssertionError(f"{name}: non-finite logprob")
        ttfts = sorted(r[0] for r in results)
        dd = m1["decode_dispatches"] - m0["decode_dispatches"]
        ds = m1["decode_steps_dispatched"] - m0["decode_steps_dispatched"]
        gen = m1["tokens_generated"] - m0["tokens_generated"]
        launched = {k: after[k] - before[k] for k in after}
        out = {
            "recipe": name, "requests": len(REQUESTS),
            "prompt_lengths": [n for n, _ in REQUESTS],
            "new_tokens_each": NEW_TOKENS, "tokens": int(gen),
            "wall_s": wall, "tok_s": gen / wall,
            "ttft_p50_ms": (ttfts[1] + ttfts[2]) / 2 * 1e3,
            "ttft_ms": [t * 1e3 for t in ttfts],
            "decode_dispatches": int(dd),
            "steps_per_dispatch": ds / max(dd, 1),
            "launches_during_requests": launched,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        }
        log(f"phase4 {name} " + json.dumps(out))
        if then is not None:
            then(client)
        return out
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1).wait(10)
        servicer.engine = None
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def phase_main_path():
    """The main path: a synthetic Llama-3.1-8B checkpoint served by the
    port's gRPC backend, bf16 then the int8 recipe."""
    import tempfile

    import torch

    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_8B, localai_synthetic=True), f)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        bf16 = serve_recipe("bf16", d, dict(dtype="bfloat16"))
        torch.cuda.reset_peak_memory_stats()
        int8 = serve_recipe("int8", d, dict(dtype="int8",
                                            cache_type_key="int8",
                                            cache_type_value="int8"))
        counts = launch_counts()
    log("phase4 launches on the main path " + json.dumps(counts))
    for k in ("flash_prefill", "ragged_decode", "ragged_decode_q8"):
        if counts[k] <= 0:
            raise AssertionError(f"the main path never launched {k}")
    if bf16["launches_during_requests"]["ragged_decode_q8"] or \
            int8["launches_during_requests"]["ragged_decode"]:
        raise AssertionError("decode kernel variant does not match the "
                             "recipe's KV cache")
    return counts


KERNELS = {
    "flash_prefill": ("localai_tpu_torch/csrc/flash_prefill.cu",
                      "localai_tpu/ops/pallas/flash_attention.py:133"),
    "ragged_decode": ("localai_tpu_torch/csrc/decode_attention.cu",
                      "localai_tpu/ops/pallas/flash_attention.py:289"),
    "ragged_decode_q8": ("localai_tpu_torch/csrc/decode_attention.cu",
                         "localai_tpu/ops/pallas/flash_attention.py:453"),
}


def main():
    import torch

    phase_device()
    phase_build()
    measured = phase_kernels()
    phase_card_vs_cpu()
    counts = phase_main_path()
    rows = []
    for name, (src, replaces) in KERNELS.items():
        m = measured[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
