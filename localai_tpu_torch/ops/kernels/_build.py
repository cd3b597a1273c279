"""Build the port's CUDA sources into shared libraries and load them.

Route: nvcc by hand into one `.so` per source with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds). Each
library is compiled at its first use — never when a module is imported —
into `localai_tpu_torch/csrc/build/`, named by a digest of its sources and
flags so an edited kernel is never served stale. All missing libraries
build in parallel (one nvcc per source, started together). A failed build
raises; nothing falls back to the plain versions. A library may be a
second build of another's source with flags of its own (VARIANTS: the
int4 weight GEMMs are weight_gemm.cu built with WG_INT4).
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("flash_prefill", "decode_attention", "paged_scatter",
           "ragged_attention", "weight_gemm", "weight_gemm4")
# library -> (the source it builds from, its extra nvcc flags)
VARIANTS = {"weight_gemm4": ("weight_gemm", ("-DWG_INT4=1",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (every pointer and the stream
# as c_void_p, so ctypes never truncates a 64-bit address)
SIGNATURES = {
    "flash_prefill": {
        "flash_prefill_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _F, _P],
    },
    "decode_attention": {
        "decode_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _F, _I, _I, _P],
        "decode_attention_q8_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                       _P],
        "decode_attention_paged_launch": [_I, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _F, _I,
                                          _I, _P],
        "decode_attention_q8_paged_launch": [_I, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _P, _I, _I, _I, _I, _I, _I,
                                             _F, _I, _I, _P],
        "decode_attention_tier_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _P, _P, _P, _I, _P, _P, _P,
                                         _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                         _I, _I, _I, _I, _I, _P],
        "decode_split_stages": [_I, _I],
    },
    "paged_scatter": {
        "paged_scatter_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P],
        "paged_scatter_q8_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _P],
    },
    "ragged_attention": {
        "ragged_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _F, _P, _I, _I,
                                    _P],
        "ragged_attention_q8_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _F, _P, _I, _I, _P],
        "ragged_attention_tier_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _I, _F, _P, _I, _I, _P],
        "ragged_attention_tiling": [_I, _I, _I],
    },
    "weight_gemm": {
        "weight_gemm_tmap": [_P, _I, _I, _P],
        "weight_gemm_wgmma_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _P],
        "weight_gemm_gemv_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _P],
        "weight_gemm_simt_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _P],
        "weight_gemm_moe_tmap": [_P, _I, _I, _I, _P],
        "weight_gemm_moe_launch": [_I, _I, _P, _I, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _P],
        "weight_gemm_head_tmap": [_P, _I, _I, _I, _P],
        "weight_gemm_split_launch": [_P, _P, _I, _I, _P],
        "weight_gemm_head_launch": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _P],
        "weight_gemm_moe4_launch": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _P],
        "weight_gemm_w4_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _P],
    },
}
SIGNATURES["weight_gemm4"] = SIGNATURES["weight_gemm"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are compiled at first use")


def _source(name: str) -> tuple:
    """(path of the .cu that library `name` builds from, its nvcc flags)."""
    src, extra = VARIANTS.get(name, (name, ()))
    return os.path.join(CSRC, src + ".cu"), NVCC_FLAGS + extra


def _digest(name: str) -> str:
    h = hashlib.sha256()
    src, flags = _source(name)
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [src]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every library in `names` that is not on disk yet, one nvcc
    per source, all started together. Returns {name: seconds} for the
    libraries built by this call."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        todo = [n for n in names if not os.path.exists(so_path(n))]
        if not todo:
            return {}
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = so_path(n) + f".tmp{os.getpid()}"
            src, flags = _source(n)
            cmd = [nvcc, *flags, "-o", tmp, src]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        took, errors = {}, []
        for n, (p, tmp) in procs.items():
            log, _ = p.communicate()
            took[n] = time.perf_counter() - t0
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n} "
                              f"({' '.join(_source(n)[1])}):\n{log}")
                continue
            os.replace(tmp, so_path(n))
        if errors:
            raise RuntimeError("\n".join(errors))
        return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not os.path.exists(so_path(name)):
                build_all()
            _libs[name] = bind(so_path(name), name)
    return _libs[name]


def bind(path: str, name: str) -> ctypes.CDLL:
    """The library at `path`, a build of csrc/<name>.cu, with its entry
    points' argument types set."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
