"""The port's native (C++) host code, built at first use.

`grammar.cpp` (the GBNF matcher and the grammar table builder) compiles with
g++ into `localai_tpu_torch/csrc/build/` beside the CUDA libraries, named by
a digest of its source and flags so an edited source is never served stale,
and loads with ctypes. Each process builds into a file of its own and moves
it into place, so concurrent builders never see a half-written library. A
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "csrc", "build")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def so_path(name: str) -> str:
    """Where the build of native/<name>.cpp lives."""
    h = hashlib.sha256()
    with open(os.path.join(_HERE, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_and_load(name: str) -> ctypes.CDLL:
    """Compile native/<name>.cpp if its build is not on disk, and dlopen
    it (once a process)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        path = so_path(name)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            r = subprocess.run(
                ["g++", *GXX_FLAGS, "-o", tmp,
                 os.path.join(_HERE, f"{name}.cpp")],
                capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"native build of {name}.cpp failed:\n"
                                   f"{r.stderr}")
            os.replace(tmp, path)
        lib = _LIBS[name] = ctypes.CDLL(path)
        return lib
