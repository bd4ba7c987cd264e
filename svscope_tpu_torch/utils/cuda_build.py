"""Build a CUDA source of csrc/ into a shared library with a plain C
interface, at first use, and load it with ctypes.

Follows svscope_tpu/native/_build.py: the library is named by the source's
content hash, so an edited source rebuilds and an unchanged one loads.
Libraries go to svscope_tpu_torch/csrc/_build/ (listed in .gitignore).
No fallback: a missing nvcc or a failed build raises with the cause.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}    # source name -> {seconds, ptxas, lib}


def find_nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels of svscope_tpu_torch cannot be built")


def load_cuda_lib(source: str) -> ctypes.CDLL:
    """ctypes handle of csrc/<source> built for sm_90a (built if needed)."""
    with _lock:
        if source in _loaded:
            return _loaded[source]
        src = os.path.join(CSRC, source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        stem = os.path.splitext(source)[0]
        lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source} "
                                   f"(rc {res.returncode}):\n{res.stderr}")
            os.replace(tmp, lib)
            BUILD_LOG[source] = {"seconds": time.perf_counter() - t0,
                                 "ptxas": res.stderr.strip(), "lib": lib}
        else:
            BUILD_LOG.setdefault(source, {"seconds": 0.0, "ptxas": "",
                                          "lib": lib})
        handle = ctypes.CDLL(lib)
        _loaded[source] = handle
        return handle
