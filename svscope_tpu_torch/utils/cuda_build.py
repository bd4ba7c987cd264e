"""Build a CUDA source of csrc/ into a shared library with a plain C
interface, at first use, and load it with ctypes.

Follows svscope_tpu/native/_build.py: the library is named by a content
hash of the source AND of every csrc/ header it includes (`#include
"x.cuh"`, followed recursively), so an edited source or header rebuilds
and an unchanged tree loads.  Libraries go to svscope_tpu_torch/csrc/_build/
(listed in .gitignore).  No fallback: a missing nvcc or a failed build
raises with the cause.  `load_cuda_libs` builds several sources at once,
one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

_lock = threading.Lock()
_source_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}    # build_key -> {seconds, ptxas, lib}


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


def source_files(source: str, csrc: str = CSRC) -> list[str]:
    """csrc/<source> and every file of `csrc` it includes with quotes,
    transitively, in first-seen order.  An include that is not a file of
    `csrc` (a system or toolkit header) is not followed."""
    seen: list[str] = []
    todo = [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        path = os.path.join(csrc, name)
        if not os.path.isfile(path):
            if name == source:
                raise FileNotFoundError(path)
            continue
        seen.append(name)
        with open(path, "rb") as f:
            todo.extend(m.decode() for m in _INCLUDE.findall(f.read()))
    return seen


def source_digest(source: str, csrc: str = CSRC) -> str:
    """Hash of the source and its csrc/ includes (names and contents)."""
    h = hashlib.sha256()
    for name in source_files(source, csrc):
        with open(os.path.join(csrc, name), "rb") as f:
            data = f.read()
        h.update(name.encode() + b"\0" + str(len(data)).encode() + b"\0")
        h.update(data)
    return h.hexdigest()[:16]


def _source_lock(source: str) -> threading.Lock:
    with _lock:
        return _source_locks.setdefault(source, threading.Lock())


def build_key(source: str, defines=()) -> str:
    """Name of one build of `source`: the source, then each `-D` macro."""
    return " ".join([source, *(f"-D{d}" for d in defines)])


def load_cuda_lib(source: str, defines=()) -> ctypes.CDLL:
    """ctypes handle of csrc/<source> built for sm_90a (built if needed),
    with the preprocessor macros `defines` (names, or NAME=value) set: a
    build per set of macros, each its own library."""
    defines = tuple(defines)
    key = build_key(source, defines)
    with _source_lock(key):
        if key in _loaded:
            return _loaded[key]
        src = os.path.join(CSRC, source)
        stem = os.path.splitext(source)[0]
        tag = "".join("_" + re.sub(r"\W", "_", d) for d in defines)
        lib = os.path.join(BUILD_DIR,
                           f"lib{stem}{tag}_{source_digest(source)}.so")
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
                   *(f"-D{d}" for d in defines), "-o", tmp, src]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source} "
                                   f"(rc {res.returncode}):\n{res.stderr}")
            os.replace(tmp, lib)
            BUILD_LOG[key] = {"seconds": time.perf_counter() - t0,
                                 "ptxas": res.stderr.strip(), "lib": lib}
        else:
            BUILD_LOG.setdefault(key, {"seconds": 0.0, "ptxas": "",
                                          "lib": lib})
        handle = ctypes.CDLL(lib)
        _loaded[key] = handle
        return handle


def load_cuda_libs(sources) -> list[ctypes.CDLL]:
    """load_cuda_lib for several sources, their nvcc builds run at once."""
    sources = list(sources)
    with ThreadPoolExecutor(max(1, len(sources))) as pool:
        return list(pool.map(load_cuda_lib, sources))
