"""Shared native-library build/load policy of the port's host engines.

The three C++ engines (csrc/host/poa_engine.cpp, bam_scan.cpp,
hcluster.cpp; copies of the JAX package's native/*.cpp) are built with
g++ at first use into csrc/_build/, with -march=native for full SIMD (the
POA engine's AVX-512 path is compile-time gated).  Nothing prebuilt is
committed; the policy guards a build directory carried to another host:

* a library is rebuilt whenever its source's content hash (or the march
  flag) differs from the sidecar recorded at build time
  (``<lib>.meta.json``), and also when its recorded ISA features are
  absent on this host (a library built on a newer CPU would SIGILL at
  call time, which a Python ``except`` cannot catch);
* when rebuilding is impossible (no g++), a library is only loaded if its
  recorded ISA features all exist here — otherwise the loader raises.

Builds take an exclusive file lock and publish the library and its sidecar
by rename, so processes that start at once (test workers) neither build
twice nor load a half-written file.
``SVSCOPE_NATIVE_MARCH`` overrides the -march flag (e.g. ``x86-64-v3``
for a portable build — its recorded feature set is then the level's fixed
ISA list, not this host's flag dump).
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import subprocess

# Only ISA features the compiler can actually EMIT instructions for are
# recorded/checked — /proc/cpuinfo also reports environment flags
# (hypervisor, tsc_known_freq, arch_capabilities, ...) that differ across
# identical-ISA hosts and would make committed prebuilts unloadable.
_ISA_FLAGS = {
    "sse3", "ssse3", "sse4_1", "sse4_2", "popcnt", "aes", "pclmulqdq",
    "avx", "f16c", "fma", "movbe", "bmi1", "bmi2", "lzcnt", "abm",
    "avx2", "gfni", "vaes", "vpclmulqdq", "adx", "sha_ni",
    "avx512f", "avx512dq", "avx512cd", "avx512bw", "avx512vl",
    "avx512ifma", "avx512vbmi", "avx512vbmi2", "avx512vnni",
    "avx512bitalg", "avx512vpopcntdq", "avx512bf16", "avx512fp16",
}
# fixed feature sets of the portable -march levels (gcc's definitions)
_MARCH_LEVELS = {
    "x86-64": set(),
    "x86-64-v2": {"sse3", "ssse3", "sse4_1", "sse4_2", "popcnt"},
    "x86-64-v3": {"sse3", "ssse3", "sse4_1", "sse4_2", "popcnt", "avx",
                  "avx2", "bmi1", "bmi2", "f16c", "fma", "lzcnt", "movbe"},
    "x86-64-v4": {"sse3", "ssse3", "sse4_1", "sse4_2", "popcnt", "avx",
                  "avx2", "bmi1", "bmi2", "f16c", "fma", "lzcnt", "movbe",
                  "avx512f", "avx512bw", "avx512cd", "avx512dq",
                  "avx512vl"},
}


def _src_hash(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _host_cpu_flags() -> set[str] | None:
    """ISA-relevant flags of this host, or None if undeterminable
    (non-Linux) — None means 'cannot verify', not 'no features'."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return set(line.split(":", 1)[1].split()) & _ISA_FLAGS
    except OSError:
        pass
    return None


def _meta_path(lib: str) -> str:
    return lib + ".meta.json"


def ensure_lib(src: str, lib: str, extra_flags: tuple[str, ...] = ()) -> str:
    """Build (if needed and possible) and validate ``lib`` from ``src``.

    Returns the library path; raises RuntimeError when no safe library can
    be produced (missing toolchain + incompatible/unverifiable library).
    """
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _ensure_locked(src, lib, extra_flags)


def _ensure_locked(src: str, lib: str, extra_flags: tuple[str, ...]) -> str:
    march = os.environ.get("SVSCOPE_NATIVE_MARCH", "native")
    have_gxx = shutil.which("g++") is not None
    meta = None
    if os.path.exists(_meta_path(lib)):
        try:
            with open(_meta_path(lib)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = None
    src_ok = os.path.exists(src)
    want_hash = _src_hash(src) if src_ok else None
    host_flags = _host_cpu_flags()
    # freshness = did the inputs change (source hash, march)?  kept
    # independent of load-compatibility so an unreadable /proc/cpuinfo
    # can never force perpetual rebuilds of a lib built right here.
    fresh = (os.path.exists(lib) and meta is not None
             and meta.get("src_sha256") == want_hash
             and meta.get("march") == march)
    recorded = set(meta.get("cpu_flags", ())) if meta else None
    # compatibility is only decidable when both sides are known; an
    # unknown host (no /proc/cpuinfo) trusts a fresh local build record
    incompatible = (recorded is not None and host_flags is not None
                    and bool(recorded - host_flags))
    if src_ok and have_gxx and (not fresh or incompatible):
        tmp = f"{lib}.{os.getpid()}.tmp"
        # extra_flags go last so -l libraries follow the source object
        subprocess.run(["g++", "-O3", f"-march={march}", "-shared", "-fPIC",
                        "-o", tmp, src, *extra_flags], check=True)
        if march in _MARCH_LEVELS:
            flags = sorted(_MARCH_LEVELS[march])
        else:
            flags = sorted(host_flags or ())
        with open(_meta_path(tmp), "w") as f:
            json.dump({"src_sha256": want_hash, "march": march,
                       "cpu_flags": flags}, f)
        os.replace(_meta_path(tmp), _meta_path(lib))
        os.replace(tmp, lib)
        return lib
    if not os.path.exists(lib):
        raise RuntimeError(f"{lib} unavailable and cannot build "
                           f"(g++={'yes' if have_gxx else 'no'}, "
                           f"src={'yes' if src_ok else 'no'})")
    # cannot (re)build: only load if the recorded ISA features verify —
    # SIGILL is not catchable from Python, so "try and see" is not an
    # option for a foreign library.
    if meta is None:
        raise RuntimeError(
            f"library {lib} has no build metadata; refusing to load "
            "(rebuild with g++ available, or set SVSCOPE_NATIVE_MARCH)")
    if incompatible:
        raise RuntimeError(
            f"library {lib} needs CPU features absent on this host: "
            f"{sorted(recorded - host_flags)[:8]}")
    return lib
