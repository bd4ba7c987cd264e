"""Native (C++) host engines of the port, loaded via ctypes.

The port keeps its own copies of the three C++ engines in csrc/host/
(poa_engine.cpp, bam_scan.cpp, hcluster.cpp).  Each is built with g++ at
first use into csrc/_build/ (gitignored); build/load policy (content-hash
staleness, CPU-feature-gated libraries) is shared across them — see
native/_build.py.
"""
from __future__ import annotations

import os

from ._build import ensure_lib as _ensure

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "csrc", "_build")
LIBPOA = os.path.join(BUILD_DIR, "libpoa.so")
_SRC = os.path.join(HOST_SRC, "poa_engine.cpp")


def ensure_libpoa() -> str:
    return _ensure(_SRC, LIBPOA)
