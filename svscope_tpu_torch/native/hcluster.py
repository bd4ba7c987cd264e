"""ctypes loader for the hierarchical-clustering kernels (csrc/host/hcluster.cpp).

Feeds models/mixture's EM initialization (replacing scipy linkage/fcluster
at reference src/ReadsCluster.py:242-243) with two entry points:

* pdist_seq — (n, n) euclidean distances with scipy pdist's exact per-pair
  accumulation order (bitwise parity is the Ward-init contract).
* ward_cut_batch — the full per-window sim -> pdist -> NN-chain Ward
  linkage -> stable sort -> union-find -> K-cut labels pipeline in C++,
  threaded across windows; bitwise label parity with
  mixture.ward_init_labels (tested).  The Python NN-chain costs ~1.1 ms
  per 24-read window and was the single largest EM host-prep item
  (0.147 s of a 0.64 s localGraph chunk — round-5 stage probe).

Build/load policy (content-hash staleness, CPU-feature-gated prebuilts)
is shared across the native libs — see native/_build.py.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from . import BUILD_DIR, HOST_SRC
from ._build import ensure_lib as _ensure

LIB = os.path.join(BUILD_DIR, "libhcluster.so")
_SRC = os.path.join(HOST_SRC, "hcluster.cpp")

_lib = None


def ensure_lib() -> str:
    # -ffp-contract=off: an FMA would skip the d*d rounding step that
    # scipy's (and the NumPy fallback's) separate ops perform.
    # -fno-math-errno lets gcc vectorize sqrt (vsqrtpd is exact IEEE;
    # only the errno side effect is dropped) in the branchless
    # Lance-Williams update.
    return _ensure(_SRC, LIB, ("-ffp-contract=off", "-fno-math-errno"))


_dp = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def lib():
    global _lib
    if _lib is None:
        l = ctypes.CDLL(ensure_lib())
        l.pdist_seq.argtypes = [_dp, ctypes.c_int64, ctypes.c_int64, _dp,
                                ctypes.c_int32]
        l.pdist_seq.restype = None
        l.ward_cut_batch.argtypes = [_dp, _i64p, _i32p, ctypes.c_int64,
                                     ctypes.c_int32, _i32p, _i64p,
                                     ctypes.c_int32]
        l.ward_cut_batch.restype = None
        _lib = l
    return _lib


def pdist_seq(obs: np.ndarray, n_threads: int | None = None) -> np.ndarray:
    """(n, n) euclidean distances of observation rows, scipy-sequential
    accumulation order, diagonal 0."""
    x = np.ascontiguousarray(np.asarray(obs, np.float64).T)  # (nf, n)
    nf, n = x.shape
    out = np.empty((n, n), np.float64)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1) if n >= 256 else 1
    lib().pdist_seq(x.ctypes.data_as(_dp), n, nf, out.ctypes.data_as(_dp),
                    n_threads)
    return out


def ward_cut_batch(sims: list[np.ndarray], kmax: int,
                   n_threads: int | None = None) -> list[np.ndarray]:
    """Per-window (kmax, n) int32 Ward-cut labels from (n, n) float64
    similarity matrices; row k-1 holds the K=k partition (row 0 all
    zeros), labels numbered by first leaf occurrence — bitwise identical
    to mixture.ward_init_labels."""
    nw = len(sims)
    if nw == 0:
        return []
    ns = np.array([s.shape[0] for s in sims], np.int32)
    sim_off = np.zeros(nw, np.int64)
    lab_off = np.zeros(nw, np.int64)
    np.cumsum((ns[:-1].astype(np.int64)) ** 2, out=sim_off[1:])
    np.cumsum(kmax * ns[:-1].astype(np.int64), out=lab_off[1:])
    blob = np.empty(int(sim_off[-1] + ns[-1] ** 2), np.float64)
    for w, s in enumerate(sims):
        blob[sim_off[w]:sim_off[w] + ns[w] ** 2] = \
            np.ascontiguousarray(s, dtype=np.float64).ravel()
    labels = np.zeros(int(lab_off[-1] + kmax * ns[-1]), np.int32)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1) if nw > 1 else 1
    lib().ward_cut_batch(blob.ctypes.data_as(_dp),
                         sim_off.ctypes.data_as(_i64p),
                         ns.ctypes.data_as(_i32p), nw, int(kmax),
                         labels.ctypes.data_as(_i32p),
                         lab_off.ctypes.data_as(_i64p), int(n_threads))
    return [labels[lab_off[w]:lab_off[w] + kmax * ns[w]]
            .reshape(kmax, ns[w]) for w in range(nw)]
