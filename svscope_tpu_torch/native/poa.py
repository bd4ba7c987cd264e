"""ctypes bindings for the native POA engine (csrc/host/poa_engine.cpp).

NativePoaGraph mirrors ops/poa.PoaGraph's build/align/fuse/pack/MSA/
consensus surface with identical semantics; `poa_native(sequences)` is the
drop-in spoa-equivalent entry point.  The device rounds
(ops/poa_batch.py) route, pack and fuse these graphs a round or a bucket
chunk at a time through the engine's batch entries (poa_stat_batch,
poa_pack_batch, poa_fuse_batch), and the fused engine (ops/poa_fused.py)
emits a fetched chunk's MSA rows and consensus through pk_emit_batch, so the
per-read bookkeeping runs at C++ speed on the engine's thread pool.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading

import numpy as np

from . import ensure_libpoa

_lib = None
_lib_lock = threading.Lock()
# threads of the engine's batch entries unless a caller gives its own
HOST_THREADS = min(8, os.cpu_count() or 1)


def declare_msa_batch(l):
    """Declare poa_msa_batch's C signature on a loaded engine `l`; returns
    it (tools/probe/engine_ab loads a second build through this)."""
    l.poa_msa_batch.restype = ct.c_int
    l.poa_msa_batch.argtypes = [ct.c_char_p, ct.POINTER(ct.c_int64),
                                ct.c_int64, ct.POINTER(ct.c_int64),
                                ct.c_int64, ct.POINTER(ct.c_uint8),
                                ct.c_int64, ct.POINTER(ct.c_int64),
                                ct.c_int32]
    return l


def lib():
    """Thread-safe lazy CDLL load.

    The handle is published only after every restype/argtype is configured —
    a partially configured library seen from another thread would truncate
    the 64-bit graph handle via the default int restype."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        l = ct.CDLL(ensure_libpoa())
        l.poa_create.restype = ct.c_void_p
        l.poa_free.argtypes = [ct.c_void_p]
        l.poa_n_nodes.argtypes = [ct.c_void_p]
        l.poa_n_seqs.argtypes = [ct.c_void_p]
        l.poa_max_indegree.argtypes = [ct.c_void_p]
        l.poa_add_sequence.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int]
        l.poa_align_only.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int,
                                     ct.POINTER(ct.c_int32),
                                     ct.POINTER(ct.c_int32)]
        l.poa_fuse.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int32),
                               ct.POINTER(ct.c_int32), ct.c_int,
                               ct.c_char_p]
        l.poa_pack.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                               ct.POINTER(ct.c_uint8),
                               ct.POINTER(ct.c_int32),
                               ct.POINTER(ct.c_uint8),
                               ct.POINTER(ct.c_int32)]
        l.poa_msa.argtypes = [ct.c_void_p, ct.c_int, ct.POINTER(ct.c_uint8)]
        l.poa_consensus.argtypes = [ct.c_void_p, ct.c_int,
                                    ct.POINTER(ct.c_uint8)]
        # the per-round device path's batch entries (an engine without
        # them raises AttributeError here)
        vp, i32, i64 = ct.c_void_p, ct.c_int32, ct.c_int64
        pv, p8, p32, p64 = (ct.POINTER(vp), ct.POINTER(ct.c_uint8),
                            ct.POINTER(i32), ct.POINTER(i64))
        l.poa_stat_batch.restype = None
        l.poa_stat_batch.argtypes = [pv, i64, p32, p32]
        l.poa_pack_batch.restype = ct.c_int
        l.poa_pack_batch.argtypes = [pv, i64, i64, i32, i32, i32,
                                     ct.c_char_p, p64, p64, p8, p32, p8,
                                     p32, p32, p8, p32, i32]
        l.poa_fuse_batch.restype = ct.c_int
        l.poa_fuse_batch.argtypes = [pv, i64, p32, p32, i64, p32, p32, i32,
                                     ct.c_char_p, p64, p64, i32,
                                     ct.POINTER(ct.c_double)]
        l.pk_emit_batch.restype = ct.c_int
        l.pk_emit_batch.argtypes = [p32] * 10 + [p8, i64, i32, i32, i32,
                                                  i64, i64, p8, p64, p64,
                                                  p64, i32]
        _lib = declare_msa_batch(l)
    return _lib


def _i32p(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_int32))


def _u8p(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint8))


class NativePoaGraph:
    def __init__(self):
        self._lib = lib()
        self._h = self._lib.poa_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.poa_free(self._h)
            self._h = None

    def n_nodes(self) -> int:
        return self._lib.poa_n_nodes(self._h)

    def n_seqs(self) -> int:
        return self._lib.poa_n_seqs(self._h)

    def max_indegree(self) -> int:
        return self._lib.poa_max_indegree(self._h)

    def add_sequence(self, seq: str) -> None:
        b = seq.encode()
        self._lib.poa_add_sequence(self._h, b, len(b))

    def align_only(self, seq: str):
        b = seq.encode()
        cap = self.n_nodes() + len(b) + 2
        nodes = np.empty(cap, np.int32)
        spos = np.empty(cap, np.int32)
        n = self._lib.poa_align_only(self._h, b, len(b), _i32p(nodes),
                                     _i32p(spos))
        return [(int(nodes[k]), int(spos[k])) for k in range(n)]

    def fuse(self, aln, seq: str) -> None:
        n = len(aln)
        nodes = np.array([a for a, _ in aln], np.int32)
        spos = np.array([s for _, s in aln], np.int32)
        self._lib.poa_fuse(self._h, _i32p(nodes), _i32p(spos), n, seq.encode())

    def pack(self, n_max: int, p_max: int = 8):
        chars = np.zeros(n_max, np.uint8)
        preds = np.full((n_max, p_max), -1, np.int32)
        sinks = np.zeros(n_max, np.uint8)
        nor = np.full(n_max, -1, np.int32)
        n = self._lib.poa_pack(self._h, n_max, p_max, _u8p(chars),
                               _i32p(preds), _u8p(sinks), _i32p(nor))
        if n < 0:
            return None
        return chars, preds, sinks.astype(bool), np.int32(n), nor

    def msa(self, max_cols: int | None = None) -> list[str]:
        ns = self.n_seqs()
        if ns == 0:
            return []
        # every MSA column holds >=1 node, so n_nodes bounds the width —
        # the old fixed 1<<20 cap zeroed ~25 MB per call
        if max_cols is None:
            max_cols = self.n_nodes() + 2
        out = np.zeros(ns * max_cols, np.uint8)
        ncol = self._lib.poa_msa(self._h, max_cols, _u8p(out))
        if ncol < 0:
            raise RuntimeError("MSA wider than buffer")
        rows = out[:ns * ncol].reshape(ns, ncol)
        return [r.tobytes().decode() for r in rows]

    def consensus(self, cap: int | None = None) -> str:
        if cap is None:
            cap = self.n_nodes() + 2     # consensus is a path in the graph
        out = np.zeros(cap, np.uint8)
        n = self._lib.poa_consensus(self._h, cap, _u8p(out))
        if n < 0:
            raise RuntimeError("consensus longer than buffer")
        return out[:n].tobytes().decode()


def poa_native(sequences: list[str]):
    """spoa-equivalent poa(sequences, 1) through the C++ engine."""
    g = NativePoaGraph()
    for s in sequences:
        g.add_sequence(s)
    return g.consensus(), g.msa()


def _i64p(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_int64))


def flatten_reads(seq_lists: list[list[str]]):
    """Every window's reads as one byte blob: (blob, seq_off, win_off),
    read k of window w at blob[seq_off[i]:seq_off[i + 1]], i = win_off[w]
    + k."""
    flat = [s.encode() for seqs in seq_lists for s in seqs]
    win_off = np.zeros(len(seq_lists) + 1, np.int64)
    win_off[1:] = np.cumsum([len(s) for s in seq_lists], dtype=np.int64)
    seq_off = np.zeros(len(flat) + 1, np.int64)
    seq_off[1:] = np.cumsum([len(b) for b in flat], dtype=np.int64)
    return b"".join(flat), seq_off, win_off


def pack_msa_batch(seq_lists: list[list[str]]):
    """poa_msa_batch's input: (blob, seq_off, win_off, est, safe), est and
    safe the two output capacities a window: a realistic MSA width (~2x
    the longest read) and the no-fusion worst case (every base)."""
    blob, seq_off, win_off = flatten_reads(seq_lists)
    est, safe = 1024, 1024
    for w, seqs in enumerate(seq_lists):
        total = int(seq_off[win_off[w + 1]] - seq_off[win_off[w]])
        longest = max((len(s) for s in seqs), default=0)
        est = max(est, (len(seqs) + 2) * (2 * longest + 260))
        safe = max(safe, (len(seqs) + 2) * (total + 2))
    return blob, seq_off, win_off, est, safe


def msa_batch_bytes(packed, threads: int, engine=None):
    """One poa_msa_batch call of `engine` (default: this package's) on
    pack_msa_batch's output, retried at the safe capacity on overflow:
    (out, out_len, cap), window w's text out[w * cap:][:out_len[w]]."""
    l = engine if engine is not None else lib()
    blob, seq_off, win_off, est, safe = packed
    n_win = len(win_off) - 1
    for cap in (est, safe):
        out = np.zeros(n_win * cap, np.uint8)
        out_len = np.zeros(n_win, np.int64)
        rc = l.poa_msa_batch(blob, _i64p(seq_off), len(seq_off) - 1,
                             _i64p(win_off), n_win, _u8p(out), cap,
                             _i64p(out_len), int(threads))
        if rc == 0:
            return out, out_len, cap
    raise RuntimeError("poa_msa_batch overflow at safe capacity")


def poa_msa_batch_native(seq_lists: list[list[str]], threads: int = 8):
    """Batch MSA across windows with the C++ engine's internal thread pool
    — one ctypes call for the whole batch (no Python thread fan-out).

    Returns [(consensus, msa_rows)] per window, identical to poa_native."""
    out, out_len, cap = msa_batch_bytes(pack_msa_batch(seq_lists), threads)
    results = []
    for w in range(len(seq_lists)):
        txt = out[w * cap: w * cap + out_len[w]].tobytes().decode()
        lines = txt.split("\n")
        results.append((lines[0], lines[1:-1]))
    return results


# build_batch_pk's fetched arrays that pk_emit_batch reads, in its order
EMIT_FIELDS = ("ch", "gm", "nn", "path", "order", "back_buf", "back_start",
               "fwd_buf", "fwd_cnt")


def _rows_in_place(path):
    """build_batch_pk's fetched paths (B, R, l_max) as pk_emit_batch reads
    them: int32 rows of l_max, the window and read axes at any
    non-negative strides.  The fetch keeps the build's read-major layout,
    so the chunk's largest array is read where it lies, not copied."""
    if (path.dtype == np.int32 and path.strides[2] == 4
            and all(st >= 0 and st % 4 == 0 for st in path.strides[:2])):
        return path
    return np.ascontiguousarray(path, np.int32)


def pk_emit_batch(state: dict, n_seqs, skip, threads: int = HOST_THREADS):
    """[(consensus, msa_rows)] of every window of a fetched fused-build
    chunk (ops/poa_fused.build_batch_pk's numpy arrays), None where `skip`
    is set, by one threaded call of the engine's pk_emit_batch: each window
    as ops/poa_fused.emit_window gives it, its first n_seqs[w] reads.
    Raises RuntimeError for a state that names an index outside its
    arrays."""
    arrs = [np.ascontiguousarray(state[k], np.int32) if k != "path"
            else _rows_in_place(state[k]) for k in EMIT_FIELDS]
    ch, gm, nn, path, order, back, _, fwd, _ = arrs
    n, ncap = ch.shape
    if any(a.shape != ch.shape for a in (gm, order, back, fwd)):
        raise ValueError("pk_emit_batch: per-node arrays of unequal shape")
    _, r_max, l_max = path.shape
    path_ws, path_rs = (st // 4 for st in path.strides[:2])
    ns = np.ascontiguousarray(n_seqs, np.int32)
    skip = np.ascontiguousarray(skip, np.uint8)
    # every column holds a node and the consensus is a path: a window's
    # consensus and each of its rows take at most nn bytes
    off = np.zeros(n + 1, np.int64)
    np.cumsum(nn.astype(np.int64) * (ns.astype(np.int64) + 1) * (skip == 0),
              out=off[1:])
    out = np.empty(int(off[-1]), np.uint8)
    cons_len = np.zeros(n, np.int64)
    ncol = np.zeros(n, np.int64)
    rc = lib().pk_emit_batch(*map(_i32p, arrs), _i32p(ns), _u8p(skip), n,
                             ncap, r_max, l_max, path_ws, path_rs,
                             _u8p(out), _i64p(off), _i64p(cons_len),
                             _i64p(ncol), int(threads))
    if rc:
        raise RuntimeError(f"pk_emit_batch: window {rc - 1} of the chunk "
                           "names a node outside its state")
    res = []
    text = memoryview(out)
    for w in range(n):
        if skip[w]:
            res.append(None)
            continue
        cl, nc, a = int(cons_len[w]), int(ncol[w]), int(off[w])
        win = str(text[a:a + cl + int(ns[w]) * nc], "ascii")
        # rows sliced at their known offsets: no scan for separators
        rows = ([win[i:i + nc] for i in range(cl, len(win), nc)] if nc
                else [""] * int(ns[w]))
        res.append((win[:cl], rows))
    return res
