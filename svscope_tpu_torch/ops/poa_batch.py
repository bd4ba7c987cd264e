"""Batched multi-window POA MSA (counterpart of svscope_tpu/ops/poa_batch.py).

Three execution modes, identical results:

  * host mode: the C++ engine (native/poa.py) aligns each
    window's reads directly, fanned out over its thread pool.
  * device mode: round r aligns the r-th read of EVERY window in one
    `ops.poa_align.align_batch` call per (node bucket, length bucket); the
    C++ engine packs the graphs and fuses the alignments between rounds.
    On a CUDA device that call is the hand-written kernel; on the CPU it
    is the kernel's plain torch version.
  * fused mode: the whole MSA build stays on the device
    (ops/poa_fused.fused_msa_batch, kernels K3 and K4/K5).

Windows past the largest bucket, or with a node of in-degree > 8, align
that round on the host (`add_sequence`), as in the JAX package.  With an
oversize device tuple set (`set_default_oversize_mesh`, the CLI's
--oversize-sharded, or `oversize_mesh=`), every mode sends them through
the column-sharded wavefront (ops/poa_sharded) instead: host and fused
mode the windows whose reads pass L_LADDER[-1], per-round mode each round
past the buckets.  With a data mesh installed (parallel/dataparallel),
each per-round batch is split over its devices.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..native.poa import (NativePoaGraph, native_available,
                          poa_msa_batch_native, poa_native)
from ..parallel.dataparallel import shard_batch
from . import poa_align
from .poa_fused import fused_msa_batch
from .poa_device import MAX_PREDS, to_torch_packed, unpack_alignment_arrays
from ..utils.device import resolve_device

N_LADDER = (128, 256, 512, 1024, 2048)
L_LADDER = (64, 128, 256, 512, 1024, 2048)
B_LADDER = (8, 32, 128, 256)
MAX_BATCH = 256
HOST_THREADS = min(8, os.cpu_count() or 1)
# Device-memory budget for one kernel call's scratch planes (H int32 +
# directions int8).  A bucket whose padded batch would exceed it is split
# into sub-batches; the largest bucket (B=256, N=L=2048, ~5.4 GB) runs as
# two calls of 204 and 52 windows.
PLANE_BUDGET_BYTES = 4 << 30

_DEFAULT_OVERSIZE = None   # device tuple of the oversize wavefront


def set_default_oversize_mesh(mesh) -> None:
    """Route over-bucket windows of every poa_msa_batch call through the
    sharded wavefront over the device tuple `mesh` (None: off; CLI
    --oversize-sharded)."""
    global _DEFAULT_OVERSIZE
    _DEFAULT_OVERSIZE = None if mesh is None else tuple(mesh)


class _Graph(NativePoaGraph):
    """C++ POA graph that also fuses an alignment given as int32 arrays.
    NativePoaGraph.fuse takes [(node, seq_pos)] pairs and rebuilds the
    arrays in Python for every read; the device rounds hand the arrays
    straight to the same C entry point."""

    def fuse_arrays(self, nodes: np.ndarray, spos: np.ndarray,
                    seq: str) -> None:
        i32p = ctypes.POINTER(ctypes.c_int32)
        nodes = np.ascontiguousarray(nodes, np.int32)
        spos = np.ascontiguousarray(spos, np.int32)
        self._lib.poa_fuse(self._h, nodes.ctypes.data_as(i32p),
                           spos.ctypes.data_as(i32p), len(nodes),
                           seq.encode())


def _bucket(x, ladder):
    for b in ladder:
        if x <= b:
            return b
    return None


def _require_native():
    if not native_available():
        from ..native.poa import lib
        try:
            lib()
        except Exception as exc:           # report the loader's own cause
            raise RuntimeError("native C++ POA engine (csrc/host/poa_engine.cpp) "
                               f"cannot load: {exc!r}") from exc
        raise RuntimeError("native C++ POA engine (csrc/host/poa_engine.cpp) "
                           "cannot load")


def poa_msa_batch(seq_lists: list[list[str]], use_device=False,
                  threads: int | None = None, device="cuda",
                  oversize_mesh=None):
    """spoa-equivalent poa(seqs, 1) over many windows.

    use_device: False/"host" = host C++ engine; True/"pallas"/"xla" =
    per-round device alignment through ops.poa_align.align_batch on
    `device` (the CUDA kernel on a CUDA device, its plain torch version on
    the CPU); "fused" = the whole build on `device`
    (ops/poa_fused.fused_msa_batch).  `device` defaults to cuda (raises
    when CUDA is absent).
    oversize_mesh: a device tuple; windows past the largest (nodes,
    length) bucket align through the column-sharded wavefront over it
    (default: the one `set_default_oversize_mesh` set, else none).
    Returns [(consensus, msa_rows)] per window."""
    device = resolve_device(device)
    _require_native()
    if oversize_mesh is None:
        oversize_mesh = _DEFAULT_OVERSIZE
    if not use_device or use_device == "host" or use_device == "fused":
        # giant windows go to the wavefront in host and fused mode too
        big = set()
        if oversize_mesh is not None:
            big = {i for i, s in enumerate(seq_lists)
                   if s and max(map(len, s)) > L_LADDER[-1]}
        small = [s for i, s in enumerate(seq_lists) if i not in big]
        if use_device == "fused":
            res = fused_msa_batch(small, device=device) if small else []
        elif len(small) > 1:
            res = poa_msa_batch_native(small,
                                       threads=threads or HOST_THREADS)
        else:
            res = [poa_native(s) for s in small]
        res = iter(res)
        return [_oversize_msa(s, oversize_mesh) if i in big else next(res)
                for i, s in enumerate(seq_lists)]
    if use_device not in (True, "pallas", "xla"):
        raise ValueError(f"unknown device POA engine {use_device!r}")
    graphs = [_Graph() for _ in seq_lists]
    host_only = [False] * len(seq_lists)
    max_rounds = max((len(s) for s in seq_lists), default=0)
    for r in range(max_rounds):
        items = []
        for w, seqs in enumerate(seq_lists):
            if r >= len(seqs):
                continue
            seq = seqs[r]
            g = graphs[w]
            if len(seq) == 0 or g.n_nodes() == 0 or host_only[w]:
                g.add_sequence(seq)
                continue
            items.append((w, seq))
        if items:
            _device_round(graphs, items, host_only, device, oversize_mesh)
    return [(g.consensus(), g.msa()) for g in graphs]


def _oversize_msa(seqs: list[str], mesh):
    """One giant window's full MSA with every alignment round on the
    sharded wavefront (host C++ graph fusion between rounds)."""
    g = _Graph()
    for seq in seqs:
        if len(seq) == 0 or g.n_nodes() == 0:
            g.add_sequence(seq)
        elif not _oversize_sharded(g, seq, mesh):
            g.add_sequence(seq)          # in-degree > 8: host DP round
    return g.consensus(), g.msa()


def _oversize_sharded(g, seq: str, mesh) -> bool:
    """Align one over-bucket (graph, read) via the sharded wavefront and
    fuse; returns False if the graph can't be packed (in-degree > 8)."""
    from .poa_sharded import align_sharded_packed
    n = g.n_nodes()
    n_max = max(N_LADDER[-1], 1 << (max(n, 2) - 1).bit_length())
    packed = g.pack(n_max, MAX_PREDS)
    if packed is None:
        return False
    aln, _score = align_sharded_packed(*packed, seq, mesh)
    g.fuse(aln, seq)
    return True


def _split_batch(b_pad: int, nb: int, lb: int) -> int:
    """Windows per kernel call so the scratch planes fit the budget."""
    per = poa_align.plane_bytes(1, nb, lb)
    return max(1, min(b_pad, PLANE_BUDGET_BYTES // per))


def _device_round(graphs, items, host_only, device, oversize_mesh=None):
    """One round: bucket (window, seq) pairs, device-align, C++ fuse."""
    buckets: dict[tuple[int, int], list] = {}
    for w, seq in items:
        g = graphs[w]
        nb = _bucket(g.n_nodes(), N_LADDER)
        lb = _bucket(len(seq), L_LADDER)
        packed = None
        if nb is not None and lb is not None:
            packed = g.pack(nb, MAX_PREDS)
        if packed is None:
            if oversize_mesh is not None and _oversize_sharded(
                    g, seq, oversize_mesh):
                continue
            host_only[w] = True
            g.add_sequence(seq)
            continue
        buckets.setdefault((nb, lb), []).append((w, seq, packed))
    for (nb, lb), group in buckets.items():
        for off in range(0, len(group), MAX_BATCH):
            chunk = group[off:off + MAX_BATCH]
            b_pad = _bucket(len(chunk), B_LADDER) or len(chunk)
            chars = np.zeros((b_pad, nb), np.uint8)
            preds = np.full((b_pad, nb, MAX_PREDS), -1, np.int32)
            sinks = np.zeros((b_pad, nb), bool)
            nn = np.zeros(b_pad, np.int32)
            seqs = np.zeros((b_pad, lb), np.uint8)
            lens = np.zeros(b_pad, np.int32)
            for bi, (w, seq, (c, p, s, n, nor)) in enumerate(chunk):
                chars[bi], preds[bi], sinks[bi], nn[bi] = c, p, s, n
                seqs[bi, :len(seq)] = np.frombuffer(seq.encode(), np.uint8)
                lens[bi] = len(seq)
            if len(chunk) < b_pad:       # batch padding: replicate row 0
                chars[len(chunk):] = chars[0]
                preds[len(chunk):] = preds[0]
                sinks[len(chunk):] = sinks[0]
                nn[len(chunk):] = nn[0]
                seqs[len(chunk):] = seqs[0]
                lens[len(chunk):] = lens[0]
            # the batch axis splits over the installed data mesh (windows
            # independent); the plane budget then applies per device, and
            # every sub-batch is launched before any is fetched
            outs = []
            for dev, arrs in shard_batch((chars, preds, sinks, nn, seqs,
                                          lens), device=device):
                b_dev = arrs[0].shape[0]
                step = _split_batch(b_dev, nb, lb)
                for s0 in range(0, b_dev, step):
                    args = to_torch_packed(*(a[s0:s0 + step] for a in arrs),
                                           dev)
                    outs.append(poa_align.align_batch(*args, lb)[:3])
            an, asp, ke = (np.concatenate([o[k].cpu().numpy() for o in outs])
                           for k in range(3))
            for bi, (w, seq, (c, p, s, n, nor)) in enumerate(chunk):
                nodes, spos = unpack_alignment_arrays(an[bi], asp[bi],
                                                      ke[bi], nor)
                graphs[w].fuse_arrays(nodes, spos, seq)
