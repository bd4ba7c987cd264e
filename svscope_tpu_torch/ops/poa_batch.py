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
that round on the host (`add_sequence`), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..native.poa import (NativePoaGraph, native_available,
                          poa_msa_batch_native, poa_native)
from . import poa_align
from .poa_fused import fused_msa_batch
from .poa_device import MAX_PREDS, to_torch_packed, unpack_alignment_arrays

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
                  threads: int | None = None, device="cpu"):
    """spoa-equivalent poa(seqs, 1) over many windows.

    use_device: False/"host" = host C++ engine; True/"pallas"/"xla" =
    per-round device alignment through ops.poa_align.align_batch on
    `device` (the CUDA kernel on a CUDA device, its plain torch version on
    the CPU); "fused" = the whole build on `device`
    (ops/poa_fused.fused_msa_batch).
    Returns [(consensus, msa_rows)] per window."""
    _require_native()
    if not use_device or use_device == "host":
        if len(seq_lists) > 1:
            return poa_msa_batch_native(seq_lists,
                                        threads=threads or HOST_THREADS)
        return [poa_native(s) for s in seq_lists]
    if use_device == "fused":
        return fused_msa_batch(seq_lists, device=device)
    if use_device not in (True, "pallas", "xla"):
        raise ValueError(f"unknown device POA engine {use_device!r}")
    device = torch.device(device)
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
            _device_round(graphs, items, host_only, device)
    return [(g.consensus(), g.msa()) for g in graphs]


def _split_batch(b_pad: int, nb: int, lb: int) -> int:
    """Windows per kernel call so the scratch planes fit the budget."""
    per = poa_align.plane_bytes(1, nb, lb)
    return max(1, min(b_pad, PLANE_BUDGET_BYTES // per))


def _device_round(graphs, items, host_only, device):
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
            step = _split_batch(b_pad, nb, lb)
            outs = []
            for s0 in range(0, b_pad, step):
                sl = slice(s0, min(s0 + step, b_pad))
                args = to_torch_packed(chars[sl], preds[sl], sinks[sl],
                                       nn[sl], seqs[sl], lens[sl], device)
                an, asp, ke, _sc = poa_align.align_batch(*args, lb)
                outs.append((an.cpu().numpy(), asp.cpu().numpy(),
                             ke.cpu().numpy()))
            an = np.concatenate([o[0] for o in outs])
            asp = np.concatenate([o[1] for o in outs])
            ke = np.concatenate([o[2] for o in outs])
            for bi, (w, seq, (c, p, s, n, nor)) in enumerate(chunk):
                nodes, spos = unpack_alignment_arrays(an[bi], asp[bi],
                                                      ke[bi], nor)
                graphs[w].fuse_arrays(nodes, spos, seq)
