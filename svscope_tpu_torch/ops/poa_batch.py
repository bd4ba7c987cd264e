"""Batched multi-window POA MSA (counterpart of svscope_tpu/ops/poa_batch.py).

Three execution modes, identical results:

  * host mode: the C++ engine (native/poa.py) aligns each
    window's reads directly, fanned out over its thread pool.
  * device mode: round r aligns the r-th read of EVERY window in one
    `ops.poa_align.align_batch` call per (node bucket, length bucket); the
    C++ engine routes, packs and fuses between rounds through its batch
    entries, one call a step over the round's windows or a bucket chunk's
    (threaded over `threads`), with pinned host buffers on a CUDA device.
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

import ctypes as ct
import subprocess
import threading

import numpy as np
import torch

from ..native.poa import HOST_THREADS, NativePoaGraph, flatten_reads
from ..native.poa import lib as native_lib
from ..native.poa import poa_msa_batch_native, poa_native
from ..parallel.dataparallel import data_mesh, shard_batch
from . import poa_align
from .poa_fused import fused_msa_batch
from .poa_device import MAX_PREDS
from ..utils.device import resolve_device
from ..utils.spans import TRACE, Spans

N_LADDER = (128, 256, 512, 1024, 2048)
L_LADDER = (64, 128, 256, 512, 1024, 2048)
B_LADDER = (8, 32, 128, 256)
MAX_BATCH = 256
# Device-memory budget for one kernel call's scratch planes (H int32 +
# directions int8).  A bucket whose padded batch would exceed it is split
# into sub-batches; the largest bucket (B=256, N=L=2048, ~5.4 GB) runs as
# two calls of 204 and 52 windows.
PLANE_BUDGET_BYTES = 4 << 30
# the parts of a device round that poa_msa_batch(timing=) times
ROUND_PARTS = ("pack", "h2d", "K1", "d2h", "unpack", "fuse")

# per-window Python pack and fuse calls (the oversize wavefront's windows,
# the one route that still packs and fuses a window at a time; 0 on a
# build whose windows all fit the buckets), the bucket chunks packed and
# fused by the C++ batch entries, and the bytes the chunks' copies to the
# device were handed
COUNTS = {"window_packs": 0, "window_fuses": 0, "chunks": 0, "h2d_bytes": 0}
_count_lock = threading.Lock()

_DEFAULT_OVERSIZE = None   # device tuple of the oversize wavefront


def reset_counts() -> None:
    with _count_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def _count(key: str, n: int = 1) -> None:
    with _count_lock:
        COUNTS[key] += n


def set_default_oversize_mesh(mesh) -> None:
    """Route over-bucket windows of every poa_msa_batch call through the
    sharded wavefront over the device tuple `mesh` (None: off; CLI
    --oversize-sharded)."""
    global _DEFAULT_OVERSIZE
    _DEFAULT_OVERSIZE = None if mesh is None else tuple(mesh)


def _bucket(x, ladder):
    for b in ladder:
        if x <= b:
            return b
    return None


def _require_native():
    """Load (or build) the C++ POA engine with every entry declared; its
    failure (an entry missing included) raises with the loader's own
    cause (no Python fallback)."""
    try:
        native_lib()
    except (OSError, AttributeError, RuntimeError,
            subprocess.SubprocessError) as exc:
        raise RuntimeError("native C++ POA engine (csrc/host/poa_engine.cpp) "
                           f"cannot load: {exc!r}") from exc


def poa_msa_batch(seq_lists: list[list[str]], use_device=False,
                  threads: int | None = None, device="cuda",
                  oversize_mesh=None, timing: dict | None = None):
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
    timing: a dict; in per-round device mode every round adds the seconds
    of its parts (ROUND_PARTS, see _RoundParts) to it.
    Returns [(consensus, msa_rows)] per window; the call is the
    recorder's span `poa.msa` (attribute `engine`: host, pallas or
    fused)."""
    device = resolve_device(device)
    _require_native()
    if oversize_mesh is None:
        oversize_mesh = _DEFAULT_OVERSIZE
    if not use_device or use_device == "host":
        engine = "host"
    elif use_device == "fused":
        engine = "fused"
    elif use_device in (True, "pallas", "xla"):
        engine = "pallas"
    else:
        raise ValueError(f"unknown device POA engine {use_device!r}")
    with TRACE.span("poa.msa", engine=engine):
        if engine == "pallas":
            return _DeviceBuild(seq_lists, device, threads or HOST_THREADS,
                                oversize_mesh).run(timing)
        # giant windows go to the wavefront in host and fused mode too
        big = set()
        if oversize_mesh is not None:
            big = {i for i, s in enumerate(seq_lists)
                   if s and max(map(len, s)) > L_LADDER[-1]}
        small = [s for i, s in enumerate(seq_lists) if i not in big]
        if not small:
            res = []
        elif engine == "fused":
            res = fused_msa_batch(small, device=device,
                                  threads=threads or HOST_THREADS)
        elif len(small) > 1:
            res = poa_msa_batch_native(small,
                                       threads=threads or HOST_THREADS)
        else:
            res = [poa_native(s) for s in small]
        res = iter(res)
        return [_oversize_msa(s, oversize_mesh) if i in big else next(res)
                for i, s in enumerate(seq_lists)]


def _oversize_msa(seqs: list[str], mesh):
    """One giant window's full MSA with every alignment round on the
    sharded wavefront (host C++ graph fusion between rounds)."""
    g = NativePoaGraph()
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
    _count("window_packs")
    if packed is None:
        return False
    aln, _score = align_sharded_packed(*packed, seq, mesh)
    g.fuse(aln, seq)
    _count("window_fuses")
    return True


def _split_batch(b_pad: int, nb: int, lb: int) -> int:
    """Windows per kernel call so the scratch planes fit the budget."""
    per = poa_align.plane_bytes(1, nb, lb)
    return max(1, min(b_pad, PLANE_BUDGET_BYTES // per))


# the host part of poa_msa_batch(timing=) each span of a device round adds to
_PART_OF = {"poa.round.route": "pack", "poa.round.host_dp": "pack",
            "poa.chunk.pack": "pack", "poa.chunk.wait": "d2h",
            "poa.chunk.fuse": "fuse"}


class _RoundParts:
    """Adds a device build's part times, in seconds, to poa_msa_batch's
    `timing` dict: the host parts from the recorder's spans (`_PART_OF`:
    pack is the rounds' routing and host DP and the chunks' packing, d2h
    the fetch, fuse the span `poa.chunk.fuse` less the `unpack` seconds
    poa_fuse_batch returns for its first pass); the H2D copies and K1 as
    spans on the device's clock (utils/spans.Spans), read at one
    synchronise just before the fetch, which waits for them anyway.
    Every sub-batch still launches before any is fetched.  Without a dict
    nothing is marked, and a span is the recorder's alone."""

    def __init__(self, timing: dict | None):
        self.timing = timing
        self.spans = Spans()

    def span(self, name: str):
        """The recorder's span `name`, timed into its part with a dict."""
        if self.timing is None:
            return TRACE.span(name)
        return TRACE.timed(name, self._add)

    def _add(self, span) -> None:
        unpack = span.attrs.get("unpack", 0.0)
        if "unpack" in span.attrs:
            self.timing["unpack"] = self.timing.get("unpack", 0.0) + unpack
        part = _PART_OF[span.name]
        self.timing[part] = self.timing.get(part, 0.0) + span.seconds - unpack

    def mark(self, dev):
        return None if self.timing is None else self.spans.mark(dev)

    def device(self, name: str, start, dev):
        """Close device part `name` from mark `start`; returns its end."""
        return None if self.timing is None else \
            self.spans.add(name, start, dev)

    def settle(self) -> None:
        if self.timing is not None:
            self.spans.read(self.timing)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ct.POINTER(ctype))


class _ChunkBuffers:
    """A bucket chunk's host buffers: the kernel's six inputs (`ins`),
    node_of_rank and K1's three outputs (`outs`), with the C pointers
    poa_pack_batch writes (`pack_out`) and poa_fuse_batch reads
    (`fuse_in`).  Pinned when the round runs on a CUDA device, so the
    copies are asynchronous."""

    def __init__(self, nb: int, lb: int, b_pad: int, pin: bool):
        def t(shape, dt):
            return torch.empty(shape, dtype=dt, pin_memory=pin)
        u8, i32 = torch.uint8, torch.int32
        self.ins = (t((b_pad, nb), u8), t((b_pad, nb, MAX_PREDS), i32),
                    t((b_pad, nb), torch.bool), t((b_pad,), i32),
                    t((b_pad, lb), u8), t((b_pad,), i32))
        self.outs = (t((b_pad, nb + lb), i32), t((b_pad, nb + lb), i32),
                     t((b_pad,), i32))
        self.nor = np.empty((b_pad, nb), np.int32)
        chars, preds, sinks, nn, seqs, lens = (a.numpy() for a in self.ins)
        c8, c32 = ct.c_uint8, ct.c_int32
        self.pack_out = (_ptr(chars, c8), _ptr(preds, c32), _ptr(sinks, c8),
                         _ptr(nn, c32), _ptr(self.nor, c32), _ptr(seqs, c8),
                         _ptr(lens, c32))
        self.fuse_in = tuple(_ptr(a.numpy(), c32) for a in self.outs) \
            + (_ptr(self.nor, c32),)


class _DeviceBuild:
    """One per-round device MSA build (poa_msa_batch's device mode): round
    r aligns read r of every window on the device, one C++ call a step
    over all the round's windows (poa_stat_batch) or a bucket chunk's
    (poa_pack_batch, then K1, then poa_fuse_batch, threaded over
    `threads`).  A window's first read, an empty read and a window marked
    host-only take the host DP (`add_sequence`); a window past the
    buckets, or with a node of in-degree > 8, goes to the oversize
    wavefront when a device tuple is set and it can pack, else turns
    host-only for the rest of the build.

    Chunk buffers are kept by (nb, lb, b_pad) and reused across rounds: a
    chunk waits for its fetch before it fuses, and so before the next
    chunk packs, so no buffer is rewritten while a copy from it is in
    flight."""

    def __init__(self, seq_lists, device, threads: int, oversize_mesh):
        self.lib = native_lib()
        self.seq_lists = seq_lists
        self.graphs = [NativePoaGraph() for _ in seq_lists]
        self.handles = np.array([g._h for g in self.graphs], np.uintp)
        self.reads, self.seq_off, self.win_off = flatten_reads(seq_lists)
        self.seq_off_p = _ptr(self.seq_off, ct.c_int64)
        self.device, self.threads = device, threads
        self.oversize_mesh = oversize_mesh
        mesh = data_mesh() or ()
        self.pin = any(d.type == "cuda" for d in (device, *mesh))
        self.bufs: dict[tuple[int, int, int], _ChunkBuffers] = {}

    def run(self, timing=None):
        """Every round; returns [(consensus, msa_rows)] per window.  Spans:
        per round `poa.round.route` and `poa.round.host_dp`, per chunk
        those of `chunk`, then `poa.extract`."""
        parts = _RoundParts(timing)
        read_len = np.diff(self.seq_off)
        n_reads = np.diff(self.win_off)
        host_only = np.zeros(len(self.graphs), bool)
        n_lb = len(L_LADDER)
        for r in range(int(n_reads.max(initial=0))):
            with parts.span("poa.round.route"):
                win = np.flatnonzero(n_reads > r)
                idx = self.win_off[win] + r
                hw = self.handles[win]
                nn = np.empty(len(win), np.int32)
                indeg = np.empty(len(win), np.int32)
                self.lib.poa_stat_batch(_ptr(hw, ct.c_void_p), len(win),
                                        _ptr(nn, ct.c_int32),
                                        _ptr(indeg, ct.c_int32))
                ln = read_len[idx]
                host = (ln == 0) | (nn == 0) | host_only[win]
                nb = np.searchsorted(N_LADDER, nn)  # len(N_LADDER): past it
                lb = np.searchsorted(L_LADDER, ln)
                fits = ~host & (nb < len(N_LADDER)) & (lb < n_lb) \
                    & (indeg <= MAX_PREDS)
                dev_k = np.flatnonzero(fits)
                key = nb[dev_k] * n_lb + lb[dev_k]
                keys, first = np.unique(key, return_index=True)
            with parts.span("poa.round.host_dp"):
                for k in np.flatnonzero(host):
                    self.graphs[win[k]].add_sequence(
                        self.seq_lists[win[k]][r])
                for k in np.flatnonzero(~host & ~fits):
                    w = win[k]
                    seq = self.seq_lists[w][r]
                    if self.oversize_mesh is None or indeg[k] > MAX_PREDS \
                            or not _oversize_sharded(self.graphs[w], seq,
                                                     self.oversize_mesh):
                        host_only[w] = True
                        self.graphs[w].add_sequence(seq)
            for kk in keys[np.argsort(first)]:     # buckets in window order
                sel = dev_k[key == kk]
                for off in range(0, len(sel), MAX_BATCH):
                    c = sel[off:off + MAX_BATCH]
                    self.chunk(hw[c], idx[c], N_LADDER[kk // n_lb],
                               L_LADDER[kk % n_lb], parts)
        with TRACE.span("poa.extract"):
            return [(g.consensus(), g.msa()) for g in self.graphs]

    def chunk(self, handles, idx, nb: int, lb: int, parts) -> None:
        """One bucket chunk of a round: its graphs and reads packed in C++
        into the chunk's buffers (span `poa.chunk.pack`), copied up and K1
        enqueued (`poa.chunk.launch`; the bytes copied counted in
        COUNTS["h2d_bytes"]), its outputs fetched into the pinned buffers
        at one synchronise (`poa.chunk.wait`), then unpacked and fused in
        C++ (`poa.chunk.fuse`, with the unpack's seconds as `unpack`)."""
        with parts.span("poa.chunk.pack"):
            n = len(handles)
            b_pad = _bucket(n, B_LADDER) or n
            key = (nb, lb, b_pad)
            if key not in self.bufs:
                self.bufs[key] = _ChunkBuffers(nb, lb, b_pad, self.pin)
            b = self.bufs[key]
            hp = _ptr(handles, ct.c_void_p)
            idx = np.ascontiguousarray(idx, np.int64)
            idx_p = _ptr(idx, ct.c_int64)
            rc = self.lib.poa_pack_batch(hp, n, b_pad, nb, MAX_PREDS, lb,
                                         self.reads, self.seq_off_p, idx_p,
                                         *b.pack_out, self.threads)
            if rc:
                raise RuntimeError(f"poa_pack_batch: window {rc - 1} of a "
                                   f"chunk does not fit its bucket ({nb}, "
                                   f"{lb})")
        # the batch axis splits over the installed data mesh (windows
        # independent); the plane budget then applies per device, and
        # every sub-batch is launched before any is fetched
        with TRACE.span("poa.chunk.launch"):
            res = []
            for dev, arrs in shard_batch(b.ins, device=self.device):
                b_dev = arrs[0].shape[0]
                step = _split_batch(b_dev, nb, lb)
                for s0 in range(0, b_dev, step):
                    m = parts.mark(dev)
                    src = [a[s0:s0 + step] for a in arrs]
                    _count("h2d_bytes", sum(a.nbytes for a in src))
                    args = [a.to(dev, non_blocking=True) for a in src]
                    m = parts.device("h2d", m, dev)
                    res.append(poa_align.align_batch(*args, lb)[:3])
                    parts.device("K1", m, dev)
        parts.settle()
        with parts.span("poa.chunk.wait"):
            off, done = 0, []
            for got in res:
                k = got[0].shape[0]
                for dst, src in zip(b.outs, got):
                    dst[off:off + k].copy_(src, non_blocking=True)
                off += k
                if got[0].is_cuda:
                    done.append(torch.cuda.Event())
                    done[-1].record(torch.cuda.current_stream(got[0].device))
            for ev in done:
                ev.synchronize()
        with parts.span("poa.chunk.fuse") as span:
            an, asp, ke, nor = b.fuse_in
            secs = np.zeros(2, np.float64)
            rc = self.lib.poa_fuse_batch(hp, n, an, asp, nb + lb, ke, nor,
                                         nb, self.reads, self.seq_off_p,
                                         idx_p, self.threads,
                                         _ptr(secs, ct.c_double))
            if rc:
                raise RuntimeError(f"poa_fuse_batch: window {rc - 1} of a "
                                   "chunk names a rank past its bucket")
            span.set(unpack=float(secs[0]))
        _count("chunks")
