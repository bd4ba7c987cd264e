"""Sequence-sharded POA wavefront: one oversized window's graph-vs-read DP
pipelined across a tuple of devices (counterpart of
svscope_tpu/ops/poa_sharded.py).

The batched aligners (K1, the fused build) make windows the parallel axis
and keep each DP on one device; windows past their buckets (giant tandem
repeats: more than 2048 graph nodes or 2048 bp reads) align here instead
of on the host.  JAX runs this as plain XLA under shard_map; here it is
torch ops, one process driving every device of the tuple (devices may
repeat).

Design (column sharding + systolic pipeline), as in the JAX package:

  * The (N+1) x (L+1) DP matrix is sharded on the COLUMN (read-position)
    axis: device d owns a contiguous block of C = ceil((L_bucket+1)/D)
    columns and keeps its H block, a direction block and a copy of its
    left neighbour's last column (`leftcol`).
  * Rows run as a wavefront: at global step t, device d computes row
    i = t - d + 1 of its block, N + D - 1 steps in all.  The host issues
    the steps in order, every device's row of a step before the next step,
    and each launch is asynchronous, so distinct GPUs work on D
    consecutive rows at once.
  * The only cross-device traffic is one int32 a device and step, copied
    to the right neighbour: the just-finished row's value at the block's
    last column.  The receiver stores it in `leftcol` before it computes
    that row, then uses it as the incoming gap-chain carry; later rows
    read their predecessors' j-1 values across the boundary through it.
  * Recurrence, scoring (m=5, n=-4, g=-8) and the traceback tie-break
    order (diagonal predecessor slots in insertion order, then graph-gap
    slots, then the sequence gap) are those of ops/poa_device and the
    host engine.  The in-row gap chain, an associative_scan(max) in JAX,
    is `torch.cummax`.  A row's predecessor list, its active steps and
    which blocks hold valid columns are known on the host, so inactive
    steps and blocks past the read launch nothing.
  * Past FULL_DIRS_CELL_LIMIT cells no direction plane is stored: H stays
    on the devices and the traceback walks it in (KR x KC) direction
    blocks recomputed on demand (O(N/KR + L/KC) blocks).

Tests: tests/test_torch_poa_sharded.py holds this against PoaGraph.align,
the C++ engine and the JAX package's align_sharded on CPU device tuples.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..parallel.dataparallel import cross_sum
from ..utils.device import resolve_device
from .poa import PoaGraph
from .poa_device import pack_graph

MATCH = 5
MISMATCH = -4
GAP = -8
NEG = -(2 ** 29)
SUB_NEG = -(2 ** 30)       # substitution score of a column with no diagonal
MAX_PREDS = 8
DIR_LEFT = 16

FULL_DIRS_CELL_LIMIT = 1 << 25   # past ~32M cells, skip the dirs plane
TB_BLOCK_R = 512                 # traceback direction-block rows (ranks)
TB_BLOCK_C = 512                 # traceback direction-block columns

# device rows computed and direction blocks recomputed, for tests and the
# card's smoke run
COUNTS = {"rows": 0, "dir_blocks": 0}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def _count(key: str, n: int = 1) -> None:
    with _count_lock:
        COUNTS[key] += n


def _pred_slots(preds: np.ndarray, n_nodes: int) -> np.ndarray:
    """Valid pred slots a rank (slot 0 always: a rank with no preds reads
    the virtual row 0).  Packed graphs fill slots from 0 up."""
    p = preds[:n_nodes]
    if ((p[:, 1:] >= 0) & (p[:, :-1] < 0)).any():
        raise ValueError("pred slots must be filled from slot 0 up")
    return np.maximum((p >= 0).sum(axis=1), 1)


class _Shard:
    """Device d's column block: H (n_max+1, C), directions (n_max, C) int8
    when stored, leftcol (n_max+1,), and the row-invariant operands."""

    def __init__(self, d, dev, block, seq_sh, seq_len, chars, char_idx,
                 rows, n_max, store_dirs):
        self.d, self.dev = d, dev
        jg = d * block + torch.arange(block, dtype=torch.int32, device=dev)
        n_valid = max(0, min(block, seq_len + 1 - d * block))
        self.n_valid = n_valid               # columns with j <= seq_len
        self.col_valid = jg <= seq_len
        self.H = torch.full((n_max + 1, block), NEG, dtype=torch.int32,
                            device=dev)
        self.H[0] = torch.where(self.col_valid, GAP * jg, NEG)
        self.leftcol = torch.full((n_max + 1,), NEG, dtype=torch.int32,
                                  device=dev)
        if d > 0 and d * block - 1 <= seq_len:
            self.leftcol[0] = GAP * (d * block - 1)
        self.dirs = (torch.full((n_max, block), DIR_LEFT, dtype=torch.int8,
                                device=dev) if store_dirs else None)
        j_local = torch.arange(block, dtype=torch.int32, device=dev)
        self.decay = GAP * j_local
        self.carry_gap = GAP * (j_local + 1)
        seq = torch.from_numpy(seq_sh[d * block:(d + 1) * block]).to(dev)
        diag_ok = self.col_valid & (jg >= 1)
        ch = torch.from_numpy(chars).to(dev)
        # substitution row of each distinct graph char, SUB_NEG where the
        # column has no diagonal (j == 0 or past the read)
        self.subm = torch.where(
            diag_ok[None, :],
            torch.where(seq[None, :] == ch[:, None], MATCH, MISMATCH),
            SUB_NEG).to(torch.int32)
        self.char_idx = char_idx
        self.rows = torch.from_numpy(rows).to(dev)     # (n_max, P) int64
        # direction code of the first matching candidate: diag slots
        # 0..k-1, then up slots 8..8+k-1; an index past them is DIR_LEFT
        self.first_w = {}
        self.codes = {}

    def code_tables(self, k: int):
        if k not in self.codes:
            self.first_w[k] = torch.arange(2 * k, 0, -1, dtype=torch.int64,
                                           device=self.dev)[:, None]
            self.codes[k] = torch.tensor(
                [DIR_LEFT] + [8 + p for p in range(k - 1, -1, -1)]
                + list(range(k - 1, -1, -1)), dtype=torch.int8,
                device=self.dev)
        return self.first_w[k], self.codes[k]

    def row(self, i: int, k: int, recv) -> None:
        """Compute and store row i (rank i-1, k valid pred slots); `recv`
        is the left neighbour's value of this row at its last column."""
        H = self.H
        rows = self.rows[i - 1, :k]
        Pb = H.index_select(0, rows)                          # (k, C)
        if self.d > 0:
            self.leftcol[i:i + 1].copy_(recv)
            lv = self.leftcol.index_select(0, rows)
            Pm1 = torch.cat([lv[:, None], Pb[:, :-1]], dim=1)
        else:
            Pm1 = torch.nn.functional.pad(Pb[:, :-1], (1, 0), value=NEG)
        maxpred = Pb.amax(dim=0) if k > 1 else Pb[0]
        maxpredm1 = Pm1.amax(dim=0) if k > 1 else Pm1[0]
        sub = self.subm[self.char_idx[i - 1]]
        base = torch.maximum(maxpredm1 + sub, maxpred + GAP)
        hrow = torch.cummax(base - self.decay, dim=0).values + self.decay
        if self.d > 0:
            hrow = torch.maximum(hrow, self.leftcol[i] + self.carry_gap)
        if self.n_valid < hrow.shape[0]:
            hrow = torch.where(self.col_valid, hrow, NEG)
        H[i] = hrow
        if self.dirs is not None:
            # directions against the finished row (first matching slot)
            cand = torch.cat([Pm1 + sub, Pb + GAP])           # (2k, C)
            w, codes = self.code_tables(k)
            first = ((cand == hrow) * w).amax(dim=0)
            self.dirs[i - 1] = codes[first]


def _wavefront(chars, preds, sinks, n_nodes: int, seq_sh, seq_len: int,
               devices, block: int, store_dirs: bool):
    """Run the column-sharded wavefront.  Returns (shards, score, best
    rank)."""
    n_max = chars.shape[0]
    uniq, char_idx = np.unique(chars, return_inverse=True)
    nslots = _pred_slots(preds, n_nodes)
    rows = np.where(preds >= 0, preds + 1, 0).astype(np.int64)
    shards = [_Shard(d, dev, block, seq_sh, seq_len, uniq, char_idx, rows,
                     n_max, store_dirs)
              for d, dev in enumerate(devices)]
    active = [s for s in shards if s.n_valid > 0]
    D = len(active)
    rows_done = 0
    for t in range(n_nodes + D - 1):
        for s in active:
            i = t - s.d + 1
            if 1 <= i <= n_nodes:
                recv = (active[s.d - 1].H[i, block - 1:] if s.d > 0
                        else None)
                s.row(i, int(nslots[i - 1]), recv)
                rows_done += 1
    _count("rows", rows_done)
    # best sink at global column seq_len: the owner device's first max in
    # rank order; the others contribute (NEG, 0) to the pmax / psum
    owner = seq_len // block
    rank_ok = np.asarray(sinks, bool) & (np.arange(n_max) < n_nodes)
    scores, bests = [], []
    for s in shards:
        if s.d == owner:
            ends = s.H[1:, seq_len - owner * block]
            ends = torch.where(torch.from_numpy(rank_ok).to(s.dev), ends,
                               NEG)
            best = torch.argmax(ends)
            scores.append(ends[best].reshape(1))
            bests.append(best.to(torch.int32).reshape(1))
        else:
            scores.append(torch.full((1,), NEG, dtype=torch.int32,
                                     device=s.dev))
            bests.append(torch.zeros(1, dtype=torch.int32, device=s.dev))
    score = cross_sum(scores, op=torch.maximum)[0]
    best = cross_sum(bests)[0]
    return shards, int(score.item()), int(best.item())


def _host_traceback(dirs, preds, best_rank, seq_len):
    """Walk the int8 direction plane (ops/poa_device's traceback order)."""
    out = []
    i = int(best_rank) + 1
    j = int(seq_len)
    while j > 0:
        if i == 0:
            out.append((-1, j - 1))
            j -= 1
            continue
        code = int(dirs[i - 1, j])
        if code == DIR_LEFT:
            out.append((-1, j - 1))
            j -= 1
        elif code >= 8:                      # graph gap via pred slot
            out.append((i - 1, -1))
            i = int(preds[i - 1, code - 8]) + 1
        else:                                # diagonal via pred slot
            out.append((i - 1, j - 1))
            i = int(preds[i - 1, code]) + 1
            j -= 1
    out.reverse()
    return out


def _h_columns(shards, block: int, c_lo: int, c_hi: int) -> torch.Tensor:
    """Global H columns [c_lo, c_hi) on the first shard's device."""
    dev0 = shards[0].dev
    parts = []
    for s in shards:
        lo = max(c_lo, s.d * block)
        hi = min(c_hi, (s.d + 1) * block)
        if lo < hi:
            parts.append(s.H[:, lo - s.d * block:hi - s.d * block].to(dev0))
    return torch.cat(parts, dim=1)


def _dir_block(Hc, preds, chars, seqc, seq_len, r0, c0, kr: int, kc: int):
    """(kr, kc) int8 direction codes for ranks [r0, r0+kr) x global columns
    [c0, c0+kc), recomputed from H's columns [c0-1, c0+kc) (`Hc`) with the
    forward pass's tie-break order.  c0 >= 1."""
    n1 = Hc.shape[0]                                  # n_max + 1
    dev = Hc.device
    ranks = torch.clamp(r0 + torch.arange(kr, device=dev), 0, n1 - 2)
    pr = preds[ranks]                                 # (kr, P)
    slot = torch.arange(pr.shape[1], device=dev)
    has = pr >= 0
    valid = has | (slot == 0)
    rows = torch.where(has, pr + 1, 0).long()
    Pc = torch.where(valid[..., None], Hc[rows], NEG)       # (kr, P, kc+1)
    h = Hc[ranks + 1, 1:]                                   # (kr, kc)
    sub = torch.where(seqc[None, :] == chars[ranks][:, None], MATCH,
                      MISMATCH).to(torch.int32)
    col_ok = (c0 + torch.arange(kc, device=dev)) <= seq_len
    dok = valid[..., None] & (h[:, None] == Pc[..., :-1] + sub[:, None]) \
        & col_ok
    uok = valid[..., None] & (h[:, None] == Pc[..., 1:] + GAP)
    d_idx = torch.argmax(dok.to(torch.uint8), dim=1)        # first True
    u_idx = torch.argmax(uok.to(torch.uint8), dim=1)
    codes = torch.where(dok.any(dim=1), d_idx,
                        torch.where(uok.any(dim=1), 8 + u_idx, DIR_LEFT))
    _count("dir_blocks")
    return codes.to(torch.int8).cpu().numpy()


def _banded_traceback(shards, block, preds_np, chars_np, seq_sh, best_rank,
                      seq_len, kr: int = TB_BLOCK_R, kc: int = TB_BLOCK_C):
    """_host_traceback without a direction plane: walk the path, fetching
    (kr, kc) direction blocks recomputed from the devices' H as the walk
    crosses block boundaries.  i and j are both non-increasing, so each
    block is visited at most once."""
    dev0 = shards[0].dev
    preds_dev = torch.from_numpy(np.asarray(preds_np, np.int64)).to(dev0)
    chars_dev = torch.from_numpy(np.asarray(chars_np)).to(dev0)
    seq_dev = torch.from_numpy(seq_sh).to(dev0)
    lpad = block * len(shards)
    blk, br0, bc0 = None, -1, -1
    out = []
    i, j = int(best_rank) + 1, int(seq_len)
    while j > 0:
        if i == 0:
            out.append((-1, j - 1))
            j -= 1
            continue
        r = i - 1
        r0 = (r // kr) * kr
        # clamp so the column slice [c0-1, c0+kc) stays in bounds
        c0 = min(((j - 1) // kc) * kc + 1, lpad - kc)
        if r0 != br0 or c0 != bc0:
            Hc = _h_columns(shards, block, c0 - 1, c0 + kc)
            blk = _dir_block(Hc, preds_dev, chars_dev, seq_dev[c0:c0 + kc],
                             seq_len, r0, c0, kr, kc)
            br0, bc0 = r0, c0
        code = int(blk[r - r0, j - c0])
        if code == DIR_LEFT:
            out.append((-1, j - 1))
            j -= 1
        elif code >= 8:                      # graph gap via pred slot
            out.append((i - 1, -1))
            i = int(preds_np[i - 1, code - 8]) + 1
        else:                                # diagonal via pred slot
            out.append((i - 1, j - 1))
            i = int(preds_np[i - 1, code]) + 1
            j -= 1
    out.reverse()
    return out


def align_sharded_packed(chars, preds, is_sink, n_nodes, node_of_rank,
                         seq: str, devices, traceback: str = "auto",
                         tb_block: tuple | None = None):
    """Sharded wavefront over pre-packed rank-space graph arrays (the
    format of ops.poa_device.pack_graph or NativePoaGraph.pack), column-
    sharded over the device tuple `devices`.  Returns
    ([(node_id, seq_pos)], score).

    traceback: 'full' fetches the whole (N, L) int8 direction plane;
    'banded' keeps H on the devices and fetches recomputed direction
    blocks along the path; 'auto' picks banded past FULL_DIRS_CELL_LIMIT
    cells."""
    devices = [resolve_device(d) for d in devices]
    n_dev = len(devices)
    n_max = chars.shape[0]
    L = len(seq)
    l_bucket = max(256, 1 << max(L - 1, 1).bit_length())
    block = -(-(l_bucket + 1) // n_dev)      # ceil((L_bucket+1)/D)
    seq_sh = np.full(block * n_dev, 255, np.uint8)
    seq_sh[1:L + 1] = np.frombuffer(seq.encode(), np.uint8)
    cells = n_max * block * n_dev
    banded = (traceback == "banded"
              or (traceback == "auto" and cells > FULL_DIRS_CELL_LIMIT))
    chars = np.asarray(chars, np.uint8)
    preds_np = np.asarray(preds, np.int32)
    shards, score, best = _wavefront(chars, preds_np, is_sink, int(n_nodes),
                                     seq_sh, L, devices, block,
                                     store_dirs=not banded)
    if banded:
        kr, kc = tb_block or (TB_BLOCK_R, TB_BLOCK_C)
        kr = min(kr, n_max)
        kc = min(kc, block * n_dev - 1)
        pairs = _banded_traceback(shards, block, preds_np, chars, seq_sh,
                                  best, L, kr=kr, kc=kc)
    else:
        dirs = np.concatenate([s.dirs.cpu().numpy() for s in shards], axis=1)
        pairs = _host_traceback(dirs, preds_np, best, L)
    aln = [(int(node_of_rank[r]) if r >= 0 else -1, s) for r, s in pairs]
    return aln, score


def align_sharded(graph: PoaGraph, seq: str, devices,
                  p_max: int = MAX_PREDS, traceback: str = "auto",
                  tb_block: tuple | None = None):
    """PoaGraph.align equivalent for one oversized (graph, read) pair,
    column-sharded over the device tuple.  Returns ([(node_id, seq_pos)],
    score) with -1 for gaps, identical to the host aligner (tested)."""
    n = len(graph.topo_order())
    n_max = max(256, 1 << (n - 1).bit_length())   # bucket: few shapes
    chars, preds, is_sink, n_nodes, node_of_rank = pack_graph(
        graph, n_max, p_max)
    return align_sharded_packed(chars, preds, is_sink, n_nodes,
                                node_of_rank, seq, devices,
                                traceback=traceback, tb_block=tb_block)

