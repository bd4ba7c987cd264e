"""The yardstick's arithmetic: the H100's peaks and the useful work of a
POA DP (copied from svscope_tpu_torch/tools/bounds.py, so a later change
to the program's copy cannot move the benchmark's roofline).

Rates of an H100 SXM at 700 W: HBM3 3.35 TB/s (data sheet); int32 64
lanes per SM (half the 128 fp32 lanes behind the data sheet's 67 TFLOP/s)
x 132 SMs x 1.98 GHz = 16.7e12 ops/s.  A POA DP cell costs 8 integer ops
per (node, column) (score select, base, gap chain, direction) and 3 per
(pred edge, column) (pred-row max, diag and up compares).  Bytes: each
input read once, each output written once: a node's base and sink flag,
4 per pred edge, the read, and two int32 per (node + column) of the
alignment path written back.

The work is counted from what each DP call must align, not from the
padded bucket it runs in: read r of a window is aligned against the
graph of the window's sequences before it, whose nodes and edges are read
off the window's MSA (a node is a distinct (column, base) among those
rows; an edge a distinct pair of nodes next to each other on one of those
rows).  So the count is the same whichever engine or kernel runs the DP.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
POA_OPS_PER_CELL = 8
POA_OPS_PER_EDGE_CELL = 3
_CODE = np.full(256, -1, np.int64)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def bound_s(nbytes: float, ops: float) -> float:
    """The least time an H100 could take: the larger of moving the bytes
    and doing the integer ops."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def window_dp_work(seqs: list[str], rows: list[str]) -> tuple[int, int]:
    """(ops, bytes) of one window's DP calls: every sequence after the
    first non-empty one, against the graph of the rows before it."""
    R = len(rows)
    ncol = len(rows[0]) if R else 0
    if ncol == 0:
        return 0, 0
    m = np.frombuffer("".join(rows).encode(), np.uint8).reshape(R, ncol)
    code = _CODE[m]
    r_idx, c_idx = np.nonzero(code >= 0)           # row-major order
    node = c_idx * 4 + code[r_idx, c_idx]
    # first row holding each node / each edge
    nodes_first = np.full(R, 0, np.int64)
    _u, first = np.unique(node, return_index=True)
    np.add.at(nodes_first, r_idx[first], 1)
    same_row = r_idx[1:] == r_idx[:-1]
    pair = node[:-1][same_row] * (ncol * 4) + node[1:][same_row]
    pair_row = r_idx[1:][same_row]
    edges_first = np.zeros(R, np.int64)
    if pair.size:
        _u, first = np.unique(pair, return_index=True)
        np.add.at(edges_first, pair_row[first], 1)
    nodes_before = np.concatenate([[0], np.cumsum(nodes_first)[:-1]])
    edges_before = np.concatenate([[0], np.cumsum(edges_first)[:-1]])
    lens = np.array([len(s) for s in seqs], np.int64)
    live = (nodes_before > 0) & (lens > 0)
    n, e, L = nodes_before[live], edges_before[live], lens[live]
    ops = int((n * L).sum()) * POA_OPS_PER_CELL \
        + int((e * L).sum()) * POA_OPS_PER_EDGE_CELL
    nbytes = int((2 * n + 4 * e + L + 8 * (n + L)).sum())
    return ops, nbytes


def dp_work(calls) -> tuple[int, int]:
    """(ops, bytes) over poa_msa_batch calls, each (seq_lists, results)
    with results [(consensus, msa_rows)] per window."""
    ops = nbytes = 0
    for seq_lists, results in calls:
        for seqs, (_cons, rows) in zip(seq_lists, results):
            o, b = window_dp_work(seqs, rows)
            ops += o
            nbytes += b
    return ops, nbytes
