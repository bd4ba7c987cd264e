"""Partial-order alignment (POA) graph engine — NumPy reference.

A frozen copy of svscope_tpu_torch/ops/poa.py as it stood when the
benchmark was defined: the program may change its own copy, the
benchmark's yardstick stays.  It imports only NumPy.

Re-implements the role of spoa/pyspoa `poa(sequences, 1)` in the reference
(src/DataScanner.py:207,213; src/DecisionMaker.py:160,171): build a partial
order graph by iteratively NW-aligning each sequence to the graph, then emit
the row-major MSA (first sequence = backbone, i.e. the reference slice) and a
heaviest-bundle consensus.

Algorithm = spoa's (Vaser et al. 2017) with linear gaps:
  * scores: match m=5, mismatch n=-4, gap g=-8 (pyspoa 0.2.1 defaults)
  * alignment type 1 = Needleman-Wunsch (global): the full sequence is
    aligned against a source-to-sink path of the graph
  * matched bases fuse into existing nodes (same char) or into a node of the
    same aligned column with the same char; otherwise a new node joins the
    column's aligned group
  * MSA columns = aligned groups in topological order
  * consensus = heaviest bundle: per node pick the in-edge with max weight
    (tie -> higher-scoring tail), follow back from the max-score node,
    extended forward to a sink by max-weight out-edges

Invariants guaranteed (tested in tests/test_poa.py):
  * each MSA row with gaps removed equals its input sequence exactly
  * all rows have equal length
  * consensus of k identical sequences is that sequence

The DP inner loop is vectorized over the sequence axis with a cummax trick
for the intra-row gap dependency, giving O(nodes) NumPy ops per sequence.
The batched TPU path implements the same recurrence as an anti-diagonal
wavefront Pallas kernel (ops/poa_pallas.py).
"""
from __future__ import annotations

import numpy as np

NEG = -(2 ** 30)


class PoaGraph:
    __slots__ = ("chars", "in_edges", "out_edges", "edge_w", "aligned",
                 "seq_begin", "rank", "_order_dirty")

    def __init__(self):
        self.chars: list[str] = []
        self.in_edges: list[list[int]] = []   # per node: list of tail node ids
        self.out_edges: list[list[int]] = []  # per node: list of head node ids
        self.edge_w: dict[tuple[int, int], int] = {}
        self.aligned: list[list[int]] = []    # per node: other nodes in its column
        self.seq_begin: list[int] = []        # first node id of each sequence's path
        self.rank: list[int] = []
        self._order_dirty = True

    # ---- construction ----
    def _add_node(self, ch: str) -> int:
        self.chars.append(ch)
        self.in_edges.append([])
        self.out_edges.append([])
        self.aligned.append([])
        self._order_dirty = True
        return len(self.chars) - 1

    def _add_edge(self, tail: int, head: int):
        key = (tail, head)
        if key in self.edge_w:
            self.edge_w[key] += 1
        else:
            self.edge_w[key] = 1
            self.out_edges[tail].append(head)
            self.in_edges[head].append(tail)
            self._order_dirty = True

    def n_nodes(self) -> int:
        return len(self.chars)

    # ---- topological order with aligned groups kept adjacent ----
    def topo_order(self) -> list[int]:
        if not self._order_dirty:
            return self.rank
        n = self.n_nodes()
        # group = connected component of `aligned` relation
        group = np.full(n, -1, np.int64)
        groups: list[list[int]] = []
        for v in range(n):
            if group[v] >= 0:
                continue
            members = sorted({v, *self.aligned[v]})
            gid = len(groups)
            for m in members:
                group[m] = gid
            groups.append(members)
        # group-level in-degrees (count cross-group edges)
        g_indeg = np.zeros(len(groups), np.int64)
        g_out: list[set[int]] = [set() for _ in groups]
        for (t, h) in self.edge_w:
            gt, gh = group[t], group[h]
            if gt != gh:
                if gh not in g_out[gt]:
                    g_out[gt].add(gh)
                    g_indeg[gh] += 1
        import heapq
        ready = [g for g in range(len(groups)) if g_indeg[g] == 0]
        heapq.heapify(ready)
        order: list[int] = []
        while ready:
            g = heapq.heappop(ready)
            order.extend(groups[g])
            for h in sorted(g_out[g]):
                g_indeg[h] -= 1
                if g_indeg[h] == 0:
                    heapq.heappush(ready, h)
        if len(order) != n:
            raise RuntimeError("POA graph has a cycle")
        self.rank = order
        self._order_dirty = False
        return order

    # ---- alignment of one sequence against the graph ----
    def align(self, seq: str, m: int = 5, n: int = -4, g: int = -8):
        """NW-align seq to the graph.

        Returns list of (node_id, seq_pos) pairs, -1 for gaps, in order.
        """
        order = self.topo_order()
        N = len(order)
        L = len(seq)
        pos_of = {node: i for i, node in enumerate(order)}
        s = np.frombuffer(seq.encode(), np.uint8)
        H = np.empty((N + 1, L + 1), np.int32)
        H[0] = g * np.arange(L + 1)
        ar = np.arange(L + 1)
        decay = g * ar
        for i, node in enumerate(order, start=1):
            preds = [pos_of[p] + 1 for p in self.in_edges[node]]
            if not preds:
                preds = [0]
            P = H[preds]  # (np, L+1)
            maxpred = P.max(axis=0)
            sub = np.where(s == ord(self.chars[node]), m, n).astype(np.int32)
            base = np.empty(L + 1, np.int32)
            base[0] = maxpred[0] + g
            base[1:] = np.maximum(maxpred[:-1] + sub, maxpred[1:] + g)
            # H[i][j] = max(base[j], H[i][j-1] + g)  via cummax of base - j*g
            H[i] = np.maximum.accumulate(base - decay) + decay
        # best end: node with no out-edges at column L (NW), rank order ties
        best_i, best = -1, None
        for i, node in enumerate(order, start=1):
            if not self.out_edges[node]:
                if best is None or H[i, L] > best:
                    best, best_i = H[i, L], i
        if best_i < 0:  # empty graph
            return [(-1, j) for j in range(L)]
        # traceback
        aln: list[tuple[int, int]] = []
        i, j = best_i, L
        while j > 0:
            if i == 0:
                aln.append((-1, j - 1))
                j -= 1
                continue
            node = order[i - 1]
            preds = [pos_of[p] + 1 for p in self.in_edges[node]] or [0]
            sub = m if s[j - 1] == ord(self.chars[node]) else n
            moved = False
            for p in preds:
                if H[i, j] == H[p, j - 1] + sub:
                    aln.append((node, j - 1))
                    i, j = p, j - 1
                    moved = True
                    break
            if moved:
                continue
            for p in preds:
                if H[i, j] == H[p, j] + g:
                    aln.append((node, -1))
                    i = p
                    moved = True
                    break
            if moved:
                continue
            if H[i, j] == H[i, j - 1] + g:
                aln.append((-1, j - 1))
                j -= 1
                continue
            raise RuntimeError("POA traceback failed")
        aln.reverse()
        return aln

    # ---- outputs ----
    def _columns(self):
        order = self.topo_order()
        col = {}
        ncol = 0
        for v in order:
            if v in col:
                continue
            for mbr in [v, *self.aligned[v]]:
                col[mbr] = ncol
            ncol += 1
        return col, ncol

    def consensus(self) -> str:
        n = self.n_nodes()
        if n == 0:
            return ""
        order = self.topo_order()
        score = np.zeros(n, np.int64)
        best_in = np.full(n, -1, np.int64)
        for v in order:
            bw = None
            for t in self.in_edges[v]:
                w = self.edge_w[(t, v)]
                if bw is None or w > bw or (w == bw and score[t] > score[best_in[v]]):
                    bw = w
                    best_in[v] = t
            if best_in[v] >= 0:
                score[v] = bw + score[best_in[v]]
        # max-score node (earliest in rank on ties)
        vmax = order[0]
        for v in order:
            if score[v] > score[vmax]:
                vmax = v
        # walk back
        path = [vmax]
        while best_in[path[-1]] >= 0:
            path.append(int(best_in[path[-1]]))
        path.reverse()
        # extend forward to a sink by heaviest out-edge
        v = vmax
        while self.out_edges[v]:
            heads = self.out_edges[v]
            v = max(heads, key=lambda h: (self.edge_w[(v, h)], score[h]))
            path.append(v)
        return "".join(self.chars[v] for v in path)

def poa(sequences: list[str], algorithm: int = 1, m: int = 5, n: int = -4,
        g: int = -8):
    """spoa-equivalent entry point: returns (consensus, msa).

    Only algorithm 1 (global NW) is implemented — the only mode the
    reference uses (src/DataScanner.py:207,213).
    """
    if algorithm != 1:
        raise NotImplementedError("only NW (algorithm=1) is supported")
    graph = PoaGraph()
    paths: list[list[int]] = []
    for seq in sequences:
        if len(seq) == 0:
            graph.seq_begin.append(-1)
            paths.append([])
            continue
        if graph.n_nodes() == 0:
            prev = -1
            begin = -1
            for ch in seq:
                cur = graph._add_node(ch)
                if prev >= 0:
                    graph._add_edge(prev, cur)
                else:
                    begin = cur
                prev = cur
            graph.seq_begin.append(begin)
            paths.append(list(range(len(seq))))
        else:
            aln = graph.align(seq, m, n, g)
            path = _fused_path(graph, aln, seq)
            paths.append(path)
    col, ncol = graph._columns()
    rows = []
    for path in paths:
        row = ["-"] * ncol
        for v in path:
            row[col[v]] = graph.chars[v]
        rows.append("".join(row))
    return graph.consensus(), rows


def _fused_path(graph: PoaGraph, aln, seq: str) -> list[int]:
    """add_alignment that also returns the node path of this sequence."""
    prev = -1
    begin = -1
    path: list[int] = []
    for node_id, spos in aln:
        if spos < 0:
            continue
        ch = seq[spos]
        if node_id >= 0:
            if graph.chars[node_id] == ch:
                cur = node_id
            else:
                cur = -1
                for a in graph.aligned[node_id]:
                    if graph.chars[a] == ch:
                        cur = a
                        break
                if cur < 0:
                    cur = graph._add_node(ch)
                    colm = [node_id, *graph.aligned[node_id]]
                    for a in colm:
                        graph.aligned[a].append(cur)
                    graph.aligned[cur].extend(colm)
        else:
            cur = graph._add_node(ch)
        if prev >= 0:
            graph._add_edge(prev, cur)
        else:
            begin = cur
        prev = cur
        path.append(cur)
    graph.seq_begin.append(begin)
    return path
