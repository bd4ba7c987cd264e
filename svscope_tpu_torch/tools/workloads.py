"""Inputs of the kernel measurement tools: the bench workload's windows,
and one device round of K1 replayed from them.

`make_window_payloads` is the port's copy of `bench.make_window_payloads`
(the workload bench.py pinned across rounds), on the port's own
WindowData: the same rng calls in the same order draw the same payloads
(tests/test_torch_imports.py holds their sha256 equal to bench.py's).
`round_workload` packs the windows' graphs after a number of reads as one
per-round K1 call of the device POA path does; `heavy_round_workload` is
such a call of the heavy tier (32 windows x 400 reads) in its busiest
bucket, (N, L) = (1024, 512).
"""
from __future__ import annotations

import numpy as np

from ..engine.datamaker import WindowData
from ..native.poa import NativePoaGraph
from ..ops.poa_device import MAX_PREDS

# bench.py's window workload
N_READS = 24
WIN_LEN = 300
OFFSET = 50
INS_LEN = 60
# the heavy tier: 32 windows x 400 reads, 200 of them carrying the INS
HEAVY_WINDOWS = 32
HEAVY_READS = 400
HEAVY_SEED = 5
HEAVY_GRAPH_READS = 200   # ~840-850 nodes: mid-way through the 1024 bucket


def make_window_payloads(n, rng, n_reads=N_READS, ins_carriers=8):
    """WindowData payloads: ref window + reads, the first ins_carriers
    (tumor) reads carrying a 60 bp INS (bench.make_window_payloads on the
    port's WindowData)."""
    wins = []
    for w in range(n):
        ref = "".join(rng.choice(list("ACGT"), WIN_LEN + 2 * OFFSET))
        ins = "".join(rng.choice(list("ACGT"), INS_LEN))
        mid = len(ref) // 2
        reads = []
        for i in range(n_reads):
            base = ref
            if i < min(n_reads // 2, ins_carriers):
                base = ref[:mid] + ins + ref[mid:]
            b = list(base)
            for _ in range(4):          # light ONT-like noise
                p = int(rng.integers(1, len(b) - 1))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[p] = str(rng.choice(list("ACGT")))
                elif op == 1:
                    b.insert(p, str(rng.choice(list("ACGT"))))
                else:
                    b.pop(p)
            reads.append("".join(b))
        # both tags >= 3: first half tumor (with INS), second half normal
        ids = ([f"S_tumor|w{w}r{i}" for i in range(n_reads // 2)]
               + [f"S_normal|w{w}r{i}" for i in range(n_reads // 2, n_reads)])
        wins.append(WindowData([ref] + reads, np.array(ids),
                               ref[:OFFSET], ref[-OFFSET:],
                               f"chr1\t{1000 + w * 1000}\t{1000 + w * 1000 + WIN_LEN}",
                               "NormalOutput"))
    return wins


def round_workload(wins, graph_reads: int, N: int, L: int):
    """One per-round K1 call: each window's graph after its first
    `graph_reads` sequences, packed to N nodes, and its next sequence to
    align.  Returns (chars, preds, sinks, n_nodes, seqs, seq_lens) numpy
    arrays, as poa_batch's device round builds them."""
    b = len(wins)
    chars = np.zeros((b, N), np.uint8)
    preds = np.full((b, N, MAX_PREDS), -1, np.int32)
    sinks = np.zeros((b, N), bool)
    nn = np.zeros(b, np.int32)
    seqs = np.zeros((b, L), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, w in enumerate(wins):
        g = NativePoaGraph()
        for s in w.sequences[:graph_reads]:
            g.add_sequence(s)
        packed = g.pack(N, MAX_PREDS)
        nxt = w.sequences[graph_reads]
        if packed is None or len(nxt) > L:
            raise RuntimeError(f"window {i} exceeds the ({N}, {L}) bucket")
        chars[i], preds[i], sinks[i], nn[i] = packed[:4]
        seqs[i, :len(nxt)] = np.frombuffer(nxt.encode(), np.uint8)
        lens[i] = len(nxt)
    return chars, preds, sinks, nn, seqs, lens


def heavy_round_workload(b: int = HEAVY_WINDOWS,
                         graph_reads: int = HEAVY_GRAPH_READS):
    """The heavy tier's K1 call at (B, N, L) = (32, 1024, 512): its windows'
    graphs after `graph_reads` sequences (the reference window and the
    first reads) and the next read.  Returns round_workload's arrays."""
    wins = make_window_payloads(b, np.random.default_rng(HEAVY_SEED),
                                n_reads=HEAVY_READS,
                                ins_carriers=HEAVY_READS // 2)
    return round_workload(wins, graph_reads, 1024, 512)
