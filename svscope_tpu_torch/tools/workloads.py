"""Inputs of the kernel measurement tools: the bench workload's windows.

`make_window_payloads` is the port's copy of `bench.make_window_payloads`
(the workload bench.py pinned across rounds), on the port's own
WindowData: the same rng calls in the same order draw the same payloads
(tests/test_torch_imports.py holds their sha256 equal to bench.py's).
"""
from __future__ import annotations

import numpy as np

from ..engine.datamaker import WindowData

# bench.py's window workload
N_READS = 24
WIN_LEN = 300
OFFSET = 50
INS_LEN = 60


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
