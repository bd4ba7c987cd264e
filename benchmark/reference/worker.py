"""Worker processes of the reference: each child reads a pickled list of
jobs on its stdin, runs one function of msa.py over them and writes the
pickled results on its stdout.  Plain pipes, so nothing is shared through
/dev/shm; the children import NumPy and msa.py alone."""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FUNCTIONS = ("stage_a", "consensus")


def _cost(job) -> int:
    seqs = job[0] if isinstance(job[0], list) else job
    return sum(len(s) for s in seqs) * max(len(seqs), 1)


def map_jobs(fn: str, jobs: list, procs: int) -> list:
    """msa.<fn> over `jobs` in up to `procs` child processes (in this
    process when one is enough), results in the jobs' order."""
    from . import msa
    if procs <= 1 or len(jobs) <= 1:
        return [getattr(msa, fn)(j) for j in jobs]
    procs = min(procs, len(jobs))
    # the costliest job first, each to the least loaded child
    loads, groups = [0] * procs, [[] for _ in range(procs)]
    for i in sorted(range(len(jobs)), key=lambda i: -_cost(jobs[i])):
        k = loads.index(min(loads))
        groups[k].append(i)
        loads[k] += _cost(jobs[i])
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.reference.worker import main; main(%r)"
            % (ROOT, fn))
    children = []
    try:
        for g in groups:
            p = subprocess.Popen([sys.executable, "-c", code],
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE)
            children.append(p)
            p.stdin.write(pickle.dumps([jobs[i] for i in g]))
            p.stdin.close()
        out: list = [None] * len(jobs)
        for g, p in zip(groups, children):
            res = pickle.loads(p.stdout.read())
            if p.wait() != 0:
                raise RuntimeError(f"reference worker exited {p.returncode}")
            for i, r in zip(g, res):
                out[i] = r
        return out
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(fn: str) -> None:
    from . import msa
    if fn not in FUNCTIONS:
        raise SystemExit(f"unknown reference function {fn!r}")
    jobs = pickle.load(sys.stdin.buffer)
    res = [getattr(msa, fn)(j) for j in jobs]
    sys.stdout.buffer.write(pickle.dumps(res))
    sys.stdout.buffer.flush()
