"""Two builds of the host C++ POA engine, loaded side by side and timed in
strict alternation (counterpart of tools/probe/engine_ab.py).

A host's speed drifts from minute to minute, so two engine builds timed one
after the other cannot tell a small change from the drift. This probe
builds each source (default: both are the port's
csrc/host/poa_engine.cpp) through native/_build.ensure_lib into a scratch
directory of its own (never csrc/_build/), loads both, packs the windows
and calls each through native/poa's own packing and signature
(pack_msa_batch, msa_batch_bytes), asserts that their
`poa_msa_batch` outputs on the bench bucket (128 bench windows, 25
sequences each) are byte-identical, and then times A and B in turns, A
first in every pair. It is the gate of any change to the engine: a
changed engine must give the same bytes.

    python -m svscope_tpu_torch.tools.probe.engine_ab [SRC_A [SRC_B]]
        [--windows 128] [--trials 7] [--threads 2] [--device cuda|cpu]

Exits 1 when the outputs differ. Host work only: `--device` checks that
the run is made on the machine it names.
"""
from __future__ import annotations

import argparse
import ctypes as ct
import os
import sys
import tempfile
import time

import numpy as np

from ...native import HOST_SRC


def load(src: str, build_dir: str):
    """Build `src` into build_dir (native/_build's policy) and load it with
    poa_msa_batch's signature declared (native/poa's declaration)."""
    from ...native._build import ensure_lib
    from ...native.poa import declare_msa_batch
    tag = os.path.splitext(os.path.basename(src))[0]
    return declare_msa_batch(ct.CDLL(
        ensure_lib(src, os.path.join(build_dir, f"lib{tag}.so"))))


def run(src_a: str | None = None, src_b: str | None = None,
        windows: int = 128, trials: int = 7, threads: int = 2,
        device="cuda", log=print) -> dict:
    """Builds, loads and compares the two engines; times them in turns when
    their outputs are byte-identical. Returns {"identical", "a_s", "b_s"}
    (seconds per call, every trial)."""
    from ...native.poa import msa_batch_bytes, pack_msa_batch
    from ...utils.device import resolve_device
    from ..workloads import make_window_payloads
    resolve_device(device)
    default = os.path.join(HOST_SRC, "poa_engine.cpp")
    src_a, src_b = src_a or default, src_b or default
    wins = make_window_payloads(windows, np.random.default_rng(3))
    packed = pack_msa_batch([w.sequences for w in wins])

    def call(engine):
        return msa_batch_bytes(packed, threads, engine)
    with tempfile.TemporaryDirectory(prefix="engine_ab_") as d:
        a = load(src_a, os.path.join(d, "a"))
        b = load(src_b, os.path.join(d, "b"))
        call(a), call(b)                                       # warm
        ra, rb = call(a), call(b)
        identical = ra[2] == rb[2] and bool((ra[1] == rb[1]).all()
                                            and (ra[0] == rb[0]).all())
        log(f"A {src_a}\nB {src_b}\noutputs byte-identical: {identical}")
        if not identical:
            return {"identical": False, "a_s": [], "b_s": []}
        ta, tb = [], []
        for _ in range(trials):
            t0 = time.perf_counter()
            call(a)
            ta.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            call(b)
            tb.append(time.perf_counter() - t0)
    log(f"A: best {min(ta):.4f} s {sorted(round(t, 4) for t in ta)}")
    log(f"B: best {min(tb):.4f} s {sorted(round(t, 4) for t in tb)}")
    return {"identical": True, "a_s": ta, "b_s": tb}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", metavar="SRC",
                    help="engine sources A and B (default: the port's "
                         "csrc/host/poa_engine.cpp)")
    ap.add_argument("--windows", type=int, default=128)
    ap.add_argument("--trials", type=int, default=7)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if len(args.sources) > 2:
        ap.error("at most two sources")
    srcs = args.sources + [None] * (2 - len(args.sources))
    res = run(*srcs, args.windows, args.trials, args.threads, args.device)
    return 0 if res["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
