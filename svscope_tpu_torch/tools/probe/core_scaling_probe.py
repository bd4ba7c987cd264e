"""Wall against host cores: is the cuda default engine host-bound?
(counterpart of tools/probe/core_scaling_probe.py).

In one process (kernels built and warm, affinity switched with
`os.sched_setaffinity`), at 1, 2, 4, ... cores up to every core of the
process's affinity:

  1. the wall of process_window_batch on the engine's cuda default (the
     per-round device aligner, K1) over the bench windows;
  2. the native C++ POA MSA stage alone
     (native/poa.poa_msa_batch_native) with its pool capped at the same
     count;
  3. at every core, the glue around K1 in ops/poa_batch's device rounds,
     part by part, over one MSA build of the same windows
     (`poa_msa_batch(..., timing=)`, the build itself, its MSAs checked):
     `pack` (a round's routing: `poa_stat_batch`, the host-DP reads and
     the bucketing in numpy; then each chunk's `poa_pack_batch` into its
     pinned buffers), the async H2D copies and K1 on the device's clock,
     the D2H into pinned buffers up to the chunk's one synchronise,
     `unpack` and `fuse` (the two passes of `poa_fuse_batch`, unpack as
     the entry times it, fuse the rest of the call); beside them the
     build's wall.  The engine's thread pool takes on the caller's CPU
     affinity with each job, so every part runs on the cores of the row.

If (1) scales with cores as (2) does, the host's cores bound the default
path; (3) says which glue to move first.

    python -m svscope_tpu_torch.tools.probe.core_scaling_probe
        [--windows 128] [--trials 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def core_counts(cpus) -> list[int]:
    """1, 2, 4, ... below len(cpus), then len(cpus)."""
    n = len(cpus)
    out, k = [], 1
    while k < n:
        out.append(k)
        k *= 2
    return out + [n]


def _best(fn, trials: int) -> tuple[float, list[float]]:
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(windows: int = 128, trials: int = 3, device="cuda",
        log=print) -> dict:
    """Rows per core count: {cores: {"engine_s", "poa_s", "glue": {part:
    s}, "msa_s"}}, with the trial lists; restores the process's
    affinity."""
    from ...engine.localgraph import process_window_batch
    from ...native.poa import poa_msa_batch_native
    from ...ops.poa_batch import ROUND_PARTS, poa_msa_batch
    from ...utils.device import resolve_device
    from ..workloads import make_window_payloads
    dev = resolve_device(device)
    all_cpus = sorted(os.sched_getaffinity(0))
    wins = make_window_payloads(windows, np.random.default_rng(3))
    seq_lists = [w.sequences for w in wins]
    want = process_window_batch(wins, device=dev)      # warm: builds, EM
    msa_want = poa_msa_batch(seq_lists, use_device=True, device=dev)

    def timed_msa():
        glue = {}
        t0 = time.perf_counter()
        got = poa_msa_batch(seq_lists, use_device=True, device=dev,
                            timing=glue)
        wall = time.perf_counter() - t0
        if got != msa_want:
            raise RuntimeError("the timed MSA build differs from the untimed")
        return glue, wall
    rows = {}
    try:
        for k in core_counts(all_cpus):
            os.sched_setaffinity(0, set(all_cpus[:k]))

            def engine():
                recs = process_window_batch(wins, device=dev)
                _sync(dev)
                if recs != want:
                    raise RuntimeError(f"{k} cores: records differ")
            e_s, e_t = _best(engine, trials)
            p_s, p_t = _best(lambda: poa_msa_batch_native(seq_lists,
                                                          threads=k),
                             trials)
            glue, msa_s = timed_msa()
            rows[k] = {"engine_s": e_s, "engine_trials": e_t, "poa_s": p_s,
                       "poa_trials": p_t, "glue": glue, "msa_s": msa_s}
            log(f"{k:3d} cores: engine {e_s:.4f} s = {windows / e_s:.1f} w/s "
                f"(trials {[round(t, 4) for t in e_t]}); POA stage "
                f"{p_s * 1e3:.1f} ms; device MSA build {msa_s * 1e3:.1f} ms, "
                "its rounds' parts "
                + ", ".join(f"{p} {glue.get(p, 0.0) * 1e3:.1f} ms"
                            for p in ROUND_PARTS))
    finally:
        os.sched_setaffinity(0, set(all_cpus))
    one, top = rows[1], rows[len(all_cpus)]
    log(f"scaling 1 -> {len(all_cpus)} cores: engine "
        f"{one['engine_s'] / top['engine_s']:.2f}x, POA stage "
        f"{one['poa_s'] / top['poa_s']:.2f}x")
    return {"windows": windows, "device": str(dev), "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=128)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return run(args.windows, args.trials, args.device)


if __name__ == "__main__":
    main()
