"""Windows/s of process_window_batch per POA engine on the bench workload
(counterpart of tools/probe/e2e_probe.py): the data behind the engine's
POA policy.

Engines: `host` (the C++ engine), `pallas` (the per-round device
aligner, K1: the cuda default) and `fused` (the whole MSA build on the
device, K3 and K4). Each engine's first run (cold: the kernels' first
launches) and its best of `--trials` warm runs are printed, with the count
of records equal to the first engine's and, given the golden's record
hashes (tests/data/jax_localgraph_golden.json's bench256, or
`--golden`), to the golden.

    python -m svscope_tpu_torch.tools.probe.e2e_probe [ENGINE ...]
        [--windows 256] [--trials 3] [--device cuda|cpu] [--golden JSON]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

ENGINES = {"host": False, "pallas": "pallas", "fused": "fused"}


def record_sha256(record) -> str:
    """sha256 of a record's Raw.bed line (the golden's record hashes)."""
    from ...engine.localgraph import record_line
    return hashlib.sha256(record_line(record).encode()).hexdigest()


def golden_count(recs, golden) -> int | None:
    """Records whose hash equals the golden's at the same index."""
    if golden is None:
        return None
    return sum(record_sha256(r) == h for r, h in zip(recs, golden))


def load_golden(path: str | None, name: str = "bench256"):
    if path is None:
        return None
    with open(path) as f:
        return json.load(f)["workloads"][name]["records"]


def run(engines=tuple(ENGINES), windows: int = 256, trials: int = 3,
        device="cuda", golden=None, log=print) -> dict:
    """{engine: {"cold_s", "best_s", "w_per_s", "trial_s", "somatic",
    "golden", "same_as_first"}}."""
    from ...engine.localgraph import process_window_batch
    from ...utils.device import resolve_device
    from ..workloads import make_window_payloads
    dev = resolve_device(device)
    wins = make_window_payloads(windows, np.random.default_rng(0))

    def once(poa):
        t0 = time.perf_counter()
        recs = process_window_batch(wins, device_poa=poa, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return recs, time.perf_counter() - t0

    out, first = {}, None
    for name in engines:
        recs, cold = once(ENGINES[name])
        trial_s = [once(ENGINES[name])[1] for _ in range(trials)]
        best = min(trial_s)
        first = recs if first is None else first
        row = {"cold_s": cold, "best_s": best, "w_per_s": windows / best,
               "trial_s": trial_s,
               "somatic": sum(1 for r in recs
                              if str(r[9]).endswith("EMOutput")),
               "golden": golden_count(recs, golden),
               "same_as_first": sum(a == b for a, b in zip(first, recs))}
        out[name] = row
        log(f"{name:7s}: cold {cold:7.3f} s  warm {best:7.4f} s "
            f"({row['w_per_s']:7.1f} w/s)  somatic {row['somatic']}/"
            f"{windows}; records == {engines[0]} {row['same_as_first']}/"
            f"{windows}" + ("" if golden is None else
                            f", == golden {row['golden']}/{len(golden)}")
            + f" (on {dev})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("engines", nargs="*", metavar="ENGINE",
                    help=f"any of {' '.join(ENGINES)} (default: all)")
    ap.add_argument("--windows", type=int, default=256)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--golden", default=None,
                    help="jax_localgraph_golden.json to count records "
                         "against (bench256's)")
    args = ap.parse_args(argv)
    bad = sorted(set(args.engines) - set(ENGINES))
    if bad:
        ap.error(f"unknown engines {bad}")
    return run(tuple(args.engines) or tuple(ENGINES), args.windows,
               args.trials, args.device, load_golden(args.golden))


if __name__ == "__main__":
    main()
