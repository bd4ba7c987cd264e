"""The fused MSA build against the host C++ engine on the bench workload
(counterpart of tools/probe/fused_probe.py): 256 windows of 300 bp + 2 x 50
flanks, 24 reads and the reference each.

ops/poa_batch.poa_msa_batch with the host engine, then with `fused` (K3
and K4 on the card, their plain versions on the CPU): the host's time,
the fused build's cold and best warm time, windows/s, and the count of
windows whose (consensus, MSA) equal the host engine's.

    python -m svscope_tpu_torch.tools.probe.fused_probe [--windows 256]
        [--trials 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def run(windows: int = 256, trials: int = 3, device="cuda",
        log=print) -> dict:
    from ...ops.poa_batch import poa_msa_batch
    from ...utils.device import resolve_device
    from ..workloads import make_window_payloads
    dev = resolve_device(device)
    jobs = [w.sequences for w in
            make_window_payloads(windows, np.random.default_rng(0))]

    def once(engine):
        t0 = time.perf_counter()
        res = poa_msa_batch(jobs, use_device=engine, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    host, host_s = once(False)
    fused, cold = once("fused")
    best = min(once("fused")[1] for _ in range(trials))
    same = sum(a == b for a, b in zip(host, fused))
    log(f"host C++     : {host_s:.4f} s ({windows / host_s:.1f} w/s)")
    log(f"fused (cold) : {cold:.4f} s")
    log(f"fused (warm) : {best:.4f} s ({windows / best:.1f} w/s) on {dev}")
    log(f"identical    : {same}/{windows}")
    return {"host_s": host_s, "fused_cold_s": cold, "fused_best_s": best,
            "identical": same}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=256)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return run(args.windows, args.trials, args.device)


if __name__ == "__main__":
    main()
