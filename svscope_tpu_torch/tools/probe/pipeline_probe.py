"""Serial chunks against the pipelined localGraph engine (counterpart of
tools/probe/pipeline_probe.py).

process_window_batch splits a batch into PIPELINE_CHUNK-window chunks
(engine/localgraph.py) and computes stage A of the next chunk in a worker
thread while the main thread runs the EM and the emission of this one.
Variants on the 256-window bench workload:

  serial      every chunk's stages A, B, C one after the other, one thread
  pipe        process_window_batch as it runs (the pipelined path)
  serial-tN, pipe-tN   the same with the native POA pool capped at N
              threads

Every variant's records must equal the pipelined run's, and at least 80 %
of them be EMOutput records (bench.py's gate).

    python -m svscope_tpu_torch.tools.probe.pipeline_probe [VARIANT ...]
        [--windows 256] [--trials 3] [--device cuda|cpu]
        [--device-poa pallas|fused|host]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

VARIANTS = ("serial", "serial-t2", "pipe", "pipe-t2", "pipe-t1",
            "serial-t1")


def run_serial(wins, device_poa, dev, threads=None):
    """Each PIPELINE_CHUNK chunk through stages A, B and C in turn."""
    from ...engine import localgraph as lg
    records = []
    for off in range(0, len(wins), lg.PIPELINE_CHUNK):
        chunk = wins[off:off + lg.PIPELINE_CHUNK]
        entries, ready = lg._stage_a(chunk, "tumor", 3, 0.05, device_poa,
                                     threads, dev)
        fetch = lg._dispatch_em(ready, None, dev)
        records.extend(lg._complete_chunk(entries, ready, fetch, "tumor", 3,
                                          device_poa, threads, dev))
    return records


def run_pipe(wins, device_poa, dev, threads=None):
    from ...engine.localgraph import process_window_batch
    return process_window_batch(wins, device_poa=device_poa,
                                threads=threads, device=dev)


def variant_fn(name: str):
    kind, _, cap = name.partition("-t")
    fn = {"serial": run_serial, "pipe": run_pipe}[kind]
    threads = int(cap) if cap else None
    return lambda wins, device_poa, dev: fn(wins, device_poa, dev, threads)


def run(variants=VARIANTS, windows: int = 256, trials: int = 3,
        device="cuda", device_poa=None, log=print) -> dict:
    """{variant: (best s, every trial's s)}; each variant warmed once."""
    from ...engine.localgraph import resolve_device_poa
    from ...utils.device import resolve_device
    from ..workloads import make_window_payloads
    dev = resolve_device(device)
    device_poa = resolve_device_poa(device_poa, dev)
    wins = make_window_payloads(windows, np.random.default_rng(0))
    want = run_pipe(wins, device_poa, dev)
    out = {}
    for name in variants:
        fn = variant_fn(name)
        fn(wins, device_poa, dev)
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            recs = fn(wins, device_poa, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
            if recs != want:
                raise RuntimeError(f"{name}: records differ from the "
                                   "pipelined run's")
        n_som = sum(1 for r in recs if str(r[9]).endswith("EMOutput"))
        if n_som < 0.8 * len(wins):
            raise RuntimeError(f"{name}: only {n_som} EMOutput records")
        out[name] = (min(ts), ts)
        log(f"{name:10s} best {min(ts):.4f} s  {windows / min(ts):8.1f} w/s"
            f"  all {[round(t, 4) for t in ts]} (POA engine {device_poa!r} "
            f"on {dev})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"any of {' '.join(VARIANTS)} (default: all)")
    ap.add_argument("--windows", type=int, default=256)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--device-poa", default=None,
                    choices=("pallas", "fused", "host"))
    args = ap.parse_args(argv)
    bad = sorted(set(args.variants) - set(VARIANTS))
    if bad:
        ap.error(f"unknown variants {bad}")
    device_poa = False if args.device_poa == "host" else args.device_poa
    return run(args.variants or VARIANTS, args.windows, args.trials,
               args.device, device_poa)


if __name__ == "__main__":
    main()
