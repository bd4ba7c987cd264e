"""The A / B / C split of one 128-window chunk of the localGraph engine
(counterpart of tools/probe/stage_probe.py).

  A: gates | POA MSA | encode + margin + feature selection
  B: host prep + dispatch of the EM | device wait (fetch)
  C: labeling and emission (Python) | consensus POA

process_window_batch runs stage A of the next chunk in a worker thread
while the main thread runs B and C (engine/localgraph.py); here every part
runs serially in one thread, so the parts add up to a serial chunk, not to
the pipelined wall. Stage A is a timed copy of engine/localgraph._stage_a
(its entries and ready windows must equal _stage_a's); C's consensus POA
is timed by wrapping localgraph's poa_msa_batch for the call.

    python -m svscope_tpu_torch.tools.probe.stage_probe [--windows 128]
        [--trials 3] [--device cuda|cpu] [--device-poa pallas|fused|host]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

PARTS = ("gates", "poa_msa", "featsel", "dispatch", "wait", "emit_python",
         "consensus_poa")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage_a_split(wins, device_poa, dev, threads=None, timing=None):
    """engine/localgraph._stage_a with its three parts timed: returns
    (entries, ready, {"gates", "poa_msa", "featsel"} seconds).  `timing`
    goes to poa_msa_batch (the device round's parts, ops/poa_batch)."""
    from ...engine import localgraph as lg
    from ...engine.decision import call_margin, find_non_same_site
    from ...utils import seq as sq
    t0 = time.perf_counter()
    entries, msa_jobs, pending, tags_of = [], [], [], {}
    for win in wins:
        tags = lg._read_tags(win.read_ids)
        if lg._passes_gates(win, tags, "tumor"):
            tags_of[len(entries)] = tags
            pending.append(len(entries))
            msa_jobs.append(win.sequences)
        entries.append([win, None])
    t1 = time.perf_counter()
    msa_out = lg.poa_msa_batch(msa_jobs, use_device=device_poa,
                               threads=threads, device=dev,
                               timing=timing) \
        if msa_jobs else []
    _sync(dev)
    t2 = time.perf_counter()
    ready = []
    for ei, (_cons, msa) in zip(pending, msa_out):
        win, _ = entries[ei]
        enc = sq.encode_rows(msa)
        flank_cols = call_margin(msa[0], win.flank_5, win.flank_3)
        keep_cols = np.setdiff1d(np.arange(enc.shape[1]), flank_cols)
        td_raw = enc[1:, keep_cols]
        cutoff = max(3, enc.shape[0] * 0.05)
        feat = td_raw[:, find_non_same_site(td_raw, cutoff)]
        if feat.shape[0] != 0 and feat.shape[1] >= 10:
            entries[ei][1] = len(ready)
            ready.append((win, enc, win.read_ids, feat, tags_of[ei]))
    t3 = time.perf_counter()
    return entries, ready, {"gates": t1 - t0, "poa_msa": t2 - t1,
                            "featsel": t3 - t2}


def _same_stage_a(a, b) -> bool:
    """Equal entries and ready windows (array fields compared by value)."""
    (ea, ra), (eb, rb) = a, b
    if [s for _, s in ea] != [s for _, s in eb] or len(ra) != len(rb):
        return False
    return all(x[0] is y[0] and np.array_equal(x[1], y[1])
               and np.array_equal(x[3], y[3]) and np.array_equal(x[4], y[4])
               for x, y in zip(ra, rb))


def run(windows: int = 128, trials: int = 3, device="cuda", device_poa=None,
        log=print) -> dict:
    """Best seconds of each part over `trials` runs of one chunk, every
    trial's parts, and the chunk's records (== process_window_batch's)."""
    from ...engine import localgraph as lg
    from ...utils.device import resolve_device
    from ..workloads import make_window_payloads
    dev = resolve_device(device)
    device_poa = lg.resolve_device_poa(device_poa, dev)
    wins = make_window_payloads(windows, np.random.default_rng(0))
    want = lg.process_window_batch(wins, device_poa=device_poa, device=dev)
    if not _same_stage_a(stage_a_split(wins, device_poa, dev)[:2],
                         lg._stage_a(wins, "tumor", 3, 0.05, device_poa,
                                     None, dev)):
        raise RuntimeError("stage_a_split differs from localgraph._stage_a")
    orig = lg.poa_msa_batch
    rows = []
    for _ in range(trials):
        entries, ready, parts = stage_a_split(wins, device_poa, dev)
        t0 = time.perf_counter()
        fetch = lg._dispatch_em(ready, None, dev)
        t1 = time.perf_counter()
        em = fetch()
        _sync(dev)
        t2 = time.perf_counter()
        cons = {"s": 0.0}

        def timed_poa(*a, **k):
            t = time.perf_counter()
            out = orig(*a, **k)
            _sync(dev)
            cons["s"] += time.perf_counter() - t
            return out
        lg.poa_msa_batch = timed_poa
        try:
            recs = lg._complete_chunk(entries, ready, lambda: em, "tumor", 3,
                                      device_poa, None, dev)
        finally:
            lg.poa_msa_batch = orig
        t3 = time.perf_counter()
        if recs != want:
            raise RuntimeError("the timed chunk's records differ from "
                               "process_window_batch's")
        parts.update(dispatch=t1 - t0, wait=t2 - t1,
                     emit_python=t3 - t2 - cons["s"],
                     consensus_poa=cons["s"])
        rows.append(parts)
        log(f"A gates {parts['gates']:.4f} poa {parts['poa_msa']:.4f} "
            f"featsel {parts['featsel']:.4f} | B dispatch "
            f"{parts['dispatch']:.4f} wait {parts['wait']:.4f} | C emit "
            f"{parts['emit_python']:.4f} consensus POA "
            f"{parts['consensus_poa']:.4f} (s; {len(ready)} windows to the "
            f"EM, POA engine {device_poa!r} on {dev})")
    best = {p: min(r[p] for r in rows) for p in PARTS}
    return {"best": best, "trials": rows, "records": want}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=128)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--device-poa", default=None,
                    choices=("pallas", "fused", "host"))
    args = ap.parse_args(argv)
    device_poa = False if args.device_poa == "host" else args.device_poa
    return run(args.windows, args.trials, args.device, device_poa)


if __name__ == "__main__":
    main()
