"""Round benchmark of the port (counterpart of bench.py): the localGraph
batch path's windows/s on the card, as bench.py measured it on the TPU
host, plus every POA engine the port runs.

Workload: bench.py's 256 candidate windows (tools/workloads.py: 300 bp, 24
spanning reads, 8 of them carrying a 60 bp somatic insertion) through
process_window_batch, exactly as the CLI drives it.  The headline is
bench.py's: host C++ POA with the EM on the device, one warm pass, then the
best of 3.  `engines` adds the same workload through each POA engine the
port has (`host`; `pallas`, the per-round device aligner K1 that the cuda
policy picks; `fused`, the whole MSA build on the device, K3 and K4), with
the records equal to the JAX golden and each engine's kernel launches.

Baseline: the reference's per-window engine, its EMCluster
(src/ReadsCluster.py), timed on matched feature matrices and scaled by its
6-process localGraph pool, when the reference's source directory is given
(`--reference-src`); else bench.py's recorded 2.2 windows/s.
`baseline_source` says which.

Runs in the process on the device asked for; asking for cuda on a host
without CUDA fails.  There is no watchdog, retry or CPU rerun.

    python -m svscope_tpu_torch.tools.bench [--device cuda|cpu] [--small]
        [--golden tests/data/jax_localgraph_golden.json]
        [--engines host pallas fused] [--reference-src DIR]

Prints one JSON line last (every key bench.py prints, plus `device`,
`baseline_source`, `engines` and the stage parts); progress goes to stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .genome_bench import launch_counts
from .workloads import (HEAVY_READS, HEAVY_SEED, HEAVY_WINDOWS, N_READS,
                        make_window_payloads)

N_WINDOWS = 256
SMALL_WINDOWS = 64
BASELINE_WIN_PER_S_RECORDED = 2.2  # bench.py's recorded reference rate
REF_POOL = 6                       # reference localGraph pool cap
ENGINES = ("host", "pallas", "fused")
KERNELS = ("K1", "K3", "K4", "K6", "K7")    # the POA engines' kernels


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _somatic(records) -> int:
    return sum(1 for r in records if str(r[9]).endswith("EMOutput"))


def _launches(before) -> dict:
    """K1, K3, K4, K6 and K7 launches since `before` (a launch_counts())."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in KERNELS}


def measure_ours(wins, dev):
    """(best windows/s, per-trial seconds, the last trial's records) of the
    pipelined engine path with host C++ POA and the EM on `dev`: one warm
    pass, then the best of 3.  Raises when fewer than 80 % of the windows
    are somatic calls."""
    from ..engine.localgraph import process_window_batch
    process_window_batch(wins, device_poa=False, device=dev)
    trials = []
    for _ in range(3):
        t0 = time.perf_counter()
        records = process_window_batch(wins, device_poa=False, device=dev)
        _sync(dev)
        trials.append(round(time.perf_counter() - t0, 3))
        n_som = _somatic(records)
        if n_som < len(wins) * 0.8:
            raise RuntimeError(f"only {n_som}/{len(wins)} somatic calls")
    return len(wins) / min(trials), trials, records


def measure_engines(n_windows, dev, engine_names=ENGINES, golden=None,
                    trials=3, log=print) -> dict:
    """Each POA engine on the same workload through tools/probe/e2e_probe:
    {engine: {"cold_s", "w_per_s", "trial_s", "somatic", "golden" (given
    a golden's record hashes), "launches": {K1, K3, K4, K6, K7} of its
    runs}}."""
    from .probe import e2e_probe
    out = {}
    for name in engine_names:
        before = launch_counts()
        row = e2e_probe.run((name,), n_windows, trials, dev, golden,
                            log)[name]
        out[name] = {**{k: row[k] for k in ("cold_s", "w_per_s",
                                            "trial_s", "somatic")},
                     **({} if golden is None else {"golden": row["golden"]}),
                     "launches": _launches(before)}
    return out


def measure_stages(n_windows, dev, engine_names=ENGINES, log=print) -> dict:
    """bench.py's three stage seconds of the host engine on ONE unpipelined
    chunk of PIPELINE_CHUNK windows (phase A: host POA MSA + feature
    selection; B: the EM's dispatch and fetch; C: labeling, consensus POA,
    emission); `parts`: each engine's parts of the chunk
    (tools/probe/stage_probe, best of 1 after its own check run);
    `pallas_round`: with the per-round device aligner, stage A's three
    parts and the device round's parts inside its POA MSA
    (poa_msa_batch(timing=), ROUND_PARTS: routing and `poa_pack_batch`,
    async H2D and K1 on the device's clock, the pinned D2H, and
    `poa_fuse_batch`'s unpack and fuse passes) from one run."""
    from ..engine import localgraph as lg
    from .probe import e2e_probe, stage_probe
    wins = make_window_payloads(n_windows, np.random.default_rng(0))
    chunk = wins[:min(len(wins), lg.PIPELINE_CHUNK)]
    t0 = time.perf_counter()
    entries, ready = lg._stage_a(chunk, "tumor", 3, 0.05, False, None, dev)
    t1 = time.perf_counter()
    em_results = lg._dispatch_em(ready, None, dev)()
    _sync(dev)
    t2 = time.perf_counter()
    lg._emit_chunk(ready, em_results, "tumor", 3, False, None, dev)
    t3 = time.perf_counter()
    out = {"n_windows": len(chunk),
           "stage_a_poa_feat_s": round(t1 - t0, 3),
           "stage_b_em_device_s": round(t2 - t1, 3),
           "stage_c_consensus_s": round(t3 - t2, 3),
           "parts": {}}
    for name in engine_names:
        res = stage_probe.run(len(chunk), 1, dev, e2e_probe.ENGINES[name],
                              log)
        out["parts"][name] = res["best"]
    if "pallas" in engine_names:
        rounds = {}
        parts = stage_probe.stage_a_split(chunk, "pallas", dev,
                                          timing=rounds)[2]
        out["pallas_round"] = {"stage_a_s": sum(parts.values()), **parts,
                               **rounds}
    return out


def measure_reference_baseline(ref_src=None, budget_s=60.0, n_runs=5):
    """Per-window rate of the reference engine (bench.py's two bounds):
    em_only, its EMCluster on matched feature matrices pooled over n_runs
    ([median, min, max]; it omits the reference's pyspoa cost, so
    vs_baseline understates the speedup), and poa_incl, EMCluster plus the
    port's host C++ POA (MSA and the two-cluster consensus re-POA) on the
    same windows; both scaled by the reference's 6-process pool, clamped to
    this machine's cores.  Without the reference's source directory
    `ref_src` (its `src/`), the recorded rate.  Returns {"source":
    "reference" | "recorded", "em_only", "poa_incl": float | None}."""
    rng = np.random.default_rng(1)
    feats = []
    for _ in range(16):
        a = rng.integers(0, 4, (1, 70))
        b = (a + 1 + rng.integers(0, 3, (1, 70))) % 4
        x = np.concatenate([np.repeat(a, N_READS // 2, 0),
                            np.repeat(b, N_READS // 2, 0)])
        flip = rng.random(x.shape) < 0.03
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x))
    recorded = {"source": "recorded",
                "em_only": [BASELINE_WIN_PER_S_RECORDED] * 3,
                "poa_incl": None}
    if ref_src is None or not os.path.isdir(ref_src):
        return recorded
    try:
        import matplotlib
        matplotlib.use("Agg")
    except ImportError:
        pass                    # only the reference's plots need it
    sys.path.insert(0, ref_src)
    try:
        import ReadsCluster as ref_rc
    except ImportError:
        return recorded
    finally:
        sys.path.remove(ref_src)
    scale = min(REF_POOL, os.cpu_count() or 1)
    rates = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        n_done = 0
        for x in feats:
            ref_rc.EMCluster(x, initselection=1)
            n_done += 1
            if time.perf_counter() - t0 > budget_s / n_runs:
                break
        rates.append(n_done / (time.perf_counter() - t0) * scale)
    rates.sort()
    em_only = [rates[len(rates) // 2], rates[0], rates[-1]]
    # the reference's spoa calls (DataScanner.py:207, DecisionMaker.py:160,
    # 171): full MSA, then a consensus re-POA of each half of the reads
    from ..native.poa import poa_native
    wins = make_window_payloads(8, np.random.default_rng(2))
    t0 = time.perf_counter()
    for w in wins:
        _cons, msa = poa_native(w.sequences)
        half = len(msa) // 2
        poa_native([r.replace("-", "") for r in msa[1:1 + half]])
        poa_native([r.replace("-", "") for r in msa[1 + half:]])
    poa_s_per_win = (time.perf_counter() - t0) / len(wins)
    em_s_per_win = scale / em_only[0]   # serial seconds per window
    return {"source": "reference", "em_only": em_only,
            "poa_incl": scale / (em_s_per_win + poa_s_per_win)}


def measure_heavy_tier(dev, engine_names=ENGINES, golden=None) -> dict:
    """300-500-read windows (the selection cap 500, reference
    src/WindowSelection_v8.py:600): HEAVY_WINDOWS x HEAVY_READS, seed 5,
    through the batch path with host POA (one warm pass, best of 2; the
    read-parallel EM routing and the native Ward init at scale), the EM's
    host prep and device wait on the same windows, and, with `pallas` in
    the engines, the same with the per-round device aligner (K1: cold,
    best of 2).  `golden`: the heavy workload's record hashes."""
    from ..engine import localgraph as lg
    from .probe.e2e_probe import golden_count
    wins = make_window_payloads(HEAVY_WINDOWS,
                                np.random.default_rng(HEAVY_SEED),
                                n_reads=HEAVY_READS,
                                ins_carriers=HEAVY_READS // 2)

    def timed(poa, runs):
        trials = []
        for _ in range(runs):
            t0 = time.perf_counter()
            records = lg.process_window_batch(wins, device_poa=poa,
                                              device=dev)
            _sync(dev)
            trials.append(round(time.perf_counter() - t0, 3))
            n_som = _somatic(records)
            if n_som < len(wins) * 0.8:
                raise RuntimeError(f"heavy tier: {n_som} somatic")
        return trials, records

    lg.process_window_batch(wins, device_poa=False, device=dev)  # warm
    trials, records = timed(False, 2)
    # the EM's host prep (the Ward init among it) apart from its device wait
    _entries, ready = lg._stage_a(wins, "tumor", 3, 0.05, False, None, dev)
    t1 = time.perf_counter()
    fetch = lg._dispatch_em(ready, None, dev)
    t2 = time.perf_counter()
    fetch()
    _sync(dev)
    t3 = time.perf_counter()
    out = {"n_windows": HEAVY_WINDOWS, "n_reads": HEAVY_READS,
           "w_per_s": round(HEAVY_WINDOWS / min(trials), 2),
           "trial_s": trials,
           "em_dispatch_prep_s": round(t2 - t1, 3),
           "em_device_wait_s": round(t3 - t2, 3)}
    if golden is not None:
        out["golden"] = golden_count(records, golden)
    if "pallas" in engine_names:
        before = launch_counts()
        p_trials, p_records = timed("pallas", 3)
        best = min(p_trials[1:])
        out["pallas"] = {"w_per_s": round(HEAVY_WINDOWS / best, 2),
                         "cold_s": p_trials[0], "trial_s": p_trials[1:],
                         "launches": _launches(before)}
        if golden is not None:
            out["pallas"]["golden"] = golden_count(p_records, golden)
    return out


def device_probe_s(dev):
    """Warm round trip of x + 1 on an (8, 128) float32 array, numpy -> the
    card -> numpy, after one untimed trip; None off CUDA."""
    if dev.type != "cuda":
        return None
    x = np.ones((8, 128), np.float32)

    def trip():
        return (torch.from_numpy(x).to(dev) + 1).cpu().numpy()
    trip()
    t0 = time.perf_counter()
    trip()
    return round(time.perf_counter() - t0, 6)


def run_measurement(n_windows=N_WINDOWS, heavy=True, device="cuda",
                    golden=None, engines=None, reference_src=None,
                    log=print) -> dict:
    """Every key bench.py prints, on `device`, plus `device`,
    `baseline_source`, `engines` (each POA engine on the same workload)
    and the stage parts.  `golden`: tests/data/jax_localgraph_golden.json's
    content; the records of each run are counted against its workloads
    (the first n_windows of bench256, and heavy32x400).  `engines`: the
    POA engines to report (default all three on CUDA; on the CPU only
    `host`, as the device engines run there as their plain versions)."""
    from ..utils.device import resolve_device
    from .probe.e2e_probe import golden_count
    dev = resolve_device(device)
    if engines is None:
        engines = ENGINES if dev.type == "cuda" else ("host",)
    bad = sorted(set(engines) - set(ENGINES))
    if bad:
        raise ValueError(f"unknown engines {bad} (of {ENGINES})")
    gold = None if golden is None else {
        k: w["records"] for k, w in golden["workloads"].items()}
    wins = make_window_payloads(n_windows, np.random.default_rng(0))
    probe = device_probe_s(dev)
    ours, trials, records = measure_ours(wins, dev)
    bench_gold = None if gold is None else gold["bench256"][:n_windows]
    per_engine = measure_engines(n_windows, dev, engines, bench_gold,
                                 log=log)
    stages = measure_stages(n_windows, dev, engines, log)
    base = measure_reference_baseline(reference_src)
    med, lo, hi = base["em_only"]
    em = "CUDA EM" if dev.type == "cuda" else "CPU EM"
    out = {
        "metric": f"localGraph windows/s (300bp, 24 reads; native POA + "
                  f"{em})",
        "value": round(ours, 2),
        "unit": "windows/s",
        "vs_baseline": round(ours / med, 2),
        "n_windows": n_windows,
        "baseline_w_per_s": round(med, 3),
        "baseline_w_per_s_spread": [round(lo, 3), round(hi, 3)],
        "trial_s": trials,
        "stages": stages,
        "device_probe_s": probe,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "baseline_source": base["source"],
        "engines": per_engine,
    }
    if bench_gold is not None:
        out["golden"] = golden_count(records, bench_gold)
    if base["poa_incl"]:
        out["vs_baseline_poa_incl"] = round(ours / base["poa_incl"], 2)
        out["baseline_poa_incl_w_per_s"] = round(base["poa_incl"], 3)
    if heavy:
        out["heavy_tier"] = measure_heavy_tier(
            dev, engines, None if gold is None else gold["heavy32x400"])
    return out


def golden_counts(out: dict) -> dict:
    """{run: (its records equal to the golden, or None without a golden,
    its window count)} of the headline, each engine, the heavy tier and
    the heavy tier's pallas run."""
    n = out["n_windows"]
    rows = {"headline": (out, n),
            **{k: (r, n) for k, r in out["engines"].items()}}
    heavy = out.get("heavy_tier")
    if heavy is not None:
        rows["heavy_tier"] = (heavy, heavy["n_windows"])
        if "pallas" in heavy:
            rows["heavy_tier.pallas"] = (heavy["pallas"], heavy["n_windows"])
    return {k: (r.get("golden"), want) for k, (r, want) in rows.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true",
                    help=f"{SMALL_WINDOWS} windows, no heavy tier")
    ap.add_argument("--golden", default=None,
                    help="jax_localgraph_golden.json: fail unless every "
                         "run's records equal it")
    ap.add_argument("--engines", nargs="+", choices=ENGINES, default=None,
                    help="POA engines to report (default: all on cuda, "
                         "host on cpu)")
    ap.add_argument("--reference-src", default=None,
                    help="the reference's src/ directory (its EMCluster "
                         "is the baseline; else the recorded rate)")
    args = ap.parse_args(argv)
    golden = None
    if args.golden is not None:
        with open(args.golden) as f:
            golden = json.load(f)
    out = run_measurement(SMALL_WINDOWS if args.small else N_WINDOWS,
                          heavy=not args.small, device=args.device,
                          golden=golden, engines=args.engines,
                          reference_src=args.reference_src,
                          log=lambda line: print(line, file=sys.stderr,
                                                 flush=True))
    print(json.dumps(out), flush=True)
    bad = {k: c for k, (c, want) in golden_counts(out).items()
           if golden is not None and c != want}
    if bad:
        print(f"bench: records short of the golden: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
