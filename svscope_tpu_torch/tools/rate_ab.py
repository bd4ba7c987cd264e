"""End-to-end windows/s of process_window_batch in several source trees,
in turns, in one call (an A/B of two commits' unsharded rates).

    python -m svscope_tpu_torch.tools.rate_ab --trees ../parent . \\
        [--workload heavy32x400] [--turns 4] [--runs 3] [--device cuda]

Each turn starts one process per tree, the trees in order and then in
reverse, every other turn with the trees' order reversed (four turns:
A B B A, B A A B, A B B A, B A A B), so each tree runs as often in each
slot of a turn.  A process puts its tree's root first on sys.path, so it runs
that tree's port on the same seeded payloads
(`tools/workloads.make_window_payloads`).  A process runs
process_window_batch once cold, then `--runs` times warm, and times the
two stages alone on the same windows, `--runs` times each: stage A (the
POA and the feature columns, `_stage_a`) and the batched EM
(`em_cluster_batch_dispatch`, labels only, as the batch path calls it).
The records must hash equal in every process.  Prints a line per process,
then one JSON object, per tree, with every warm run's seconds, as the
last line.

Workloads: bench256 (256 windows x 24 reads, default_rng(0)) and
heavy32x400 (32 x 400 reads, 200 insertion carriers, default_rng(5)),
the payloads of chip_smoke.py; `--windows` keeps the first n.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WORKLOADS = {"bench256": (256, 0, {}),
             "heavy32x400": (32, 5, {"n_reads": 400, "ins_carriers": 200})}

WORKER = """
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from svscope_tpu_torch.engine import localgraph as lg
from svscope_tpu_torch.models.mixture import em_cluster_batch_dispatch
from svscope_tpu_torch.tools.workloads import make_window_payloads
n, seed, kw = json.loads(sys.argv[2])
runs, dev = int(sys.argv[3]), torch.device(sys.argv[4])
wins = make_window_payloads(n, np.random.default_rng(seed), **kw)
wins = wins[:int(sys.argv[5])] if len(sys.argv) > 5 else wins
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
poa = lg.resolve_device_poa(None, lg.resolve_device(dev))

def timed(fn):
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t

recs, cold = timed(lambda: lg.process_window_batch(wins, device=dev))
sha = hashlib.sha256("\\n".join(lg.record_line(r) for r in recs)
                     .encode()).hexdigest()
out = {"records": sha, "cold_s": cold, "run_s": [], "stage_a_s": [],
       "em_s": []}
for _ in range(runs):
    again, s = timed(lambda: lg.process_window_batch(wins, device=dev))
    if again != recs:
        raise SystemExit("records not repeatable")
    out["run_s"].append(s)
for _ in range(runs):
    (_e, ready), s = timed(lambda: lg._stage_a(wins, "tumor", 3, 0.05, poa,
                                               None, dev))
    out["stage_a_s"].append(s)
feats = [f for (_w, _e, _r, f, _t) in ready]
for _ in range(runs):
    _r, s = timed(lambda: em_cluster_batch_dispatch(
        feats, labels_only=True, device=dev)())
    out["em_s"].append(s)
print(json.dumps(out))
"""


def run_tree(root: str, spec, runs: int, device: str, windows) -> dict:
    argv = [sys.executable, "-c", WORKER, root, json.dumps(spec), str(runs),
            device] + ([str(windows)] if windows else [])
    res = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                         timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: rc {res.returncode}\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="source trees' roots ('.' is this checkout)")
    ap.add_argument("--workload", default="heavy32x400",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=None)
    args = ap.parse_args(argv)
    spec = WORKLOADS[args.workload]
    n = min(spec[0], args.windows or spec[0])
    roots = [os.path.abspath(t) for t in args.trees]
    fwd = list(range(len(roots)))
    turns = (fwd + fwd[::-1], fwd[::-1] + fwd)
    order = [t for k in range(args.turns) for t in turns[k % 2]]
    res = {t: {"run_s": [], "stage_a_s": [], "em_s": [], "cold_s": []}
           for t in args.trees}
    shas = set()
    for k in order:
        r = run_tree(roots[k], spec, args.runs, args.device, args.windows)
        shas.add(r["records"])
        tree = args.trees[k]
        for key in ("run_s", "stage_a_s", "em_s"):
            res[tree][key].extend(r[key])
        res[tree]["cold_s"].append(r["cold_s"])
        print(f"[rate_ab] {tree}: {n / min(r['run_s']):.3f} w/s (runs "
              f"{[round(s, 4) for s in r['run_s']]}), stage A "
              f"{[round(s, 4) for s in r['stage_a_s']]} s, EM "
              f"{[round(s, 4) for s in r['em_s']]} s", flush=True)
    if len(shas) != 1:
        print("[rate_ab] records differ between trees", file=sys.stderr)
        return 1
    for tree, r in res.items():
        r["w_s_best"] = n / min(r["run_s"])
        r["w_s_range"] = [n / max(r["run_s"]), n / min(r["run_s"])]
    print(json.dumps({"workload": args.workload, "windows": n,
                      "device": args.device, "trees": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
