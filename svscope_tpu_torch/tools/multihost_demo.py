"""Multi-process sharded localGraph demo (counterpart of
tools/multihost_demo.py).

    python -m svscope_tpu_torch.tools.multihost_demo [--procs 2] \
        [--device cuda|cpu]

Writes a synthetic tumor/normal pair (11 windows over 120 kb), launches
`--procs` processes of tools/dist_worker.py that meet through a gloo
rendezvous on a file in the run directory; each runs its block-cyclic
shard of the window stream through the batched engine on its own device
(`cuda:<rank mod card count>`, or the CPU) and process 0 merges the
canonical Raw.bed.  The merged output is then checked identical to a
single-process run over the same windows.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker_env() -> dict:
    """The environment of a worker: this checkout put first on
    PYTHONPATH, the rest of PYTHONPATH kept."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def launch_workers(procs: int, coord: str, ref: str, tumor: str,
                   normal: str, window_bed: str, savedir: str, devices,
                   threads: int | None = None):
    """Start `procs` dist_worker processes (device k for rank k) and wait
    for them.  Returns [(returncode, output)]."""
    cmds = [[sys.executable, "-m", "svscope_tpu_torch.tools.dist_worker",
             str(r), str(procs), coord, ref, tumor, normal, window_bed,
             savedir, "--device", str(devices[r])]
            + (["--threads", str(threads)] if threads else [])
            for r in range(procs)]
    ps = [subprocess.Popen(c, env=worker_env(), cwd=REPO,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=900)[0] for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(ps, outs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch
    from ..engine.localgraph import raw_bed_name, run_local_graph
    from .workloads import make_test_pair
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: CUDA is not available")
        n = torch.cuda.device_count()
        devices = [f"cuda:{r % n}" for r in range(args.procs)]
    else:
        devices = ["cpu"] * args.procs
    with tempfile.TemporaryDirectory(prefix="multihost_") as d:
        wins = [dict(start=s, end=s + 100, svtype="INS", svlen=70, som_reads=5,
                     depth=12) for s in range(5_000, 115_000, 10_000)]
        ref, tumor, normal, records, _ = make_test_pair(
            d, seed=4, ref_len=120_000, windows=wins)
        win_bed = os.path.join(d, "windows.bed")
        with open(win_bed, "w") as f:
            f.write("\n".join(records) + "\n")
        sharded_dir = os.path.join(d, "sharded")
        t0 = time.time()
        res = launch_workers(args.procs, f"file://{d}/rendezvous", ref, tumor,
                             normal, win_bed, sharded_dir, devices, threads=1)
        for rc, out in res:
            if rc != 0:
                raise RuntimeError(f"worker failed (rc {rc}):\n{out[-3000:]}")
        print(f"[sharded] {args.procs} processes on {devices} in "
              f"{time.time() - t0:.1f}s")
        t0 = time.time()
        single = run_local_graph(records, ref, [tumor], [normal], ["S"], ["S"],
                                 os.path.join(d, "single"), threads=1,
                                 device=devices[0], data_parallel=False)
        print(f"[single] 1 process in {time.time() - t0:.1f}s")
        with open(os.path.join(sharded_dir, raw_bed_name(["S"], ["S"]))) as f:
            a = f.read()
        with open(single) as f:
            b = f.read()
        if a != b:
            raise RuntimeError("sharded merge differs from the single run")
        print(f"[parity] merged Raw.bed identical ({len(a.splitlines())} "
              f"records)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
