"""Kernel throughput against the H100 bound, in one table (counterpart of
tools/roofline.py).

Measures, on this host and card:
  * the native C++ POA MSA (csrc/host/poa_engine.cpp), one core and the
    engine's pool, in GCUPS and MSA windows/s;
  * K1 (csrc/poa_align.cu) and its plain torch version
    (ops/poa_device.align_batch_reference) on B graphs of 500 nodes (15 %
    branch rows) against 450 bp reads, in useful GCUPS (sum of nodes x
    read length over the batch / t);
  * K2 (csrc/nw_stats.cu) on misscore4096, one launch per bucket, in
    useful GCUPS (sum of la x lb / t; its plain version's time is
    chip_smoke.py's k2-time);
  * the batched EM (models/mixture.em_cluster_batch) in windows/s.
Each kernel row carries its bound from tools/bounds.py (the table of
chip_smoke.py uses the same function) and the share of it reached
(bound ms / kernel ms). On the card the kernels' calls are timed queued
ahead of the device and the plain versions as they run (tools/timing.py).

    python -m svscope_tpu_torch.tools.roofline [--device cuda|cpu]
        [--windows 64] [--b 256] [--pairs 4096] [--em-windows 256]

On the CPU (`--device cpu`) K1 and K2 run their plain versions only and
no row is a device number.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import bounds
from .timing import time_call

K1_N, K1_L, K1_NODES, K1_READ = 512, 512, 500, 450
BRANCH_SHARE = 0.15
MSA_READS, MSA_REF_LEN, MSA_EDITS = 24, 400, 5


def msa_windows(n: int, rng):
    """The JAX tool's native-POA windows: a 400 bp reference and 24 reads
    with 5 random edits each (the same rng calls)."""
    mk = lambda k: "".join(rng.choice(list("ACGT"), k))
    windows = []
    for _ in range(n):
        ref = mk(MSA_REF_LEN)
        reads = []
        for _ in range(MSA_READS):
            b = list(ref)
            for _ in range(MSA_EDITS):
                p = int(rng.integers(1, len(b) - 1))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[p] = str(rng.choice(list("ACGT")))
                elif op == 1:
                    b.insert(p, str(rng.choice(list("ACGT"))))
                else:
                    b.pop(p)
            reads.append("".join(b))
        windows.append([ref] + reads)
    return windows


def native_poa(n_windows: int, log=print) -> dict:
    """The C++ engine's batch MSA on one core and on its pool (every core
    of this process's affinity)."""
    from ..native.poa import poa_msa_batch_native
    windows = msa_windows(n_windows, np.random.default_rng(0))
    # cells: sum over reads of nodes x length, ~ 24 x 500 x 400 a window
    cells = n_windows * MSA_READS * 500 * MSA_REF_LEN
    pool = len(os.sched_getaffinity(0))
    poa_msa_batch_native(windows[:4])
    t0 = time.perf_counter()
    poa_msa_batch_native(windows, threads=1)
    dt1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    poa_msa_batch_native(windows, threads=pool)
    dtn = time.perf_counter() - t0
    out = {"gcups_core": cells / dt1 / 1e9, "gcups_pool": cells / dtn / 1e9,
           "threads": pool, "windows_per_s": n_windows / dtn}
    log(f"native C++ POA MSA ({n_windows} windows, 400 bp x 24 reads): "
        f"{out['gcups_core']:.3f} GCUPS on one core, {out['gcups_pool']:.3f} "
        f"GCUPS on {pool} threads, {out['windows_per_s']:.1f} windows/s")
    return out


def k1_workload(b: int, rng):
    """The JAX tool's K1 batch: B chains of 512 ranks with 15 % branch rows
    (a second pred to rank 0), 500 live nodes, 450 bp reads in a 512
    bucket; numpy (chars, preds, sinks, n_nodes, seqs, seq_lens)."""
    from ..ops.poa_device import MAX_PREDS
    chars = rng.integers(65, 69, (b, K1_N)).astype(np.uint8)
    preds = np.full((b, K1_N, MAX_PREDS), -1, np.int32)
    for r in range(1, K1_N):
        preds[:, r, 0] = r - 1
    rs = rng.choice(np.arange(2, K1_N), int(BRANCH_SHARE * K1_N),
                    replace=False)
    preds[:, rs, 1] = 0
    sinks = np.zeros((b, K1_N), bool)
    sinks[:, K1_NODES - 1] = True
    nn = np.full(b, K1_NODES, np.int32)
    seqs = rng.integers(65, 69, (b, K1_L)).astype(np.uint8)
    lens = np.full(b, K1_READ, np.int32)
    return chars, preds, sinks, nn, seqs, lens


def _row(name, cells, ms, bnd, plain_ms=None):
    return {"name": name, "ms": ms, "gcups": cells / ms / 1e6,
            "plain_ms": plain_ms,
            "plain_gcups": None if plain_ms is None else
            cells / plain_ms / 1e6,
            "bound_ms": bnd[0] if bnd else None,
            "bound_by": bnd[1] if bnd else None,
            "bound_gcups": cells / bnd[0] / 1e6 if bnd else None,
            "share": bnd[0] / ms if bnd else None}


def k1_row(b: int, dev: torch.device, reps: int = 10) -> dict:
    from ..ops import poa_align
    from ..ops.poa_device import align_batch_reference, to_torch_packed
    arrs = k1_workload(b, np.random.default_rng(0))
    args = to_torch_packed(*arrs, dev)
    cells = float((arrs[3].astype(np.int64) * arrs[5]).sum())
    plain_ms = time_call(lambda: align_batch_reference(*args, K1_L), dev, 1,
                         queued=False)
    if dev.type != "cuda":
        return _row("K1 plain (CPU)", cells, plain_ms, None)
    ms = time_call(lambda: poa_align.align_batch_cuda(*args, K1_L), dev,
                   reps, queued=True)
    outs = poa_align.align_batch_cuda(*args, K1_L)
    return _row("K1", cells, ms, bounds.k1_bound(args, outs), plain_ms)


def k2_row(n_pairs: int, dev: torch.device, reps: int = 5) -> dict:
    """K2 over misscore4096's first n_pairs, one launch per bucket."""
    from ..ops.nw_batch import bucket_of
    from ..ops.nw_kernel import nw_stats_cuda, nw_stats_reference
    from .workloads import misscore4096_pairs, pad_pairs
    pairs = misscore4096_pairs()[:n_pairs]
    groups = {}
    for a, b in pairs:
        groups.setdefault(bucket_of(max(len(a), len(b))), []).append((a, b))
    cells, ms, launches = 0, 0.0, []
    for bucket, sub in sorted(groups.items()):
        args = [torch.from_numpy(x).to(dev) for x in pad_pairs(sub, bucket)]
        cells += sum(len(a) * len(b) for a, b in sub)
        launches.append((args, sub))
        if dev.type == "cuda":
            ms += time_call(lambda: nw_stats_cuda(*args, bucket), dev, reps,
                            queued=True)
        else:
            ms += time_call(lambda: nw_stats_reference(*args, bucket), dev,
                            1, queued=False)
    if dev.type != "cuda":
        return _row("K2 plain (CPU)", cells, ms, None)
    return _row("K2", cells, ms, bounds.k2_bound_all(launches))


def em_windows(n: int, rng):
    """The JAX tool's EM windows: two 16-read haplotypes over 100 columns
    with 3 % symbol noise."""
    feats = []
    for _ in range(n):
        a = rng.integers(0, 4, (1, 100))
        b = (a + 1 + rng.integers(0, 3, (1, 100))) % 4
        x = np.concatenate([np.repeat(a, 16, 0), np.repeat(b, 16, 0)])
        flip = rng.random(x.shape) < 0.03
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    return feats


def em_stage(n: int, dev: torch.device) -> float:
    """Batched EM windows/s (the call returns host arrays: it waits)."""
    from ..models.mixture import em_cluster_batch
    feats = em_windows(n, np.random.default_rng(1))
    em_cluster_batch(feats, device=dev)
    t0 = time.perf_counter()
    em_cluster_batch(feats, device=dev)
    return n / (time.perf_counter() - t0)


def run(device="cuda", windows: int = 64, b: int = 256, pairs: int = 4096,
        em: int = 256, log=print) -> dict:
    """Every row of the table: {"native_poa", "K1", "K2", "em_windows_per_s"}."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    res = {"native_poa": native_poa(windows, log),
           "K1": k1_row(b, dev), "K2": k2_row(pairs, dev),
           "em_windows_per_s": em_stage(em, dev)}
    for k in ("K1", "K2"):
        r = res[k]
        line = (f"{r['name']}: {r['ms']:.4f} ms, {r['gcups']:.3f} useful "
                "GCUPS")
        if r["plain_ms"] is not None:
            line += (f"; plain {r['plain_ms']:.4f} ms ({r['plain_gcups']:.4f}"
                     " GCUPS)")
        if r["bound_ms"] is not None:
            line += (f"; H100 bound {r['bound_ms']:.4f} ms "
                     f"({r['bound_by']}, {r['bound_gcups']:.1f} GCUPS), "
                     f"{100 * r['share']:.2f} % of it")
        log(line + (f" [K1: B={b}, {K1_NODES} nodes x {K1_READ} bp]"
                    if k == "K1" else f" [K2: misscore4096, {pairs} pairs]"))
    log(f"EM phasing (32 reads x 100 columns, K 1-9 x 20 steps): "
        f"{res['em_windows_per_s']:.1f} windows/s on {dev}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--pairs", type=int, default=4096)
    ap.add_argument("--em-windows", type=int, default=256)
    args = ap.parse_args(argv)
    return run(args.device, args.windows, args.b, args.pairs,
               args.em_windows)


if __name__ == "__main__":
    main()
