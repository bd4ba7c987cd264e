"""Where the host time of the cuda default's device rounds goes
(ops/poa_batch._DeviceBuild: a round's `poa_stat_batch`, then per bucket
chunk `poa_pack_batch`, H2D, K1, D2H, `poa_fuse_batch`).

  1. One MSA build of the bench windows and one of the heavy windows on
     the per-round device aligner, each after a warm build: its wall, its
     round parts (`poa_msa_batch(timing=)`, ROUND_PARTS) and the wall of
     each C++ batch entry's calls on the calling thread (the engine handle
     wrapped so every `*_batch` call is timed); the rest of the wall is
     Python around them and the wait for the device.  MSAs == the host
     engine's.
  2. `poa_pack_batch` alone on the heavy windows' graphs after their
     first read and after read `--pack-read`, at 1, 2, 4 and 8 threads of
     the engine's pool, each the median and least of `--reps` calls: the
     pool's own cost per job beside the work it splits.

    python -m svscope_tpu_torch.tools.probe.round_probe [--windows 128]
        [--heavy-windows 32] [--heavy-reads 400] [--pack-read 200]
        [--reps 40] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import ctypes as ct
import time

import numpy as np

THREADS = (1, 2, 4, 8)


class _TimedEngine:
    """The C++ engine's handle with every `*_batch` entry's call wall
    added to `seconds[name]`."""

    def __init__(self, lib):
        self._lib = lib
        self.seconds: dict[str, float] = {}

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.endswith("_batch"):
            return fn

        def call(*args):
            t = time.perf_counter()
            rc = fn(*args)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)
            return rc
        return call


def build_split(seq_lists, dev, threads: int | None = None) -> dict:
    """One device MSA build after a warm one: {"wall_s", "parts",
    "entries"} in seconds; raises when its MSAs differ from the host
    engine's."""
    from ...ops.poa_batch import HOST_THREADS, _DeviceBuild, poa_msa_batch
    want = poa_msa_batch(seq_lists, device=dev)
    poa_msa_batch(seq_lists, use_device="pallas", device=dev)
    build = _DeviceBuild(seq_lists, dev, threads or HOST_THREADS, None)
    build.lib = _TimedEngine(build.lib)
    parts = {}
    t = time.perf_counter()
    got = build.run(parts)
    wall = time.perf_counter() - t
    if got != want:
        raise RuntimeError("the device build's MSAs differ from the host "
                           "engine's")
    return {"wall_s": wall, "parts": parts, "entries": build.lib.seconds}


def pack_threads(seq_lists, read: int, reps: int,
                 threads=THREADS) -> dict:
    """poa_pack_batch on the windows' graphs after `read` reads (host DP
    builds them), one chunk of all windows: {threads: (median s, least
    s)}."""
    from ...native.poa import NativePoaGraph, flatten_reads, lib
    from ...ops.poa_batch import (B_LADDER, L_LADDER, N_LADDER, MAX_PREDS,
                                  _bucket, _ChunkBuffers, _ptr)
    graphs = []
    for seqs in seq_lists:
        g = NativePoaGraph()
        for s in seqs[:read]:
            g.add_sequence(s)
        graphs.append(g)
    nxt = [seqs[read] for seqs in seq_lists]
    nb = _bucket(max(g.n_nodes() for g in graphs), N_LADDER)
    lb = _bucket(max(map(len, nxt)), L_LADDER)
    b_pad = _bucket(len(graphs), B_LADDER) or len(graphs)
    bufs = _ChunkBuffers(nb, lb, b_pad, False)
    reads, seq_off, _ = flatten_reads([[s] for s in nxt])
    idx = np.arange(len(graphs), dtype=np.int64)
    handles = np.array([g._h for g in graphs], np.uintp)
    args = (_ptr(handles, ct.c_void_p), len(graphs), b_pad, nb, MAX_PREDS,
            lb, reads, _ptr(seq_off, ct.c_int64), _ptr(idx, ct.c_int64),
            *bufs.pack_out)
    out = {}
    for n_threads in threads:
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            rc = lib().poa_pack_batch(*args, n_threads)
            ts.append(time.perf_counter() - t)
            if rc:
                raise RuntimeError(f"poa_pack_batch failed at window {rc - 1}")
        out[n_threads] = (float(np.median(ts)), min(ts))
    return {"nb": nb, "lb": lb, "windows": len(graphs), "threads": out}


def run(windows: int = 128, heavy_windows: int = 32, heavy_reads: int = 400,
        pack_read: int = 200, reps: int = 40, device="cuda",
        log=print) -> dict:
    from ...utils.device import resolve_device
    from ..workloads import make_window_payloads
    dev = resolve_device(device)
    bench = [w.sequences for w in
             make_window_payloads(windows, np.random.default_rng(0))]
    heavy = [w.sequences for w in make_window_payloads(
        heavy_windows, np.random.default_rng(5), n_reads=heavy_reads,
        ins_carriers=heavy_reads // 2)]
    out = {"builds": {}, "pack": {}}
    for name, jobs in (("bench", bench), ("heavy", heavy)):
        r = build_split(jobs, dev)
        out["builds"][name] = r
        rest = r["wall_s"] - sum(r["entries"].values())
        log(f"{name} build of {len(jobs)} windows: {r['wall_s'] * 1e3:.1f} "
            "ms; C++ entries "
            + ", ".join(f"{k} {v * 1e3:.1f} ms"
                        for k, v in sorted(r["entries"].items()))
            + f", the rest {rest * 1e3:.1f} ms; round parts "
            + ", ".join(f"{k} {v * 1e3:.1f} ms"
                        for k, v in r["parts"].items()))
    for read in (1, pack_read):
        r = pack_threads(heavy, read, reps)
        out["pack"][read] = r
        log(f"poa_pack_batch, {r['windows']} heavy windows after {read} "
            f"reads (nb {r['nb']}, lb {r['lb']}): " + ", ".join(
                f"{k} threads {m * 1e6:.1f} us (least {lo * 1e6:.1f})"
                for k, (m, lo) in r["threads"].items()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=128)
    ap.add_argument("--heavy-windows", type=int, default=32)
    ap.add_argument("--heavy-reads", type=int, default=400)
    ap.add_argument("--pack-read", type=int, default=200)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return run(args.windows, args.heavy_windows, args.heavy_reads,
               args.pack_read, args.reps, args.device)


if __name__ == "__main__":
    main()
