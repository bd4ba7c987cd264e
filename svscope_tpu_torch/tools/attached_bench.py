"""Per-round POA kernel time: K1, K1-int16 and their plain versions on one
per-round batch (counterpart of tools/attached_bench.py).

The workload is the exact input of one device round of the bench
workload: B bench windows whose graphs hold 13 reads, packed to the
(N, L) = (512, 512) bucket, and each window's 14th read to align.  Per
engine it prints the time of one call, the useful GCUPS (sum of
n_nodes x seq_len over the batch) and the padded GCUPS (B x N x L), and
then the windows/s a 24-round MSA build would reach if each round cost
only this call: B / (24 x t).

On the card the kernels are timed with CUDA events around `--reps` calls
queued ahead of the device after a warm-up call (tools/timing.py), so
the JAX tool's k-loop subtraction (which took the TPU link's dispatch
cost out of its wall clock) has no counterpart here.
On the CPU (`--device cpu`) `align_batch` runs the plain version and the
host clock times it.  The JAX tool's `[auto-policy]` line read
`engine/localgraph.ATTACHED_LATENCY_S`, a dispatch budget that the port
never had (its device path takes the kernel on cuda), so it is left out.

    python -m svscope_tpu_torch.tools.attached_bench [--device cuda|cpu]
        [--b 64] [--reps 32] [--skip-int16]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..native.poa import NativePoaGraph
from ..ops import poa_align
from ..ops.poa_device import (MAX_PREDS, align_batch_reference,
                              to_torch_packed)
from ..utils.device import resolve_device
from .timing import time_call
from .workloads import make_window_payloads

N_BUCKET = 512
L_BUCKET = 512
GRAPH_READS = 13        # reads already in each graph; the 14th is aligned
ROUNDS = 24             # reads per bench window = rounds of an MSA build
PLAIN_REPS = 3          # the plain version takes ~1e3 x the kernel's time


def build_round_workload(b: int, rng):
    """B bench windows' graphs after 13 reads, packed to N = L = 512, and the
    14th read of each: (chars, preds, sinks, n_nodes, seqs, seq_lens, N, L)
    as numpy arrays, as the JAX tool builds them."""
    wins = make_window_payloads(b, rng)
    N, L = N_BUCKET, L_BUCKET
    chars = np.zeros((b, N), np.uint8)
    preds = np.full((b, N, MAX_PREDS), -1, np.int32)
    sinks = np.zeros((b, N), bool)
    nn = np.zeros(b, np.int32)
    seqs = np.zeros((b, L), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, w in enumerate(wins):
        g = NativePoaGraph()
        for s in w.sequences[:GRAPH_READS]:
            g.add_sequence(s)
        packed = g.pack(N, MAX_PREDS)
        if packed is None:
            raise RuntimeError(f"bench window {i} exceeds the ({N}, {L}) "
                               "bucket")
        chars[i], preds[i], sinks[i], nn[i] = packed[:4]
        nxt = w.sequences[GRAPH_READS]
        seqs[i, :len(nxt)] = np.frombuffer(nxt.encode(), np.uint8)
        lens[i] = len(nxt)
    return chars, preds, sinks, nn, seqs, lens, N, L


def engines(l_max: int, skip_int16: bool = False):
    """(label, fn(args), is the dispatching entry point) per engine; on
    CUDA tensors align_batch launches K1 / K1-int16, on CPU tensors the
    plain version."""
    modes = (False,) if skip_int16 else (False, True)
    rows = [(f"align_batch int{16 if m else 32}",
             lambda a, m=m: poa_align.align_batch(*a, l_max, int16_mode=m),
             True) for m in modes]
    rows += [(f"align_batch_reference int{16 if m else 32}",
              lambda a, m=m: align_batch_reference(*a, l_max, int16_mode=m),
              False) for m in modes]
    return rows


def main(argv=None) -> dict:
    """Run the tool; returns {engine label: ms per call}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--reps", type=int, default=32)
    ap.add_argument("--skip-int16", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)} (align_batch "
              "launches the kernels)", flush=True)
    else:
        print("device: cpu (align_batch runs the plain version)", flush=True)
    chars, preds, sinks, nn, seqs, lens, N, L = build_round_workload(
        args.b, np.random.default_rng(0))
    cells = float((nn.astype(np.int64) * lens).sum())
    pad_cells = float(args.b) * N * L
    print(f"workload: B={args.b} bucket N={N} L={L}, useful cells/call "
          f"{cells / 1e6:.3f} M (padded {pad_cells / 1e6:.3f} M)", flush=True)
    targs = to_torch_packed(chars, preds, sinks, nn, seqs, lens, dev)
    results = {}
    for label, fn, kernel in engines(L, args.skip_int16):
        reps = args.reps if kernel else max(1, min(args.reps, PLAIN_REPS))
        # the kernels' calls are queued ahead (device time alone); the plain
        # versions wait for the card inside, so they are timed as they run
        ms = time_call(lambda: fn(targs), dev, reps, queued=kernel)
        results[label] = ms
        print(f"[{label}] {ms:.4f} ms/call  {cells / ms / 1e6:.3f} GCUPS "
              f"({pad_cells / ms / 1e6:.3f} padded), {reps} reps",
              flush=True)
    for label, ms in results.items():
        print(f"[windows/s] {label}: {args.b / (ROUNDS * ms / 1e3):.1f} "
              f"windows/s on the per-round path (B={args.b}, {ROUNDS} "
              "rounds, this call only)", flush=True)
    return results


if __name__ == "__main__":
    main()
