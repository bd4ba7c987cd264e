"""K1's time split into its parts, from clock64() stamps in the kernel.

Builds csrc/poa_align.cu a second time with -DPOA_ALIGN_SPLIT, which keeps
the kernel as it is and adds thread 0's clock64() stamps at the end of
each part of a CTA's run (PARTS, in order; a part the kernel does not have
reads 0), written per CTA by the entry point `poa_align_split_launch`.
A barrier belongs to the part it ends, so a part counts thread 0's wait
for the slowest thread too.  Per workload it prints each part's share of
the CTAs' cycles and its cycles and microseconds per row (a CTA's cycles
over its window's own rows, averaged over the CTAs; microseconds at the
H100 SXM's 1.98 GHz boost clock), K1's own time (calls queued ahead of the
device, tools/timing.py) and the stamped build's, and checks that the
stamped build's outputs equal K1's.

Workloads: `attached`, the per-round bench batch of attached_bench
(B=64, N=L=512); `heavy`, the heavy tier's call at (B, N, L) =
(32, 1024, 512) (workloads.heavy_round_workload).

    python -m svscope_tpu_torch.tools.k1_split [--workload attached heavy]
        [--reps 20]

Needs the card: the stamps exist only in the kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..ops import poa_align
from ..ops.poa_device import to_torch_packed
from ..utils.cuda_build import load_cuda_lib
from ..utils.device import resolve_device
from .attached_bench import build_round_workload
from .timing import time_call
from .workloads import heavy_round_workload

PARTS = ("prologue", "pred setup", "pred max", "scan", "direction",
         "traceback")
DEFINES = ("POA_ALIGN_SPLIT",)
SM_HZ = 1.98e9
_fn = None


def _split_kernel():
    global _fn
    if _fn is None:
        fn = load_cuda_lib(poa_align.SOURCE, DEFINES).poa_align_split_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 12 + [ci] * 5 + [vp, vp]
        fn.restype = ci
        _fn = fn
    return _fn


def workload(name: str):
    """(chars, preds, sinks, n_nodes, seqs, seq_lens, L) numpy arrays."""
    if name == "attached":
        *arrs, _n, L = build_round_workload(64, np.random.default_rng(0))
        return (*arrs, L)
    if name == "heavy":
        return (*heavy_round_workload(), 512)
    raise ValueError(f"unknown workload {name!r}")


def split_run(args, L: int):
    """One launch of the stamped build on CUDA tensors `args`: its outputs
    and the (B, len(PARTS)) cycles per CTA as int64 numpy."""
    B = args[0].shape[0]
    split = torch.zeros((B, len(PARTS)), dtype=torch.int64,
                        device=args[0].device)
    out = poa_align.launch_with(_split_kernel(), *args, L,
                                extra=(split.data_ptr(),))
    torch.cuda.synchronize()
    return out, split.cpu().numpy()


def measure(name: str, dev, reps: int) -> dict:
    chars, preds, sinks, nn, seqs, lens, L = workload(name)
    args = to_torch_packed(chars, preds, sinks, nn, seqs, lens, dev)
    want = [t.cpu() for t in poa_align.align_batch_cuda(*args, L)]
    got, cyc = split_run(args, L)
    if any(not torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise RuntimeError(f"{name}: the stamped build's outputs differ "
                           "from K1's")
    k_ms = time_call(lambda: poa_align.align_batch_cuda(*args, L), dev,
                     reps, queued=True)
    s_ms = time_call(lambda: split_run(args, L), dev, 3, queued=False)
    rows = np.maximum(nn.astype(np.float64), 1)[:, None]
    per_row = (cyc / rows).mean(0)
    total = cyc.sum(1).astype(np.float64)
    share = (cyc / total[:, None]).mean(0)
    res = {"workload": name, "B": int(len(nn)), "N": int(chars.shape[1]),
           "L": int(L), "mean_rows": float(nn.mean()),
           "kernel_ms": k_ms, "stamped_ms": s_ms,
           "cycles_per_cta": float(total.mean()),
           "parts": {p: {"share": float(share[k]),
                         "cycles_per_row": float(per_row[k]),
                         "us_per_row": float(per_row[k] / SM_HZ * 1e6)}
                     for k, p in enumerate(PARTS)}}
    print(f"[{name}] B={res['B']} N={res['N']} L={L} rows {nn.mean():.1f}: "
          f"K1 {k_ms:.4f} ms, stamped build {s_ms:.4f} ms, "
          f"{total.mean():.0f} cycles per CTA; " + ", ".join(
              f"{p} {v['share'] * 100:.1f} % ({v['us_per_row']:.4f} us/row)"
              for p, v in res["parts"].items()), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", default=["attached", "heavy"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    out = {w: measure(w, dev, args.reps) for w in args.workload}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
