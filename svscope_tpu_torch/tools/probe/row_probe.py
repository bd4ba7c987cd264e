"""Row probe: K1's per-row cost, one part at a time (counterpart of
tools/probe/row_probe.py, kernel csrc/probe_row.cu).

Each variant runs the same loop of NROWS = 512 rows over L1 = 513 columns
per window and returns the last row hN (B, L1) int32 that the JAX probe's
variant returns from the same inputs:

  loop      carried row + 1 per row (one block barrier per row on the card)
  store     + the row stored to an H plane in device memory
  pfx       + the row's prefix max (K1's block max-scan), floored at NEG
  chmask    + the row's node char, a load per row, added before the scan
  row       the full chain row (substitution, diag/up, gap chain,
            direction byte) + store

`row_probe` sends CUDA tensors to the kernel (one CTA per window, one
thread per column) and CPU tensors to the plain version
(`row_probe_reference`, built on cummax); `LAUNCHES` counts kernel
launches per variant.  On the card all B windows run in one wave, so one
call's time over NROWS is the time of one row.

    python -m svscope_tpu_torch.tools.probe.row_probe [variants ...]
        [--device cuda|cpu] [--reps 5]
"""
from __future__ import annotations

import argparse
import ctypes
import threading

import numpy as np
import torch

from ...ops.poa_align import check_tensor
from ...utils.cuda_build import load_cuda_lib
from ...utils.device import resolve_device
from ..timing import time_call

SOURCE = "probe_row.cu"
VARIANTS = ("loop", "store", "pfx", "chmask", "row")
W, NROWS, LM = 8, 512, 512          # W: windows per TPU grid step
L1 = LM + 1
B = 256                             # windows per call
NEG = -(2 ** 29)
GAP = -8
MATCH, MISMATCH = 5, -4
LIVE_COLS = 450                     # row 0: GAP * j up to column 450, NEG past

LAUNCHES = {v: 0 for v in VARIANTS}
_count_lock = threading.Lock()
_fns: dict[str, object] = {}


def reset_launches() -> None:
    with _count_lock:
        for v in LAUNCHES:
            LAUNCHES[v] = 0


def make_inputs(b: int, device="cpu", seed: int = 0):
    """The JAX probe's inputs: chars (b, NROWS) and seqs (b, L1) int32 in
    65..68, drawn in that order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    chars = rng.integers(65, 69, (b, NROWS)).astype(np.int32)
    seqs = rng.integers(65, 69, (b, L1)).astype(np.int32)
    return (torch.from_numpy(chars).to(device),
            torch.from_numpy(seqs).to(device))


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")


def row_probe_reference(chars, seqs, variant: str):
    """Plain torch version: hN (B, l1) int32 of `variant` (the H plane the
    kernel writes is scratch, not an output, so it keeps none)."""
    _check_variant(variant)
    B, nrows = chars.shape
    l1 = seqs.shape[1]
    dev = chars.device
    j = torch.arange(l1, dtype=torch.int32, device=dev)
    decay = GAP * j
    h = torch.where(j <= LIVE_COLS, decay, NEG).expand(B, l1).contiguous()
    for i in range(1, nrows + 1):
        if variant in ("loop", "store"):
            h = h + 1
        elif variant in ("pfx", "chmask"):
            x = h + (1 if variant == "pfx" else chars[:, i - 1:i])
            h = torch.cummax(x, dim=1).values.clamp(min=NEG)
        else:
            sub = torch.where(seqs == chars[:, i - 1:i], MATCH, MISMATCH)
            shifted = torch.nn.functional.pad(h[:, :-1], (1, 0), value=NEG)
            diag = torch.where(j >= 1, shifted + sub, NEG)
            up = h + GAP
            base = torch.where(j == 0, up, torch.maximum(diag, up))
            h = torch.cummax(base - decay, dim=1).values.clamp(min=NEG) \
                + decay
    return h.to(torch.int32)


def _kernel():
    if "k" not in _fns:
        fn = load_cuda_lib(SOURCE).row_probe_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        fn.restype = ci
        _fns["k"] = fn
    return _fns["k"]


def row_probe_cuda(chars, seqs, variant: str):
    """Launch the probe kernel of `variant` on CUDA tensors."""
    _check_variant(variant)
    dev = chars.device
    if dev.type != "cuda":
        raise ValueError(f"row_probe_cuda needs CUDA tensors, got {dev}")
    B, nrows = chars.shape
    l1 = seqs.shape[1]
    if l1 > 1024:
        raise ValueError(f"l1 {l1} > 1024 (one thread per column)")
    check_tensor("chars", chars, torch.int32, (B, nrows), dev)
    check_tensor("seqs", seqs, torch.int32, (B, l1), dev)
    out = torch.empty((B, l1), dtype=torch.int32, device=dev)
    H = None if variant == "loop" else torch.empty(
        (B, nrows + 1, l1), dtype=torch.int32, device=dev)
    D = torch.empty((B, nrows, l1), dtype=torch.int8, device=dev) \
        if variant == "row" else None
    threads = (l1 + 31) // 32 * 32
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(chars.data_ptr(), seqs.data_ptr(),
                0 if H is None else H.data_ptr(),
                0 if D is None else D.data_ptr(), out.data_ptr(), B, nrows,
                l1, threads, VARIANTS.index(variant), stream)
    if rc != 0:
        raise RuntimeError(f"row_probe_launch failed: CUDA error {rc} "
                           f"(variant {variant}, B={B})")
    with _count_lock:
        LAUNCHES[variant] += 1
    return out


def row_probe(chars, seqs, variant: str):
    """hN of `variant`: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if chars.device.type == "cuda":
        return row_probe_cuda(chars, seqs, variant)
    if chars.device.type == "cpu":
        return row_probe_reference(chars, seqs, variant)
    raise ValueError(f"unsupported device {chars.device}")


def main(argv=None) -> dict:
    """Run the probe; returns {variant: {ms, plain_ms, max_abs_err}}.  Each
    variant's first call is checked against the plain version; a
    difference raises."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    chars, seqs = make_inputs(B, dev)
    print(f"row probe on {dev}: B={B} windows, {NROWS} rows x {L1} "
          "columns" + ("" if dev.type == "cuda" else
                       " (cpu: the plain version)"), flush=True)
    res = {}
    for v in args.variants:
        got = row_probe(chars, seqs, v)
        plain = row_probe_reference(chars, seqs, v)
        err = int((got.long() - plain.long()).abs().max())
        if err:
            raise RuntimeError(f"row probe {v}: kernel != plain (max abs "
                               f"error {err})")
        ms = time_call(lambda: row_probe(chars, seqs, v), dev, args.reps,
                       queued=True)
        p_ms = time_call(lambda: row_probe_reference(chars, seqs, v), dev, 1,
                         queued=False)
        res[v] = {"ms": ms, "plain_ms": p_ms, "max_abs_err": err}
        print(f"{v:8s}: {ms:.4f} ms/call, {ms * 1e3 / NROWS:.4f} us/row; "
              f"plain {p_ms:.4f} ms/call; kernel == plain", flush=True)
    return res


if __name__ == "__main__":
    main()
