"""int16 op probe: the int16 op set that a packed int16 K1 would use, one
small kernel per op (counterpart of tools/probe/int16_mosaic_probe.py,
kernel csrc/probe_int16.cu).

The JAX probe's five ops on its (16, 128) int16 inputs (x = iota % 100,
y = x reversed along the row):

  eq16        where(x == y, x, y)
  le16        where(x <= y, x, y)
  max16       max(x, y)
  roll16      x rolled by one column along each row
  where_i32m  where(col >= 3, x, y), the mask born from an int32 index

and the packed s16x2 intrinsics a K1-int16 with two columns per 32-bit
register would use, on the same arrays read as neighbouring pairs (z a
third input):

  vmaxs2          __vmaxs2: per-halfword max(x, y)
  vimax3_s16x2    __vimax3_s16x2 (DPX): max(x, y, z)
  viaddmax_s16x2  __viaddmax_s16x2 (DPX): max(x + y, z)

Each op's kernel output is held against its plain torch version and
printed `OK` or `FAIL`, as the JAX probe prints them; then every op is
timed on large arrays (rows x 128), beside its plain version and, for
max16 and roll16, the one PyTorch call that computes it (torch.maximum,
torch.roll).  A FAIL makes the tool exit non-zero.  `LAUNCHES` counts
kernel launches per op; CPU tensors take the plain versions.

    python -m svscope_tpu_torch.tools.probe.int16_probe [--device cuda|cpu]
        [--rows 262144] [--reps 20]
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import threading

import numpy as np
import torch

from ...ops.poa_align import check_tensor
from ...utils.cuda_build import load_cuda_lib
from ...utils.device import resolve_device
from ..timing import time_call

SOURCE = "probe_int16.cu"
OPS = ("eq16", "le16", "max16", "roll16", "where_i32m")   # the JAX probe's
DPX_OPS = ("vmaxs2", "vimax3_s16x2", "viaddmax_s16x2")
ALL_OPS = OPS + DPX_OPS
WIDTH = 128
SMALL_ROWS = 16
# large inputs lie in [-LIM, LIM): x + y cannot leave int16, so wrapping
# and saturating adds agree
LIM = 16000
N_INPUTS = {"roll16": 1, "vimax3_s16x2": 3, "viaddmax_s16x2": 3}
# the one PyTorch call computing the same function, where there is one
LIBRARY = {"max16": lambda x, y, z: torch.maximum(x, y),
           "roll16": lambda x, y, z: torch.roll(x, 1, 1)}

LAUNCHES = {op: 0 for op in ALL_OPS}
_count_lock = threading.Lock()
_fns: dict[str, object] = {}


def reset_launches() -> None:
    with _count_lock:
        for op in LAUNCHES:
            LAUNCHES[op] = 0


def probe_inputs(device="cpu"):
    """The JAX probe's (16, 128) x and y, and z for the three-input ops."""
    x = np.arange(SMALL_ROWS * WIDTH, dtype=np.int16).reshape(
        SMALL_ROWS, WIDTH) % 100
    y = x[:, ::-1].copy()
    z = (np.arange(SMALL_ROWS * WIDTH).reshape(SMALL_ROWS, WIDTH) * 7 % 211
         - 100).astype(np.int16)
    return tuple(torch.from_numpy(a).to(device) for a in (x, y, z))


def large_inputs(rows: int, device="cpu", seed: int = 0):
    """x, y, z (rows, 128) int16 in [-LIM, LIM) from default_rng(seed)."""
    a = np.random.default_rng(seed).integers(-LIM, LIM, (3, rows, WIDTH),
                                             dtype=np.int16)
    return tuple(torch.from_numpy(a[i]).to(device) for i in range(3))


def _check_op(op: str) -> None:
    if op not in ALL_OPS:
        raise ValueError(f"op {op!r}: one of {ALL_OPS}")


def int16_op_reference(op: str, x, y, z):
    """Plain torch version of `op` on (rows, 128) int16 tensors."""
    _check_op(op)
    if op == "eq16":
        return torch.where(x == y, x, y)
    if op == "le16":
        return torch.where(x <= y, x, y)
    if op in ("max16", "vmaxs2"):
        return torch.where(x >= y, x, y)
    if op == "roll16":
        return torch.cat([x[:, -1:], x[:, :-1]], dim=1)
    if op == "where_i32m":
        col = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        return torch.where(col >= 3, x, y)
    m = torch.where(x >= y, x, y) if op == "vimax3_s16x2" else x + y
    return torch.where(m >= z, m, z)


def _kernel():
    if "k" not in _fns:
        fn = load_cuda_lib(SOURCE).int16_probe_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ctypes.c_longlong, ci, ci, vp]
        fn.restype = ci
        _fns["k"] = fn
    return _fns["k"]


def int16_op_cuda(op: str, x, y, z):
    """Launch the probe kernel of `op` on CUDA tensors."""
    _check_op(op)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"int16_op_cuda needs CUDA tensors, got {dev}")
    rows, width = x.shape
    if width % 2:
        raise ValueError(f"row width {width} must be even (s16x2 pairs)")
    for name, t in (("x", x), ("y", y), ("z", z)):
        check_tensor(name, t, torch.int16, (rows, width), dev)
    out = torch.empty_like(x)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(),
                x.numel(), width, ALL_OPS.index(op), stream)
    if rc != 0:
        raise RuntimeError(f"int16_probe_launch failed: CUDA error {rc} "
                           f"(op {op})")
    with _count_lock:
        LAUNCHES[op] += 1
    return out


def int16_op(op: str, x, y, z):
    """`op` on (rows, 128) int16 tensors: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if x.device.type == "cuda":
        return int16_op_cuda(op, x, y, z)
    if x.device.type == "cpu":
        return int16_op_reference(op, x, y, z)
    raise ValueError(f"unsupported device {x.device}")


def op_bytes(op: str, rows: int) -> int:
    """Bytes the op must move: each input read once, the output written."""
    return (N_INPUTS.get(op, 2) + 1) * rows * WIDTH * 2


def main(argv=None) -> dict:
    """Run the probe; returns {op: {ok, max_abs_err, ms, plain_ms,
    library_ms}} (times None for an op that failed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=262144)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"int16 probe on {dev}" + (
        f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
        else " (cpu: the plain versions)"), flush=True)
    small = probe_inputs(dev)
    res = {}
    for op in ALL_OPS:
        try:
            got = int16_op(op, *small)
            err = int((got.int() - int16_op_reference(op, *small).int())
                      .abs().max())
            msg = "" if err == 0 else f"kernel != plain (max abs error {err})"
        except (RuntimeError, ValueError) as exc:
            err, msg = None, f"{type(exc).__name__}: {exc}"
        res[op] = {"ok": not msg, "max_abs_err": err, "ms": None,
                   "plain_ms": None, "library_ms": None}
        print(f"{op:16s} OK" if not msg else f"{op:16s} FAIL: {msg[-90:]}",
              flush=True)
    big = large_inputs(args.rows, dev)
    print(f"timing on ({args.rows}, {WIDTH}) int16 arrays, {args.reps} reps",
          flush=True)
    for op in ALL_OPS:
        r = res[op]
        if not r["ok"]:
            continue
        err = int((int16_op(op, *big).int()
                   - int16_op_reference(op, *big).int()).abs().max())
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if err:
            r["ok"] = False
            print(f"{op:16s} FAIL: kernel != plain on the large arrays "
                  f"(max abs error {err})", flush=True)
            continue
        r["ms"] = time_call(lambda: int16_op(op, *big), dev, args.reps,
                            queued=True)
        r["plain_ms"] = time_call(lambda: int16_op_reference(op, *big), dev,
                                  args.reps, queued=False)
        lib = LIBRARY.get(op)
        if lib is not None:
            r["library_ms"] = time_call(lambda: lib(*big), dev, args.reps,
                                        queued=True)
        gbs = op_bytes(op, args.rows) / r["ms"] / 1e6
        print(f"{op:16s} {r['ms']:.4f} ms ({gbs:.1f} GB/s), plain "
              f"{r['plain_ms']:.4f} ms" + (
                  f", {'torch.maximum' if op == 'max16' else 'torch.roll'} "
                  f"{r['library_ms']:.4f} ms" if lib else ""), flush=True)
    if all(r["ok"] for r in res.values()):
        print("\nALL OK: every int16 op and packed s16x2 intrinsic equals its "
              "plain version on this device", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main().values()) else 1)
