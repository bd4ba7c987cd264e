"""K2: batched global-alignment statistics — the hand-written CUDA kernel
(csrc/nw_stats.cu), its plain torch version and the dispatcher.

`nw_stats` has the contract of svscope_tpu.ops.nw_batch.nw_stats_batch
(and of the TPU kernel svscope_tpu.ops.nw_pallas.nw_stats_pallas, which
fixes the scoring at (1, 0, -1)) on torch tensors: for padded pairs it
returns the (score, matches, align_len) of the one optimal global
alignment that the traceback preference diag > up > left picks.  CUDA
tensors go to the kernel; CPU tensors go to `nw_stats_reference`.  There
is no fallback between the two: a kernel that fails to build or launch
raises.

`LAUNCHES` counts kernel launches (the main path's proof that it ran the
kernel); the plain version never touches it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..utils.cuda_build import load_cuda_lib
from .nw import GAP, MATCH, MISMATCH
from .poa_align import check_tensor

SOURCE = "nw_stats.cu"
MAX_LEN = 32767         # K2 packs (M, A) as M << 16 | A: la + lb < 65536
LPT_MIN = 1024          # buckets whose pairs run longest first
NEG = -(2 ** 29)
LAUNCHES = 0
_count_lock = threading.Lock()
_fn = None


def reset_launches() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = load_cuda_lib(SOURCE).nw_stats_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [ci] * 6 + [vp]
        fn.restype = ci
        _fn = fn
    return _fn


def launch_config(l_max: int) -> tuple[int, int, bool]:
    """(rows a lane R, bands of the longest pair, longest pairs first) of K2
    for pairs padded to l_max: a warp per pair sweeps bands of 32 x R rows
    of `a`; R = 4, 8, 16 keeps the 128, 256 and 512 buckets in one band and
    the longer ones in bands of 512 rows; from LPT_MIN on, the pairs run
    longest first (csrc/nw_stats.cu)."""
    rows = 4 if l_max <= 128 else 8 if l_max <= 256 else 16
    return rows, max(1, -(-l_max // (32 * rows))), l_max >= LPT_MIN


def scratch_shape(batch: int, l_max: int) -> tuple[int, ...] | None:
    """Shape of K2's boundary-row buffer, (B, l_max+1, 2) int32 = one
    (H, M << 16 | A) per column and pair, or None where no pair can have a
    second band."""
    _rows, bands, _lpt = launch_config(l_max)
    return (batch, l_max + 1, 2) if bands > 1 else None


def nw_stats_reference(a_codes, b_codes, la, lb, l_max: int,
                       match: int = MATCH, mismatch: int = MISMATCH,
                       gap: int = GAP):
    """Plain torch version of K2: svscope_tpu/ops/nw_batch.py::_row_scan
    batched over pairs.  Row i (a Python loop) is vectorised over pairs and
    columns: the in-row gap chain H[j] = max(base[j], H[j-1] + gap) is
    `cummax(base - gap*j) + gap*j`, left runs copy (M, A) from their head
    found by a cummax over the non-left column indices.  Rows i >= la keep
    the previous row.  Lengths are clamped to [0, l_max], as in the kernel.

    a_codes/b_codes (B, l_max) uint8; la/lb (B,) int.  Returns int32 (B,)
    (score, matches, align_len) on the inputs' device."""
    dev = a_codes.device
    B = a_codes.shape[0]
    la = la.to(torch.int64).clamp(0, l_max)
    lb = lb.to(torch.int64).clamp(0, l_max)
    j = torch.arange(l_max + 1, dtype=torch.int64, device=dev)
    lbv = lb[:, None]
    jvalid = j[None, 1:] <= lbv                                  # (B, l_max)
    H = torch.where(j[None] <= lbv, gap * j, NEG).to(torch.int32)
    M = torch.zeros((B, l_max + 1), dtype=torch.int32, device=dev)
    A = torch.where(j[None] <= lbv, j, 0).to(torch.int32)
    decay = (gap * j).to(torch.int32)
    zero = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    false = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    n_rows = int(la.max()) if B else 0
    for i in range(n_rows):
        eq = b_codes == a_codes[:, i:i + 1]
        sub = torch.where(eq, match, mismatch).to(torch.int32)
        diag = torch.where(jvalid, H[:, :-1] + sub, NEG)
        up = H[:, 1:] + gap
        base = torch.cat([H[:, :1] + gap, torch.maximum(diag, up)], 1)
        Hn = torch.cummax(base - decay, 1).values + decay
        diag_sel = torch.cat([false, (Hn[:, 1:] == diag) & jvalid], 1)
        up_sel = torch.cat([~false, ~diag_sel[:, 1:] & (Hn[:, 1:] == up)], 1)
        left = ~(diag_sel | up_sel)
        head = torch.cummax(torch.where(left, -1, j[None]), 1).values
        M_cand = torch.where(diag_sel,
                             torch.cat([zero, M[:, :-1] + eq.to(torch.int32)],
                                       1), M)
        A_cand = torch.where(diag_sel, torch.cat([zero, A[:, :-1] + 1], 1),
                             A + 1)
        Mn = M_cand.gather(1, head)
        An = A_cand.gather(1, head) + (j[None] - head).to(torch.int32)
        ok = (i < la)[:, None]
        H = torch.where(ok, Hn, H)
        M = torch.where(ok, Mn, M)
        A = torch.where(ok, An, A)
    return H.gather(1, lbv)[:, 0], M.gather(1, lbv)[:, 0], \
        A.gather(1, lbv)[:, 0]


def nw_stats_cuda(a_codes, b_codes, la, lb, l_max: int, match: int = MATCH,
                  mismatch: int = MISMATCH, gap: int = GAP):
    """Launch the CUDA kernel on CUDA tensors (see nw_stats)."""
    global LAUNCHES
    dev = a_codes.device
    if dev.type != "cuda":
        raise ValueError(f"nw_stats_cuda needs CUDA tensors, got {dev}")
    if l_max > MAX_LEN:
        raise ValueError(f"l_max {l_max} > {MAX_LEN}, the longest pair K2 "
                         "takes")
    B = a_codes.shape[0]
    check_tensor("a_codes", a_codes, torch.uint8, (B, l_max), dev)
    check_tensor("b_codes", b_codes, torch.uint8, (B, l_max), dev)
    check_tensor("la", la, torch.int32, (B,), dev)
    check_tensor("lb", lb, torch.int32, (B,), dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out[0], out[1], out[2]
    rows, _bands, lpt = launch_config(l_max)
    shape = scratch_shape(B, l_max)
    scratch = None if shape is None else torch.empty(shape,
                                                     dtype=torch.int32,
                                                     device=dev)
    order = torch.argsort(la.long() * lb.long(), descending=True).to(
        torch.int32) if lpt else None
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a_codes.data_ptr(), b_codes.data_ptr(), la.data_ptr(),
                lb.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                None if order is None else order.data_ptr(), B, l_max, match,
                mismatch, gap, rows, stream)
    if rc != 0:
        raise RuntimeError(f"nw_stats_launch failed: CUDA error {rc} "
                           f"(B={B}, l_max={l_max})")
    with _count_lock:
        LAUNCHES += 1
    return out[0], out[1], out[2]


def nw_stats(a_codes, b_codes, la, lb, l_max: int, match: int = MATCH,
             mismatch: int = MISMATCH, gap: int = GAP):
    """(scores, matches, align_lens) int32 (B,) for padded pairs, on the
    inputs' device: a_codes/b_codes (B, l_max) uint8 ascii, la/lb (B,)
    int32 true lengths."""
    if a_codes.device.type == "cuda":
        return nw_stats_cuda(a_codes, b_codes, la, lb, l_max, match,
                             mismatch, gap)
    if a_codes.device.type == "cpu":
        return nw_stats_reference(a_codes, b_codes, la, lb, l_max, match,
                                  mismatch, gap)
    raise ValueError(f"unsupported device {a_codes.device}")
