"""K1 wrapper: the hand-written CUDA POA aligner (csrc/poa_align.cu).

`align_batch` has the contract of
svscope_tpu.ops.poa_pallas.align_batch_pallas on torch tensors.  CUDA
tensors go to the kernel; CPU tensors go to the plain torch version
(ops/poa_device.align_batch_reference).  There is no fallback between the
two: a kernel that fails to build or launch raises.

`LAUNCHES` counts kernel launches (the main path's proof that it ran the
kernel); the plain version never touches it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..utils.cuda_build import load_cuda_lib
from .poa_device import MAX_PREDS, align_batch_reference, pad_pred_slots

SOURCE = "poa_align.cu"
LAUNCHES = 0
_count_lock = threading.Lock()
_fn = None


def reset_launches() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES = 0


def plane_bytes(batch: int, n_max: int, l_max: int) -> int:
    """Device bytes of the kernel's two scratch planes for one call:
    H (B, N+1, L+1) int32 and directions (B, N, L+1) int8."""
    l1 = l_max + 1
    return batch * ((n_max + 1) * l1 * 4 + n_max * l1)


def _kernel():
    global _fn
    if _fn is None:
        fn = load_cuda_lib(SOURCE).poa_align_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 12 + [ci] * 5 + [vp]
        fn.restype = ci
        _fn = fn
    return _fn


def check_tensor(name, t, dtype, shape, device):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def align_batch_cuda(chars, preds, sinks, n_nodes, seqs, seq_lens,
                     l_max: int):
    """Launch the CUDA kernel on CUDA tensors (see align_batch)."""
    global LAUNCHES
    dev = chars.device
    if dev.type != "cuda":
        raise ValueError(f"align_batch_cuda needs CUDA tensors, got {dev}")
    B, N = chars.shape
    L = seqs.shape[1]
    if L > l_max:
        raise ValueError(f"seqs width {L} > l_max {l_max}")
    p8 = pad_pred_slots(preds).contiguous()
    sinks_u8 = sinks.to(torch.uint8).contiguous()
    check_tensor("chars", chars, torch.uint8, (B, N), dev)
    check_tensor("preds", p8, torch.int32, (B, N, MAX_PREDS), dev)
    check_tensor("sinks", sinks_u8, torch.uint8, (B, N), dev)
    check_tensor("n_nodes", n_nodes, torch.int32, (B,), dev)
    check_tensor("seqs", seqs, torch.uint8, (B, L), dev)
    check_tensor("seq_lens", seq_lens, torch.int32, (B,), dev)
    l1 = l_max + 1
    out_len = N + l_max
    H = torch.empty((B, N + 1, l1), dtype=torch.int32, device=dev)
    D = torch.empty((B, N, l1), dtype=torch.int8, device=dev)
    an = torch.empty((B, out_len), dtype=torch.int32, device=dev)
    asp = torch.empty((B, out_len), dtype=torch.int32, device=dev)
    k_end = torch.empty((B,), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    threads = min(1024, (l1 + 31) // 32 * 32)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(chars.data_ptr(), p8.data_ptr(), sinks_u8.data_ptr(),
                n_nodes.data_ptr(), seqs.data_ptr(), seq_lens.data_ptr(),
                H.data_ptr(), D.data_ptr(), an.data_ptr(), asp.data_ptr(),
                k_end.data_ptr(), score.data_ptr(), B, N, L, l_max, threads,
                stream)
    if rc != 0:
        raise RuntimeError(f"poa_align_launch failed: CUDA error {rc} "
                           f"(B={B}, N={N}, l_max={l_max})")
    with _count_lock:
        LAUNCHES += 1
    return an, asp, k_end, score


def align_batch(chars, preds, sinks, n_nodes, seqs, seq_lens, l_max: int):
    """Batched POA alignment of one read per window against that window's
    packed graph (contract of align_batch_pallas, on torch tensors).

    chars (B, N) uint8; preds (B, N, P<=8) int32; sinks (B, N) bool;
    n_nodes (B,) int32; seqs (B, L<=l_max) uint8; seq_lens (B,) int32.
    Returns (aln_nodes, aln_spos, k_end, score) on the inputs' device."""
    if chars.device.type == "cuda":
        return align_batch_cuda(chars, preds, sinks, n_nodes, seqs,
                                seq_lens, l_max)
    if chars.device.type == "cpu":
        return align_batch_reference(chars, preds, sinks, n_nodes, seqs,
                                     seq_lens, l_max)
    raise ValueError(f"unsupported device {chars.device}")
