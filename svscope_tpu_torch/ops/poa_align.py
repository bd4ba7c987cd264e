"""K1 wrapper: the hand-written CUDA POA aligner (csrc/poa_align.cu).

`align_batch` has the contract of
svscope_tpu.ops.poa_pallas.align_batch_pallas on torch tensors.  CUDA
tensors go to the kernel; CPU tensors go to the plain torch version
(ops/poa_device.align_batch_reference).  There is no fallback between the
two: a kernel that fails to build or launch raises.

`int16_mode=True` runs K1-int16 (the counterpart of
`align_batch_pallas(..., int16_mode=True)`): the H plane in int16, sentinel
NEG16, N and l_max at most 1024 (else ValueError, on every device, before
anything runs).  No call site of the port selects it but the kernel
measurement tools (svscope_tpu_torch/tools/): the JAX package's localGraph
path never picks it either.

`LAUNCHES` counts K1 launches and `LAUNCHES16` K1-int16 launches (the main
path's proof that it ran the kernel); the plain version touches neither.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..utils.cuda_build import load_cuda_lib
from .poa_device import (MAX_PREDS, align_batch_reference,
                         check_int16_shape, pad_pred_slots)

SOURCE = "poa_align.cu"
MAX_TILES = 4           # columns a thread (csrc/poa_row.cuh launch())
TARGET_THREADS = 320    # threads a CTA to aim at
RING_MAX = 16           # recent H rows in shared memory
SMEM_MAX = 232448       # dynamic shared memory of a block on the H100
LAUNCHES = 0
LAUNCHES16 = 0
_count_lock = threading.Lock()
_fns: dict[bool, object] = {}


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES16
    with _count_lock:
        LAUNCHES = 0
        LAUNCHES16 = 0


def plane_bytes(batch: int, n_max: int, l_max: int,
                int16_mode: bool = False) -> int:
    """Device bytes of the kernel's two scratch planes for one call:
    H (B, N+1, L+1) int32 (int16 in int16 mode) and directions (B, N, L+1)
    int8."""
    l1 = l_max + 1
    return batch * ((n_max + 1) * l1 * (2 if int16_mode else 4)
                    + n_max * l1)


def _kernel(int16_mode: bool):
    if int16_mode not in _fns:
        lib = load_cuda_lib(SOURCE)
        fn = lib.poa_align16_launch if int16_mode else lib.poa_align_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 12 + [ci] * 5 + [vp]
        fn.restype = ci
        _fns[int16_mode] = fn
    return _fns[int16_mode]


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


def launch_tiles(l_max: int) -> int:
    """Columns a thread of K1's CTA owns for reads padded to l_max: enough
    that the CTA has about TARGET_THREADS threads (a row costs each thread
    a fixed share, the scan and the barrier, plus a little per column), at
    most 3 unless 1024 threads need more, at most MAX_TILES.  ValueError
    past MAX_TILES * 1024 columns."""
    l1 = l_max + 1
    tiles = max(-(-l1 // 1024), min(3, -(-l1 // TARGET_THREADS)))
    if tiles > MAX_TILES:
        raise ValueError(f"l_max {l_max} > {MAX_TILES * 1024 - 1}, the "
                         "widest read K1 takes")
    return tiles


def launch_threads(l_max: int) -> int:
    """Threads of K1's CTA: the fewest whole warps whose launch_tiles
    contiguous columns each cover the l_max+1 columns."""
    return (-(-(l_max + 1) // launch_tiles(l_max)) + 31) // 32 * 32


def ring_rows(n_max: int, l_max: int, int16_mode: bool = False) -> int:
    """Recent H rows K1 keeps in shared memory: RING_MAX, halved until the
    CTA's shared memory fits SMEM_MAX (csrc/poa_row.cuh launch_tiles)."""
    ring = RING_MAX
    while ring > 1 and smem_bytes(n_max, l_max, ring, int16_mode) > SMEM_MAX:
        ring //= 2
    return ring


def smem_bytes(n_max: int, l_max: int, ring: int,
               int16_mode: bool = False) -> int:
    """Dynamic shared memory of K1's CTA: the ring of H rows, then per rank
    8 uint16 pred entries, 8 uint16 per-slot pred rows, the entry count,
    the node char and the sink flag (csrc/poa_row.cuh::smem_bytes)."""
    return ring * (l_max + 1) * (2 if int16_mode else 4) \
        + n_max * (2 * MAX_PREDS * 2 + 3)


def launch_with(fn, chars, preds, sinks, n_nodes, seqs, seq_lens,
                l_max: int, int16_mode: bool = False, extra=()):
    """Check the inputs, allocate the outputs and scratch planes, and call
    the C entry point `fn` (K1's signature, then `extra` pointers) on the
    current stream.  Returns (an, asp, k_end, score); raises on a launch
    error.  Counts nothing."""
    B, N = chars.shape
    if int16_mode:
        check_int16_shape(N, l_max)
    dev = chars.device
    if dev.type != "cuda":
        raise ValueError(f"align_batch_cuda needs CUDA tensors, got {dev}")
    L = seqs.shape[1]
    if L > l_max:
        raise ValueError(f"seqs width {L} > l_max {l_max}")
    threads = launch_threads(l_max)
    p8 = pad_pred_slots(preds).contiguous()
    if p8.data_ptr() % 16:             # the kernel reads a rank's slots as
        p8 = p8.clone()                # two 16-byte words
    sinks_u8 = sinks.to(torch.uint8).contiguous()
    check_tensor("chars", chars, torch.uint8, (B, N), dev)
    check_tensor("preds", p8, torch.int32, (B, N, MAX_PREDS), dev)
    check_tensor("sinks", sinks_u8, torch.uint8, (B, N), dev)
    check_tensor("n_nodes", n_nodes, torch.int32, (B,), dev)
    check_tensor("seqs", seqs, torch.uint8, (B, L), dev)
    check_tensor("seq_lens", seq_lens, torch.int32, (B,), dev)
    l1 = l_max + 1
    out_len = N + l_max
    H = torch.empty((B, N + 1, l1),
                    dtype=torch.int16 if int16_mode else torch.int32,
                    device=dev)
    D = torch.empty((B, N, l1), dtype=torch.int8, device=dev)
    an = torch.empty((B, out_len), dtype=torch.int32, device=dev)
    asp = torch.empty((B, out_len), dtype=torch.int32, device=dev)
    k_end = torch.empty((B,), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(chars.data_ptr(), p8.data_ptr(), sinks_u8.data_ptr(),
                n_nodes.data_ptr(), seqs.data_ptr(), seq_lens.data_ptr(),
                H.data_ptr(), D.data_ptr(), an.data_ptr(), asp.data_ptr(),
                k_end.data_ptr(), score.data_ptr(), B, N, L, l_max,
                threads, stream, *extra)
    if rc != 0:
        raise RuntimeError(f"poa_align{'16' if int16_mode else ''}_launch "
                           f"failed: CUDA error {rc} (B={B}, N={N}, "
                           f"l_max={l_max})")
    return an, asp, k_end, score


def align_batch_cuda(chars, preds, sinks, n_nodes, seqs, seq_lens,
                     l_max: int, int16_mode: bool = False):
    """Launch K1 (K1-int16 with int16_mode) on CUDA tensors (see
    align_batch)."""
    global LAUNCHES, LAUNCHES16
    if int16_mode:
        check_int16_shape(chars.shape[1], l_max)
    if chars.device.type != "cuda":
        raise ValueError(f"align_batch_cuda needs CUDA tensors, got "
                         f"{chars.device}")
    out = launch_with(_kernel(int16_mode), chars, preds, sinks, n_nodes,
                      seqs, seq_lens, l_max, int16_mode)
    with _count_lock:
        if int16_mode:
            LAUNCHES16 += 1
        else:
            LAUNCHES += 1
    return out


def align_batch(chars, preds, sinks, n_nodes, seqs, seq_lens, l_max: int,
                int16_mode: bool = False):
    """Batched POA alignment of one read per window against that window's
    packed graph (contract of align_batch_pallas, on torch tensors).

    chars (B, N) uint8; preds (B, N, P<=8) int32; sinks (B, N) bool;
    n_nodes (B,) int32; seqs (B, L<=l_max) uint8; seq_lens (B,) int32.
    Returns (aln_nodes, aln_spos, k_end, score) on the inputs' device."""
    if int16_mode:
        check_int16_shape(chars.shape[1], l_max)
    if chars.device.type == "cuda":
        return align_batch_cuda(chars, preds, sinks, n_nodes, seqs,
                                seq_lens, l_max, int16_mode)
    if chars.device.type == "cpu":
        return align_batch_reference(chars, preds, sinks, n_nodes, seqs,
                                     seq_lens, l_max, int16_mode)
    raise ValueError(f"unsupported device {chars.device}")
