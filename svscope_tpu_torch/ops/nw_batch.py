"""Batched global-alignment statistics on the device — the MisScore and
edit-distance entry points (counterpart of svscope_tpu/ops/nw_batch.py).

Pairs are grouped by length bucket (128 ... 4096); each bucket is one
upload and one K2 launch (ops/nw_kernel.nw_stats: the CUDA kernel on a
CUDA device, its plain torch version on the CPU), and one device-to-host
copy fetches every bucket's results.  `misscore_batch` sends a pair longer
than the largest bucket to the host DP (ops/nw.nw_align_stats), as the JAX
package does, and counts it in `COUNTS["host_dp_pairs"]`;
`edit_distance_batch` refuses such a pair.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..utils.device import resolve_device
from .nw import GAP, MATCH, MISMATCH, nw_align_stats
from .nw_kernel import nw_stats

L_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
COUNTS = {"host_dp_pairs": 0}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        COUNTS["host_dp_pairs"] = 0


def nw_stats_batch(a_codes, b_codes, la, lb, l_max: int, match: int = MATCH,
                   mismatch: int = MISMATCH, gap: int = GAP, device="cuda"):
    """(scores, matches, align_lens) int32 tensors on `device` for padded
    pairs: a_codes/b_codes (B, l_max) uint8 ascii, la/lb (B,) true lengths
    (numpy arrays or tensors)."""
    dev = resolve_device(device)
    a = torch.as_tensor(a_codes, dtype=torch.uint8).to(dev).contiguous()
    b = torch.as_tensor(b_codes, dtype=torch.uint8).to(dev).contiguous()
    la = torch.as_tensor(la).to(dev, torch.int32).contiguous()
    lb = torch.as_tensor(lb).to(dev, torch.int32).contiguous()
    return nw_stats(a, b, la, lb, l_max, match, mismatch, gap)


def bucket_of(length: int):
    """Smallest bucket holding `length`, None past the largest."""
    return next((x for x in L_BUCKETS if length <= x), None)


def _bucket_stats(pairs, groups, scoring, dev):
    """(matches, align_len, score) int64 numpy (3, len(pairs)) of the
    grouped pairs: one upload and one launch per bucket, one device-to-host
    copy for all buckets.  Pairs outside `groups` keep 0."""
    out = np.zeros((3, len(pairs)), np.int64)
    pending = []
    for lbk, idxs in groups.items():
        n = len(idxs)
        codes = np.zeros((2, n, lbk), np.uint8)
        lens = np.zeros((2, n), np.int32)
        for k, i in enumerate(idxs):
            a, b = pairs[i]
            codes[0, k, :len(a)] = np.frombuffer(a.encode(), np.uint8)
            codes[1, k, :len(b)] = np.frombuffer(b.encode(), np.uint8)
            lens[:, k] = len(a), len(b)
        dc = torch.from_numpy(codes).to(dev)
        dl = torch.from_numpy(lens).to(dev)
        s, m, al = nw_stats(dc[0], dc[1], dl[0], dl[1], lbk, *scoring)
        pending.append((idxs, torch.stack([m, al, s])))
    if pending:
        fetched = torch.cat([t for _, t in pending], 1).cpu().numpy()
        off = 0
        for idxs, t in pending:
            out[:, idxs] = fetched[:, off:off + len(idxs)]
            off += len(idxs)
    return out


def misscore_batch(pairs: list[tuple[str, str]], device="cuda"):
    """MisScores (align_len - matches under (1, 0, -1)) of (som, germ)
    pairs through K2 on `device`; a pair longer than the largest bucket
    goes to the host DP and is counted in COUNTS["host_dp_pairs"]."""
    dev = resolve_device(device)
    out = np.zeros(len(pairs), np.int64)
    groups: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(pairs):
        lbk = bucket_of(max(len(a), len(b)))
        if lbk is None:
            _, m, al = nw_align_stats(a, b)
            out[i] = al - m
            with _count_lock:
                COUNTS["host_dp_pairs"] += 1
        else:
            groups.setdefault(lbk, []).append(i)
    m, al, _s = _bucket_stats(pairs, groups, (MATCH, MISMATCH, GAP), dev)
    sel = [i for idxs in groups.values() for i in idxs]
    out[sel] = al[sel] - m[sel]
    return out


def edit_distance_batch(pairs: list[tuple[str, str]], device="cuda"):
    """Levenshtein distances via K2 with unit costs: maximising (match 0,
    mismatch -1, gap -1) makes distance = -score."""
    dev = resolve_device(device)
    groups: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(pairs):
        lbk = bucket_of(max(len(a), len(b), 1))
        if lbk is None:
            raise ValueError(f"pair {i} longer than {L_BUCKETS[-1]}")
        groups.setdefault(lbk, []).append(i)
    _m, _al, s = _bucket_stats(pairs, groups, (0, -1, -1), dev)
    return -s


def pairwise_edit_distance_matrix(seqs: list[str], device="cuda"
                                  ) -> np.ndarray:
    """Symmetric read-vs-read Levenshtein matrix on `device`."""
    n = len(seqs)
    iu, ju = np.triu_indices(n, 1)
    pairs = [(seqs[i], seqs[j]) for i, j in zip(iu, ju)]
    out = np.zeros((n, n), np.int64)
    if pairs:
        d = edit_distance_batch(pairs, device=device)
        out[iu, ju] = d
        out[ju, iu] = d
    return out
