"""In-framework genomic interval algebra.

Replaces the reference's `bedtools merge/intersect`, GNU `sort`, `awk` and
`grep` subprocess fan-out (reference: src/WindowSelection_v8.py:464-469,
502-556, 619-625; src/SVscope.py:335-338) with vectorized NumPy over sorted
interval tables.  All functions operate on per-chromosome (start, end) arrays
or on "interval tables": dicts chrom -> (starts, ends, payload-index).

Semantics follow bedtools:
  * merge -d D: intervals whose gap <= D are merged (bedtools merges
    book-ended intervals at d=0; an interval starting exactly at prev_end+D
    is merged).
  * intersect: half-open [start, end) overlap, overlap length
    min(e1,e2)-max(s1,s2) > 0.
  * intersect -f F -r: reciprocal fraction-of-overlap filter.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

CHROM_ORDER = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY", "chrM"]
_CHROM_RANK = {c: i for i, c in enumerate(CHROM_ORDER)}


def chrom_sort_key(chrom: str):
    """Sort chromosomes in lexicographic order (matching GNU `sort -k1,1`)."""
    return chrom


def sort_bed_rows(rows: Sequence[tuple]) -> list:
    """Sort rows of (chrom, start, ...) like `sort -k1,1 -k2,2n`."""
    return sorted(rows, key=lambda r: (str(r[0]), int(r[1])))


def merge(starts: np.ndarray, ends: np.ndarray, dist: int = 0):
    """Merge sorted-or-unsorted intervals on one chromosome.

    Returns (mstarts, mends, group_id) where group_id[i] gives the merged
    cluster index of input interval i (after sorting by start).  Mirrors
    `bedtools merge -d dist`.
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    if starts.size == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.int64), np.empty(0, np.intp))
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    # running maximum of end, exclusive of current
    run_end = np.maximum.accumulate(e)
    new_cluster = np.ones(s.size, dtype=bool)
    new_cluster[1:] = s[1:] > run_end[:-1] + dist
    gid = np.cumsum(new_cluster) - 1
    n = int(gid[-1]) + 1
    mstarts = np.full(n, np.iinfo(np.int64).max, np.int64)
    mends = np.zeros(n, np.int64)
    np.minimum.at(mstarts, gid, s)
    np.maximum.at(mends, gid, e)
    return mstarts, mends, gid, order


def overlap_pairs(a_starts, a_ends, b_starts, b_ends):
    """All-pairs overlap between two interval sets on one chromosome.

    Returns (ai, bi, ov_len) index arrays of overlapping pairs with
    ov_len = min(ae,be) - max(as,bs) > 0.  O((n+m) log + pairs) sweep.
    """
    a_starts = np.asarray(a_starts, np.int64); a_ends = np.asarray(a_ends, np.int64)
    b_starts = np.asarray(b_starts, np.int64); b_ends = np.asarray(b_ends, np.int64)
    if a_starts.size == 0 or b_starts.size == 0:
        z = np.empty(0, np.intp)
        return z, z, np.empty(0, np.int64)
    bo = np.argsort(b_starts, kind="stable")
    bs, be = b_starts[bo], b_ends[bo]
    # candidates for a: bs < ae (prefix in start order) AND be > as.  The
    # prefix is bounded below via the running max of be (monotone), so the
    # scanned span is ~output-sized for genomic interval sets instead of
    # O(n_a * n_b)
    hi = np.searchsorted(bs, a_ends, side="left")
    cummax_be = np.maximum.accumulate(be)
    lo = np.minimum(np.searchsorted(cummax_be, a_starts, side="right"), hi)
    lens = hi - lo
    tot = int(lens.sum())
    ai_all = np.repeat(np.arange(a_starts.size, dtype=np.intp), lens)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = (np.arange(tot, dtype=np.int64) - np.repeat(off, lens)
            + np.repeat(lo, lens))
    keep = be[flat] > a_starts[ai_all]
    ai_out = [ai_all[keep]]
    bi_out = [bo[flat[keep]].astype(np.intp)]
    if tot == 0 or not keep.any():
        z = np.empty(0, np.intp)
        return z, z, np.empty(0, np.int64)
    ai = np.concatenate(ai_out)
    bi = np.concatenate(bi_out)
    ov = np.minimum(a_ends[ai], b_ends[bi]) - np.maximum(a_starts[ai], b_starts[bi])
    return ai, bi, ov


def reciprocal_filter(a_starts, a_ends, b_starts, b_ends, ai, bi, ov, frac):
    """Keep overlap pairs meeting `bedtools intersect -f frac -r`."""
    alen = np.maximum(a_ends[ai] - a_starts[ai], 1)
    blen = np.maximum(b_ends[bi] - b_starts[bi], 1)
    keep = (ov >= frac * alen) & (ov >= frac * blen)
    return ai[keep], bi[keep], ov[keep]


def any_overlap_mask(a_starts, a_ends, b_starts, b_ends, frac: float | None = None,
                     reciprocal: bool = False):
    """Boolean mask over A of intervals overlapping any B interval.

    frac/reciprocal mirror `bedtools intersect -f frac [-r]`.
    """
    a_starts = np.asarray(a_starts, np.int64); a_ends = np.asarray(a_ends, np.int64)
    ai, bi, ov = overlap_pairs(a_starts, a_ends, b_starts, b_ends)
    if frac is not None:
        if reciprocal:
            ai, bi, ov = reciprocal_filter(a_starts, a_ends,
                                           np.asarray(b_starts, np.int64),
                                           np.asarray(b_ends, np.int64), ai, bi, ov, frac)
        else:
            alen = np.maximum(a_ends[ai] - a_starts[ai], 1)
            keep = ov >= frac * alen
            ai = ai[keep]
    mask = np.zeros(a_starts.size, dtype=bool)
    mask[ai] = True
    return mask


def coverage_length(win_start: int, win_end: int, starts, ends) -> int:
    """Sum of per-interval overlap with [win_start, win_end) (no flattening).

    Mirrors the reference's OVLEN accumulation (src/DataScanner.py:413-425,
    449-451): read coverage is summed per read without merging overlaps.
    """
    starts = np.asarray(starts, np.int64); ends = np.asarray(ends, np.int64)
    ov = np.minimum(ends, win_end) - np.maximum(starts, win_start)
    return int(np.clip(ov, 0, None).sum())
