"""Stage A and the consensus of the reference, in NumPy alone (the worker
processes import only this): the entry gates, the MSA, the feature
columns (src/DataScanner.py:146-220, src/DecisionMaker.py:126-134), and
one cluster's consensus."""
from __future__ import annotations

import numpy as np

from .poa import poa

ALPHABET = "ATCG-"          # codes 0..4 (src/DataScanner.py:125)
GAP = 4
_ENC = np.full(256, -1, np.int8)
for _i, _c in enumerate(ALPHABET):
    _ENC[ord(_c)] = _i


def tags_of(read_ids) -> np.ndarray:
    """Sample tag per read: "<sample>_<tag>|<name>" -> tag."""
    return np.array([x.split("|")[0].split("_")[-1] for x in read_ids])


def passes_gates(n_seqs: int, tags: np.ndarray) -> bool:
    """More than 3 sequences, both tags, each on 3 reads or more."""
    if tags.size == 0:
        return False
    uniq, cnt = np.unique(tags, return_counts=True)
    return n_seqs > 3 and uniq.shape[0] >= 2 and cnt.min() >= 3


def encode_rows(rows: list[str]) -> np.ndarray:
    b = np.frombuffer("".join(rows).encode(), np.uint8)
    out = _ENC[b]
    if (out < 0).any():
        raise ValueError("non-ATCG- character in an MSA row")
    return out.reshape(len(rows), -1)


def decode_degapped(codes: np.ndarray) -> list[str]:
    return ["".join(ALPHABET[c] for c in row if c != GAP) for row in codes]


def flank_columns(row0: str, flank_5: str, flank_3: str) -> list[int]:
    """Columns of the flank bases on the reference row (CallMargin): the
    non-gap columns read from each end until the bases read equal the
    flank."""
    idx, acc = [], ""
    for i, ch in enumerate(row0):
        if ch != "-":
            acc += ch
            idx.append(i)
        if acc == flank_5:
            break
    acc = ""
    for i in range(len(row0) - 1, 0, -1):
        if row0[i] != "-":
            acc = row0[i] + acc
            idx.append(i)
        if acc == flank_3:
            break
    return idx


def variable_columns(mat: np.ndarray, cutoff: float) -> np.ndarray:
    """Columns whose second most frequent symbol is on >= cutoff rows."""
    if mat.shape[1] == 0:
        return np.empty(0, np.int64)
    counts = np.stack([(mat == a).sum(axis=0) for a in range(5)])
    return np.flatnonzero(np.sort(counts, axis=0)[-2] >= cutoff)


def stage_a(job):
    """(sequences, read_ids, flank_5, flank_3, hcutoff, scutoff) ->
    (enc, feat): enc the encoded MSA (reference row first) or None when
    the window fails the gates, feat the reads' feature columns or None
    when there are fewer than 10."""
    seqs, read_ids, flank_5, flank_3, hcutoff, scutoff = job
    if not passes_gates(len(seqs), tags_of(read_ids)):
        return None, None
    _cons, msa = poa(seqs, 1)
    enc = encode_rows(msa)
    drop = set(flank_columns(msa[0], flank_5, flank_3))
    keep = np.array([c for c in range(enc.shape[1]) if c not in drop],
                    np.int64)
    reads = enc[1:][:, keep]
    cutoff = max(hcutoff, enc.shape[0] * scutoff)
    feat = reads[:, variable_columns(reads, cutoff)]
    if feat.shape[0] == 0 or feat.shape[1] < 10:
        return enc, None
    return enc, feat


def consensus(rows: list[str]) -> str:
    """Heaviest-bundle consensus of one cluster's reads."""
    return poa(list(rows), 1)[0]
