"""Per-window somatic decision: MSA feature selection + EM phasing +
cluster labeling + consensus emission (counterpart of
svscope_tpu/engine/decision.py, on the port's EM).

Output row format (10 columns, tab-joined by the driver):
  [chrom, start, end, somSeqs;, somReads;, somCount,
   germSeqs;, germReads;, germCount, flag]
with flag "<windowFlag>|EMOutput" on success (src/DecisionMaker.py:178-190).
"""
from __future__ import annotations

import numpy as np

from ..models.mixture import em_cluster_batch
from ..native.poa import poa_native
from ..utils import seq as sq
from .datamaker import WindowData


def call_margin(msa_row0: str, flank_5: str, flank_3: str) -> np.ndarray:
    """Column indices of the 5'/3' flank bases on the reference backbone
    (CallMargin, src/DataScanner.py:146-165).  Only non-gap columns are
    collected — gap columns inside the flank region survive into the
    feature matrix, replicating the reference."""
    idx = []
    acc = ""
    for i, ch in enumerate(msa_row0):
        if ch != "-":
            acc += ch
            idx.append(i)
        if acc == flank_5:
            break
    acc = ""
    for i in range(len(msa_row0) - 1, 0, -1):
        if msa_row0[i] != "-":
            acc = msa_row0[i] + acc
            idx.append(i)
        if acc == flank_3:
            break
    return np.array(idx, dtype=np.int64)


def find_non_same_site(mat: np.ndarray, cutoff: float) -> np.ndarray:
    """Columns whose second-most-frequent symbol count >= cutoff
    (FindNonSameSite, src/DataScanner.py:167-179)."""
    if mat.shape[1] == 0:
        return np.empty(0, np.int64)
    counts = np.stack([(mat == a).sum(axis=0) for a in range(5)])
    second = np.sort(counts, axis=0)[-2]
    return np.flatnonzero(second >= cutoff)


def msa_feature_selection(sequences: list[str], flank_5: str, flank_3: str,
                          read_ids: np.ndarray, hcutoff: int = 3,
                          scutoff: float = 0.05):
    """MSAFeatureSelection equivalent (src/DataScanner.py:181-220).

    Returns (encoded full MSA incl. reference row, feature matrix, read_ids).
    """
    _, msa = poa_native(sequences)
    enc = np.stack([sq.encode(row) for row in msa])
    flank_cols = call_margin(msa[0], flank_5, flank_3)
    keep_cols = np.setdiff1d(np.arange(enc.shape[1]), flank_cols)
    td_raw = enc[1:, keep_cols]
    cutoff = max(hcutoff, enc.shape[0] * scutoff)
    feat = td_raw[:, find_non_same_site(td_raw, cutoff)]
    return enc, feat, read_ids


def decision(win: WindowData, t_label: str = "tumor", readcutoff: int = 3,
             hcutoff: int = 3, scutoff: float = 0.05, em_dtype=None,
             em_kwargs: dict | None = None, device="cpu") -> list:
    """Decision equivalent (src/DecisionMaker.py:110-191); the EM runs on
    `device`."""
    parts = win.record.strip().split("\t")
    chrom, start, end = parts[0], parts[1], parts[2]
    record = [chrom, start, end, "-", "-", 0, "-", "-", 0, win.flag]
    tags = np.array([x.split("|")[0].split("_")[-1] for x in win.read_ids])
    uniq, cnt = (np.unique(tags, return_counts=True) if tags.size
                 else (np.array([]), np.array([])))
    if not (len(win.sequences) > 3 and uniq.shape[0] >= 2 and cnt.min() >= 3):
        return record
    enc, feat, read_ids = msa_feature_selection(
        win.sequences, win.flank_5, win.flank_3, win.read_ids,
        hcutoff=hcutoff, scutoff=scutoff)
    if feat.shape[0] == 0 or feat.shape[1] < 10:
        return record
    kwargs = dict(em_kwargs or {})
    if em_dtype is not None:
        kwargs["dtype"] = em_dtype
    K, _, labels, theta, gamma, pi, bics = em_cluster_batch(
        [feat], device=device, **kwargs)[0]
    som_idx, germ_idx = [], []
    for L in np.unique(labels):
        members = np.flatnonzero(labels == L)
        mtags = np.unique(tags[members])
        if mtags.shape[0] == 1 and mtags[0] == t_label and members.size >= readcutoff:
            som_idx.append(members)
        else:
            if members.size >= readcutoff:
                germ_idx.append(members)
    som_seqs, germ_seqs = [], []
    for idx in som_idx:
        rows = [sq.decode(enc[i + 1]) for i in idx]
        som_seqs.append(poa_native(rows)[0] if max(map(len, rows)) > 0 else "-")
    for idx in germ_idx:
        rows = [sq.decode(enc[i + 1]) for i in idx]
        germ_seqs.append(poa_native(rows)[0] if max(map(len, rows)) > 0 else "-")
    if som_seqs and germ_idx:
        record = [chrom, start, end,
                  ";".join(som_seqs),
                  ";".join(",".join(read_ids[i] for i in idx) for idx in som_idx),
                  len(som_seqs),
                  ";".join(germ_seqs),
                  ";".join(",".join(read_ids[i] for i in idx) for idx in germ_idx),
                  len(germ_seqs),
                  win.flag + "|EMOutput"]
    return record


def tdscope(record: str, make_data, make_data2, decide) -> list:
    """TDscope pipeline (src/SomTDDetector.py:26-61): Decision, then for DUP
    windows that missed, re-scan both 50bp corner windows and retry; flag
    rescue when >=3 new tumor reads appear.  The trigger reads bed column 4
    (index 3), replicated from the reference for output parity."""
    win = make_data(record)
    result = decide(win)
    parts = record.strip().split("\t")
    svtype = parts[3].split(",")[0] if len(parts) > 3 else ""
    if result[-1].split("|")[-1] != "EMOutput" and svtype == "DUP":
        result = dup_rescue(result, win, record, make_data2, decide)
    return result


def dup_rescue(result: list, win: WindowData, record: str, make_data2,
               decide) -> list:
    """The DUP corner re-scan half of TDscope (src/SomTDDetector.py:41-58):
    retry both 50 bp corner windows; failing that, flag the window when >=3
    new tumor reads appear in a corner."""
    corner5, corner3 = make_data2(record)
    r5 = decide(corner5)
    if r5[-1].split("|")[-1] == "EMOutput":
        return r5
    r3 = decide(corner3)
    if r3[-1].split("|")[-1] == "EMOutput":
        return r3
    new5 = [x for x in np.setdiff1d(corner5.read_ids, win.read_ids)
            if "_tumor" in x]
    new3 = [x for x in np.setdiff1d(corner3.read_ids, win.read_ids)
            if "_tumor" in x]
    if len(new5) >= 3:
        result[-1] = corner5.flag
    elif len(new3) >= 3:
        result[-1] = corner3.flag
    return result
