"""Research/cohort analysis helpers (src_evo/try.py capabilities).

  * consensus FASTA export per called window: majority vote per MSA column
    with the gap->second-best substitution (GenerateConsensus,
    src_evo/try.py:281-312); >20 kb windows truncated like the reference
    (:330-342)
  * per-column chi-square differential test between somatic and germline
    cluster rows with Benjamini-Hochberg FDR, annotating conserved vs
    differential columns (:436-462)
  * RepeatMasker .out parsing into window annotations
    (GetSpecialRegionIDX, :376-399)
"""
from __future__ import annotations

import numpy as np
from scipy.stats import chi2_contingency

from ..utils import seq as sq


def consensus_by_majority(msa_rows: list[str]) -> str:
    """Per-column majority vote; when the gap wins, the second-best symbol
    is used (GenerateConsensus semantics)."""
    if not msa_rows:
        return ""
    mat = np.stack([sq.encode(r) for r in msa_rows])
    out = []
    for j in range(mat.shape[1]):
        counts = np.bincount(mat[:, j], minlength=5)
        best = int(np.argmax(counts))
        if best == 4:
            counts[4] = -1
            if counts.max() <= 0:
                continue
            best = int(np.argmax(counts))
        out.append(best)
    return sq.decode(np.array(out))


def export_consensus_fasta(raw_bed_path: str, out_fasta: str,
                           max_len: int = 20_000) -> int:
    """Write every called window's somatic consensi to FASTA; sequences
    beyond max_len are truncated (the reference special-cases >20 kb)."""
    n = 0
    with open(raw_bed_path) as f, open(out_fasta, "w") as out:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 10 or not cols[9].endswith("EMOutput"):
                continue
            window = f"{cols[0]}_{cols[1]}-{cols[2]}"
            for i, seq in enumerate(cols[3].split(";")):
                if seq == "-":
                    continue
                out.write(f">{window}.som{i}\n{seq[:max_len]}\n")
                n += 1
    return n


def column_differential_test(som_rows: np.ndarray, germ_rows: np.ndarray,
                             alpha: float = 0.05):
    """Per-column chi2 between somatic and germline symbol counts with
    BH-FDR; returns (pvalues, qvalues, differential_mask)."""
    nf = som_rows.shape[1]
    pvals = np.ones(nf)
    for j in range(nf):
        s_counts = np.bincount(som_rows[:, j], minlength=5) + 1
        g_counts = np.bincount(germ_rows[:, j], minlength=5) + 1
        try:
            stat, p, *_ = chi2_contingency(np.stack([s_counts, g_counts]))
            pvals[j] = p
        except ValueError:
            pvals[j] = 1.0
    qvals = bh_fdr(pvals)
    return pvals, qvals, qvals < alpha


def bh_fdr(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values."""
    p = np.asarray(pvals, np.float64)
    n = p.size
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(ranked, 0, 1)
    return out


# ---------------------------------------------------------------------------
# Cohort enrichment helpers (ScopeVIZ CountSomTD / R_OE / AnnoTDwindow,
# src/ScopeVIZ.py:131-188): is a recurrent somatic TD window enriched in a
# particular cancer type?
# ---------------------------------------------------------------------------

def som_td_cross_tab(record: np.ndarray, ca_type: np.ndarray) -> np.ndarray:
    """(2, n_types) positive/negative patient counts per cancer type for
    one window (CountSomTD): positive = patients with a nonzero call."""
    record = np.asarray(record)
    ca_type = np.asarray(ca_type)
    type_names, total = np.unique(ca_type, return_counts=True)
    pos = np.zeros(type_names.shape[0])
    hit_types, hit_counts = np.unique(ca_type[record != 0],
                                      return_counts=True)
    for t, c in zip(hit_types, hit_counts):
        pos[type_names == t] += c
    return np.vstack([pos, total - pos])


def r_oe(cross_tab: np.ndarray) -> np.ndarray:
    """Observed/expected positive ratio per cancer type (R_OE)."""
    observed = cross_tab[0]
    total_pos = cross_tab[0].sum()
    totals = cross_tab.sum(axis=0)
    expected = totals * total_pos / cross_tab.sum()
    return observed / expected


def annotate_td_window(record: np.ndarray, ca_type: np.ndarray,
                       p_cutoff: float = 0.05, roe_cutoff: float = 1.5,
                       min_pos: int = 4) -> str:
    """AnnoTDwindow: comma-joined cancer types where the window is enriched
    (chi2 p <= 0.05, R(O/E) >= 1.5, >= 4 positive patients), '-' if none."""
    cross = som_td_cross_tab(record, ca_type)
    roe = r_oe(cross)
    type_names = np.unique(np.asarray(ca_type))
    _chi, p, _dof, _ex = chi2_contingency(cross)
    if p <= p_cutoff:
        enriched = type_names[(roe >= roe_cutoff) & (cross[0] >= min_pos)]
        if enriched.shape[0] > 0:
            return ",".join(enriched)
    return "-"


def parse_repeatmasker_out(path: str):
    """RepeatMasker .out -> list of (chrom, start, end, repeat_class)."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 11 or not p[0].isdigit():
                continue
            rows.append((p[4], int(p[5]) - 1, int(p[6]), p[10]))
    return rows
