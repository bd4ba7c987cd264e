"""Whole-genome alignment features + random-forest confidence filter
(the AlnFeature stage; counterpart of svscope_tpu/engine/features.py).

Re-designs reference src/SVscope.py:241-317 and src/DataScanner.py:391-481
over the in-memory AlignmentTable:

  * window_info: per-window coverage rate (summed per-read overlap /
    window length) and low-mapQ read fraction, optionally the
    multi-chromosome span ratio of the window's reads
    (windowInfo/spanchrRatio, src/DataScanner.py:403-467)
  * background_stats over the 10 kb genome grid and over Raw.bed EMOutput
    rows (background, src/DataScanner.py:469-481)
  * Z-scoring vs the genome background (src/SVscope.py:271-280)
  * MisScore over somatic x germline consensus pairs
    (PairwiseCompare.MisScorePipe, src/PairwiseCompare.py:54-86): on a
    CUDA device through K2 (ops/nw_batch.misscore_batch), on the CPU
    through the host DP, as the JAX package on its CPU backend
  * allele frequency with the reference's `_tumor|` regex quirk — the
    empty alternation matches everything, so every germline support read
    counts in the denominator (CallAlleleFreq, src/PairwiseCompare.py:66-74;
    replicated)
  * 10-feature assembly + RF predict (src/SVscope.py:293-315) through the
    torch forest (models/forest.py) on the same device
"""
from __future__ import annotations

import logging
import os

import numpy as np
import pandas as pd

from ..io.bam import AlignmentTable
from ..models.forest import Forest
from ..ops.nw import calculate_misscore, pick_misscore
from ..ops.nw_batch import misscore_batch
from ..utils import intervals as iv
from ..utils.device import resolve_device

log = logging.getLogger("svscope_tpu_torch.features")

RF_FEATURES = ["COV_Tumor", "mapQ_Tumor", "COV_Normal", "mapQ_Normal",
               "ABSMisScore", "chromSpan_Tumor", "chromSpan_Normal",
               "AdaptRatio_T", "AdaptRatio_N", "SupportReadSpanRatio"]

RAW_COLS = ["chrom", "start", "end", "SomSeq", "SomReads", "SomCount",
            "GermSeq", "GermReads", "GermCount", "Label"]


def make_genome_windows(fai_path: str, size: int = 10_000):
    """10 kb genome grid (the reference expects a pre-made
    `bedtools makewindows` bed; we generate it natively)."""
    out = []
    with open(fai_path) as f:
        for line in f:
            p = line.split("\t")
            chrom, length = p[0], int(p[1])
            for s in range(0, length, size):
                out.append((chrom, s, min(s + size, length)))
    return out


def window_info(table: AlignmentTable, chrom: str, start: int, end: int,
                mapq_cutoff: int = 5, show_chrom_span: bool = False):
    """windowInfo equivalent (src/DataScanner.py:427-467).

    Zero-length windows (merged point-INS breakpoints can produce
    start == end) return the NaN row: htslib's tabix yields nothing for an
    empty region, which is how the reference avoids dividing by a
    zero window length."""
    idx = (table.fetch_idx(chrom, start, end) if end > start
           else np.empty(0, np.intp))
    if idx.size == 0:
        if show_chrom_span:
            return (np.nan, np.nan, np.nan, [])
        return (np.nan, np.nan)
    per = {}
    for i in idx:
        r = per.setdefault(table.name[i], [table.start[i], table.end[i],
                                           table.mapq[i]])
        r[0] = min(r[0], table.start[i])
        r[1] = max(r[1], table.end[i])
        r[2] = min(r[2], table.mapq[i])
    wlen = end - start
    cov = sum(iv.coverage_length(start, end, [v[0]], [v[1]])
              for v in per.values()) / wlen
    mapq_rate = sum(1 for v in per.values() if v[2] < mapq_cutoff) / len(per)
    if not show_chrom_span:
        return (cov, mapq_rate)
    reads = sorted(per)
    span = table.spanchr_ratio(reads)
    return (cov, mapq_rate, span, reads)


def background_stats(table: AlignmentTable, windows, show_chrom_span=False):
    """background equivalent (src/DataScanner.py:469-481): DataFrame keyed
    'chrom_start-end'.

    The genome-grid case (show_chrom_span=False, the ~308k-window sweep) is
    fully vectorized: every (window, alignment) overlap pair is generated
    with searchsorted over the per-chromosome window grid, reduced per
    (window, read) with lexsort groupby — no per-window Python loop."""
    if not show_chrom_span and len(windows) > 64:
        return _background_stats_vectorized(table, windows)
    rows = []
    for (chrom, start, end) in windows:
        info = window_info(table, chrom, int(start), int(end),
                           show_chrom_span=show_chrom_span)
        key = f"{chrom}_{start}-{end}"
        if show_chrom_span:
            rows.append([key, info[0], info[1], info[2], info[3]])
        else:
            rows.append([key, info[0], info[1]])
    cols = (["window", "COV", "mapQRate", "chromSpan", "TotalReadID"]
            if show_chrom_span else ["window", "COV", "mapQRate"])
    df = pd.DataFrame(rows, columns=cols)
    df.index = df["window"]
    return df


def _background_stats_vectorized(table: AlignmentTable, windows,
                                 mapq_cutoff: int = 5) -> pd.DataFrame:
    """Vectorized COV/mapQRate over an arbitrary window list.

    Per window w: group that window's overlapping alignment rows by read
    (start=min, end=max, mapQ=min over the rows IN the window), then
    COV = sum per-read clipped span / window length and mapQRate = fraction
    of reads with min mapQ < cutoff — windowInfo semantics exactly."""
    win_df = pd.DataFrame(windows, columns=["chrom", "start", "end"])
    keys = (win_df.chrom.astype(str) + "_" + win_df.start.astype(str)
            + "-" + win_df.end.astype(str))
    cov = np.full(len(win_df), np.nan)
    mqr = np.full(len(win_df), np.nan)
    name_codes = table.name_codes()
    for chrom, wg in win_df.groupby("chrom", sort=False):
        if chrom not in table._chrom_slices:
            continue
        lo, hi = table._chrom_slices[chrom]
        a_start = table.start[lo:hi]
        a_end = table.end[lo:hi]
        a_mapq = table.mapq[lo:hi]
        a_name = name_codes[lo:hi]
        ws = wg.start.to_numpy(np.int64)
        we = wg.end.to_numpy(np.int64)
        worder = np.argsort(ws, kind="stable")
        ws_s, we_s = ws[worder], we[worder]
        widx_s = wg.index.to_numpy()[worder]
        if not (np.diff(we_s) >= 0).all():
            # non-monotone window ends (irregular bed): per-window fallback
            for wi, s_, e_ in zip(wg.index, wg.start, wg.end):
                info = window_info(table, chrom, int(s_), int(e_))
                cov[wi], mqr[wi] = info
            continue
        # window j overlaps row i iff ws[j] < a_end[i] and we[j] > a_start[i]
        hi_w = np.searchsorted(ws_s, a_end, side="left")
        lo_w = np.searchsorted(we_s, a_start, side="right")
        reps = np.maximum(hi_w - lo_w, 0)
        pair_a = np.repeat(np.arange(len(a_start)), reps)
        pair_w = (np.concatenate([np.arange(l, h) for l, h
                                  in zip(lo_w, hi_w) if h > l])
                  if reps.sum() else np.empty(0, np.intp))
        if len(pair_a) == 0:
            continue
        # reduce per (window, read): start min, end max, mapq min
        grp = pd.DataFrame({
            "w": pair_w, "r": a_name[pair_a],
            "s": a_start[pair_a], "e": a_end[pair_a], "q": a_mapq[pair_a]})
        agg = grp.groupby(["w", "r"], sort=False).agg(
            s=("s", "min"), e=("e", "max"), q=("q", "min")).reset_index()
        wn = agg.w.to_numpy()
        ov = (np.minimum(agg.e.to_numpy(), we_s[wn])
              - np.maximum(agg.s.to_numpy(), ws_s[wn]))
        ov = np.clip(ov, 0, None)
        n_reads = np.bincount(wn, minlength=len(ws_s))
        cov_sum = np.bincount(wn, weights=ov, minlength=len(ws_s))
        low_q = np.bincount(wn, weights=(agg.q.to_numpy() < mapq_cutoff),
                            minlength=len(ws_s))
        has = n_reads > 0
        wlen = np.maximum(we_s - ws_s, 1)
        cov[widx_s[has]] = cov_sum[has] / wlen[has]
        mqr[widx_s[has]] = low_q[has] / n_reads[has]
    df = pd.DataFrame({"window": keys, "COV": cov, "mapQRate": mqr})
    df.index = df["window"]
    return df


def call_allele_freq(som_reads_field: str, germ_reads_field: str) -> str:
    """CallAlleleFreq with the `_tumor|` empty-alternation quirk: ALL
    germline support reads enter the denominator
    (src/PairwiseCompare.py:66-74, replicated for output parity)."""
    som_counts = np.array([len(x.split(","))
                           for x in som_reads_field.split(";")])
    germ_reads = [r for grp in germ_reads_field.split(";")
                  for r in grp.split(",")]
    n = som_counts.sum() + len(germ_reads)
    return ";".join(str(c / n) for c in som_counts)


def misscore_pipe(raw_bed_path: str, use_device: bool | None = None,
                  device="cuda") -> pd.DataFrame:
    """MisScorePipe (src/PairwiseCompare.py:76-86): per
    'NormalOutput|EMOutput' row, MisScore + AF.  use_device=None sends the
    som x germ alignment stats through K2 (ops/nw_batch) on a CUDA
    `device` and through the host DP on the CPU; use_device=True on the CPU
    takes K2's plain torch version."""
    df = pd.read_csv(raw_bed_path, sep="\t", header=None, names=RAW_COLS)
    som = df[df.Label == "NormalOutput|EMOutput"].copy()
    out_cols = ["chrom", "start", "end", "window", "somSupportReadID",
                "germSupportReadID", "MisScore", "AF"]
    if len(som) == 0:
        return pd.DataFrame(columns=out_cols)
    som["window"] = (som.chrom + "_" + som.start.astype(str) + "-"
                     + som.end.astype(str))
    dev = resolve_device(device)
    if use_device is None:
        use_device = dev.type == "cuda"
    if use_device:
        pairs, spans = [], []
        for s, g in zip(som.SomSeq, som.GermSeq):
            row_pairs = [(a, b) for a in s.split(";") for b in g.split(";")]
            spans.append((len(pairs), len(row_pairs)))
            pairs.extend(row_pairs)
        raw = misscore_batch(pairs, device=dev)
        signed = [int(raw[i]) if len(pairs[i][0]) >= len(pairs[i][1])
                  else -int(raw[i]) for i in range(len(pairs))]
        som["MisScore"] = [pick_misscore(signed[o:o + n]) for o, n in spans]
    else:
        som["MisScore"] = [
            calculate_misscore(s.split(";"), g.split(";"))
            for s, g in zip(som.SomSeq, som.GermSeq)]
    som["AF"] = [call_allele_freq(s, g)
                 for s, g in zip(som.SomReads, som.GermReads)]
    som = som.rename(columns={"SomReads": "somSupportReadID",
                              "GermReads": "germSupportReadID"})
    return som[out_cols]


def run_aln_feature(raw_bed_path: str, genome_windows, t_table, n_table,
                    t_sample_id: str, savedir: str,
                    forest: Forest | None = None, device="cuda"):
    """AlnFeature feature assembly + RF scoring (src/SVscope.py:241-317).

    Writes <T>.Somatic.bed and RandomForestResult.tsv; returns the ReadPool
    DataFrame (with yprob/y_hat) for the VCF stage.  MisScore and the
    forest run on `device`."""
    os.makedirs(savedir, exist_ok=True)
    raw = pd.read_csv(raw_bed_path, sep="\t", header=None, names=RAW_COLS)
    em = raw[raw.Label.str.contains("EMOutput")].drop_duplicates()
    sv_windows = [(r.chrom, r.start, r.end) for r in em.itertuples()]

    log.info("background stats over %d genome windows", len(genome_windows))
    bg_t = background_stats(t_table, genome_windows)
    bg_n = background_stats(n_table, genome_windows)
    sv_t = background_stats(t_table, sv_windows, show_chrom_span=True)
    sv_n = background_stats(n_table, sv_windows, show_chrom_span=True)
    for sv, bg in ((sv_t, bg_t), (sv_n, bg_n)):
        cov = bg.COV.dropna()
        mq = bg.mapQRate.dropna()
        sv["COV_Zscore"] = (sv.COV - cov.mean()) / np.std(cov)
        sv["mapQ_Zscore"] = (sv.mapQRate - mq.mean()) / np.std(mq)
    sv_t = sv_t[~sv_t.index.duplicated()]
    sv_n = sv_n[~sv_n.index.duplicated()]

    comp = misscore_pipe(raw_bed_path, device=device).drop_duplicates(
        subset=["chrom", "start", "end", "window", "somSupportReadID",
                "germSupportReadID", "MisScore", "AF"])
    comp["ABSMisScore"] = comp.MisScore.abs()
    comp.index = comp.window
    somatic_bed = os.path.join(savedir, f"{t_sample_id}.Somatic.bed")
    comp.to_csv(somatic_bed, sep="\t", index=False, header=False)

    em2 = raw[raw.Label == "NormalOutput|EMOutput"].drop_duplicates().copy()
    if len(em2):
        em2["window"] = (em2.chrom.astype(object) + "_"
                         + em2.start.astype(str) + "-"
                         + em2.end.astype(str))
        em2.index = em2.window
        windows = np.intersect1d(comp.index.to_numpy(),
                                 em2.index.to_numpy())
    else:
        windows = np.empty(0, dtype=object)

    rows = []
    for w in windows:
        r = em2.loc[w]
        som_names = [a.split("|")[-1]
                     for a in r.SomReads.replace(";", ",").split(",")]
        germ_names = [a.split("|")[-1]
                      for a in r.GermReads.replace(";", ",").split(",")]
        adapt = som_names + germ_names
        tot_t = sv_t.loc[w, "TotalReadID"]
        tot_n = sv_n.loc[w, "TotalReadID"]
        mq_t = sv_t.loc[w, "mapQRate"]
        mq_n = sv_n.loc[w, "mapQRate"]
        den_t = len(tot_t) * (1 - mq_t)
        den_n = len(tot_n) * (1 - mq_n)
        rows.append({
            "window": w,
            "COV_Tumor": sv_t.loc[w, "COV_Zscore"],
            "mapQ_Tumor": sv_t.loc[w, "mapQ_Zscore"],
            "COV_Normal": sv_n.loc[w, "COV_Zscore"],
            "mapQ_Normal": sv_n.loc[w, "mapQ_Zscore"],
            "ABSMisScore": comp.loc[w, "ABSMisScore"],
            "chromSpan_Tumor": sv_t.loc[w, "chromSpan"],
            "chromSpan_Normal": sv_n.loc[w, "chromSpan"],
            "AdaptRatio_T": (len(np.intersect1d(adapt, tot_t)) / den_t
                             if den_t > 0 else 0.0),
            "AdaptRatio_N": (len(np.intersect1d(adapt, tot_n)) / den_n
                             if den_n > 0 else 0.0),
            "SupportReadSpanRatio": t_table.spanchr_ratio(som_names),
        })
    pool = pd.DataFrame(rows)
    if len(pool):
        pool.index = pool.window
        forest = forest or Forest.from_npz(device=device)
        X = pool[RF_FEATURES].to_numpy(np.float64)
        proba = forest.predict_proba(X)
        pool["yprob"] = proba[:, 1]
        pool["y_hat"] = forest.predict(X)
    else:
        pool = pd.DataFrame(columns=["window"] + RF_FEATURES
                            + ["yprob", "y_hat"])
    rf_out = os.path.join(savedir, "RandomForestResult.tsv")
    pool.to_csv(rf_out, sep="\t")
    return pool, somatic_bed, rf_out
