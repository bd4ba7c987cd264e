"""Candidate-window selection: whole-genome breakpoint scan -> somatic
candidate windows + split-alignment SV clusters.

Re-designs reference src/WindowSelection_v8.py:266-635 (ParseWindows /
FindCandidateSVWindow) over in-memory tables: no bedtools/sort/awk/grep
subprocesses — interval ops come from utils.intervals, clustering from
ops.dbscan.  The named intermediate bed files are still written into
savedir because downstream stages (InterALNSVs.vcf writer, adjustVCF) read
them, and they make run state inspectable.

Replicated decision semantics (with citations):
  * bp merge: DEL/INS breakpoints merged within 200 bp, windows kept when
    >3 distinct supporting reads (:464-467)
  * RepeatMasker channel: repeat windows holding >=3 distinct INS-bp reads
    (:468-469, 575-588)
  * CLIP DUP/DEL pairs: DBSCAN eps=500 min_samples=3 on linearized 2-D
    sites, keep all-tumor clusters (:437-447, 471-479); single BPType and
    >=3 distinct reads per cluster (:476-479); cluster span = min BP1 /
    min BP2 position (:481-485, including the min-end quirk)
  * good/bad span split and the large-vs-inner intersect dedupe at
    reciprocal 0.5 (:490-559) including the asymmetric DUP else-branch that
    drops INS windows when good-span DUPs exist but none intersect
    (:555-556 cats a file that was never written — replicated as a no-op)
  * RoughCompare span-length test: >=3 tumor spanning reads longer
    (INS/DUP) or shorter (DEL) by >40 bp than every normal spanning read,
    flank 50 (:391-434); min(span counts) in [3, 500] retention (:598-614)
  * LC-over-denovo preference in the final merge + whole-line sort -u
    (:619-625)
"""
from __future__ import annotations

import logging
import os

import numpy as np
import pandas as pd

from ..io.bam import AlignmentTable, parse_cigar_string
from ..ops.dbscan import dbscan_labels
from ..utils import intervals as iv
from .breakpoints import (BreakpointRows, chrom_offsets, classify_clip_pairs,
                          encode_site, non_unique_reads, sort_breakpoint,
                          span_breakpoints)

log = logging.getLogger("svscope_tpu_torch.select")


# ---------------------------------------------------------------------------
# ParseWindows
# ---------------------------------------------------------------------------

def parse_windows(table: AlignmentTable, fai_path: str, data_label: str,
                  mapq: int = 5, rm_chroms=("chrM",), bp_df=None):
    """ParseWindows equivalent (:266-331).

    bp_df: precomputed breakpoint frame (native scanner,
    native/bam.scan_with_breakpoints) — row-identical to the Python
    extraction below, just fast.

    Returns dict with DataFrames: del_bp, ins_bp, clip_others, clip_inv,
    clip_tra (each with Site + DataLabel columns), clip_groups.
    """
    if bp_df is not None:
        df = bp_df
    else:
        bp = BreakpointRows()
        for i in range(len(table)):
            span_breakpoints(table.chrom[i], int(table.start[i]),
                             int(table.end[i]), table.name[i],
                             int(table.mapq[i]),
                             "-" if table.strand_rev[i] else "+",
                             table.cigar[i], out=bp)
        df = pd.DataFrame(bp.asarrays())
    if len(df) == 0:
        empty = pd.DataFrame(columns=["BPsite", "readID", "BPType", "mapQ",
                                      "Site", "DataLabel"])
        z = pd.DataFrame(columns=df.columns)
        return dict(del_bp=z, ins_bp=z, clip_others=empty, clip_inv=empty,
                    clip_tra=empty)
    df = df[~df.chrom.isin(rm_chroms)]
    # non-unique-alignment reads: fragments overlap > 100 bp on the read
    uniq_regions = (df.ref_region + "|" + df.read_region)
    per_read = {}
    for rid, comb in zip(df.read_id, uniq_regions):
        per_read.setdefault(rid, set()).add(comb)
    nonuniq = {rid for rid, combs in per_read.items()
               if non_unique_reads([c.split("|")[-1] for c in sorted(combs)])}
    del_bp = df[(df.bp_type == "DEL") & (df.mapq >= mapq)]
    ins_bp = df[(df.bp_type == "INS") & (df.mapq >= mapq)]
    clip = df[(df.bp_type == "CLIP") & (df.mapq > 0)
              & ~df.read_id.isin(nonuniq)].sort_values(
                  ["read_id", "read_start"], kind="stable")
    records = []
    for rid, g in clip.groupby("read_id", sort=True):
        # >1 CLIP rows (row count, not unique regions — :307)
        if len(g) <= 1:
            continue
        records.extend(classify_clip_pairs(
            list(g.chrom), list(g.ref_start), list(g.read_start),
            list(g.read_region), list(g.ref_region), list(g.strand),
            list(g.mapq), rid))
    offsets = chrom_offsets(fai_path)
    rows = [r.split("|") for r in records]
    clip_df = pd.DataFrame(rows, columns=["BPsite", "readID", "BPType", "mapQ"])
    if len(clip_df):
        clip_df["Site"] = [encode_site(s, offsets) for s in clip_df.BPsite]
    else:
        clip_df["Site"] = []
    clip_df["DataLabel"] = data_label
    return dict(
        del_bp=del_bp, ins_bp=ins_bp,
        clip_others=clip_df[clip_df.BPType.isin(["DUP", "DEL"])],
        clip_inv=clip_df[clip_df.BPType == "INV"],
        clip_tra=clip_df[clip_df.BPType == "TRA"],
    )


# ---------------------------------------------------------------------------
# Span-read fetch + RoughCompare
# ---------------------------------------------------------------------------

def _read_span_sites(cigar: str, aln_start: int, win_start: int, win_end: int):
    """FetchAimRegion's per-record walk (:333-371): full-read coordinates of
    the window boundaries inside this alignment record."""
    ops, lens = parse_cigar_string(cigar)
    letters = np.array(list("MIDNSHP=X"))[ops]
    ref_grow = np.isin(letters, ("D", "P", "N", "M", "=", "X"))
    read_grow = np.isin(letters, ("H", "S", "I", "M", "=", "X"))
    ref_loci = np.concatenate([[aln_start],
                               aln_start + np.cumsum(np.where(ref_grow, lens, 0))])
    read_loci = np.concatenate([[0], np.cumsum(np.where(read_grow, lens, 0))])
    m_idx = np.flatnonzero(np.isin(letters, ("M", "=", "X")))
    if m_idx.size == 0:       # no aligned block (e.g. CG-placeholder)
        return 0, 0
    read_start_aln = int(lens[:m_idx[0]].sum())
    upto = m_idx[-1] + 1
    rg = np.isin(letters, ("D", "P", "N"))
    read_end_aln = int(lens[:upto][~rg[:upto]].sum())
    aln_end = int(ref_loci[-1])
    if aln_start < win_start:
        t5 = int(np.flatnonzero(ref_loci <= win_start)[-1])
        site5 = int(read_loci[t5] + (win_start - ref_loci[t5]))
    else:
        site5 = read_start_aln
    if aln_end > win_end:
        t3 = int(np.flatnonzero(ref_loci <= win_end)[-1])
        site3 = int(read_loci[t3] + (win_end - ref_loci[t3]))
    else:
        site3 = read_end_aln
    return site5, site3


def fetch_span_reads(table: AlignmentTable, chrom: str, start: int, end: int,
                     mapq_cutoff: int = 5):
    """FetchSpanReadDf equivalent (:374-389): spanning reads of [start, end]
    with their on-read window length.  Returns DataFrame(read -> Length).

    The per-record window-boundary walk runs as one native batch call
    (span_sites_batch), whose failure raises; the Python walk
    (_read_span_sites) is the tests' parity oracle, not a fallback."""
    from ..native.bam import span_sites
    idx = table.fetch_idx(chrom, start, end)
    idx = idx[table.mapq[idx] >= mapq_cutoff] if len(idx) else idx
    if len(idx) == 0:
        return pd.DataFrame({"Length": pd.Series({}, dtype=np.int64)})
    starts = table.start[idx].astype(np.int64)
    blob, off = table.cig_arrays()
    s5s, s3s = span_sites(blob, off[idx], off[idx + 1] - off[idx],
                          starts, np.full(len(idx), start, np.int64),
                          np.full(len(idx), end, np.int64))
    uniq, inv = np.unique(table.name[idx], return_inverse=True)
    ng = len(uniq)
    big = np.iinfo(np.int64).max
    rs = np.full(ng, big)
    re_ = np.full(ng, -big)
    s5m = np.full(ng, big)
    s3m = np.full(ng, -big)
    np.minimum.at(rs, inv, starts)
    np.maximum.at(re_, inv, table.end[idx].astype(np.int64))
    np.minimum.at(s5m, inv, s5s)
    np.maximum.at(s3m, inv, s3s)
    keep = (rs <= start) & (re_ >= end)
    return pd.DataFrame({"Length": pd.Series((s3m - s5m)[keep],
                                             index=uniq[keep],
                                             dtype=np.int64)})


def rough_compare(t_table, n_table, chrom: str, start: int, end: int,
                  window_type: str, offset: int = 40, cutoff: int = 5,
                  flank: int = 50) -> str:
    """RoughCompare / LCRoughCompare decision (:391-434)."""
    s = max(start - flank, 0)
    e = end + flank
    tdf = fetch_span_reads(t_table, chrom, s, e, mapq_cutoff=cutoff)
    ndf = fetch_span_reads(n_table, chrom, s, e, mapq_cutoff=0)
    if len(ndf) == 0:
        n_hit = 0
    elif window_type == "DEL":
        n_hit = int((tdf.Length < ndf.Length.min() - offset).sum())
    else:
        n_hit = int((tdf.Length > ndf.Length.max() + offset).sum())
    label = "CandidateSom" if n_hit >= 3 else "GermlineWindow"
    return (f"{chrom}\t{start}\t{end}\t{len(tdf)}\t{len(ndf)}\t"
            f"{window_type}\t{label}")


# ---------------------------------------------------------------------------
# DBSCAN somatic cluster selection
# ---------------------------------------------------------------------------

def decide_with_dbscan(df: pd.DataFrame, eps: float = 500.0,
                       min_samples: int = 3, aim_label: str = "Tumor"):
    """DecisionWithDBSCAN (:437-447): cluster 2-D sites, keep clusters whose
    members are all `aim_label` with >= min_samples members."""
    if len(df) == 0:
        out = df.copy()
        out["labels"] = pd.Series(dtype=np.int64)
        return out
    data = np.vstack(df.Site.to_numpy())
    labels = dbscan_labels(data, eps=eps, min_samples=min_samples)
    df = df.copy()
    df["labels"] = labels
    df = df[df.labels != -1]
    keep = []
    for lab, g in df.groupby("labels"):
        if (g.DataLabel == aim_label).all() and len(g) >= min_samples:
            keep.append(lab)
    return df[df.labels.isin(keep)].sort_values("labels", kind="stable")


# ---------------------------------------------------------------------------
# bp merge -> candidate windows
# ---------------------------------------------------------------------------

def _merge_bp_windows(bp_df: pd.DataFrame, svtype: str, dist: int = 200,
                      min_reads: int = 4) -> pd.DataFrame:
    """`bedtools merge -d 200 -c 4,4 -o count_distinct,distinct` + awk $4>3
    (:464-467).  Returns DataFrame(chrom,start,end,count,reads,type)."""
    rows = []
    if len(bp_df):
        for chrom in sorted(bp_df.chrom.unique()):
            g = bp_df[bp_df.chrom == chrom]
            ms, me, gid, order = iv.merge(g.ref_start.to_numpy(),
                                          g.ref_end.to_numpy(), dist=dist)
            names = g.read_id.to_numpy()[order]
            for k in range(len(ms)):
                rd = sorted(set(names[gid == k]))
                if len(rd) >= min_reads:
                    rows.append([chrom, int(ms[k]), int(me[k]), len(rd),
                                 ",".join(rd), svtype])
    return pd.DataFrame(rows, columns=["chrom", "start", "end", "count",
                                       "reads", "type"])


def _lc_candidates(repeat_bed: str, ins_bp: pd.DataFrame) -> pd.DataFrame:
    """RepeatMasker windows holding INS breakpoints (:468-469, 578-584):
    intersect repeat windows with raw tumor INS bps, group by window, keep
    windows with >=3 supporting bp records (reads column joined verbatim,
    duplicates included, as the reference's groupby-join does)."""
    rows = []
    if len(ins_bp) == 0 or not repeat_bed or not os.path.exists(repeat_bed):
        return pd.DataFrame(columns=["chrom", "start", "end", "reads", "count"])
    rep = pd.read_csv(repeat_bed, sep="\t", header=None, usecols=[0, 1, 2],
                      names=["chrom", "start", "end"])
    for chrom in sorted(rep.chrom.unique()):
        rsub = rep[rep.chrom == chrom]
        isub = ins_bp[ins_bp.chrom == chrom]
        if len(isub) == 0:
            continue
        ai, bi, _ = iv.overlap_pairs(rsub.start.to_numpy(), rsub.end.to_numpy(),
                                     isub.ref_start.to_numpy(),
                                     np.maximum(isub.ref_end.to_numpy(),
                                                isub.ref_start.to_numpy() + 1))
        if len(ai) == 0:
            continue
        names = isub.read_id.to_numpy()
        g = pd.DataFrame({"wi": ai, "read": names[bi]})
        for wi, gg in g.groupby("wi"):
            reads = ",".join(gg.read)
            if len(gg) >= 3:
                r = rsub.iloc[int(wi)]
                rows.append([r.chrom, int(r.start), int(r.end), reads, len(gg)])
    return pd.DataFrame(rows, columns=["chrom", "start", "end", "reads", "count"])


def _cluster_spans(filtered: pd.DataFrame, offsets) -> pd.DataFrame:
    """Per-DBSCAN-cluster representative span (:480-486): chrom + min BP1
    position as start, min BP2 position as end (min, not max — replicated),
    first BPType, distinct reads."""
    rows = []
    for lab, g in filtered.groupby("labels"):
        sortbp = [sort_breakpoint(s, offsets) for s in g.BPsite]
        bp1 = [x[0] for x in sortbp]
        bp2 = [x[1] for x in sortbp]
        chrom = bp1[0].split(":")[0]
        start = min(int(x.split(":")[-1]) for x in bp1)
        end = min(int(x.split(":")[-1]) for x in bp2)
        rows.append([lab, chrom, start, end, g.BPType.iloc[0],
                     ",".join(sorted(set(g.readID)))])
    return pd.DataFrame(rows, columns=["labels", "chrom", "start", "end",
                                       "BPType", "readID"])


def _reciprocal_hits(a: pd.DataFrame, b: pd.DataFrame, frac=0.5):
    """Pairs of (a_idx, b_idx) overlapping with `-f frac -r` semantics."""
    hits = []
    if len(a) == 0 or len(b) == 0:
        return hits
    for chrom in sorted(set(a.chrom) & set(b.chrom)):
        am = a[a.chrom == chrom]
        bm = b[b.chrom == chrom]
        ai, bi, ov = iv.overlap_pairs(am.start.to_numpy(), am.end.to_numpy(),
                                      bm.start.to_numpy(), bm.end.to_numpy())
        ai, bi, ov = iv.reciprocal_filter(
            am.start.to_numpy(), am.end.to_numpy(), bm.start.to_numpy(),
            bm.end.to_numpy(), ai, bi, ov, frac)
        hits.extend((am.index[x], bm.index[y]) for x, y in zip(ai, bi))
    return hits


def find_candidate_sv_windows(t_table: AlignmentTable, n_table: AlignmentTable,
                              fai_path: str, repeat_bed: str, savedir: str,
                              eps: float = 500.0, min_samples: int = 3,
                              t_bp=None, n_bp=None, rm_chroms=("chrM",)):
    """FindCandidateSVWindow equivalent (:458-635).

    rm_chroms: chromosomes excluded from breakpoint parsing (v8 drops
    chrM; the v7 lineage wrapper in select/legacy passes ()).
    Returns dict of output paths: somatic_bed, large_del, large_dup, inv,
    tra, lc_somatic (the files the reference returns/consumes downstream).
    """
    os.makedirs(savedir, exist_ok=True)
    offsets = chrom_offsets(fai_path)
    tum = parse_windows(t_table, fai_path, "Tumor", mapq=5, bp_df=t_bp,
                        rm_chroms=rm_chroms)
    nor = parse_windows(n_table, fai_path, "Normal", mapq=0, bp_df=n_bp,
                        rm_chroms=rm_chroms)

    cand_del = _merge_bp_windows(tum["del_bp"], "DEL")
    cand_ins = _merge_bp_windows(tum["ins_bp"], "INS")
    cand_lc = _lc_candidates(repeat_bed, tum["ins_bp"])
    _write_bed(cand_del, f"{savedir}/CandidateDEL.tumor.merged.bed")
    _write_bed(cand_ins, f"{savedir}/CandidateINS.tumor.merged.bed")
    _write_bed(cand_lc, f"{savedir}/CandidateLC.tumor.merge.bed")

    # --- CLIP DUP/DEL clusters -> large-SV candidates ---
    others = pd.concat([tum["clip_others"], nor["clip_others"]],
                       ignore_index=True)
    filt = decide_with_dbscan(others, eps, min_samples)
    # single BPType + >=3 distinct reads per cluster (:476-479)
    keep_labels = [lab for lab, g in filt.groupby("labels")
                   if g.BPType.nunique() == 1 and g.readID.nunique() >= 3]
    filt = filt[filt.labels.isin(keep_labels)]
    spans = _cluster_spans(filt, offsets) if len(filt) else pd.DataFrame(
        columns=["labels", "chrom", "start", "end", "BPType", "readID"])

    # good/bad span classification (:490-499); both cutoffs default to 5
    good, bad = [], []
    for _, row in spans.iterrows():
        t_span = fetch_span_reads(t_table, row.chrom,
                                  max(row.start - 50, 0), row.end + 50)
        n_span = fetch_span_reads(n_table, row.chrom,
                                  max(row.start - 50, 0), row.end + 50)
        sup = np.intersect1d(row.readID.split(","), t_span.index.to_numpy())
        (good if (sup.shape[0] >= 3 and len(n_span) >= 3) else bad).append(row)
    good = pd.DataFrame(good, columns=spans.columns)
    bad = pd.DataFrame(bad, columns=spans.columns)

    span_windows: list[list] = []   # rows of CandidateSpan.tumor.merged.bed

    def handle_type(bptype: str, inner: pd.DataFrame, inner_name: str):
        """Large DEL vs inner DEL / large DUP vs inner INS (:500-567).
        Returns the cluster table for the InterALNSVs writer."""
        g = good[good.BPType == bptype][["chrom", "start", "end", "BPType",
                                         "readID"]].reset_index(drop=True)
        b = bad[bad.BPType == bptype][["chrom", "start", "end", "BPType",
                                       "readID"]]
        if len(g) == 0:
            # no good-span clusters: all inner windows proceed (:523-525, :557-559)
            span_windows.extend(inner.values.tolist())
            return b
        hits = _reciprocal_hits(g, inner.rename(
            columns={"count": "cnt"})[["chrom", "start", "end"]], 0.5)
        hit_g = {x for x, _ in hits}
        no_hit = g.loc[[i for i in g.index if i not in hit_g]]
        large = pd.concat([no_hit, b], axis=0)
        if hits:
            inter_rows = []
            for gi, bi in hits:
                grow = g.loc[gi]
                irow = inner.loc[bi]
                start = min(grow.start, irow.start)
                # end rule replicates :515/:549 (condition on a.start vs b.end)
                end = grow.end if grow.start >= irow.end else irow.end
                reads = sorted(set(grow.readID.split(",") +
                                   irow.reads.split(",")))
                inter_rows.append([grow.chrom, int(start), int(end),
                                   len(reads), ",".join(reads), grow.BPType])
            span_windows.extend(inter_rows)
            # inner windows overlapping ANY merged window are subsumed
            # (`intersect -a inner -b merged -wa -v`, :520/:554)
            inter_df = pd.DataFrame(
                [(r[0], r[1], r[2]) for r in inter_rows],
                columns=["chrom", "start", "end"])
            for chrom in sorted(inner.chrom.unique()):
                im = inner[inner.chrom == chrom]
                mm = inter_df[inter_df.chrom == chrom]
                mask = iv.any_overlap_mask(im.start.to_numpy(),
                                           im.end.to_numpy(),
                                           mm.start.to_numpy(),
                                           mm.end.to_numpy())
                span_windows.extend(im[~mask].values.tolist())
        else:
            if bptype == "DEL":
                span_windows.extend(inner.values.tolist())
            # DUP branch: reference cats a never-written file (:556) — no-op
        return large

    # inner candidate tables share the span-window row shape
    inner_del = cand_del.rename(columns={"type": "BPType"})
    inner_ins = cand_ins.rename(columns={"type": "BPType"})
    large_del = handle_type("DEL", inner_del, "DEL")
    large_dup = handle_type("DUP", inner_ins, "INS")

    large_del_path = f"{savedir}/CandidateLargeDEL.tumor.merged.decision.bed"
    large_dup_path = f"{savedir}/CandidateDUP.tumor.merged.decision.bed"
    _write_cluster_decision(filt, large_del, large_del_path)
    _write_cluster_decision(filt, large_dup, large_dup_path)

    # --- RoughCompare over candidate span windows (:569-618) ---
    denovo_rows, lc_rows = [], []
    for row in span_windows:
        chrom, start, end = row[0], int(row[1]), int(row[2])
        wtype = str(row[-1])
        line = rough_compare(t_table, n_table, chrom, start, end, wtype)
        counts = np.array(line.split("\t")[3:5], dtype=int)
        if counts.min() >= 3 and counts.min() <= 500:
            denovo_rows.append(line)
    for _, row in cand_lc.iterrows():
        line = rough_compare(t_table, n_table, row.chrom, int(row.start),
                             int(row.end), "INS")
        counts = np.array(line.split("\t")[3:5], dtype=int)
        if counts.min() >= 3 and counts.min() <= 500:
            lc_rows.append(line)
    _write_lines([_DEC_HEADER] + denovo_rows,
                 f"{savedir}/CandidateSpan.tumorDenovo.merged.decision.bed")
    _write_lines([_DEC_HEADER] + lc_rows,
                 f"{savedir}/CandidateSpan.tumorLC.merged.decision.bed")
    denovo_som = [l.rsplit("\t", 1)[0] for l in denovo_rows
                  if l.endswith("CandidateSom")]
    lc_som = [l.rsplit("\t", 1)[0] for l in lc_rows
              if l.endswith("CandidateSom")]
    lc_som_path = f"{savedir}/CandidateSpan.tumorLC.merged.decision.somatic.bed"
    _write_lines(lc_som, lc_som_path)

    # final merge: LC representation preferred on reciprocal-0.5 overlap,
    # then symmetric difference, then whole-line `sort -u` (:619-625)
    lc_df = _rows_to_df(lc_som)
    dn_df = _rows_to_df(denovo_som)
    hits = _reciprocal_hits(lc_df, dn_df, 0.5)
    lc_hit = {x for x, _ in hits}
    dn_hit = {y for _, y in hits}
    final = ([lc_som[i] for i in sorted(lc_hit)]
             + [lc_som[i] for i in lc_df.index if i not in lc_hit]
             + [denovo_som[i] for i in dn_df.index if i not in dn_hit])
    final = sorted(set(final))
    somatic_path = f"{savedir}/CandidateSpan.tumor.merged.decision.somatic.bed"
    _write_lines(final, somatic_path)

    # --- INV / TRA clusters (:626-634) ---
    inv = decide_with_dbscan(pd.concat([tum["clip_inv"], nor["clip_inv"]],
                                       ignore_index=True), eps, min_samples)
    tra = decide_with_dbscan(pd.concat([tum["clip_tra"], nor["clip_tra"]],
                                       ignore_index=True), eps, min_samples)
    inv_path = f"{savedir}/CandidateINV.tumor.merged.decision.bed"
    tra_path = f"{savedir}/CandidateTRA.tumor.merged.decision.bed"
    _write_cluster_csv(inv, inv_path)
    _write_cluster_csv(tra, tra_path)
    return dict(somatic_bed=somatic_path, large_del=large_del_path,
                large_dup=large_dup_path, inv=inv_path, tra=tra_path,
                lc_somatic=lc_som_path)


_DEC_HEADER = "chrom\tstart\tend\tTumorSpan\tNormalSpan\twindowType\twindowLabel"


def _rows_to_df(rows: list[str]) -> pd.DataFrame:
    if not rows:
        return pd.DataFrame(columns=["chrom", "start", "end"])
    parts = [r.split("\t") for r in rows]
    return pd.DataFrame({"chrom": [p[0] for p in parts],
                         "start": [int(p[1]) for p in parts],
                         "end": [int(p[2]) for p in parts]})


def _write_bed(df: pd.DataFrame, path: str):
    df.to_csv(path, sep="\t", header=False, index=False)


def _write_lines(lines: list[str], path: str):
    with open(path, "w") as f:
        for l in lines:
            f.write(l + "\n")


def _write_cluster_decision(filt: pd.DataFrame, large: pd.DataFrame, path: str):
    """Cluster-level rows for clusters whose read set appears in `large`
    (:526-531, 562-567), the file the InterALNSVs writer consumes."""
    if len(large) == 0 or len(filt) == 0:
        _write_cluster_csv(filt.iloc[0:0] if len(filt) else filt, path)
        return
    reads = set(large.readID)
    spans_idx = [lab for lab, g in filt.groupby("labels")
                 if ",".join(sorted(set(g.readID))) in reads]
    _write_cluster_csv(filt[filt.labels.isin(spans_idx)], path)


def _write_cluster_csv(df: pd.DataFrame, path: str):
    cols = ["BPsite", "readID", "BPType", "Site", "DataLabel", "labels"]
    if len(df) == 0:
        pd.DataFrame(columns=cols).to_csv(path, sep="\t", index=False)
        return
    out = df.copy()
    out["Site"] = [f"[{int(s[0])} {int(s[1])}]" for s in out.Site]
    out[cols].to_csv(path, sep="\t", index=False)
