"""Per-window read/sequence extraction (DataMaker family).

Re-implements reference src/DataScanner.py:50-325 on top of the native BAM
reader: collect every read whose alignments span both the 5' flank
[start-offset, start] and the 3' flank [end, end+offset] of a candidate
window, slice the primary read sequence between the outermost flank
coordinates, and return (sequences, read IDs, flanks, flag).

Semantics replicated exactly:
  * flank-span test uses reference_start < flank_start and
    reference_end > flank_end on non-secondary records
    (src/DataScanner.py:82, 91)
  * supplementary leading hard-clips shift query coords into full-read
    space (src/DataScanner.py:84-87)
  * reads hitting one flank with >=2 alignments are blacklisted
    (src/DataScanner.py:100-104)
  * per read: slice start = min over F5 hits, end = max over F3 hits,
    sequence from the primary record with "N" stripped
    (src/DataScanner.py:115-118)
  * window gate: flag GapRegion when any N in flanks/window, flag
    NoEnoughspanReads when <=3 reads pass the mapQ gate
    (src/DataScanner.py:227-247)
  * DUP corner re-scan (DataMaker2): 50bp corner windows with per-read
    stitched subsequences across all non-secondary alignments sorted by
    read start (src/DataScanner.py:267-325)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.bam import BamReader
from ..io.fasta import FastaFile


@dataclass
class WindowData:
    sequences: list[str]     # [ref_window, read subseqs...] or []
    read_ids: np.ndarray     # label|name per read
    flank_5: str
    flank_3: str
    record: str              # the window bed record (verbatim)
    flag: str


def fetch_td_subseq(bam_readers: list[BamReader], labels: list[str],
                    chrom: str, start: int, end: int, offset: int = 200):
    """FetchTDsubSeq equivalent (src/DataScanner.py:67-122)."""
    f5s, f5e, f3s, f3e = start - offset, start, end, end + offset
    read_seqs: list[str] = []
    read_ids: list[str] = []
    mapqs: list[int] = []
    for rd, label in zip(bam_readers, labels):
        primary: dict[str, tuple[str, int]] = {}
        primary_order: list[str] = []
        f5_hits: dict[str, list[int]] = {}
        f3_hits: dict[str, list[int]] = {}
        f5_count: dict[str, int] = {}
        f3_count: dict[str, int] = {}
        for r in rd.fetch(chrom, start, end):
            if not (r.is_secondary or r.is_supplementary):
                if r.name not in primary:
                    primary_order.append(r.name)
                primary[r.name] = (r.seq, r.mapq)
            if r.is_secondary:
                continue
            hc = r.leading_hardclip() if r.is_supplementary else 0
            if r.reference_start < f5s and r.reference_end > f5e:
                q = hc + r.query_pos_floor(f5s)
                f5_hits.setdefault(r.name, []).append(q)
                f5_count[r.name] = f5_count.get(r.name, 0) + 1
            if r.reference_start < f3s and r.reference_end > f3e:
                q = hc + r.query_pos_ceil(f3e)
                f3_hits.setdefault(r.name, []).append(q)
                f3_count[r.name] = f3_count.get(r.name, 0) + 1
        blacklist = {n for n, c in f5_count.items() if c >= 2}
        blacklist |= {n for n, c in f3_count.items() if c >= 2}
        span = [n for n in sorted(set(primary) & set(f5_hits) & set(f3_hits))
                if n not in blacklist]
        if len(primary) and len(f5_hits) and len(f3_hits) and len(span) >= 3:
            for name in span:
                qseq, mq = primary[name]
                s = min(f5_hits[name])
                e = max(f3_hits[name])
                read_ids.append(f"{label}|{name}")
                read_seqs.append(qseq[s:e].replace("N", ""))
                mapqs.append(int(mq))
    return read_seqs, read_ids, mapqs


def data_maker(record: str, ref: FastaFile, bam_readers: list[BamReader],
               labels: list[str], offset: int = 200, mapq: int = 5) -> WindowData:
    """DataMaker equivalent (src/DataScanner.py:222-247)."""
    parts = record.strip().split("\t")
    chrom, start, end = parts[0], int(parts[1]), int(parts[2])
    seqs, ids, mqs = fetch_td_subseq(bam_readers, labels, chrom, start, end, offset)
    certain = [i for i in range(len(mqs)) if mqs[i] >= mapq]
    flank_5 = ref.fetch(chrom, start - offset, start).upper()
    flank_3 = ref.fetch(chrom, end, end + offset).upper()
    window = ref.fetch(chrom, start - offset, end + offset).upper()
    if "N" in flank_5 or "N" in flank_3 or "N" in window:
        return WindowData([], np.array([]), flank_5, flank_3, record, "GapRegion")
    if len(certain) <= 3:
        return WindowData([], np.array([]), flank_5, flank_3, record,
                          "NoEnoughspanReads")
    sequences = [window] + [seqs[i] for i in certain]
    read_ids = np.array([ids[i] for i in certain])
    return WindowData(sequences, read_ids, flank_5, flank_3, record,
                      "NormalOutput")


def _subseq_in_window(bam_readers, labels, chrom: str, start: int, end: int):
    """SubSeqInWindow equivalent (src/DataScanner.py:267-295): stitch each
    read's pieces across all its non-secondary alignments in the window,
    ordered by position on the read."""
    pieces: dict[str, list[tuple[int, int]]] = {}
    primary: dict[str, tuple[str, int]] = {}
    for rd, label in zip(bam_readers, labels):
        for r in rd.fetch(chrom, start, end):
            rid = f"{label}|{r.name}"
            if not (r.is_secondary or r.is_supplementary):
                primary[rid] = (r.seq, r.mapq)
            if r.is_secondary:
                continue
            hc = r.leading_hardclip()
            rs, re_ = r.reference_start, r.reference_end
            try:
                if rs < start and re_ > end:
                    qs, qe = r.query_pos_floor(start), r.query_pos_ceil(end)
                elif start <= rs < end and re_ > end:
                    qs, qe = _first_q(r), r.query_pos_ceil(end)
                elif rs < start and start < re_ <= end:
                    qs, qe = r.query_pos_floor(start), _last_q(r)
                elif rs >= start and re_ <= end:
                    qs, qe = _first_q(r), _last_q(r)
                else:
                    continue
            except ValueError:
                continue
            pieces.setdefault(rid, []).append((hc + qs, hc + qe))
    seqs, ids, mqs = [], [], []
    for rid in sorted(set(primary) & set(pieces)):
        qseq, mq = primary[rid]
        sub = ""
        for qs, qe in sorted(pieces[rid]):
            sub += qseq[qs:qe]
        ids.append(rid)
        seqs.append(sub)
        mqs.append(int(mq))
    return seqs, ids, mqs


def _first_q(r):
    qs, _, _ = r.match_runs()
    return int(qs[0])


def _last_q(r):
    qs, _, ln = r.match_runs()
    return int(qs[-1] + ln[-1] - 1)


def data_maker2(record: str, ref: FastaFile, bam_readers, labels,
                offset: int = 200, mapq: int = 5):
    """DataMaker2 equivalent (src/DataScanner.py:297-325): re-scan the two
    50bp breakpoint corner windows of a DUP candidate."""
    parts = record.strip().split("\t")
    chrom, start, end = parts[0], int(parts[1]), int(parts[2])
    out = []
    for ws, we, default_flag in ((start, start + 50, "UnspanedSV"),
                                 (end - 50, end, "UnspannedSV")):
        seqs, ids, mqs = _subseq_in_window(bam_readers, labels, chrom, ws, we)
        certain = [i for i in range(len(mqs)) if mqs[i] >= mapq]
        if len(certain) <= 3:
            out.append(WindowData([], np.array([]), "", "", record,
                                  "Unspaned+NotEnoughReads"))
        else:
            seq_list = [ref.fetch(chrom, ws, we).upper()] + [seqs[i] for i in certain]
            out.append(WindowData(seq_list, np.array([ids[i] for i in certain]),
                                  "", "", record, default_flag))
    return out
