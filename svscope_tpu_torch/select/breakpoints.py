"""Breakpoint extraction and classification from alignment records.

Re-implements reference src/WindowSelection_v8.py:46-264 over the in-memory
AlignmentTable (no bed.gz/tabix round-trip):

  * span_breakpoints: per alignment record, inner DEL/INS breakpoints
    (length >= 40) and CLIP breakpoints (soft/hard clip >= 100), with the
    reference's strand-aware CLIP coordinate rule (ParseCLIP, :46-76) and
    its readstart-from-reference-walk quirk for DEL/INS (:96-107).
  * non_unique_reads: reads whose fragments self-overlap > 100 bp on the
    read axis (NonUniqReads, :111-120).
  * classify_clip_pairs: adjacent CLIP-pair classification per read into
    SoloBP / TRA / INV / DUP / DEL (readsCLIP3, :179-210), including the
    SoloBP tail record's refstart[0] mate quirk (:192) and the >=100 kb
    same-chromosome TRA rule (:205-206).
  * linearized 2-D breakpoint coordinates for DBSCAN clustering
    (RegionEncoder/faiToChromDict, :212-264).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bam import parse_cigar_string

MATCH = frozenset("MX")
REF_GROW = frozenset("DPN")      # consume reference only
READ_GROW = frozenset("HSI")     # consume read only
CANON_CHROMS = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY", "chrM"]


@dataclass
class BreakpointRows:
    """Columnar breakpoint table (one row per breakpoint)."""
    chrom: list = field(default_factory=list)
    ref_start: list = field(default_factory=list)
    ref_end: list = field(default_factory=list)
    read_id: list = field(default_factory=list)
    read_start: list = field(default_factory=list)
    read_end: list = field(default_factory=list)
    ref_region: list = field(default_factory=list)   # "chrom:alnstart-alnend"
    read_region: list = field(default_factory=list)  # "readStart-readEnd"
    mapq: list = field(default_factory=list)
    strand: list = field(default_factory=list)
    bp_type: list = field(default_factory=list)      # DEL | INS | CLIP

    def extend_from(self, other: "BreakpointRows"):
        for f in self.__dataclass_fields__:
            getattr(self, f).extend(getattr(other, f))

    def __len__(self):
        return len(self.chrom)

    def asarrays(self):
        return {f: np.asarray(getattr(self, f)) for f in self.__dataclass_fields__}


def _cigar_letters_numbers(cigar: str):
    ops, lens = parse_cigar_string(cigar)
    letters = np.array(list("MIDNSHP=X"))[ops]
    return letters, lens


def span_breakpoints(chrom: str, start: int, end: int, read_id: str,
                     mapq: int, strand: str, cigar: str,
                     indel_cutoff: int = 40, clip_cutoff: int = 100,
                     out: BreakpointRows | None = None) -> BreakpointRows:
    """GetSpanReads + ParseCLIP equivalent for one alignment record."""
    bp = out if out is not None else BreakpointRows()
    letters, nums = _cigar_letters_numbers(cigar)
    is_match = np.isin(letters, ("M", "=", "X"))
    match_idx = np.flatnonzero(is_match)
    if match_idx.size == 0:
        return bp
    is_refgrow = np.isin(letters, ("D", "P", "N"))
    # full-read coordinates of the aligned block
    read_start_aln = int(nums[:match_idx[0]].sum())
    upto = match_idx[-1] + 1
    read_end_aln = int(nums[:upto][~is_refgrow[:upto]].sum())
    ref_region = f"{chrom}:{start}-{end}"
    read_region = f"{read_start_aln}-{read_end_aln}"

    # cumulative ref-walk before each op: matches + ref-growers
    ref_walk = np.cumsum(np.where(is_match | is_refgrow, nums, 0))
    ref_before = np.concatenate([[0], ref_walk[:-1]])
    for i in np.flatnonzero((letters == "D") & (nums >= indel_cutoff)):
        rs = int(start + ref_before[i])
        # readstart replicates the reference's ref-walk expression
        # (src/WindowSelection_v8.py:98: same sums as refstart, sans start)
        qs = int(ref_before[i])
        bp.chrom.append(chrom); bp.ref_start.append(rs)
        bp.ref_end.append(rs + int(nums[i]))
        bp.read_id.append(read_id); bp.read_start.append(qs)
        bp.read_end.append(qs)
        bp.ref_region.append(ref_region); bp.read_region.append(read_region)
        bp.mapq.append(int(mapq)); bp.strand.append(strand)
        bp.bp_type.append("DEL")
    for i in np.flatnonzero((letters == "I") & (nums >= indel_cutoff)):
        rs = int(start + ref_before[i])
        qs = int(ref_before[i])
        bp.chrom.append(chrom); bp.ref_start.append(rs)
        bp.ref_end.append(rs)
        bp.read_id.append(read_id); bp.read_start.append(qs)
        bp.read_end.append(qs + int(nums[i]))
        bp.ref_region.append(ref_region); bp.read_region.append(read_region)
        bp.mapq.append(int(mapq)); bp.strand.append(strand)
        bp.bp_type.append("INS")

    # CLIP breakpoints on strand-reversed cigar (ParseCLIP, :46-76)
    if strand == "-":
        letters_c, nums_c = letters[::-1], nums[::-1]
    else:
        letters_c, nums_c = letters, nums
    m_idx = np.flatnonzero(np.isin(letters_c, ("M", "=", "X")))
    rg_c = np.isin(letters_c, ("D", "P", "N"))
    rs_c = int(nums_c[:m_idx[0]].sum())
    upto_c = m_idx[-1] + 1
    re_c = int(nums_c[:upto_c][~rg_c[:upto_c]].sum())
    for i in np.flatnonzero(np.isin(letters_c, ("S", "H")) &
                            (nums_c >= clip_cutoff)):
        if i == 0:
            refpos = start if strand == "+" else end
            readpos = rs_c
        else:
            refpos = end if strand == "+" else start
            readpos = re_c
        bp.chrom.append(chrom); bp.ref_start.append(int(refpos))
        bp.ref_end.append(int(refpos))
        bp.read_id.append(read_id); bp.read_start.append(int(readpos))
        bp.read_end.append(int(readpos))
        bp.ref_region.append(ref_region)
        bp.read_region.append(f"{rs_c}-{re_c}")
        bp.mapq.append(int(mapq)); bp.strand.append(strand)
        bp.bp_type.append("CLIP")
    return bp


def non_unique_reads(read_regions: list[str], cutoff: int = 100) -> bool:
    """True when a read's aligned fragments self-overlap on more than
    `cutoff` read positions (NonUniqReads, :111-120)."""
    spans = np.array([r.split("-") for r in read_regions], dtype=np.int64)
    events = []
    for s, e in spans:
        events.append((s, 1))
        events.append((e + 1, -1))
    events.sort()
    depth = over = 0
    prev = None
    for pos, d in events:
        if prev is not None and depth > 1:
            over += pos - prev
        depth += d
        prev = pos
    return over > cutoff


def _region_overlap(a: str, b: str):
    """Inclusive-coordinate overlap ratios of two 'start-end' read regions
    (RegionOverlap, :136-144)."""
    sa, ea = map(int, a.split("-"))
    sb, eb = map(int, b.split("-"))
    la, lb = ea - sa + 1, eb - sb + 1
    ov = max(0, min(ea, eb) - max(sa, sb) + 1)
    return ov / la, ov / lb


def classify_clip_pairs(chroms, ref_starts, read_starts, read_regions,
                        ref_regions, strands, mapqs, read_id,
                        ovl_cutoff: float = 0.5, mapq_cutoff: int = 5,
                        length_threshold: int = 100_000) -> list[str]:
    """readsCLIP3 equivalent (:179-210).

    Inputs are the per-read CLIP rows (already sorted by read_start as in
    the reference's groupby of a read_start-sorted frame).  Returns records
    "BP1_BP2|readID|TYPE|mapQ"."""
    order = np.argsort([int(r.split("-")[0]) for r in read_regions],
                       kind="stable")
    n = len(order)
    if n < 2:
        return []
    arr = lambda x: [x[i] for i in order]
    chroms, ref_starts = arr(chroms), arr(ref_starts)
    read_regions, ref_regions = arr(read_regions), arr(ref_regions)
    strands, mapqs = arr(strands), arr(mapqs)
    out = []
    bp_sites = []
    for i in range(n - 1):
        ra, rb = _region_overlap(read_regions[i], read_regions[i + 1])
        if max(ra, rb) < ovl_cutoff and min(mapqs[i], mapqs[i + 1]) >= mapq_cutoff:
            bp_sites.append(i)
    if 0 not in bp_sites:
        out.append(f"{chroms[0]}:{ref_starts[0]}_{chroms[0]}:{ref_starts[0]}"
                   f"|{read_id}|SoloBP|{mapqs[0]}")
    if (n - 2) not in bp_sites:
        # tail SoloBP pairs refstart[-1] with refstart[0] — reference quirk
        # (src/WindowSelection_v8.py:192)
        out.append(f"{chroms[-1]}:{ref_starts[-1]}_{chroms[-1]}:{ref_starts[0]}"
                   f"|{read_id}|SoloBP|{mapqs[-1]}")
    for i in bp_sites:
        c1, c2 = chroms[i], chroms[i + 1]
        s1, s2 = int(ref_starts[i]), int(ref_starts[i + 1])
        mq = min(mapqs[i], mapqs[i + 1])
        pair = f"{c1}:{s1}_{c2}:{s2}"
        if c1 != c2:
            t = "TRA"
        elif strands[i] != strands[i + 1]:
            t = "INV"
        elif abs(s1 - s2) >= length_threshold:
            t = "TRA"
        else:
            t = _judge_dup_del(s1, s2, ref_regions[i], ref_regions[i + 1])
        out.append(f"{pair}|{read_id}|{t}|{mq}")
    return out


def _judge_dup_del(s1: int, s2: int, region1: str, region2: str) -> str:
    """JudgeDUPDEL (:158-177): DUP when both alignment blocks end exactly on
    the breakpoint window, DEL when both lie outside it."""
    ws, we = min(s1, s2), max(s1, s2)
    r1s, r1e = map(int, region1.split(":")[-1].split("-"))
    r2s, r2e = map(int, region2.split(":")[-1].split("-"))
    in1 = (r1s == ws) or (r1e == we)
    in2 = (r2s == ws) or (r2e == we)
    if in1 and in2:
        return "DUP"
    if not in1 and not in2:
        return "DEL"
    return "Others"


def chrom_offsets(fai_path: str) -> dict[str, int]:
    """faiToChromDict (:252-264): linear genome offsets.

    Chrom names are the canonical list; lengths come from the .fai in file
    order (the reference assumes they coincide — we key offsets by the
    actual fai names when they differ, which is strictly safer)."""
    names, lens = [], []
    with open(fai_path) as f:
        for line in f:
            p = line.split("\t")
            names.append(p[0])
            lens.append(int(p[1]))
    cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return {n: int(c) for n, c in zip(names, cum)}


def encode_site(bp_info: str, offsets: dict[str, int]) -> np.ndarray:
    """RegionEncoder (:212-219): sorted linearized (2,) coordinates."""
    c1, p1, c2, p2 = _split_pair(bp_info)
    a = int(p1) + offsets[c1]
    b = int(p2) + offsets[c2]
    return np.array([a, b]) if a <= b else np.array([b, a])


def sort_breakpoint(bp_info: str, offsets: dict[str, int]):
    """SortBreakPoint (:231-239)."""
    c1, p1, c2, p2 = _split_pair(bp_info)
    a = int(p1) + offsets[c1]
    b = int(p2) + offsets[c2]
    if a <= b:
        return [f"{c1}:{p1}", f"{c2}:{p2}"]
    return [f"{c2}:{p2}", f"{c1}:{p1}"]


def _split_pair(bp_info: str):
    left, right = bp_info.split("_")
    c1, p1 = left.rsplit(":", 1)
    c2, p2 = right.rsplit(":", 1)
    return c1, p1, c2, p2


def bp_arrange(sorted_bp_list) -> tuple[str, str]:
    """BPArrange (:241-250): mean position per side of a cluster."""
    bps = np.array(sorted_bp_list, dtype=object).reshape(-1, 2)
    c1 = bps[0, 0].split(":")[0]
    c2 = bps[0, 1].split(":")[0]
    m1 = int(np.mean([int(x.split(":")[-1]) for x in bps[:, 0]]))
    m2 = int(np.mean([int(x.split(":")[-1]) for x in bps[:, 1]]))
    return f"{c1}:{m1}", f"{c2}:{m2}"
