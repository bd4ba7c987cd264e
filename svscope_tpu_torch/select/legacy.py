"""Legacy window-selection lineage (SURVEY §2.1 rows v7 / v3 / v1).

The reference ships three superseded generations of its candidate-window
selector alongside v8 — `WindowSelection_v7.py`,
`SelectCandidateWindows_v3.py`, `SelectCandidateWindows.py` — whose
`main()`s are runnable even though `SVscope.py` never imports them.
This module completes the inventory with the lineage's *distinct
algorithms* (everything else is shared with the v8 engine in
select/windows.py):

* `classify_clip_pairs_v1` — v1's `readsCLIP`
  (reference SelectCandidateWindows.py:72-111): walk CLIP points in
  read-coordinate order; a left-clip start opens a SoloBP pairing with
  the NEXT point; a right-clip followed within 50 bp on the read by a
  left-clip classifies DUP (same strand/chrom, ref steps backwards past
  the current fragment start — with the double-DUP lookahead when the
  next two fragments share a read region), INV (strand flip), TRA
  (chrom change), else SoloBP.
* `classify_clip_pairs_v2` — v3's `readsCLIP2`
  (SelectCandidateWindows_v3.py:103-144): group CLIP points whose
  read-coordinates lie within `mergecutoff`; drop groups whose fragments
  self-overlap on the read by >= 50% (`NonUniqDetail`); singleton groups
  emit SoloBP; larger groups pair consecutive fragments into
  TRA / INV / Others (DUP and large DEL are not yet distinguished —
  that is v8's `JudgeDUPDEL`).
* `window_selection_v7` — v7's `FindCandidateSVWindow` flow: the v8
  engine minus the RepeatMasker/LC channel and minus the chrM
  exclusion (WindowSelection_v7.py vs _v8 diff; the remaining deltas —
  multi-bed.gz staging, `sort -T ./` tmpdirs — have no analog in the
  in-memory columnar engine).

Behavioral parity for the classifiers is tested against the reference
modules imported as oracles (tests/test_select_legacy.py).
"""
from __future__ import annotations

import numpy as np

from .windows import find_candidate_sv_windows


def sort_read_span(read_regions) -> np.ndarray:
    """Fragment order by on-read start (`SortReadSpan`,
    SelectCandidateWindows.py / _v3)."""
    starts = np.array([int(str(x).split("-")[0]) for x in read_regions])
    return np.argsort(starts)


def non_uniq_detail(read_regions) -> float:
    """Fraction of covered read positions claimed by >1 fragment
    (`NonUniqDetail`, SelectCandidateWindows_v3.py:89-96)."""
    span = np.array([str(x).split("-") for x in np.unique(read_regions)],
                    dtype=int)
    cov = np.zeros(int(span.max()) + 1)
    for s in span:
        cov[np.arange(s[0], s[-1] + 1)] += 1
    sub = cov[int(span.min()):]
    return float((sub > 1).sum() / sub.shape[0])


def _bp(chrom1, pos1, chrom2, pos2, read_id, kind) -> str:
    return f"{chrom1}:{pos1}_{chrom2}:{pos2}|{read_id}|{kind}"


def classify_clip_pairs_v1(chroms, ref_starts, read_starts, read_regions,
                           ref_regions, strands, read_id: str):
    """v1 `readsCLIP` (SelectCandidateWindows.py:72-111): one read's CLIP
    points -> breakpoint-pair records.  Inputs are parallel per-CLIP-point
    arrays in bed order; ref_regions are 'chrom:start-end' strings."""
    chroms = list(chroms)
    ref_starts = np.asarray(ref_starts, dtype=int)
    read_starts = np.asarray(read_starts, dtype=int)
    read_regions = [str(x) for x in read_regions]
    ref_regions = [str(x) for x in ref_regions]
    strands = list(strands)
    order = sort_read_span(read_regions)
    out: list[str] = []
    if len(order) == 1:
        out.append(_bp(chroms[0], ref_starts[0], chroms[0], ref_starts[0],
                       read_id, "SoloBP"))
        return out
    i = 0
    while i < order.shape[0] - 1:
        a = order[i]
        if read_regions[a].split("-")[0] == str(read_starts[a]):
            # left-clip point: SoloBP paired with the NEXT point's refstart
            out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                           ref_starts[order[i + 1]], read_id, "SoloBP"))
            i += 1
        else:
            b = order[i + 1]
            near = (abs(int(read_starts[b]) - int(read_starts[a])) < 50
                    and read_starts[b]
                    == int(read_regions[b].split("-")[0]))
            if near:
                same = (strands[a] == strands[b]
                        and chroms[a] == chroms[b])
                frag_ref_start = int(ref_regions[a].split(":")[-1]
                                     .split("-")[0])
                if (same and ref_starts[b] < ref_starts[a]
                        and ref_starts[b] > frag_ref_start):
                    out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                                   ref_starts[b], read_id, "DUP"))
                    if i + 2 < order.shape[0] and \
                            read_regions[b] == read_regions[order[i + 2]]:
                        out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                                       ref_starts[b], read_id, "DUP"))
                        i += 3
                    else:
                        i += 2
                elif strands[a] != strands[b] and chroms[a] == chroms[b]:
                    out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                                   ref_starts[b], read_id, "INV"))
                    i += 2
                elif chroms[a] != chroms[b]:
                    out.append(_bp(chroms[a], ref_starts[a], chroms[b],
                                   ref_starts[b], read_id, "TRA"))
                    i += 2
                else:
                    out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                                   ref_starts[a], read_id, "SoloBP"))
                    i += 1
            else:
                out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                               ref_starts[a], read_id, "SoloBP"))
                i += 1
        if i >= order.shape[0] - 1:
            break
    return out


def classify_clip_pairs_v2(chroms, ref_starts, read_starts, read_regions,
                           ref_regions, strands, read_id: str,
                           mergecutoff: int = 100):
    """v3 `readsCLIP2` (SelectCandidateWindows_v3.py:103-144): read-gap
    grouping + NonUniq filtering, consecutive fragments paired into
    SoloBP / TRA / INV / Others."""
    chroms = list(chroms)
    ref_starts = np.asarray(ref_starts, dtype=int)
    read_starts = np.asarray(read_starts, dtype=int)
    read_regions = [str(x) for x in read_regions]
    strands = list(strands)
    split_at = np.where(np.diff(read_starts) > mergecutoff)[0]
    groups = np.split(np.arange(len(read_starts)), split_at + 1)
    out: list[str] = []
    for g in groups:
        if non_uniq_detail([read_regions[i] for i in g]) >= 0.5:
            continue
        if g.shape[0] == 1:
            a = g[0]
            out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                           ref_starts[a], read_id, "SoloBP"))
            continue
        if np.unique([read_regions[i] for i in g]).shape[0] == 1:
            for a in g:
                out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                               ref_starts[a], read_id, "SoloBP"))
            continue
        order = sort_read_span([read_regions[i] for i in g])
        r = 0
        while r < len(order) - 1:
            a, b = g[order[r]], g[order[r + 1]]
            if read_regions[a] == read_regions[b]:
                out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                               ref_starts[a], read_id, "SoloBP"))
                r += 1
            else:
                if chroms[a] != chroms[b]:
                    kind = "TRA"
                elif strands[a] != strands[b]:
                    kind = "INV"
                else:
                    kind = "Others"
                out.append(_bp(chroms[a], ref_starts[a], chroms[b],
                               ref_starts[b], read_id, kind))
                r += 2
            if r == len(order) - 1:
                out.append(_bp(chroms[a], ref_starts[a], chroms[a],
                               ref_starts[a], read_id, "SoloBP"))
    return out


def window_selection_v7(t_table, n_table, fai_path: str, savedir: str,
                        eps: float = 500.0, min_samples: int = 3,
                        t_bp=None, n_bp=None):
    """v7 `FindCandidateSVWindow` flow (WindowSelection_v7.py): the v8
    engine without the RepeatMasker/LC channel and without the chrM
    exclusion.  Returns the same output-path dict as
    find_candidate_sv_windows."""
    return find_candidate_sv_windows(
        t_table, n_table, fai_path, repeat_bed=None, savedir=savedir,
        eps=eps, min_samples=min_samples, t_bp=t_bp, n_bp=n_bp,
        rm_chroms=())
