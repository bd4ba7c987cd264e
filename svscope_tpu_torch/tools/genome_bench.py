"""Genome-scale end-to-end run: several chromosomes, ONT-like reads, planted
somatic truth and decoys built to die at one stage each; precision and
recall per stage, with wall times (counterpart of tools/genome_bench.py).

Planted classes (SLOT_CLASSES, CLASSES_DOC): four truth tiers (som, som3
at the minimum support, som45 at the size threshold, sompair: two
adjacent subclonal events) and five decoy tiers: germ and noise die at
window selection, germ_comp at the EM's tumor-only rule, germ_gate at the
engine's mapQ gate, rf_trap only at the random forest. Reads carry ~2 %
substitutions and 1-3 bp indels at ~1 %.

The inputs are the JAX harness's, drawn by the port's own io with the
same rng calls in the same order, so every file a run leaves (the BAMs
included) can be held against the JAX run's (`chrom_bench.output_hashes`).

    python -m svscope_tpu_torch.tools.genome_bench [--mb-per-chrom 5]
        [--chroms 4] [--depth 12] [--device cuda|cpu]
        [--device-poa pallas|fused|host] [--savedir D] [--stream]

The defaults are the 20 Mb configuration (4 x 5 Mb at depth 12, seed 11).
--device defaults to cuda (raises without CUDA); --device-poa omitted is
the engine's policy (K1 on cuda, the host C++ engine on cpu). `--stream`
synthesizes, then runs the pipeline twice in fresh processes
(`--pipeline-only`): a warm-up, whose exit code it prints, and the
measured run, which asserts its peak RSS and whose exit code is the
tool's.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 11


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def ont_read(rng, ref, name, a0, a1, sv=None, mapq: int = 60,
             ref_id: int = 0, sub=0.02, indel=0.01):
    """BamRecord over ref[a0:a1) with ONT-like noise: substitutions stay
    inside M ops; 1-3 bp insertions/deletions get their own cigar ops; an
    optional ("INS", pos, seq) / ("DEL", pos, len) SV, or a list of such
    svs sorted by position, is emitted exactly."""
    from ..io.bam import BamRecord, parse_cigar_string
    if sv is None and indel == 0:
        # the background reads: vectorized substitutions, one M op
        arr = np.frombuffer(ref[a0:a1].encode(), np.uint8).copy()
        hits = np.flatnonzero(rng.random(arr.size) < sub)
        arr[hits] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, hits.size)]
        ops, lens = parse_cigar_string(f"{arr.size}M")
        return BamRecord(name, 0, ref_id, a0, mapq, ops, lens,
                         arr.tobytes().decode())
    svs = list(sv) if sv and isinstance(sv[0], (tuple, list)) else \
        ([sv] if sv else [])
    svs.sort(key=lambda s: s[1])
    seq_parts = []
    cig = []

    def emit(op, ln):
        if ln <= 0:
            return
        if cig and cig[-1][0] == op:
            cig[-1][1] += ln
        else:
            cig.append([op, ln])

    p = a0
    while p < a1:
        if svs and p >= svs[0][1]:
            s0 = svs.pop(0)
            if s0[0] == "INS":
                seq_parts.append(s0[2])
                emit("I", len(s0[2]))
            else:
                dl = min(s0[2], a1 - p - 1)
                emit("D", dl)
                p += dl
                continue
        r = rng.random()
        if r < indel / 2 and a0 < p < a1 - 2:          # small insertion
            ln = int(rng.integers(1, 4))
            seq_parts.append(rand_seq(rng, ln))
            emit("I", ln)
        elif r < indel and p < a1 - 4:                 # small deletion
            ln = int(rng.integers(1, 4))
            emit("D", ln)
            p += ln
            continue
        base = ref[p]
        if rng.random() < sub:
            base = "ACGT"[int(rng.integers(0, 4))]
        seq_parts.append(base)
        emit("M", 1)
        p += 1
    cigar = "".join(f"{ln}{op}" for op, ln in cig)
    ops, lens = parse_cigar_string(cigar)
    return BamRecord(name, 0, ref_id, a0, mapq, ops, lens,
                     "".join(seq_parts))


def clip_read(rng, ref, name, pos, mapq, ref_id):
    """Artifact read: one-sided soft clip at pos (random clip content)."""
    from ..io.bam import BamRecord, parse_cigar_string
    ml = int(rng.integers(300, 600))
    cl = int(rng.integers(150, 400))
    left = rng.random() < 0.5
    cigar = f"{cl}S{ml}M" if left else f"{ml}M{cl}S"
    ops, lens = parse_cigar_string(cigar)
    seq = (rand_seq(rng, cl) + ref[pos:pos + ml]) if left else \
        (ref[pos:pos + ml] + rand_seq(rng, cl))
    return BamRecord(name, 0, ref_id, pos, mapq, ops, lens, seq)


# per-chromosome slot layout: 16 planted loci cycling through the classes
SLOT_CLASSES = ("som", "som", "germ", "noise",
                "som3", "som45", "sompair", "rf_trap",
                "som", "germ_comp", "germ_gate", "noise",
                "som", "som45", "germ_comp", "rf_trap")
TRUTH_CLASSES = ("som", "som3", "som45", "sompair")
DECOY_CLASSES = ("germ", "noise", "germ_comp", "germ_gate", "rf_trap")
CLASSES_DOC = {
    # class: (is truth, tier expected to reject it)
    "som":       "truth: 6/12 tumor reads carry a 60-200 bp INS/DEL",
    "som3":      "truth boundary: exactly 4 carriers, selection's >3-read"
                 " bp-merge threshold; EM's somatic-cluster minimum is 3",
    "som45":     "truth boundary: svlen 42-58 (40 bp selection threshold /"
                 " 50 bp VCF INS type threshold)",
    "sompair":   "truth: two adjacent subclonal INS ~200 bp apart, merged"
                 " into one window; EM must resolve two tumor clusters",
    "germ":      "decoy, selection-tier: SV in all tumor AND normal reads",
    "noise":     "decoy, selection-tier: tumor-only low-mapQ pileup+clips",
    "germ_comp": "decoy, EM-tier: germline ALT in both samples, normal ALT"
                 " length-compensated by scattered <40 bp deletions;"
                 " passes the selection length test, EM co-clusters the"
                 " carriers (mixed tags) and the tumor-only rule rejects",
    "germ_gate": "decoy, engine-gate tier: normal spans only at mapQ<5"
                 " (selection counts mapQ>=0, engine needs >=5); passes"
                 " selection, engine normal-tag gate rejects",
    "rf_trap":   "decoy, RF-tier: consistent tumor-only INS inside an"
                 " artifact context (coverage spike, low-mapQ pileup,"
                 " cross-chromosome alignments); EM accepts, the RF's"
                 " whole-genome alignment features reject",
}


def build_genome(d, n_chroms, mb, depth, rng):
    """Write ref.fa, tumor.bam and normal.bam under d; returns (ref_path,
    tumor, normal, classes), classes: class -> [(chrom, start, end,
    svtype, svlen)]."""
    from ..io.bam import BamWriter
    from ..io.fasta import write_fasta
    clen = int(mb * 1e6)
    names = [f"chr{c + 1}" for c in range(n_chroms)]
    refs = {nm: rand_seq(rng, clen) for nm in names}
    ref_path = os.path.join(d, "ref.fa")
    write_fasta(ref_path, refs)
    classes: dict[str, list] = {c: [] for c in SLOT_CLASSES}
    t_recs, n_recs = [], []
    per_chrom = 16
    for ci, nm in enumerate(names):
        ref = refs[nm]
        step = clen // (per_chrom + 2)
        for k in range(per_chrom):
            s = (k + 1) * step + int(rng.integers(-step // 8, step // 8))
            e = s + 100
            mid = (s + e) // 2
            svtype = "INS" if k % 2 == 0 else "DEL"
            cls = SLOT_CLASSES[k]
            if cls == "som45":
                svlen = int(rng.integers(42, 59))
            elif cls == "germ_comp":
                # 48 bp of sub-40 bp compensation near the bp site keeps
                # normal ALT within +40 of tumor ALT for the length test
                svlen = int(rng.integers(66, 81))
            else:
                svlen = int(rng.integers(60, 200))
            ins = rand_seq(rng, svlen)
            classes[cls].append((nm, s, e, svtype, svlen))

            def jsv(jrng=rng, stype=svtype, slen=svlen, iseq=ins):
                jm = mid + int(jrng.integers(-15, 16))
                return ("INS", jm, iseq) if stype == "INS" else \
                    ("DEL", jm - slen // 2, slen)

            if cls == "noise":
                # mapping artifact: tumor-only low-mapQ pileup + clips
                for i in range(depth):
                    mq = 3 if i % 2 else 60
                    t_recs.append(ont_read(rng, ref, f"{nm}ar{k}t{i}",
                                           s - 350, e + 350, None, mq, ci))
                for i in range(6):
                    t_recs.append(clip_read(
                        rng, ref, f"{nm}cl{k}t{i}",
                        mid + int(rng.integers(-200, 200)), 60, ci))
                for i in range(depth):
                    n_recs.append(ont_read(rng, ref, f"{nm}ar{k}n{i}",
                                           s - 350, e + 350, None, 60, ci))
            elif cls in ("som", "som3", "som45"):
                carriers = 4 if cls == "som3" else 6
                for i in range(depth):
                    r_sv = jsv() if i < carriers else None
                    t_recs.append(ont_read(rng, ref, f"{nm}s{k}t{i}",
                                           s - 350, e + 350, r_sv, 60, ci))
                for i in range(depth):
                    n_recs.append(ont_read(rng, ref, f"{nm}s{k}n{i}",
                                           s - 350, e + 350, None, 60, ci))
            elif cls == "sompair":
                # two subclonal INS ~200 bp apart (merge -d 200 joins them)
                ins_b = rand_seq(rng, max(60, svlen))
                m1, m2 = mid - 100, mid + 100
                for i in range(depth):
                    if i < 4:
                        r_sv = ("INS", m1 + int(rng.integers(-10, 11)), ins)
                    elif i < 8:
                        r_sv = ("INS", m2 + int(rng.integers(-10, 11)),
                                ins_b)
                    else:
                        r_sv = None
                    t_recs.append(ont_read(rng, ref, f"{nm}p{k}t{i}",
                                           s - 350, e + 350, r_sv, 60, ci))
                for i in range(depth):
                    n_recs.append(ont_read(rng, ref, f"{nm}p{k}n{i}",
                                           s - 350, e + 350, None, 60, ci))
            elif cls == "germ":
                # classic germline: SV in all tumor AND normal reads
                for i in range(depth):
                    t_recs.append(ont_read(rng, ref, f"{nm}g{k}t{i}",
                                           s - 350, e + 350, jsv(), 60, ci))
                    n_recs.append(ont_read(rng, ref, f"{nm}g{k}n{i}",
                                           s - 350, e + 350, jsv(), 60, ci))
            elif cls == "germ_comp":
                # germline ALT in both; the normal ALT carriers compensate
                # the INS with six 8 bp deletions hugging the site (each
                # far below the 40 bp breakpoint threshold, 9 bp apart so
                # the D ops never coalesce): selection's "tumor > all
                # normal + 40" test sees tumor-only evidence, the EM the
                # shared ALT columns in both samples
                ins60 = ins if svtype == "INS" else rand_seq(rng, svlen)
                comp = [("DEL", int(p), 8)
                        for p in (mid - 45, mid - 36, mid - 27,
                                  mid + 22, mid + 31, mid + 40)]
                for i in range(depth):
                    jm = mid + int(rng.integers(-15, 16))
                    alt = ("INS", jm, ins60)
                    if i < 6:
                        t_recs.append(ont_read(rng, ref, f"{nm}c{k}t{i}",
                                               s - 350, e + 350, alt, 60,
                                               ci))
                    else:
                        t_recs.append(ont_read(rng, ref, f"{nm}c{k}t{i}",
                                               s - 350, e + 350, None, 60,
                                               ci))
                    if i < 4:
                        n_recs.append(ont_read(
                            rng, ref, f"{nm}c{k}n{i}", s - 350, e + 350,
                            comp + [alt], 60, ci))
                    else:
                        n_recs.append(ont_read(rng, ref, f"{nm}c{k}n{i}",
                                               s - 350, e + 350, None, 60,
                                               ci))
            elif cls == "germ_gate":
                # germline where the normal spans only through mapQ<5 REF
                # reads (fragmented ALT): selection's normal count
                # (mapQ>=0) passes, the engine's mapQ>=5 fetch sees no
                # spanning normal and the decision gate rejects
                for i in range(depth):
                    r_sv = jsv() if i < 6 else None
                    t_recs.append(ont_read(rng, ref, f"{nm}q{k}t{i}",
                                           s - 350, e + 350, r_sv, 60, ci))
                for i in range(depth // 2):
                    n_recs.append(ont_read(rng, ref, f"{nm}q{k}n{i}",
                                           s - 350, e + 350, None, 3, ci))
                for i in range(depth // 2):     # fragmented ALT halves
                    n_recs.append(ont_read(rng, ref, f"{nm}qf{k}a{i}",
                                           s - 350, mid, None, 60, ci))
                    n_recs.append(ont_read(rng, ref, f"{nm}qf{k}b{i}",
                                           mid + 1, e + 350, None, 60, ci))
            elif cls == "rf_trap":
                # consistent tumor-only INS in a mapping-artifact context:
                # the EM phases it, the RF's whole-genome features (COV z,
                # mapQ rate, chromSpan) must reject it
                other = names[(ci + 1) % n_chroms]
                for i in range(depth):
                    r_sv = jsv(stype="INS", iseq=ins) if i < 6 else None
                    t_recs.append(ont_read(rng, ref, f"{nm}f{k}t{i}",
                                           s - 350, e + 350, r_sv, 60, ci))
                    if i < 8:   # cross-chromosome secondary alignments
                        opos = (s + 777) % (clen - 2000)
                        t_recs.append(ont_read(
                            rng, refs[other], f"{nm}f{k}t{i}", opos,
                            opos + 1200, None, 60, (ci + 1) % n_chroms))
                for i in range(2 * depth):      # low-mapQ coverage spike
                    t_recs.append(ont_read(rng, ref, f"{nm}fx{k}t{i}",
                                           s - 350, e + 350, None, 3, ci))
                for i in range(depth):
                    n_recs.append(ont_read(rng, ref, f"{nm}f{k}n{i}",
                                           s - 350, e + 350, None, 60, ci))
        # background coverage at ~window depth keeps the candidate windows'
        # COV z-scores in the RF's trained range; background reads that
        # overlap a planted window are dropped so its coverage stays at the
        # genome average (the RF is coverage-z-score sensitive)
        rl_lo, rl_hi = 1800, 3600
        n_bg = int(clen * depth / ((rl_lo + rl_hi) / 2))
        spans = np.array([(t[1], t[2]) for cl in classes.values()
                          for t in cl if t[0] == nm]
                         or [(0, 0)], np.int64)
        for sample, recs, tag in ((0, t_recs, "bt"), (1, n_recs, "bn")):
            starts = rng.integers(0, clen - rl_lo, n_bg)
            lens_r = rng.integers(rl_lo, rl_hi, n_bg)
            mqs = np.where(rng.random(n_bg) < 0.07, 3, 60)
            ends = np.minimum(starts + lens_r, clen)
            hit = ((starts[:, None] <= spans[None, :, 1] + 400)
                   & (ends[:, None] >= spans[None, :, 0] - 400)).any(1)
            for i in np.flatnonzero(~hit):
                recs.append(ont_read(rng, ref, f"{nm}{tag}{i}",
                                     int(starts[i]), int(ends[i]),
                                     None, int(mqs[i]), ci, sub=0.01,
                                     indel=0))
    tumor = os.path.join(d, "tumor.bam")
    normal = os.path.join(d, "normal.bam")
    lens = [clen] * n_chroms
    with BamWriter(tumor, names, lens) as w:
        for r in sorted(t_recs, key=lambda r: (r.ref_id, r.pos)):
            w.write(r)
    with BamWriter(normal, names, lens) as w:
        for r in sorted(n_recs, key=lambda r: (r.ref_id, r.pos)):
            w.write(r)
    return ref_path, tumor, normal, classes


def overlaps(calls, span):
    nm, s, e = span[:3]
    return any(cn == nm and cs <= e and ce >= s for cn, cs, ce in calls)


def score(calls, truth, decoys) -> dict:
    """Calls against the planted truth: precision [calls on truth, calls],
    recall [truth hit, truth], decoys [decoys hit, decoys]."""
    spans = [(t[0], t[1], t[2]) for t in truth]
    on_truth = sum(1 for c in calls if overlaps(spans, c))
    return {"precision": [on_truth, len(calls)],
            "recall": [sum(1 for t in truth if overlaps(calls, t)),
                       len(truth)],
            "decoys": [sum(1 for g in decoys if overlaps(calls, g)),
                       len(decoys)]}


def ratio(pair) -> float:
    """A [hit, of] pair as the JAX harness prints it (1.0 when of is 0)."""
    return pair[0] / pair[1] if pair[1] else 1.0


def tier_table(classes, cand_spans, som_calls, vcf_calls) -> dict:
    """Per class: [n, candidate windows, Raw.bed EMOutput rows, VCF
    records] that overlap its planted spans."""
    return {c: [len(classes[c]),
                sum(1 for m in classes[c] if overlaps(cand_spans, m)),
                sum(1 for m in classes[c] if overlaps(som_calls, m)),
                sum(1 for m in classes[c] if overlaps(vcf_calls, m))]
            for c in TRUTH_CLASSES + DECOY_CLASSES}


def launch_counts() -> dict:
    """Kernel launches so far: K1, K2 and the fused build's K3-K7 (each
    wrapper's count)."""
    from ..ops import nw_kernel, poa_align
    from ..ops import poa_fused_kernel as tpk
    return {"K1": poa_align.LAUNCHES, "K2": nw_kernel.LAUNCHES,
            **tpk.LAUNCHES}


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def run(mb_per_chrom: float = 5.0, chroms: int = 4, depth: int = 12,
        device="cuda", device_poa=None, savedir: str | None = None,
        synth: bool = True, log=print) -> dict:
    """The whole pipeline on a synthesized genome: scan with breakpoints,
    window selection, InterALN, localGraph, AlnFeature (forest and VCFs).

    synth=False reads the inputs and classes.json a synthesizing run left
    in savedir. Returns the candidate count, `raw_bed` and `vcf` (score's
    pairs), the per-class `tiers`, the stage walls (`stages`, s), the
    kernel launches of the run (`launches`), the directory and the sha256
    of every file it leaves (`hashes`)."""
    from .. import cli
    from ..engine.localgraph import run_local_graph
    from ..native.bam import scan_with_breakpoints
    from ..select.interaln import write_interaln_vcf
    from ..select.windows import find_candidate_sv_windows
    from ..utils.device import resolve_device
    from .chrom_bench import output_hashes
    dev = resolve_device(device)
    d = savedir or tempfile.mkdtemp(prefix="genomebench_")
    os.makedirs(d, exist_ok=True)
    stages = {}
    if synth:
        t0 = time.perf_counter()
        ref_path, tumor, normal, classes = build_genome(
            d, chroms, mb_per_chrom, depth, np.random.default_rng(SEED))
        with open(os.path.join(d, "classes.json"), "w") as f:
            json.dump(classes, f)
        stages["synth"] = time.perf_counter() - t0
    else:
        with open(os.path.join(d, "classes.json")) as f:
            classes = {k: [tuple(t) for t in v]
                       for k, v in json.load(f).items()}
        ref_path, tumor, normal = (os.path.join(d, n) for n in
                                   ("ref.fa", "tumor.bam", "normal.bam"))
    truth = [t for c in TRUTH_CLASSES for t in classes[c]]
    decoys = [t for c in DECOY_CLASSES for t in classes[c]]
    log(f"[synth] {stages.get('synth', 0.0):.3f}s  {chroms} chroms x "
        f"{mb_per_chrom:g} Mb, depth {depth}; {len(truth)} truth ("
        + ", ".join(f"{c} {len(classes[c])}" for c in TRUTH_CLASSES)
        + f"); {len(decoys)} decoys ("
        + ", ".join(f"{c} {len(classes[c])}" for c in DECOY_CLASSES) + ")")
    before = launch_counts()

    t0 = time.perf_counter()
    t_table, t_bp = scan_with_breakpoints(tumor)
    n_table, n_bp = scan_with_breakpoints(normal)
    stages["scan"] = time.perf_counter() - t0
    log(f"[scan] {stages['scan']:.3f}s  tumor {len(t_table)} aln, normal "
        f"{len(n_table)} aln; peak RSS {peak_rss_mb():.0f} MB")

    t0 = time.perf_counter()
    paths = find_candidate_sv_windows(t_table, n_table, ref_path + ".fai",
                                      None, d, t_bp=t_bp, n_bp=n_bp)
    write_interaln_vcf(d, ref_path + ".fai", "tumor", paths)
    with open(paths["somatic_bed"]) as f:
        windows = [l for l in f.read().splitlines() if l.strip()]
    stages["select"] = time.perf_counter() - t0
    log(f"[select] {stages['select']:.3f}s  {len(windows)} candidate "
        f"windows; peak RSS {peak_rss_mb():.0f} MB")

    t0 = time.perf_counter()
    raw = run_local_graph(windows, ref_path, [tumor], [normal], ["T1"],
                          ["N1"], d, device_poa=device_poa, threads=4,
                          device=dev)
    with open(raw) as f:
        som_calls = [(p[0], int(p[1]), int(p[2])) for p in
                     (l.split("\t") for l in f
                      if l.strip().endswith("EMOutput"))]
    stages["localGraph"] = time.perf_counter() - t0
    log(f"[localGraph] {stages['localGraph']:.3f}s  {len(som_calls)} "
        f"somatic rows; peak RSS {peak_rss_mb():.0f} MB")

    t0 = time.perf_counter()
    ns = argparse.Namespace(
        Reference=ref_path, Tumorbam=tumor, Normalbam=normal,
        TSampleID="T1", NSampleID="N1", savedir=d, rawBedFile=raw,
        genomeWindow=None, device_dtype="float32", device=dev)
    merged = cli.cmd_aln_feature(ns)
    vcf_calls = []
    with open(merged) as f:
        for l in f:
            if l.startswith("#"):
                continue
            p = l.split("\t")
            info = dict(kv.split("=", 1) for kv in p[7].split(";")
                        if "=" in kv)
            vcf_calls.append((p[0], int(p[1]),
                              int(info.get("END", int(p[1]) + 1))))
    stages["AlnFeature"] = time.perf_counter() - t0
    log(f"[AlnFeature] {stages['AlnFeature']:.3f}s  {len(vcf_calls)} VCF "
        f"records; peak RSS {peak_rss_mb():.0f} MB")
    after = launch_counts()

    cand_spans = [(w.split("\t")[0], int(w.split("\t")[1]),
                   int(w.split("\t")[2])) for w in windows]
    res = {"candidates": len(windows),
           "raw_bed": score(som_calls, truth, decoys),
           "vcf": score(vcf_calls, truth, decoys),
           "tiers": tier_table(classes, cand_spans, som_calls, vcf_calls),
           "stages": stages,
           "launches": {k: after[k] - before[k] for k in after},
           "dir": d, "hashes": output_hashes(d)}
    for label, key in (("Raw.bed", "raw_bed"), ("mergedVCF", "vcf")):
        sc = res[key]
        log(f"[{label}] precision {ratio(sc['precision']):.3f} "
            f"({sc['precision'][0]}/{sc['precision'][1]} calls on truth), "
            f"recall {ratio(sc['recall']):.3f} ({sc['recall'][0]}/"
            f"{sc['recall'][1]}), decoys called {sc['decoys'][0]}/"
            f"{sc['decoys'][1]}")
    log("[tiers] class           n  candidate  Raw.bed  VCF   expected")
    for c, (n, n_cand, n_raw, n_vcf) in res["tiers"].items():
        want = ("call" if c in TRUTH_CLASSES else
                CLASSES_DOC[c].split(":")[0].split(", ")[-1])
        log(f"[tiers] {c:12s} {n:4d} {n_cand:9d} {n_raw:8d} {n_vcf:4d}   "
            f"{want}")
    log("[stage-walls] " + " ".join(f"{k}={v:.3f}s"
                                    for k, v in stages.items())
        + f"; launches {res['launches']}")
    log(f"[dir] {d}")
    return res


def rss_bound_mb(tumor: str, normal: str) -> float:
    """The pipeline's peak-RSS bound: an eager reader holding every decoded
    sequence would exceed the decoded size by itself (BAM packs bases
    4-bit under ~2x BGZF: decoded ~ 8x the file size)."""
    decoded_mb = sum(os.path.getsize(p) for p in (tumor, normal)) * 8 / 1e6
    return max(2048, 0.75 * decoded_mb)


def stream(args, d: str) -> int:
    """--stream: synthesize here, then run the pipeline in fresh processes
    (their peak RSS holds no synthesis): a warm-up, which pays the one-time
    nvcc and g++ builds of the kernels and host engines, and the measured
    run, whose exit code is returned."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    ref_path, tumor, normal, classes = build_genome(
        d, args.chroms, args.mb_per_chrom, args.depth, rng)
    with open(os.path.join(d, "classes.json"), "w") as f:
        json.dump(classes, f)
    bam_mb = (os.path.getsize(tumor) + os.path.getsize(normal)) / 1e6
    print(f"[synth] {time.perf_counter() - t0:.3f}s; BAM pair "
          f"{bam_mb:.0f} MB on disk; launching the pipeline processes",
          flush=True)
    cmd = [sys.executable, "-m", "svscope_tpu_torch.tools.genome_bench",
           "--pipeline-only", "--savedir", d, "--chroms", str(args.chroms),
           "--mb-per-chrom", str(args.mb_per_chrom),
           "--depth", str(args.depth), "--device", args.device]
    if args.device_poa:
        cmd += ["--device-poa", args.device_poa]
    print("[stream] warm-up run (one-time kernel and host engine builds)",
          flush=True)
    w = subprocess.run(cmd, stdout=subprocess.DEVNULL)
    print(f"[stream] warm-up exit {w.returncode}", flush=True)
    print("[stream] measured run", flush=True)
    return subprocess.run(cmd).returncode


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb-per-chrom", type=float, default=5.0)
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--device-poa", default=None,
                    choices=("pallas", "fused", "host"))
    ap.add_argument("--savedir", default=None)
    ap.add_argument("--stream", action="store_true",
                    help="synthesize, then run the pipeline in fresh "
                         "processes (a warm-up, then the measured run, "
                         "which asserts its peak RSS)")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="skip synthesis (inputs and classes.json from "
                         "--savedir), run the pipeline, assert peak RSS")
    args = ap.parse_args(argv)
    d = args.savedir or tempfile.mkdtemp(prefix="genomebench_")
    os.makedirs(d, exist_ok=True)
    if args.stream:
        return stream(args, d)
    device_poa = False if args.device_poa == "host" else args.device_poa
    res = run(args.mb_per_chrom, args.chroms, args.depth, args.device,
              device_poa, d, synth=not args.pipeline_only)
    if args.pipeline_only:
        rss_mb = peak_rss_mb()
        bound = rss_bound_mb(os.path.join(d, "tumor.bam"),
                             os.path.join(d, "normal.bam"))
        print(f"[rss] peak {rss_mb:.0f} MB for the whole pipeline (bound "
              f"{bound:.0f} MB)", flush=True)
        if rss_mb >= bound:
            raise SystemExit(f"peak RSS {rss_mb:.0f} MB breaks the "
                             f"O(chunk)-ingest claim (bound {bound:.0f} MB)")
    return res


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
