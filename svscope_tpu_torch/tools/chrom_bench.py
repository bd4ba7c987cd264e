"""Chromosome-scale end-to-end run with per-stage walls (counterpart of
tools/chrom_bench.py).

Synthesizes a ~2.1 Mb chromosome with 80 planted somatic SV windows plus
background coverage and 8 split-alignment LargeDELs, writes real
tumor/normal BAMs, and drives the port's whole pipeline (BAM scan with
breakpoints -> window selection -> localGraph -> AlnFeature -> adjustVCF),
printing the wall seconds of each stage and the recall of the planted SVs.
The inputs are the JAX harness's, drawn by the port's own generators (the
same rng calls give the same BAM bytes), so every output file can be held
against the JAX run's (`output_hashes`).

    python -m svscope_tpu_torch.tools.chrom_bench [--mb 2.1] [--n-sv 80]
        [--device cuda|cpu] [--device-poa pallas|fused|host] [--savedir D]

--device defaults to cuda (raises without CUDA); --device-poa omitted is
the engine's policy (the K1 device aligner on cuda, the host C++ engine on
cpu).
"""
from __future__ import annotations

import argparse
import hashlib
import os
import tempfile
import time

import numpy as np

INPUTS = ("ref.fa", "ref.fa.fai", "tumor.bam", "normal.bam", "repeats.bed")


def synthesize(d: str, mb: float, n_sv: int, depth: int):
    """The JAX harness's chromosome: (ref_path, tumor, normal, repeat_bed,
    sv_windows, n_large) written under d."""
    from ..io.bam import BamReader, BamRecord, BamWriter, parse_cigar_string
    from .workloads import make_test_pair
    rng = np.random.default_rng(7)
    ref_len = int(mb * 1e6)
    sv_windows = []
    step = ref_len // (n_sv + 2)
    for k in range(n_sv):
        s = (k + 1) * step + int(rng.integers(-step // 4, step // 4))
        svtype = "INS" if k % 2 == 0 else "DEL"
        svlen = int(rng.integers(60, 200))
        sv_windows.append(dict(start=s, end=s + 100, svtype=svtype,
                               svlen=svlen, som_reads=6, depth=depth))
    ref_path, tumor, normal, _, _ = make_test_pair(
        d, seed=3, ref_len=ref_len, windows=sv_windows, bg_reads_per_10kb=6)
    # split-alignment LargeDEL events for the InterALN channel: tumor-only
    # read pairs clipped at two breakpoints ~20 kb apart
    n_large = max(n_sv // 10, 2)
    for k in range(n_large):
        bp1 = int((k + 0.5) * (ref_len // n_large))
        bp2 = bp1 + 20_000
        recs = []
        for i in range(6):
            j1 = bp1 + int(rng.integers(-30, 30))
            j2 = bp2 + int(rng.integers(-30, 30))
            for pos, cig in ((j1 - 400, "400M600S"), (j2, "400H600M")):
                ops, lens = parse_cigar_string(cig)
                qlen = int(sum(l for o, l in zip(ops, lens)
                               if o in (0, 1, 4, 7, 8)))
                recs.append(BamRecord(f"lg{k}r{i}", 0, 0, pos, 60, ops,
                                      lens, "A" * qlen))
        rd = BamReader(tumor)
        old = list(rd.records)
        with BamWriter(tumor, rd.references, rd.lengths) as w:
            for r in sorted(old + recs, key=lambda r: r.pos):
                w.write(r)
    # RepeatMasker bed covering every 4th planted window (the LC channel)
    repeat_bed = os.path.join(d, "repeats.bed")
    with open(repeat_bed, "w") as f:
        for w in sv_windows[::4]:
            f.write(f"chr1\t{w['start'] - 40}\t{w['end'] + 40}\n")
    return ref_path, tumor, normal, repeat_bed, sv_windows, n_large


def output_hashes(d: str) -> dict:
    """sha256 of every file under d: BAMs as bytes, text without the
    `##fileDate=` line and with the run directory written as `<dir>`."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            data = f.read()
        if not name.endswith(".bam"):
            text = data.decode().replace(d, "<dir>")
            data = "".join(l for l in text.splitlines(keepends=True)
                           if not l.startswith("##fileDate=")).encode()
        out[name] = hashlib.sha256(data).hexdigest()
    return out


def run(mb: float = 2.1, n_sv: int = 80, depth: int = 14, device="cuda",
        device_poa=None, savedir: str | None = None, log=print) -> dict:
    """The whole pipeline on a synthesized chromosome.  Returns the stage
    walls in seconds (`stages`), the counts of each stage, `recall`
    (hit, planted), the run directory and `output_hashes`."""
    from .. import cli
    from ..engine.localgraph import run_local_graph
    from ..native.bam import scan_with_breakpoints
    from ..select.interaln import write_interaln_vcf
    from ..select.windows import find_candidate_sv_windows
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    d = savedir or tempfile.mkdtemp(prefix="chrombench_")
    os.makedirs(d, exist_ok=True)
    stages = {}
    t0 = time.perf_counter()
    ref_path, tumor, normal, repeat_bed, sv_windows, n_large = synthesize(
        d, mb, n_sv, depth)
    stages["synth"] = time.perf_counter() - t0
    log(f"[synth] {stages['synth']:.3f}s  ref {mb:.1f} Mb, {n_sv} SVs + "
        f"{n_large} LargeDELs, depth {depth}")

    t0 = time.perf_counter()
    t_table, t_bp = scan_with_breakpoints(tumor)
    n_table, n_bp = scan_with_breakpoints(normal)
    stages["scan"] = time.perf_counter() - t0
    log(f"[scan] {stages['scan']:.3f}s  tumor {len(t_table)} aln, normal "
        f"{len(n_table)} aln")

    t0 = time.perf_counter()
    paths = find_candidate_sv_windows(t_table, n_table, ref_path + ".fai",
                                      repeat_bed, d, t_bp=t_bp, n_bp=n_bp)
    inter = write_interaln_vcf(d, ref_path + ".fai", "tumor", paths)
    windows = [l for l in open(paths["somatic_bed"]).read().splitlines()
               if l.strip()]
    n_inter = sum(1 for l in open(inter) if not l.startswith("#"))
    n_ldel = sum(1 for l in open(inter) if "SVTYPE=LargeDEL" in l)
    stages["select"] = time.perf_counter() - t0
    log(f"[select] {stages['select']:.3f}s  {len(windows)} candidate "
        f"windows; InterALN {n_inter} records ({n_ldel} LargeDEL of "
        f"{n_large} planted)")

    t0 = time.perf_counter()
    raw = run_local_graph(windows, ref_path, [tumor], [normal], ["T1"],
                          ["N1"], d, device_poa=device_poa, threads=2,
                          device=dev)
    n_som = sum(1 for l in open(raw) if l.strip().endswith("EMOutput"))
    stages["localGraph"] = time.perf_counter() - t0
    log(f"[localGraph] {stages['localGraph']:.3f}s  {n_som} somatic rows")

    t0 = time.perf_counter()
    ns = argparse.Namespace(
        Reference=ref_path, Tumorbam=tumor, Normalbam=normal,
        TSampleID="T1", NSampleID="N1", savedir=d, rawBedFile=raw,
        genomeWindow=None, device_dtype="float32", device=dev)
    merged = cli.cmd_aln_feature(ns)
    stages["AlnFeature"] = time.perf_counter() - t0
    log(f"[AlnFeature] {stages['AlnFeature']:.3f}s  -> {merged}")

    t0 = time.perf_counter()
    cli.cmd_adjust_vcf(argparse.Namespace(savedir=d))
    stages["adjustVCF"] = time.perf_counter() - t0
    log(f"[adjustVCF] {stages['adjustVCF']:.3f}s")

    # recall: planted windows hit by a somatic Raw.bed row
    som_spans = [(int(l.split("\t")[1]), int(l.split("\t")[2]))
                 for l in open(raw) if l.strip().endswith("EMOutput")]
    hit = sum(1 for w in sv_windows
              if any(s <= w["end"] and e >= w["start"] for s, e in som_spans))
    log(f"[recall] {hit}/{n_sv} planted SV windows somatic-called")
    log(f"[dir] {d}")
    return {"stages": stages, "windows": len(windows), "interaln": n_inter,
            "large_del": [n_ldel, n_large], "somatic_rows": n_som,
            "recall": [hit, n_sv], "dir": d, "hashes": output_hashes(d)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=2.1)
    ap.add_argument("--n-sv", type=int, default=80)
    ap.add_argument("--depth", type=int, default=14)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--device-poa", default=None,
                    choices=("pallas", "fused", "host"))
    ap.add_argument("--savedir", default=None)
    args = ap.parse_args(argv)
    device_poa = False if args.device_poa == "host" else args.device_poa
    return run(args.mb, args.n_sv, args.depth, args.device, device_poa,
               args.savedir)


if __name__ == "__main__":
    main()
