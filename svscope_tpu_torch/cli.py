"""Command-line interface of the PyTorch/CUDA port (counterpart of
svscope_tpu/cli.py).

Subcommands, with the JAX CLI's flags plus `--device {cuda,cpu}` (default
cuda; asking for cuda without it raises):
  * `DataPrepare`: candidate-window selection from the two BAMs (native
    scan with breakpoints, select/windows, InterALNSVs.vcf) with
    `--selectwindows`; then `--saveData` (window payloads to npz) or
    `--FullProcess` (localGraph then AlnFeature; `-c` drops the selection
    intermediates).  Without `--selectwindows` it does nothing, as in JAX.
  * `localGraph`, `localGraph_npz` (replays saved payloads 256 windows at
    a time, `-C` resumes), `AlnFeature`, `callsomaticSV` (localGraph then
    AlnFeature), `adjustVCF`, and `viz` (the per-window figure, its EM on
    `--device`).
On cuda, AlnFeature's MisScore runs through K2 (csrc/nw_stats.cu) and the
forest on the card; on cpu, MisScore takes the host DP, as the JAX package
on its CPU backend.  `--device-poa`: omitted, bare, `pallas` or `xla` select
the per-round device aligner (the CUDA kernel on cuda, its plain torch
version on cpu) — except that an omitted flag on cpu keeps the host C++
engine, as the JAX engine does on its CPU backend; `host` selects the C++
engine; `fused` keeps the whole MSA build on the device (kernels K3 and
K4/K5 on cuda, their plain torch versions on cpu).  `--oversize-sharded`
aligns windows past the 2048-node / 2048 bp buckets through the column-
sharded wavefront (ops/poa_sharded) over every local CUDA device (one card:
a one-device tuple, as the JAX CLI's mesh over one chip), or over the CPU
with `--device cpu`.
"""
from __future__ import annotations

import argparse
import logging
import os

log = logging.getLogger("svscope_tpu_torch.cli")

def _device_poa_arg(args):
    v = getattr(args, "device_poa", None)
    if v == "host":
        return False
    return v


def _oversize_devices(device: str) -> tuple:
    """--oversize-sharded's device tuple: every local CUDA device on cuda
    (svscope_tpu/cli.py:143-149 takes every JAX device), the CPU on cpu."""
    import torch
    from .utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,)
    return tuple(resolve_device(f"cuda:{i}")
                 for i in range(torch.cuda.device_count()))


def cmd_local_graph(args):
    from .engine.localgraph import run_local_graph
    from .ops.poa_batch import set_default_oversize_mesh
    device_poa = _device_poa_arg(args)
    records = [l for l in open(args.windowBed).read().splitlines()
               if l.strip() and not l.startswith("chrom\t")]
    if args.oversize_sharded:
        set_default_oversize_mesh(_oversize_devices(args.device))
    try:
        return run_local_graph(
            records, args.Reference, args.Tumorbam.split(","),
            args.Normalbam.split(","), args.TSampleID.split(","),
            args.NSampleID.split(","), args.savedir, offset=args.offset,
            mapq=args.mapQ, continue_run=args.Continue,
            em_dtype=args.device_dtype, device_poa=device_poa,
            threads=int(args.thread or 8), device=args.device)
    finally:
        set_default_oversize_mesh(None)


def _load_tables(args):
    """AlnFeature's tables from the native scanner (the Python parser's
    table, tested).  A failing native scan raises: the Python scan would
    give the same tables and so hide it."""
    from .io.bam import AlignmentTable
    from .native.bam import scan_alignment_table
    t = AlignmentTable.concat([scan_alignment_table(p)
                               for p in args.Tumorbam.split(",")])
    n = AlignmentTable.concat([scan_alignment_table(p)
                               for p in args.Normalbam.split(",")])
    return t, n


def _load_tables_with_bp(args):
    """Tables + native breakpoint frames in one C++ pass (selection path).

    A failing native scan raises: the Python scan would give the same
    tables and so hide it."""
    import pandas as pd
    from .io.bam import AlignmentTable
    from .native.bam import scan_with_breakpoints
    ts, tb, ns, nb = [], [], [], []
    for p in args.Tumorbam.split(","):
        t, b = scan_with_breakpoints(p)
        ts.append(t)
        tb.append(b)
    for p in args.Normalbam.split(","):
        t, b = scan_with_breakpoints(p)
        ns.append(t)
        nb.append(b)
    return (AlignmentTable.concat(ts), AlignmentTable.concat(ns),
            pd.concat(tb, ignore_index=True),
            pd.concat(nb, ignore_index=True))


def _genome_windows(args, fai):
    from .engine.features import make_genome_windows
    if getattr(args, "genomeWindow", None):
        rows = [l.split("\t")[:3] for l in
                open(args.genomeWindow).read().splitlines() if l.strip()]
        return [(c, int(s), int(e)) for c, s, e in rows]
    return make_genome_windows(fai)


def _cleanup_dat(savedir):
    """--cleanupDat: drop the selection intermediates (Candidate*.bed, not
    the final somatic window bed) after a full run."""
    import glob
    n = 0
    for f in glob.glob(os.path.join(savedir, "Candidate*.bed")):
        if f.endswith(".somatic.bed"):
            continue
        os.remove(f)
        n += 1
    log.info("cleanupDat: removed %d intermediate files", n)


def cmd_data_prepare(args):
    from .select.interaln import write_interaln_vcf
    from .select.windows import find_candidate_sv_windows
    from .utils.device import resolve_device
    resolve_device(args.device)
    fai = args.Reference + ".fai"
    os.makedirs(args.savedir, exist_ok=True)
    if args.selectwindows:
        t_table, n_table, t_bp, n_bp = _load_tables_with_bp(args)
        paths = find_candidate_sv_windows(t_table, n_table, fai,
                                          args.tandemRepeatFile, args.savedir,
                                          t_bp=t_bp, n_bp=n_bp)
        write_interaln_vcf(args.savedir, fai,
                           os.path.basename(args.Tumorbam.split(",")[0]
                                            ).split(".bam")[0], paths)
        args.windowBed = paths["somatic_bed"]
        if args.saveData:
            from .engine.npz import save_window_data
            records = [l for l in open(args.windowBed).read().splitlines()
                       if l.strip()]
            save_window_data(records, args.Reference,
                             args.Tumorbam.split(","),
                             args.Normalbam.split(","),
                             args.TSampleID.split(","),
                             args.NSampleID.split(","), args.savedir,
                             offset=args.offset, mapq=args.mapQ)
        elif args.FullProcess:
            args.rawBedFile = cmd_local_graph(args)
            cmd_aln_feature(args)
            if args.cleanupDat:
                _cleanup_dat(args.savedir)
    log.info("DataPrepare: all processes finished")


def cmd_local_graph_npz(args):
    from .engine.localgraph import (process_window_batch, raw_bed_name,
                                    resolve_device_poa)
    from .engine.npz import load_window_data
    from .utils.device import resolve_device
    dev = resolve_device(args.device)
    device_poa = resolve_device_poa(_device_poa_arg(args), dev)
    t_ids = args.TSampleID.split(",")
    n_ids = args.NSampleID.split(",")
    out_path = os.path.join(args.savedir, raw_bed_name(t_ids, n_ids))
    done = set()
    rows = []
    if args.Continue and os.path.exists(out_path):
        for line in open(out_path):
            if line.strip():
                rows.append(line.rstrip("\n"))
                done.add(":".join(line.split("\t")[0:3]))
    wins = [w for w in load_window_data(args.savedir)
            if ":".join(w.record.strip().split("\t")[0:3]) not in done]
    for off in range(0, len(wins), 256):
        for rec in process_window_batch(wins[off:off + 256],
                                        em_dtype=args.device_dtype,
                                        device_poa=device_poa, device=dev):
            rows.append("\t".join(str(x) for x in rec))
    rows.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1])))
    with open(out_path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    log.info("localGraph_npz: %d records -> %s", len(rows), out_path)
    return out_path


def cmd_aln_feature(args):
    from .engine.features import run_aln_feature
    from .out.vcf import bed2vcf, merge_somatic_vcf
    from .utils.device import resolve_device
    device = resolve_device(args.device)
    fai = args.Reference + ".fai"
    t_table, n_table = _load_tables(args)
    windows = _genome_windows(args, fai)
    _pool, somatic_bed, rf_out = run_aln_feature(
        args.rawBedFile, windows, t_table, n_table, args.TSampleID,
        args.savedir, device=device)
    tag = "_".join(args.TSampleID.split(","))
    out_vcf = os.path.join(args.savedir, f"{tag}.vcf")
    bed2vcf(args.rawBedFile, somatic_bed, rf_out, out_vcf, args.TSampleID,
            args.Reference)
    inter = os.path.join(args.savedir, "InterALNSVs.vcf")
    merged = os.path.join(args.savedir, f"{tag}.mergedSomatic.vcf")
    merge_somatic_vcf(out_vcf, inter, merged)
    log.info("AlnFeature: %s", merged)
    return merged


def cmd_call_somatic_sv(args):
    args.rawBedFile = cmd_local_graph(args)
    merged = cmd_aln_feature(args)
    if args.cleanupDat:
        _cleanup_dat(args.savedir)
    return merged


def cmd_viz(args):
    from .utils.device import resolve_device
    from .viz.scopeviz import draw_pipe
    dev = resolve_device(args.device)
    common = (args.Reference, args.Tumorbam.split(","),
              args.Normalbam.split(","), args.TSampleID.split(","),
              args.NSampleID.split(","), args.savedir)
    kw = dict(offset=args.offset, mapq=args.mapQ, graph=not args.no_graph,
              device=dev)
    w = args.window
    if os.path.exists(w):  # a window bed: render every row (ScopeVIZ.main)
        outs = []
        for line in open(w):
            if not line.strip() or line.startswith("chrom\t"):
                continue
            try:
                outs.append(draw_pipe(line, *common, **kw))
            except ValueError as exc:  # no spanning reads; device errors raise
                log.warning("viz: skipping %r (%s)", line.strip(), exc)
        log.info("viz: %d figures", len(outs))
        return outs
    if ":" in w:
        chrom, span = w.split(":")
        start, end = span.split("-")
        record = f"{chrom}\t{start}\t{end}"
    else:
        record = w
    out = draw_pipe(record, *common, **kw)
    log.info("viz: %s", out)
    return out


def cmd_adjust_vcf(args):
    from .out.adjust import adjust_vcf
    out = adjust_vcf(args.savedir)
    log.info("adjustVCF: %s", out)
    return out


def _device_args(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels, the EM and the forest run "
                        "(default cuda; raises when CUDA is absent)")


def _device_poa_flag(p):
    p.add_argument("--device-poa", nargs="?", const="pallas", default=None,
                   choices=("fused", "xla", "pallas", "host"),
                   help="POA alignment backend: 'pallas'/'xla' (or bare) = "
                        "per-read device alignment rounds with host fusion "
                        "(the CUDA kernel on --device cuda), 'host' = C++ "
                        "engine, 'fused' = the whole MSA build on the device "
                        "(the pk kernels on --device cuda).  Omitted = the "
                        "device aligner on cuda, host C++ on cpu")


def _common_bam_args(p, window_bed=True):
    if window_bed:
        p.add_argument("-w", "--windowBed", required=True)
    _device_poa_flag(p)
    p.add_argument("--oversize-sharded", action="store_true",
                   help="align windows beyond the 2048-node/2048 bp device "
                        "buckets (giant tandem repeats) via the sequence-"
                        "sharded wavefront over every local CUDA device "
                        "(the CPU with --device cpu) instead of the host DP")
    p.add_argument("-T", "--Tumorbam", required=True)
    p.add_argument("-N", "--Normalbam", required=True)
    p.add_argument("-t", "--TSampleID", required=True)
    p.add_argument("-n", "--NSampleID", required=True)
    p.add_argument("-r", "--Reference", required=True)
    p.add_argument("-s", "--savedir", required=True)
    p.add_argument("-p", "--thread", default="8")
    p.add_argument("-o", "--offset", type=int, default=50)
    p.add_argument("-q", "--mapQ", type=int, default=5)
    p.add_argument("--device-dtype", default="float32",
                   choices=["float32", "float64"])
    _device_args(p)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(
        prog="svscope-tpu-torch",
        description="Somatic SV caller, PyTorch/CUDA port (local "
                    "graph-genome optimization)")
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("DataPrepare")
    p.add_argument("-D", "--tandemRepeatFile", required=True)
    _common_bam_args(p, window_bed=False)
    p.add_argument("--selectwindows", action="store_true", default=False)
    p.add_argument("--saveData", action="store_true", default=False)
    p.add_argument("--FullProcess", action="store_true", default=False)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.add_argument("-c", "--cleanupDat", action="store_true", default=False)
    p.add_argument("-W", "--genomeWindow", required=False)
    p.set_defaults(func=cmd_data_prepare)

    p = sub.add_parser("localGraph")
    _common_bam_args(p)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.set_defaults(func=cmd_local_graph)

    p = sub.add_parser("localGraph_npz")
    p.add_argument("-t", "--TSampleID", required=True)
    p.add_argument("-n", "--NSampleID", required=True)
    p.add_argument("-s", "--savedir", required=True)
    p.add_argument("-p", "--thread", default="8")
    p.add_argument("-o", "--offset", type=int, default=50)
    p.add_argument("-q", "--mapQ", type=int, default=5)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.add_argument("--device-dtype", default="float32",
                   choices=["float32", "float64"])
    _device_poa_flag(p)
    _device_args(p)
    p.set_defaults(func=cmd_local_graph_npz)

    p = sub.add_parser("AlnFeature")
    p.add_argument("-B", "--rawBedFile", required=True)
    p.add_argument("-W", "--genomeWindow", required=False)
    _common_bam_args(p, window_bed=False)
    p.set_defaults(func=cmd_aln_feature)

    p = sub.add_parser("callsomaticSV")
    p.add_argument("-W", "--genomeWindow", required=False)
    _common_bam_args(p)
    p.add_argument("-c", "--cleanupDat", action="store_true", default=False)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.set_defaults(func=cmd_call_somatic_sv)

    p = sub.add_parser("adjustVCF")
    p.add_argument("-s", "--savedir", required=True)
    p.set_defaults(func=cmd_adjust_vcf)

    p = sub.add_parser("viz", help="per-window diagnostic figure "
                       "(ScopeVIZ equivalent)")
    p.add_argument("-w", "--window", required=True,
                   help="window as chrom:start-end or chrom<TAB>start<TAB>end")
    _common_bam_args(p, window_bed=False)
    p.add_argument("--no-graph", action="store_true", default=False)
    p.set_defaults(func=cmd_viz)

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return None
    for attr, what in (("Tumorbam", "tumor BAM"), ("Normalbam", "normal BAM"),
                       ("Reference", "reference FASTA"),
                       ("windowBed", "window bed"),
                       ("rawBedFile", "Raw.bed"),
                       ("tandemRepeatFile", "RepeatMasker bed")):
        val = getattr(args, attr, None)
        if not val:
            continue
        for path in str(val).split(","):
            if not os.path.exists(path):
                parser.error(f"{what} not found: {path}")
    ref = getattr(args, "Reference", None)
    if ref and not os.path.exists(ref + ".fai"):
        parser.error(f"reference index not found: {ref}.fai "
                     "(write_fasta creates it; or `samtools faidx`)")
    return args.func(args)


if __name__ == "__main__":
    main()
