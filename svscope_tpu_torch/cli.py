"""Command-line interface of the PyTorch/CUDA port (counterpart of
svscope_tpu/cli.py).

Ported subcommands: `localGraph`, `AlnFeature`, `callsomaticSV` (localGraph
then AlnFeature) and `adjustVCF`, with the JAX CLI's flags plus
`--device {cuda,cpu}` (default cuda; asking for cuda without it raises).
On cuda, AlnFeature's MisScore runs through K2 (csrc/nw_stats.cu) and the
forest on the card; on cpu, MisScore takes the host DP, as the JAX package
on its CPU backend.  `DataPrepare`, `localGraph_npz` and `viz` are not
ported yet.  `--device-poa`: omitted, bare, `pallas` or `xla` select the
per-round device aligner (the CUDA kernel on cuda, its plain torch version
on cpu) — except that an omitted flag on cpu keeps the host C++ engine, as
the JAX engine does on its CPU backend; `host` selects the C++ engine;
`fused` keeps the whole MSA build on the device (kernels K3 and K4/K5 on
cuda, their plain torch versions on cpu).  `--oversize-sharded` is not
ported yet and raises.
"""
from __future__ import annotations

import argparse
import logging
import os

log = logging.getLogger("svscope_tpu_torch.cli")

_NOT_PORTED = "not yet ported to svscope_tpu_torch (see ROADMAP.md)"


def _device_poa_arg(args):
    v = getattr(args, "device_poa", None)
    if v == "host":
        return False
    return v


def cmd_local_graph(args):
    from .engine.localgraph import run_local_graph
    if args.oversize_sharded:
        raise NotImplementedError(f"--oversize-sharded is {_NOT_PORTED}")
    device_poa = _device_poa_arg(args)
    records = [l for l in open(args.windowBed).read().splitlines()
               if l.strip() and not l.startswith("chrom\t")]
    return run_local_graph(
        records, args.Reference, args.Tumorbam.split(","),
        args.Normalbam.split(","), args.TSampleID.split(","),
        args.NSampleID.split(","), args.savedir, offset=args.offset,
        mapq=args.mapQ, continue_run=args.Continue,
        em_dtype=args.device_dtype, device_poa=device_poa,
        threads=int(args.thread or 8), device=args.device)


def _load_tables(args):
    from .io.bam import AlignmentTable

    def load(path):
        try:  # native scanner (22x the Python parser); same table (tested)
            from .native.bam import scan_alignment_table
            return scan_alignment_table(path)
        except Exception as exc:
            log.warning("native BAM scan failed (%s); Python fallback", exc)
            return AlignmentTable.from_bam(path)

    t = AlignmentTable.concat([load(p) for p in args.Tumorbam.split(",")])
    n = AlignmentTable.concat([load(p) for p in args.Normalbam.split(",")])
    return t, n


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


def cmd_adjust_vcf(args):
    from .out.adjust import adjust_vcf
    out = adjust_vcf(args.savedir)
    log.info("adjustVCF: %s", out)
    return out


def _common_bam_args(p, window_bed=True):
    if window_bed:
        p.add_argument("-w", "--windowBed", required=True)
    p.add_argument("--device-poa", nargs="?", const="pallas", default=None,
                   choices=("fused", "xla", "pallas", "host"),
                   help="POA alignment backend: 'pallas'/'xla' (or bare) = "
                        "per-read device alignment rounds with host fusion "
                        "(the CUDA kernel on --device cuda), 'host' = C++ "
                        "engine, 'fused' = the whole MSA build on the device "
                        "(the pk kernels on --device cuda).  Omitted = the "
                        "device aligner on cuda, host C++ on cpu")
    p.add_argument("--oversize-sharded", action="store_true",
                   help="not ported yet (raises)")
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
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels, the EM and the forest run "
                        "(default cuda; raises when CUDA is absent)")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(
        prog="svscope-tpu-torch",
        description="Somatic SV caller, PyTorch/CUDA port (local "
                    "graph-genome optimization)")
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("localGraph")
    _common_bam_args(p)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.set_defaults(func=cmd_local_graph)

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

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return None
    for attr, what in (("Tumorbam", "tumor BAM"), ("Normalbam", "normal BAM"),
                       ("Reference", "reference FASTA"),
                       ("windowBed", "window bed"),
                       ("rawBedFile", "Raw.bed")):
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
