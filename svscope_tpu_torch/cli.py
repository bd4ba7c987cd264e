"""Command-line interface of the PyTorch/CUDA port (counterpart of
svscope_tpu/cli.py).

Only the `localGraph` subcommand is ported so far, with the JAX CLI's flags
plus `--device {cuda,cpu}` (default cuda; asking for cuda without it
raises).  `--device-poa`: omitted, bare, `pallas` or `xla` select the
per-round device aligner (the CUDA kernel on cuda, its plain torch version
on cpu) — except that an omitted flag on cpu keeps the host C++ engine, as
the JAX engine does on its CPU backend; `host` selects the C++ engine.
`fused` and `--oversize-sharded` are not ported yet and raise.
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
    if v == "fused":
        raise NotImplementedError(f"--device-poa fused is {_NOT_PORTED}")
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


def _common_bam_args(p, window_bed=True):
    if window_bed:
        p.add_argument("-w", "--windowBed", required=True)
    p.add_argument("--device-poa", nargs="?", const="pallas", default=None,
                   choices=("fused", "xla", "pallas", "host"),
                   help="POA alignment backend: 'pallas'/'xla' (or bare) = "
                        "per-read device alignment rounds with host fusion "
                        "(the CUDA kernel on --device cuda), 'host' = C++ "
                        "engine, 'fused' = not ported yet.  Omitted = the "
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
                   help="where the POA kernel and the EM run (default cuda; "
                        "raises when CUDA is absent)")


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

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return None
    for attr, what in (("Tumorbam", "tumor BAM"), ("Normalbam", "normal BAM"),
                       ("Reference", "reference FASTA"),
                       ("windowBed", "window bed")):
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
