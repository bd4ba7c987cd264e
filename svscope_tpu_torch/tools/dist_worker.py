"""One process of a multi-process localGraph run (counterpart of
tools/dist_worker.py; parallel/shard.py's harness).

    python -m svscope_tpu_torch.tools.dist_worker RANK WORLD COORD \
        REFERENCE TUMOR_BAM NORMAL_BAM WINDOW_BED SAVEDIR [--device DEV]

COORD is the gloo rendezvous: a port on localhost, "host:port", or an
init_method URL ("tcp://host:port", "file:///path").  Each process runs its
block-cyclic slice of WINDOW_BED on DEV (default `cuda:<LOCAL_RANK or 0>`;
`cpu` for a run without a card; asking for cuda without it raises) and
process 0 merges SAVEDIR's Raw.bed.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name in ("rank", "world", "coord", "reference", "tumor", "normal",
                 "window_bed", "savedir"):
        ap.add_argument(name)
    ap.add_argument("--device", default=None)
    ap.add_argument("--threads", type=int, default=None,
                    help="host threads of the C++ POA engine")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from ..parallel.shard import init_distributed, run_local_graph_sharded
    coord = (f"localhost:{args.coord}" if args.coord.isdigit()
             else args.coord)
    rank, world = init_distributed(coord, int(args.world), int(args.rank))
    if (rank, world) != (int(args.rank), int(args.world)):
        raise RuntimeError(f"rendezvous gave rank {rank} of {world}")
    with open(args.window_bed) as f:
        recs = [l for l in f.read().splitlines() if l.strip()]
    try:
        out = run_local_graph_sharded(
            recs, args.reference, [args.tumor], [args.normal], ["S"], ["S"],
            args.savedir, merge=(rank == 0), device=args.device, offset=50,
            threads=args.threads)
    finally:
        dist.destroy_process_group()
    print(f"proc {rank}/{world}: done, merged={out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
