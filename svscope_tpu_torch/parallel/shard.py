"""Multi-process window-stream sharding for localGraph (counterpart of
svscope_tpu/parallel/shard.py).

The reference is single-node (SURVEY.md §2.4); the scale-out shards the
candidate-window stream across processes: every process runs the batched
engine on a block-cyclic slice (block-cyclic because window cost
correlates with genome position: hot repeat regions cluster) on its own
card, `cuda:<local rank>`, writes a per-process shard journal, and process
0 merges the sorted Raw.bed.  Reference FASTA and BAMs are read by every
process; the only exchange is the final record gather through the
filesystem, as in the JAX package.

`torch.distributed` with the gloo backend serves only rendezvous and
identity, as `jax.distributed.initialize` does there: no collective moves
data.  Rank and size can also be injected (tests, external launchers such
as SLURM).
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger("svscope_tpu_torch.shard")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Join a gloo process group at `coordinator` ("host:port", or an
    init_method URL such as "tcp://host:port" or "file:///path") and
    return (rank, world size); (0, 1) when no coordinator is given and no
    group is initialised."""
    import torch.distributed as dist
    if coordinator:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group("gloo", init_method=init,
                                world_size=num_processes, rank=process_id)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_records(records: list[str], process_index: int,
                  process_count: int, block: int = 16) -> list[str]:
    """Block-cyclic slice of the window stream for one process."""
    out = []
    for start in range(0, len(records), block * process_count):
        lo = start + process_index * block
        out.extend(records[lo:lo + block])
    return out


def shard_raw_bed_name(t_ids, n_ids, process_index: int) -> str:
    from ..engine.localgraph import raw_bed_name
    return raw_bed_name(t_ids, n_ids) + f".shard{process_index}"


def run_local_graph_sharded(records, reference, tumor_bams, normal_bams,
                            t_ids, n_ids, savedir,
                            process_index: int | None = None,
                            process_count: int | None = None,
                            merge: bool = True, device=None,
                            **kwargs) -> str | None:
    """Distributed localGraph: run this process's slice on its own card,
    then (process 0) merge.  device None = `cuda:<LOCAL_RANK or 0>`; each
    process keeps to that one device (no data mesh unless
    `data_parallel=` is passed).  Returns the merged Raw.bed path on
    process 0, else None."""
    from ..engine.localgraph import run_local_graph
    if process_index is None or process_count is None:
        rank, world = init_distributed()
        process_index = rank if process_index is None else process_index
        process_count = world if process_count is None else process_count
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    kwargs.setdefault("data_parallel", False)
    mine = shard_records(records, process_index, process_count)
    log.info("shard %d/%d: %d of %d windows on %s", process_index,
             process_count, len(mine), len(records), device)
    shard_dir = os.path.join(savedir, f"shard{process_index}")
    shard_out = run_local_graph(mine, reference, tumor_bams, normal_bams,
                                t_ids, n_ids, shard_dir, device=device,
                                **kwargs)
    marker = os.path.join(shard_dir, "DONE")
    with open(marker + ".tmp", "w") as f:
        f.write(shard_out + "\n")
    os.replace(marker + ".tmp", marker)     # the merge never sees it half
    if not merge or process_index != 0:
        return None
    return merge_shards(savedir, t_ids, n_ids, process_count)


def merge_shards(savedir: str, t_ids, n_ids, process_count: int,
                 timeout_s: float = 3600.0) -> str:
    """Process-0 merge: wait for every shard's DONE marker, concatenate and
    re-sort into the canonical Raw.bed."""
    import time
    from ..engine.localgraph import raw_bed_name
    rows: list[str] = []
    deadline = time.time() + timeout_s
    for p in range(process_count):
        marker = os.path.join(savedir, f"shard{p}", "DONE")
        while not os.path.exists(marker):
            if time.time() > deadline:
                raise TimeoutError(f"shard {p} did not finish")
            time.sleep(0.5)
        with open(marker) as f:
            shard_out = f.read().strip()
        with open(shard_out) as f:
            rows.extend(l for l in f.read().splitlines() if l.strip())
    rows.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1])))
    out_path = os.path.join(savedir, raw_bed_name(t_ids, n_ids))
    with open(out_path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return out_path
