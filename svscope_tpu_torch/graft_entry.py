"""Entry points of the port's scale-out checks (counterpart of
__graft_entry__.py): a single-device forward of the per-K EM and a dry run
of every sharded compute path over a tuple of devices.

    python -m svscope_tpu_torch.graft_entry [--device cuda|cpu] [--n N]

runs `entry()`'s function once and `dryrun_multichip(N)` (N = the local
CUDA device count; on the CPU, ("cpu",) * N).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): the batched per-window EM clustering pass (all
    K x 20 EM iterations of the per-K path over a padded (16, 32, 64)
    window batch), the device half of localGraph, on `device`."""
    from .models.mixture import MAX_K, _em_all_k, torch_gammas
    from .parallel.mesh import make_example_batch
    from .utils.device import resolve_device
    dev = resolve_device(device)
    batch, n_reads, nf = 16, 32, 64
    x_oh, read_mask, gamma0, _kmask, n_true = make_example_batch(
        batch, n_reads, nf)
    # per-window K-expanded init like em_cluster_batch
    gamma0_all = np.zeros((batch, MAX_K, n_reads, MAX_K), np.float32)
    kmask_all = np.zeros((batch, MAX_K, MAX_K), bool)
    for ki in range(MAX_K):
        kmask_all[:, ki, :ki + 1] = True
        gamma0_all[:, ki] = gamma0
    draws = torch_gammas(0, 0, nf, 20, torch.float32, dev)

    def fn(x_oh, read_mask, gamma0_all, kmask_all, n_true, nf_true, zpn,
           draws):
        outs = [_em_all_k(x_oh[b], read_mask[b], gamma0_all[b],
                          kmask_all[b], n_true[b], nf_true[b], zpn[b],
                          draws, 20) for b in range(x_oh.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    t = lambda a: torch.as_tensor(a, device=dev)
    args = (t(x_oh), t(read_mask), t(gamma0_all), t(kmask_all), t(n_true),
            torch.full((batch,), float(nf), device=dev),
            torch.zeros((batch,), device=dev), draws)
    return fn, args


def _two_cluster_window(rng, n_half: int, nf: int) -> np.ndarray:
    """(2 * n_half, nf) int8 feature rows of two haplotypes, 3 % noise."""
    a = rng.integers(0, 4, (1, nf))
    b = (a + 1 + rng.integers(0, 3, (1, nf))) % 4
    x = np.concatenate([np.repeat(a, n_half, 0), np.repeat(b, n_half, 0)])
    flip = rng.random(x.shape) < 0.03
    return np.where(flip, rng.integers(0, 5, x.shape), x).astype(np.int8)


def _chain_graph(seq: str):
    from .ops.poa import PoaGraph
    g = PoaGraph()
    prev = -1
    for ch in seq:
        cur = g._add_node(ch)
        if prev >= 0:
            g._add_edge(prev, cur)
        prev = cur
    g.seq_begin.append(0)
    return g


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Every sharded compute path over an n-device tuple (default: the
    first n CUDA devices; devices may repeat), each held to its unsharded
    counterpart:
    (0) the production engine path, process_window_batch, with its batched
        dispatches split over a data mesh: records identical to the
        single-device run, the dispatch sharded;
    (0a) the read-parallel (mp) EM: a 300-read window's read axis split
        over the mesh; K and labels unchanged;
    (0b) the fused on-device MSA build split over the mesh: equal to the
        host engine;
    (1) the EM over (windows x reads) in one dispatch: small windows with
        their window axis split, 300-read windows with their read axis
        split; K and labels unchanged, BICs finite;
    (2) the oversized-window POA wavefront, column-sharded over all n
        devices: equal to PoaGraph.align;
    (2b) its banded (H-resident) traceback on a 1000-node tandem repeat:
        equal to PoaGraph.align."""
    from .engine.datamaker import WindowData
    from .engine.localgraph import process_window_batch
    from .models import mixture as mx
    from .ops.poa_batch import poa_msa_batch
    from .ops.poa_sharded import align_sharded
    from .parallel import dataparallel as dpm
    from .tools.workloads import make_window_payloads
    mesh = dpm.make_dp_mesh(n_devices, devices)
    if len(mesh) != n_devices:
        raise ValueError(f"{len(mesh)} devices given for n={n_devices}")
    dev0 = mesh[0]

    # (0) production engine path over the dp mesh; a second read bucket
    # (10-read windows: reads bucket 16 vs 64) in the same batch
    wins = make_window_payloads(24, np.random.default_rng(11))
    for w in make_window_payloads(8, np.random.default_rng(12)):
        keep = list(range(5)) + list(range(12, 17))   # 5 tumor + 5 normal
        wins.append(WindowData([w.sequences[0]]
                               + [w.sequences[1 + i] for i in keep],
                               w.read_ids[keep], w.flank_5, w.flank_3,
                               w.record, w.flag))
    with dpm.data_mesh_installed(None):
        base_records = process_window_batch(wins, device=dev0)
    with dpm.data_mesh_installed(mesh):
        dp_records = process_window_batch(wins, device=dev0)
        # the 24+8-window batch pads to 32-slot buckets; sharding engages
        # whenever the mesh divides it
        if 32 % n_devices == 0:
            assert dpm.LAST_DISPATCH["sharded"], "dispatch did not shard"
            assert dpm.LAST_DISPATCH["n_shards"] == n_devices
    assert dp_records == base_records, "dp-mesh records != single-device"

    # (0a) read-parallel (mp) EM on a >256-read window
    big = _two_cluster_window(np.random.default_rng(7), 150, 32)
    base_em = mx.em_cluster_batch_dispatch([big], labels_only=True,
                                           device=dev0)()
    with dpm.data_mesh_installed(mesh):
        got_em = mx.em_cluster_batch_dispatch([big], labels_only=True,
                                              device=dev0)()
        if 512 % n_devices == 0 and n_devices > 1:
            assert mx.LAST_MP_DISPATCH["used"], "mp EM did not engage"
            assert mx.LAST_MP_DISPATCH["n_shards"] == n_devices
    assert got_em[0][0] == base_em[0][0], "mp EM K != unsharded"
    assert (got_em[0][2] == base_em[0][2]).all(), "mp EM labels != unsharded"

    # (0b) fused on-device MSA build over the dp mesh (small windows)
    rngf = np.random.default_rng(5)
    fwins = []
    for _ in range(8):
        ref = "".join(rngf.choice(list("ACGT"), 48))
        ins = "".join(rngf.choice(list("ACGT"), 6))
        reads = [ref[:24] + ins + ref[24:] if i % 2 else ref
                 for i in range(4)]
        fwins.append([ref] + reads)
    base_msa = poa_msa_batch(fwins, use_device=False, device=dev0)
    with dpm.data_mesh_installed(mesh):
        fused_msa = poa_msa_batch(fwins, use_device="fused", device=dev0)
        if 8 % n_devices == 0:
            assert dpm.LAST_DISPATCH["sharded"], "fused build did not shard"
    assert fused_msa == base_msa, "fused dp-mesh MSA != host engine"

    # (1) the EM over (windows x reads): 8 small windows (one 32-slot
    # chunk, window axis split) and two 300-read windows (read axis split)
    rnge = np.random.default_rng(8)
    feats = [_two_cluster_window(rnge, 6, 20) for _ in range(8)]
    feats[3:3] = [_two_cluster_window(rnge, 150, 24)]
    feats.append(_two_cluster_window(rnge, 150, 40))
    base_em = mx.em_cluster_batch_dispatch(feats, labels_only=True,
                                           device=dev0)()
    with dpm.data_mesh_installed(mesh):
        got_em = mx.em_cluster_batch_dispatch(feats, labels_only=True,
                                              device=dev0)()
        if 32 % n_devices == 0:
            assert dpm.LAST_DISPATCH["sharded"], "EM chunk did not shard"
        if 512 % n_devices == 0 and n_devices > 1:
            assert mx.LAST_MP_DISPATCH["n_windows"] == 2, "mp EM windows"
    for b, g in zip(base_em, got_em):
        assert g[0] == b[0] and (g[2] == b[2]).all(), "EM != unsharded"
        assert np.isfinite(g[6]).all() and g[6].shape == b[6].shape

    # (2) sequence-parallel POA wavefront over the device tuple
    rng = np.random.default_rng(0)
    ref = "".join(rng.choice(list("ACGT"), 96))
    g = _chain_graph(ref)
    read = ref[:40] + "ACGTACGT" + ref[40:]
    aln, _score = align_sharded(g, read, mesh)
    assert aln == g.align(read), "sharded wavefront != host"

    # (2b) the block-recompute traceback (H-resident, no direction plane)
    # on a tandem-repeat graph
    unit = "".join(rng.choice(list("ACGT"), 48))
    tr_ref = (unit * 22)[:1000]
    g2 = _chain_graph(tr_ref)
    tr_read = tr_ref[:500] + unit + tr_ref[500:]
    aln_b, _sc = align_sharded(g2, tr_read, mesh, traceback="banded",
                               tb_block=(128, 128))
    assert aln_b == g2.align(tr_read), "banded traceback != host"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=None,
                    help="devices of the dry run (default: every CUDA "
                         "device; 4 on the CPU)")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry ok:", [tuple(o.shape) for o in out])
    if args.device == "cpu":
        n = args.n or 4
        dryrun_multichip(n, devices=("cpu",) * n)
    else:
        dryrun_multichip(args.n or torch.cuda.device_count())
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
