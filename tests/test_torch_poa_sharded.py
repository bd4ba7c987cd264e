"""The port's column-sharded POA wavefront (ops/poa_sharded) and the
oversize routing of ops/poa_batch against the host aligners and the JAX
package's align_sharded, on CPU device tuples.

Alignments (pairs and score), MSAs and consensuses must be identical,
tie-breaks included, for every tuple width D in {1, 2, 3, 8} and with the
full and the banded (H-resident) traceback.  tests/test_poa_sharded.py
holds the JAX package to the same; JAX runs on the 8 virtual CPU devices
of tests/conftest.py.
"""
import numpy as np
import pytest
import jax
import torch
from jax.sharding import Mesh

import svscope_tpu.ops.poa as jpoa
from svscope_tpu.ops.poa_sharded import align_sharded as jax_align_sharded
from svscope_tpu_torch.native.poa import NativePoaGraph
from svscope_tpu_torch.ops import poa_batch as pb
from svscope_tpu_torch.ops import poa_sharded as ps
from svscope_tpu_torch.ops.poa import PoaGraph, _fused_path, poa

torch.set_num_threads(1)


def cpus(n):
    return ("cpu",) * n


def _noisy_reads(rng, ref, n_reads, n_edits, ins=None):
    reads = []
    for r in range(n_reads):
        b = list(ref if ins is None or r % 2 else
                 ref[: len(ref) // 2] + ins + ref[len(ref) // 2:])
        for _ in range(n_edits):
            p = int(rng.integers(1, len(b) - 1))
            op = int(rng.integers(0, 3))
            if op == 0:
                b[p] = str(rng.choice(list("ACGT")))
            elif op == 1:
                b.insert(p, str(rng.choice(list("ACGT"))))
            else:
                b.pop(p)
        reads.append("".join(b))
    return reads


def _graphs(ref, reads):
    """The same graph in the port's and the JAX package's oracle: the
    reference as a chain, then each read aligned and fused."""
    out = []
    for cls, fused in ((PoaGraph, _fused_path), (jpoa.PoaGraph,
                                                 jpoa._fused_path)):
        g = cls()
        prev = -1
        for ch in ref:
            cur = g._add_node(ch)
            if prev >= 0:
                g._add_edge(prev, cur)
            prev = cur
        g.seq_begin.append(0)
        for s in reads:
            fused(g, g.align(s), s)
        out.append(g)
    return out


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_block_boundary_stress(n_dev):
    """Highly divergent reads (dense bubbles, multi-pred nodes), read
    lengths on and next to block edges: full and banded == PoaGraph.align
    == JAX's align_sharded (tests/test_poa_sharded.py:270)."""
    rng = np.random.default_rng(20 + n_dev)
    ref = "".join(rng.choice(list("ACGT"), 90))
    g, jg = _graphs(ref, _noisy_reads(rng, ref, 6, 25))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("sp",))
    for L in (63, 64, 65, 89, 90, 107, 128):
        read = "".join(rng.choice(list("ACGT"), 20)) + ref[:max(L - 20, 5)]
        host = g.align(read)
        want = jax_align_sharded(jg, read, mesh)
        assert want[0] == host
        for tb in ("full", "banded"):
            got = ps.align_sharded(g, read, cpus(n_dev), traceback=tb,
                                   tb_block=(16, 32))
            assert got == want, (n_dev, L, tb)


@pytest.mark.parametrize("seed,ref_len", [(0, 120), (1, 300), (2, 75)])
def test_align_sharded_matches_host(seed, ref_len):
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), ref_len))
    reads = _noisy_reads(rng, ref, 6, 5,
                         ins="".join(rng.choice(list("ACGT"), 40)))
    g, _jg = _graphs(ref, reads[:3])
    for s in reads[3:]:
        got, _score = ps.align_sharded(g, s, cpus(8))
        assert got == g.align(s)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_banded_traceback_matches_full(n_dev):
    """Tiny direction blocks force many block crossings on a branch-heavy
    graph; banded == full == host, scores equal."""
    rng = np.random.default_rng(31 + n_dev)
    ref = "".join(rng.choice(list("ACGT"), 130))
    g, _jg = _graphs(ref, _noisy_reads(
        rng, ref, 6, 20, ins="".join(rng.choice(list("ACGT"), 25))))
    for L in (64, 97, 130):
        read = "".join(rng.choice(list("ACGT"), 15)) + ref[:max(L - 15, 5)]
        host = g.align(read)
        full, fscore = ps.align_sharded(g, read, cpus(n_dev),
                                        traceback="full")
        assert full == host
        for kb in ((8, 8), (16, 32), (512, 512)):
            got, score = ps.align_sharded(g, read, cpus(n_dev),
                                          traceback="banded", tb_block=kb)
            assert got == host and score == fscore, (n_dev, L, kb)


def test_oversize_msa_matches_host_msa(monkeypatch):
    """A window past the (shrunk) length ladder through poa_msa_batch's
    oversize route over 3 devices: every round on the wavefront, the C++
    graph fusing between rounds; == the host MSA."""
    rng = np.random.default_rng(7)
    ref = "".join(rng.choice(list("ACGT"), 200))
    seqs = [ref] + _noisy_reads(rng, ref, 8, 4,
                                ins="".join(rng.choice(list("ACGT"), 30)))
    monkeypatch.setattr(pb, "L_LADDER", (64,))
    ps.reset_counts()
    got = pb.poa_msa_batch([seqs], use_device=False, device="cpu",
                           oversize_mesh=cpus(3))
    assert ps.COUNTS["rows"] > 0
    assert got == [poa(seqs, 1)]


def test_banded_msa_matches_host(monkeypatch):
    """Every round through the banded traceback ('auto' past a zero cell
    limit) == the host MSA."""
    rng = np.random.default_rng(41)
    ref = "".join(rng.choice(list("ACGT"), 220))
    seqs = [ref] + _noisy_reads(rng, ref, 7, 5,
                                ins="".join(rng.choice(list("ACGT"), 35)))
    monkeypatch.setattr(pb, "L_LADDER", (64,))
    monkeypatch.setattr(ps, "FULL_DIRS_CELL_LIMIT", 0)
    monkeypatch.setattr(ps, "TB_BLOCK_R", 64)
    monkeypatch.setattr(ps, "TB_BLOCK_C", 64)
    ps.reset_counts()
    assert pb.poa_msa_batch([seqs], use_device=False, device="cpu",
                            oversize_mesh=cpus(2)) == [poa(seqs, 1)]
    assert ps.COUNTS["dir_blocks"] > 0


def test_design_point_4k_tandem_repeat_banded_auto():
    """The oversized-window design point (tests/test_poa_sharded.py:206): a
    ~4k-node tandem-repeat graph against a >4k bp read over 2 devices;
    'auto' takes the banded path, whose direction-block count stays within
    the O(N/kr + L/kc) bound, and the alignment equals the C++ engine's."""
    rng = np.random.default_rng(0)
    unit = "".join(rng.choice(list("ACGT"), 60))
    ref = (unit * 70)[:3900]

    def noisy(s, ne):
        b = list(s)
        for _ in range(ne):
            p = int(rng.integers(1, len(b) - 1))
            op = int(rng.integers(0, 3))
            if op == 0:
                b[p] = str(rng.choice(list("ACGT")))
            elif op == 1:
                b.insert(p, str(rng.choice(list("ACGT"))))
            else:
                b.pop(p)
        return "".join(b)

    g = NativePoaGraph()
    for s in (ref, noisy(ref, 50), noisy(ref, 50)):
        g.add_sequence(s)
    n = g.n_nodes()
    assert 3900 <= n <= 4096, n
    read = noisy(ref, 60) + noisy(unit * 5, 10)
    assert len(read) > 4096
    packed = g.pack(4096, ps.MAX_PREDS)
    block = -(-(8192 + 1) // 2)
    assert 4096 * block * 2 > ps.FULL_DIRS_CELL_LIMIT
    ps.reset_counts()
    got, _score = ps.align_sharded_packed(*packed, read, cpus(2),
                                          traceback="auto")
    assert 0 < ps.COUNTS["dir_blocks"] <= \
        n // ps.TB_BLOCK_R + len(read) // ps.TB_BLOCK_C + 2
    assert ps.COUNTS["rows"] == 2 * n
    assert got == g.align_only(read)


def _counting(monkeypatch):
    calls = {"n": 0}
    real = pb._oversize_sharded

    def counting(g, seq, mesh):
        calls["n"] += 1
        return real(g, seq, mesh)

    monkeypatch.setattr(pb, "_oversize_sharded", counting)
    return calls


def test_per_round_routes_oversize_through_wavefront(monkeypatch):
    """Per-round device mode: with the ladders shrunk, every round of a
    150 bp window goes through the wavefront (test_poa_sharded.py:101);
    the MSA equals the host engine's."""
    rng = np.random.default_rng(9)
    ref = "".join(rng.choice(list("ACGT"), 150))
    seqs = [ref] + _noisy_reads(rng, ref, 5, 3)
    host = pb.poa_msa_batch([seqs], use_device=False, device="cpu")
    monkeypatch.setattr(pb, "N_LADDER", (64,))
    monkeypatch.setattr(pb, "L_LADDER", (64,))
    calls = _counting(monkeypatch)
    got = pb.poa_msa_batch([seqs], use_device=True, device="cpu",
                           oversize_mesh=cpus(4))
    assert calls["n"] == len(seqs) - 1
    assert got == host


@pytest.mark.parametrize("use_device", [False, "fused"])
def test_host_and_fused_route_giant_windows(monkeypatch, use_device):
    """Host and fused mode send windows whose reads pass L_LADDER[-1]
    through the wavefront when a default oversize tuple is set (CLI
    --oversize-sharded; test_poa_sharded.py:128); the others take their
    usual engine."""
    rng = np.random.default_rng(13)
    ref = "".join(rng.choice(list("ACGT"), 180))
    giant = [ref] + _noisy_reads(rng, ref, 4, 3)
    small_ref = "".join(rng.choice(list("ACGT"), 60))
    small = [small_ref] + _noisy_reads(rng, small_ref, 3, 2)
    want = pb.poa_msa_batch([giant, small], use_device=False, device="cpu")
    monkeypatch.setattr(pb, "L_LADDER", (64,))   # 'giant' now over-bucket
    calls = _counting(monkeypatch)
    pb.set_default_oversize_mesh(cpus(2))
    try:
        got = pb.poa_msa_batch([giant, small], use_device=use_device,
                               device="cpu")
    finally:
        pb.set_default_oversize_mesh(None)
    assert calls["n"] == len(giant) - 1
    assert got == want


def test_without_mesh_nothing_routes(monkeypatch):
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), 100))
    seqs = [ref] + _noisy_reads(rng, ref, 3, 2)
    monkeypatch.setattr(pb, "L_LADDER", (64,))
    calls = _counting(monkeypatch)
    for mode in (False, True, "fused"):
        assert pb.poa_msa_batch([seqs], use_device=mode, device="cpu") == \
            [poa(seqs, 1)]
    assert calls["n"] == 0


def test_pred_slots_must_be_a_prefix():
    preds = np.full((4, 8), -1, np.int32)
    preds[1, 0] = 0
    preds[2, :2] = (0, 1)
    assert list(ps._pred_slots(preds, 3)) == [1, 1, 2]
    preds[3, 1] = 2
    with pytest.raises(ValueError, match="slot"):
        ps._pred_slots(preds, 4)
