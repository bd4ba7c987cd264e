"""Tests that need an NVIDIA GPU: the CUDA kernels (K1 and K1-int16; K3,
K4, K5, K6, K7 of the fused pk build; K2 of the MisScore path; the row,
fusion-body and int16 probes) against their plain torch versions, at the
edges of K1's, K3's, K4's, K2's and the three probes' layouts too, and the
slices' device paths and the measurement tools (K1's clock64 split among
them), on the card.

Marked `cuda`; they skip without a card.  This file imports no JAX, so it
also runs on the GPU machine, which has none (and where tests/conftest.py,
which imports JAX, must be skipped):

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

import alnfeature_golden as ag
import chip_smoke
import torch_workloads as tw
from svscope_tpu_torch.engine.localgraph import process_window_batch
from svscope_tpu_torch.ops import nw, nw_batch, nw_kernel
from svscope_tpu_torch.ops import poa_align, poa_device
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops import poa_fused_kernel as tpk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_and_plain(arrs, L, dev):
    args = poa_device.to_torch_packed(*arrs, dev)
    before = poa_align.LAUNCHES
    got = [t.cpu().numpy() for t in poa_align.align_batch(*args, L)]
    assert poa_align.LAUNCHES == before + 1
    want = [t.cpu().numpy()
            for t in poa_device.align_batch_reference(*args, L)]
    return got, want


@pytest.mark.parametrize("shape", [(128, 64, 9), (256, 128, 33),
                                   (512, 512, 64)])
def test_kernel_matches_plain_and_native(dev, shape):
    N, L, B = shape
    graphs, reads, packed, arrs = chip_smoke.random_graph_case(N, L, B, 1)
    got, want = _kernel_and_plain(arrs, L, dev)
    for g, w in zip(got, want):
        assert (g == w).all()
    an, asp, ke, _ = got
    for i, gr in enumerate(graphs):
        assert poa_device.unpack_alignment(an[i], asp[i], ke[i],
                                           packed[i][4]) == \
            gr.align_only(reads[i])


def test_kernel_edge_windows(dev):
    """An empty read, a read filling l_max exactly, and a window with no
    nodes, next to ordinary windows."""
    N, L, B = 128, 64, 9
    _g, _r, _p, arrs = chip_smoke.random_graph_case(N, L, B, 2)
    chars, preds, sinks, nn, seqs, lens = [a.copy() for a in arrs]
    rng = np.random.default_rng(0)
    lens[0] = 0
    seqs[1] = np.frombuffer(
        "".join(rng.choice(list("ACGT"), L)).encode(), np.uint8)
    lens[1] = L
    nn[2] = 0
    got, want = _kernel_and_plain((chars, preds, sinks, nn, seqs, lens),
                                  L, dev)
    for g, w in zip(got, want):
        assert (g == w).all()


def test_kernel_edge_layout_windows(dev):
    """A rank with 8 distinct preds, more ranks than the CTA's threads, a
    read longer than its graph and a window with no sink."""
    got, want = _kernel_and_plain(chip_smoke.k1_edge_case(), 64, dev)
    for g, w in zip(got, want):
        assert (g == w).all()
    assert got[3][3] == poa_device.NEG


def test_kernel_heavy_bucket_2048(dev):
    """Heavy's B = 32 at the N = 2048 bucket (graphs past 1024 nodes)."""
    from svscope_tpu_torch.tools import workloads as wl
    wins = wl.make_window_payloads(wl.HEAVY_WINDOWS, np.random.default_rng(
        wl.HEAVY_SEED), n_reads=wl.HEAVY_READS,
        ins_carriers=wl.HEAVY_READS // 2)
    arrs = wl.round_workload(wins, chip_smoke.HEAVY_2048_READS, 2048, 512)
    assert arrs[3].min() > 1024
    got, want = _kernel_and_plain(arrs, 512, dev)
    for g, w in zip(got, want):
        assert (g == w).all()


def test_k1_split_tool_on_card(dev):
    from svscope_tpu_torch.tools import k1_split
    res = k1_split.main(["--workload", "attached", "--reps", "2"])
    shares = [p["share"] for p in res["attached"]["parts"].values()]
    assert abs(sum(shares) - 1) < 1e-6


def test_kernel_rejects_bad_input(dev):
    _g, _r, _p, arrs = chip_smoke.random_graph_case(128, 64, 8, 3)
    args = list(poa_device.to_torch_packed(*arrs, dev))
    with pytest.raises(ValueError):
        poa_align.align_batch_cuda(*args, 32)          # seqs wider than l_max
    args[3] = args[3].to(torch.int64)
    with pytest.raises(TypeError):
        poa_align.align_batch_cuda(*args, 64)


def test_slice_device_path_on_card(dev):
    from torch_workloads import make_window_payloads
    wins = make_window_payloads(8, np.random.default_rng(4))
    poa_align.reset_launches()
    recs = process_window_batch(wins, device=dev)
    assert poa_align.LAUNCHES > 0
    assert recs == process_window_batch(wins, device=dev, device_poa=False)


@pytest.fixture(scope="module")
def pk_rounds():
    """Operands of the pk kernels at rounds 1, 6 and 21 of the port's
    fused build of 8 bench windows, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from torch_workloads import make_window_payloads
    wins = make_window_payloads(8, np.random.default_rng(6))
    dev = torch.device("cuda", torch.cuda.current_device())
    _bucket, caps = chip_smoke.capture_rounds(
        [w.sequences for w in wins], (0, 5, 20), dev)
    return caps


@pytest.mark.parametrize("r", [0, 5, 20])
def test_pk_kernels_match_plain(pk_rounds, r):
    ops, st, an, asx, ke = pk_rounds[r]
    errs, (k4_walks, model_flags) = chip_smoke.pk_compare(ops, st, an, asx,
                                                          ke)
    assert not any(errs.values()), errs
    assert k4_walks == model_flags == 0


def test_pk_kernels_count_launches_and_reject_bad_input(pk_rounds):
    ops, st, an, asx, ke = pk_rounds[5]
    charsr, sinksr, predsp, seqv, lb, nn_eff, gminr = ops
    before = dict(tpk.LAUNCHES)
    tpk.align_tb(charsr, sinksr, predsp, seqv, lb, nn_eff)
    tpk.fusion(an, asx, ke, gminr, seqv[:, 1:].contiguous(), st.clone())
    assert tpk.LAUNCHES["K3"] == before["K3"] + 1
    assert tpk.LAUNCHES["K4"] == before["K4"] + 1
    with pytest.raises(TypeError):
        tpk.align_tb_cuda(charsr.long(), sinksr, predsp, seqv, lb, nn_eff)
    with pytest.raises(ValueError):               # not contiguous
        tpk.fusion_cuda(an, asx.t().contiguous().t(), ke, gminr,
                        seqv[:, 1:].contiguous(), st.clone())


@pytest.mark.parametrize("batch", [1, 3, 13, 129])
@pytest.mark.parametrize("ncap", [129, 1025, 3073])
def test_k6_k7_edge_states_match_plain(dev, ncap, batch):
    """K6 (prep and order modes) and K7 == plain on glue_edge_case's
    windows (an empty graph, one node, 8 full in-slots, two cyclic
    windows, an empty read, ncap - 1 nodes, columns and branches, a head
    with over 32 blockers, duplicate edges, a run of over 32 columns over
    holes, one long chain, weights past 2^10 for K7's 64-bit keys), in
    batches of 1, 3, 13 and 129 of them (the grid's edges)."""
    st, seq, slen = chip_smoke.glue_edge_tensors(ncap, dev, batch=batch)
    idx = chip_smoke.glue_edge_windows(batch)
    before = dict(tpk.LAUNCHES)
    errs, n_cyclic = chip_smoke.glue_compare(st, seq, slen)
    assert errs == {"K6": 0, "K7": 0}
    assert n_cyclic == sum(int(b in chip_smoke.GLUE_CYCLIC) for b in idx)
    assert tpk.LAUNCHES["K6"] == before["K6"] + 2
    assert tpk.LAUNCHES["K7"] == before["K7"] + 1


@pytest.mark.parametrize("r", [0, 5, 20])
def test_k6_k7_match_plain_on_captured_rounds(pk_rounds, r):
    """K6 == plain == the build's own operands, K7 == plain, on the states
    of real rounds."""
    ops, st, an, asx, ke = pk_rounds[r]
    errs, n_cyclic = chip_smoke.glue_compare(
        st, ops[3][:, 1:].contiguous(), ops[4], build_ops=ops)
    assert errs == {"K6": 0, "K7": 0} and n_cyclic == 0


def test_k6_k7_count_launches_and_reject_bad_input(pk_rounds):
    ops, st, an, asx, ke = pk_rounds[5]
    seq = ops[3][:, 1:].contiguous()
    before = dict(tpk.LAUNCHES)
    with pytest.raises(TypeError):
        tpk.toposort_cuda(st.pn.long(), st.gm, st.nn)
    with pytest.raises(ValueError):               # not contiguous
        tpk.round_prep_cuda(st, ops[3][:, 1:], ops[4])
    shifted = torch.empty(st.pn.numel() + 1, dtype=torch.int32,
                          device=st.pn.device)[1:].view(st.pn.shape)
    shifted.copy_(st.pn)
    with pytest.raises(ValueError):               # pn not 16-byte aligned
        tpk.toposort_cuda(shifted, st.gm, st.nn)
    order = tpk.toposort_cuda(st.pn, st.gm, st.nn)[0]
    with pytest.raises(TypeError):
        tpk.consensus_cuda(st.pn, st.pw, st.pt, st.nn, order.int())
    assert tpk.LAUNCHES["K6"] == before["K6"] + 1
    tpf.pk_round_prep(st.clone(), seq, ops[4])
    tpf.consensus_walk(st.ch, st.pn, st.pw, st.pt, st.nn, order)
    assert tpk.LAUNCHES["K6"] == before["K6"] + 2
    assert tpk.LAUNCHES["K7"] == before["K7"] + 1


def test_k6_k7_shared_memory_plans_match_the_kernels(dev):
    import ctypes
    prep = tpk.load_cuda_lib(tpk.PREP_SOURCE).pk_prep_smem_bytes
    walk = tpk.load_cuda_lib(tpk.CONSENSUS_SOURCE).pk_consensus_smem_bytes
    for fn in (prep, walk):
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for n in (1, 2, 48, 65, 97, 129, 1025, 2049, 3073, 4096):
        assert prep(n) == tpk.prep_smem_bytes(n), n
        assert walk(n) == tpk.consensus_smem_bytes(n), n


def test_glue_split_tool_on_card(dev):
    """The stamped builds of K6 and K7 equal the kernels (measure raises
    otherwise) and their parts cover each block's cycles."""
    from svscope_tpu_torch.tools import glue_split
    res = glue_split.measure("bench", dev, 2)
    for key in ("K6", "K6 order", "K7"):
        shares = [p["mean_share"] for p in res[key]["parts"].values()]
        assert abs(sum(shares) - 1) < 1e-6, key
    assert res["K6"]["cycles_per_step"] > 0
    assert res["K7"]["cycles_per_rank"] > 0
    assert min(res["K6"]["step_parts"].values()) > 0


def test_fused_build_reads_nothing_back(dev):
    """A fused build on the card makes no host check (the plain versions'
    COUNTS stay 0), three launches a round and one K6 and one K7 after
    the last, and equals the CPU build."""
    from torch_workloads import make_window_payloads
    wins = make_window_payloads(8, np.random.default_rng(2))
    _out, groups, _fb, enc = tpf.plan_buckets([w.sequences for w in wins])
    (rb, lb, nb), idxs = next(iter(groups.items()))
    arrs = tpf.chunk_arrays(idxs, enc, rb, lb)
    rounds = int(arrs[2].max())
    tpk.reset_launches()
    tpf.reset_counts()
    got = tpf.build_batch_pk(*arrs, ncap=nb + 1, device=dev)
    assert tpf.COUNTS["host_syncs"] == tpf.COUNTS["kahn_steps"] == 0
    assert tpf.COUNTS["consensus_steps"] == 0
    assert tpk.LAUNCHES == {"K3": rounds, "K4": rounds, "K5": 0,
                            "K6": rounds + 1, "K7": 1}
    want = tpf.build_batch_pk(*arrs, ncap=nb + 1, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_k3_edge_windows(dev):
    """K3 == plain on the pk-layout edge windows (an empty graph, an empty
    read, 8 distinct preds beside padded slots, sources past rank 0, a
    read longer than its graph, no sink), one launch."""
    before = tpk.LAUNCHES["K3"]
    assert chip_smoke.k3_parity(chip_smoke.pk_layout(
        *chip_smoke.k3_edge_case(), 64), dev, "edge windows") == 0
    assert tpk.LAUNCHES["K3"] == before + 1


@pytest.mark.parametrize("l_max", [512, 2048])
def test_k3_widest_bucket(dev, l_max):
    """K3 == plain on random graphs at ncap 3073, the widest pk bucket (at
    l_max 2048 the ring of H rows halves to fit shared memory)."""
    arrs = chip_smoke.random_graph_case(chip_smoke.PK_NCAP_MAX, l_max, 4,
                                        l_max)[3]
    assert chip_smoke.k3_parity(chip_smoke.pk_layout(*arrs, l_max), dev,
                                f"l_max={l_max}") == 0


def test_k3_heavy_round_200(dev):
    """K3 == plain (and == the build's own K3) at round 200 of heavy32x400,
    ncap 3073."""
    import localgraph_golden as lgg
    wins = lgg.make_workload("heavy32x400")
    _bucket, caps = chip_smoke.capture_rounds(
        [w.sequences for w in wins], (chip_smoke.PK_HEAVY_ROUND,), dev)
    ops, st, an, asx, ke = caps[chip_smoke.PK_HEAVY_ROUND]
    assert ops[0].shape[1] == chip_smoke.PK_NCAP_MAX
    errs, flags = chip_smoke.pk_compare(ops, st, an, asx, ke)
    assert not any(errs.values()), errs
    assert flags == (0, 0)


def test_k4_k5_edge_states(dev):
    """K4 == K5 == plain == the CPU model on the fusion edge states (a
    duplicate key, the trash row reached, overflow set on entry, 8 full
    pred slots, re-walked edges, runs of gaps, an empty alignment, a read
    longer than its graph); K4 takes the serial walk in cases 1-3 only,
    as the model flags them; one launch each."""
    (an, asx, ke, gminr, seq5), st = chip_smoke.fusion_edge_tensors(dev)
    before = dict(tpk.LAUNCHES)
    errs, flags = chip_smoke.fusion_compare(an, asx, ke, gminr, seq5, st)
    assert not any(errs.values()), errs
    assert flags == (3, 3)
    assert tpk.LAUNCHES["K4"] == before["K4"] + 1
    assert tpk.LAUNCHES["K5"] == before["K5"] + 1


def test_k4_shared_memory_plan_matches_the_kernel(dev):
    """fusion_smem_bytes == the kernel's own size at every pk bucket."""
    fn = tpk._fusion_fns()["pk_fusion_smem_bytes"]
    for n in tpf.N_LADDER:
        for l_max in tpf.L_LADDER:
            assert fn(n + 1, l_max, n + l_max) == tpk.fusion_smem_bytes(
                n + 1, l_max, n + l_max)


def test_k4_rejects_unaligned_state(pk_rounds):
    ops, st, an, asx, ke = pk_rounds[5]
    seq5 = ops[3][:, 1:].contiguous()
    bad = st.clone()
    shifted = torch.empty(bad.pn.numel() + 1, dtype=torch.int32,
                          device=an.device)[1:].view(bad.pn.shape)
    shifted.copy_(bad.pn)
    bad.pn = shifted
    before = dict(tpk.LAUNCHES)
    for order in tpk.FUSION_ENGINES:
        with pytest.raises(ValueError):
            tpk.fusion_cuda(an, asx, ke, ops[6], seq5, bad, order)
    assert tpk.LAUNCHES == before


def test_k3_rejects_unaligned_preds(pk_rounds):
    ops = pk_rounds[5][0]
    charsr, sinksr, predsp, seqv, lb, nn_eff, _gminr = ops
    shifted = torch.empty(predsp.numel() + 1, dtype=torch.int32,
                          device=predsp.device)[1:].view(predsp.shape)
    shifted.copy_(predsp)
    before = tpk.LAUNCHES["K3"]
    with pytest.raises(ValueError):
        tpk.align_tb_cuda(charsr, sinksr, shifted, seqv, lb, nn_eff)
    assert tpk.LAUNCHES["K3"] == before


def test_fused_msa_on_card_matches_host(dev):
    from torch_workloads import make_window_payloads
    from svscope_tpu.native.poa import poa_msa_batch_native
    jobs = [w.sequences for w in
            make_window_payloads(6, np.random.default_rng(7))]
    jobs += [["ACGT", "", "AGT"], ["", "ACGTA"], ["ACGRT", "ACGT"]]
    tpk.reset_launches()
    tpf.reset_counts()
    got = tpf.fused_msa_batch(jobs, device=dev)
    assert got == poa_msa_batch_native(jobs)
    assert all(tpk.LAUNCHES[k] > 0 for k in ("K3", "K4", "K6", "K7"))
    assert tpf.COUNTS["host_syncs"] == 0
    assert tpf.COUNTS["fallbacks"] == 1          # the IUPAC window


def test_fused_slice_on_card(dev, monkeypatch):
    from torch_workloads import make_window_payloads
    wins = make_window_payloads(8, np.random.default_rng(4))
    want = process_window_batch(wins, device=dev, device_poa=False)
    tpk.reset_launches()
    assert process_window_batch(wins, device=dev, device_poa="fused") == want
    assert all(tpk.LAUNCHES[k] > 0 for k in ("K3", "K4", "K6", "K7"))
    monkeypatch.setenv("SVSCOPE_PK_FUSION", "seq")
    tpk.reset_launches()
    assert process_window_batch(wins, device=dev, device_poa="fused") == want
    assert tpk.LAUNCHES["K5"] > 0 and tpk.LAUNCHES["K4"] == 0


@pytest.mark.parametrize("bucket", [128, 512, 4096])
def test_k2_matches_plain_and_host(dev, bucket):
    """Kernel == plain under both score sets, with the bucket-edge and
    empty-side pairs and a batch that is not a multiple of 8; == the host
    DP on the first pairs."""
    pairs = tw.bucket_pairs(np.random.default_rng(bucket), bucket, 13)
    for sc in ag.SCORINGS.values():
        k, p = chip_smoke.k2_pair(pairs, bucket, dev, sc)
        assert torch.equal(k, p)
        assert k[:, :4].T.tolist() == [list(nw.nw_align_stats(a, b, *sc))
                                        for a, b in pairs[:4]]


@pytest.mark.parametrize("bucket", [128, 256, 512, 1024, 4096])
def test_k2_band_edges(dev, bucket):
    """la at 0, 1, the band height and two bands, each +-1, and the bucket;
    lb at 0, 1 and the bucket; mixed in one launch, both score sets;
    kernel == plain == host DP."""
    pairs = chip_smoke.k2_edge_pairs(bucket, bucket)
    for sc in ag.SCORINGS.values():
        k, p = chip_smoke.k2_pair(pairs, bucket, dev, sc)
        assert torch.equal(k, p)
        assert k.T.tolist() == [list(nw.nw_align_stats(a, b, *sc))
                                for a, b in pairs]


def test_k2_packing_gate_edge(dev):
    """K2 packs (M, A) as M << 16 | A up to l_max = MAX_LEN: at the edge an
    all-gap alignment of A = 65534 (gaps beat mismatches under
    (1, -3, -1)) and M = 32767 (identical sides) come out whole; one more
    bp raises."""
    n = nw_kernel.MAX_LEN
    pairs = [("A" * n, "C" * n), ("A" * n, "A" * n)]
    args = [torch.from_numpy(x).to(dev) for x in ag.pad_pairs(pairs, n)]
    got = torch.stack(nw_kernel.nw_stats_cuda(*args, n, 1, -3, -1)).cpu()
    assert got.T.tolist() == [[-2 * n, 0, 2 * n], [n, n, n]]
    wide = [torch.from_numpy(x).to(dev) for x in ag.pad_pairs(pairs, n + 1)]
    before = nw_kernel.LAUNCHES
    with pytest.raises(ValueError):
        nw_kernel.nw_stats_cuda(*wide, n + 1)
    assert nw_kernel.LAUNCHES == before


def test_k2_counts_launches_and_rejects_bad_input(dev):
    args = [torch.from_numpy(x).to(dev)
            for x in ag.pad_pairs([("ACGT", "AGT"), ("", "A")], 128)]
    nw_kernel.reset_launches()
    nw_kernel.nw_stats(*args, 128)
    assert nw_kernel.LAUNCHES == 1
    with pytest.raises(ValueError):
        nw_kernel.nw_stats_cuda(*args, 256)          # width != l_max
    with pytest.raises(TypeError):
        nw_kernel.nw_stats_cuda(args[0], args[1], args[2].long(), args[3],
                                128)
    with pytest.raises(ValueError):
        nw_kernel.nw_stats_cuda(*args, 8192)          # width != l_max


def test_misscore_batch_on_card(dev):
    rng = np.random.default_rng(8)
    pairs = [p for b in (128, 1024, 4096) for p in tw.bucket_pairs(rng, b, 3)]
    pairs.append((tw.rand_seq(rng, 4100), tw.rand_seq(rng, 20)))
    nw_kernel.reset_launches()
    nw_batch.reset_counts()
    got = nw_batch.misscore_batch(pairs, device=dev)
    assert nw_kernel.LAUNCHES == 3
    assert nw_batch.COUNTS["host_dp_pairs"] == 1
    assert got.tolist() == nw_batch.misscore_batch(pairs, device="cpu") \
        .tolist()


@pytest.mark.parametrize("shape", [(128, 64, 9), (512, 512, 64)])
def test_k1_int16_matches_plain_and_int32(dev, shape):
    N, L, B = shape
    graphs, reads, packed, arrs = chip_smoke.random_graph_case(N, L, B, 5)
    args = poa_device.to_torch_packed(*arrs, dev)
    before = poa_align.LAUNCHES16
    k16, p16, k32 = chip_smoke.k1_int16_outputs(args, L)
    assert poa_align.LAUNCHES16 == before + 1
    for a, b, c in zip(k16, p16, k32):
        assert (a == b).all() and (a == c).all()
    for i, g in enumerate(graphs):
        assert poa_device.unpack_alignment(k16[0][i], k16[1][i], k16[2][i],
                                           packed[i][4]) == \
            g.align_only(reads[i])


def test_k1_int16_no_sink_and_gate(dev):
    _g, _r, _p, arrs = chip_smoke.random_graph_case(128, 64, 9, 6)
    sinks = arrs[2].copy()
    sinks[3] = False
    args = poa_device.to_torch_packed(arrs[0], arrs[1], sinks, *arrs[3:], dev)
    k16, p16, _k32 = chip_smoke.k1_int16_outputs(args, 64)
    assert k16[3][3] == poa_device.NEG16
    for a, b in zip(k16, p16):
        assert (a == b).all()
    big = poa_device.to_torch_packed(
        np.zeros((2, 2048), np.uint8), np.full((2, 2048, 8), -1, np.int32),
        np.zeros((2, 2048), bool), np.full(2, 4, np.int32),
        np.zeros((2, 8), np.uint8), np.full(2, 4, np.int32), dev)
    before = poa_align.LAUNCHES16
    with pytest.raises(ValueError):
        poa_align.align_batch(*big, 8, int16_mode=True)
    assert poa_align.LAUNCHES16 == before


def test_attached_bench_on_card(dev):
    from svscope_tpu_torch.tools import attached_bench as tab
    poa_align.reset_launches()
    res = tab.main(["--device", "cuda", "--b", "8", "--reps", "2"])
    assert len(res) == 4 and poa_align.LAUNCHES16 > 0
    assert poa_align.LAUNCHES > 0


def test_row_probe_kernels_match_plain(dev):
    from svscope_tpu_torch.tools.probe import row_probe as rp
    chars, seqs = rp.make_inputs(16, dev)
    for v in rp.VARIANTS:
        before = rp.LAUNCHES[v]
        got = rp.row_probe(chars, seqs, v)
        assert rp.LAUNCHES[v] == before + 1
        assert torch.equal(got.cpu(), rp.row_probe_reference(
            chars, seqs, v).cpu()), v


def test_fusebody_probe_kernels_match_plain(dev):
    from svscope_tpu_torch.tools.probe import fusebody_probe as fp
    *ops, st0 = fp.device_inputs(fp.build_states(), dev)
    for v in fp.VARIANTS:
        sk, sp = st0.clone(), st0.clone()
        got = [*fp.fusebody(v, *ops, sk), *sk.tensors()]
        want = [*fp.fusebody_reference(v, *ops, sp, fp.OUT_LEN - fp.STEPS),
                *sp.tensors()]
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu()), v


@pytest.mark.parametrize("shape", chip_smoke.ROW_PROBE_EDGES)
def test_row_probe_edges_match_plain(dev, shape):
    """Every variant == plain at the edges of K1's layout: one window, 300,
    one row, rows of 1, 33 and 1025 columns (a partial last tile of 3)."""
    from svscope_tpu_torch.tools.probe import row_probe as rp
    chars, seqs = chip_smoke.row_probe_edge_inputs(*shape, dev)
    for v in rp.VARIANTS:
        got = rp.row_probe_cuda(chars, seqs, v)
        assert torch.equal(got.cpu(), rp.row_probe_reference(
            chars, seqs, v).cpu()), v


@pytest.fixture(scope="module")
def fusebody_states():
    from svscope_tpu_torch.tools.probe import fusebody_probe as fp
    return fp.build_states()


@pytest.mark.parametrize("windows", chip_smoke.FUSEBODY_EDGE_WINDOWS
                         + (tuple(range(8)),))
@pytest.mark.parametrize("entries", chip_smoke.FUSEBODY_EDGE_ENTRIES)
def test_fusebody_probe_edges_match_plain(dev, fusebody_states, entries,
                                          windows):
    """Every variant == plain (nn_out, path, the whole state) at the edges
    of the staged tiles (1, 255, 256, 257 and all entries), on 1, 8 and 9
    windows."""
    from svscope_tpu_torch.tools.probe import fusebody_probe as fp
    *ops, st0 = fp.device_inputs(fusebody_states, dev)
    ops, st0 = chip_smoke.fusebody_windows(ops, st0, list(windows))
    k0 = fp.OUT_LEN - entries
    for v in fp.VARIANTS:
        sk, sp = st0.clone(), st0.clone()
        got = [*fp.fusebody_cuda(v, *ops, sk, k0), *sk.tensors()]
        want = [*fp.fusebody_reference(v, *ops, sp, k0), *sp.tensors()]
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu()), v


def test_fusebody_probe_rejects_bad_launch(dev, fusebody_states):
    from svscope_tpu_torch.ops.poa_fused_kernel import GraphState
    from svscope_tpu_torch.tools.probe import fusebody_probe as fp
    *ops, st = fp.device_inputs(fusebody_states, dev)
    before = dict(fp.LAUNCHES)
    t = st.pn.flatten()
    off = torch.cat([t[:1], t]).narrow(0, 1, t.numel()).view(st.pn.shape)
    assert off.data_ptr() % 16
    bad = GraphState(off, *st.tensors()[1:])
    with pytest.raises(ValueError):
        fp.fusebody_cuda("full", *ops, bad, 0)
    assert fp.LAUNCHES == before


def test_int16_probe_ops_match_plain(dev):
    from svscope_tpu_torch.tools.probe import int16_probe as ip
    for inputs in (ip.probe_inputs(dev), ip.large_inputs(1000, dev)):
        for op in ip.ALL_OPS:
            got = ip.int16_op(op, *inputs)
            assert torch.equal(got.cpu(), ip.int16_op_reference(
                op, *inputs).cpu()), op
    res = ip.main(["--device", "cuda", "--rows", "4096", "--reps", "2"])
    assert all(r["ok"] for r in res.values())


@pytest.mark.parametrize("width", [8, 24, 128, 256, 520])
def test_int16_probe_row_widths(dev, width):
    """Every op == plain at row widths of 1, 3, 16, 32 and 65 int4 (rows
    that straddle warps read roll16's neighbour from memory), on 16-byte
    accesses."""
    from svscope_tpu_torch.tools.probe import int16_probe as ip
    a = np.random.default_rng(width).integers(-ip.LIM, ip.LIM,
                                              (3, 37, width), np.int16)
    x, y, z = (torch.from_numpy(a[i]).to(dev) for i in range(3))
    for op in ip.ALL_OPS:
        assert torch.equal(ip.int16_op_cuda(op, x, y, z).cpu(),
                           ip.int16_op_reference(op, x, y, z).cpu()), op


def test_int16_probe_rejects_widths_off_8(dev):
    from svscope_tpu_torch.tools.probe import int16_probe as ip
    x = torch.zeros((16, 12), dtype=torch.int16, device=dev)
    before = dict(ip.LAUNCHES)
    with pytest.raises(ValueError):
        ip.int16_op_cuda("max16", x, x, x)
    big = torch.zeros(16 * 128 + 1, dtype=torch.int16, device=dev)
    off = big[1:].view(16, 128)
    with pytest.raises(ValueError):
        ip.int16_op_cuda("max16", off, off, off)
    assert ip.LAUNCHES == before


# -- the scale-out on the card: a two-shard tuple of the one GPU ----------

def test_dp_split_launches_each_shard(dev):
    """process_window_batch under ("cuda:0", "cuda:0"): records == the
    unsharded run's, the last dispatch split in 2, K1 launched per shard;
    the fused build too (K3 and K4)."""
    from svscope_tpu_torch.parallel import dataparallel as dpm
    wins = tw.make_window_payloads(16, np.random.default_rng(0))
    for engine, kernels in (("pallas", ("K1",)),
                            ("fused", ("K3", "K4", "K6", "K7"))):
        base = process_window_batch(wins, device=dev, device_poa=engine)
        poa_align.reset_launches()
        tpk.reset_launches()
        with dpm.data_mesh_installed((dev, dev)):
            got = process_window_batch(wins, device=dev, device_poa=engine)
            assert dpm.LAST_DISPATCH == {"sharded": True, "n_shards": 2}
        launches = {"K1": poa_align.LAUNCHES, **tpk.LAUNCHES}
        assert got == base, engine
        assert all(launches[k] > 0 for k in kernels), launches


def test_mp_em_on_card_matches_batched(dev):
    from svscope_tpu_torch.models import mixture as mx
    from svscope_tpu_torch.parallel import dataparallel as dpm
    rng = np.random.default_rng(7)
    a = rng.integers(0, 4, (1, 32))
    b = (a + 1 + rng.integers(0, 3, (1, 32))) % 4
    x = np.concatenate([np.repeat(a, 150, 0), np.repeat(b, 150, 0)])
    x = np.where(rng.random(x.shape) < 0.03, rng.integers(0, 5, x.shape),
                 x).astype(np.int8)
    base = mx.em_cluster_batch_dispatch([x], labels_only=True, device=dev)()
    with dpm.data_mesh_installed((dev, dev)):
        got = mx.em_cluster_batch_dispatch([x], labels_only=True,
                                           device=dev)()
        assert mx.LAST_MP_DISPATCH["used"]
    assert got[0][0] == base[0][0] and (got[0][2] == base[0][2]).all()


@pytest.mark.parametrize("traceback", ["full", "banded"])
def test_sharded_wavefront_on_card_matches_engine(dev, traceback):
    from svscope_tpu_torch.native.poa import NativePoaGraph
    from svscope_tpu_torch.ops import poa_sharded as ps
    reads = chip_smoke.oversize_window(np.random.default_rng(3), 48, 700, 4)
    g = NativePoaGraph()
    for r in reads[:3]:
        g.add_sequence(r)
    packed = g.pack(1024, ps.MAX_PREDS)
    for shards in (1, 2, 3):
        got, _ = ps.align_sharded_packed(*packed, reads[3], (dev,) * shards,
                                         traceback=traceback,
                                         tb_block=(64, 64))
        assert got == g.align_only(reads[3]), shards
