"""Tests that need an NVIDIA GPU: the CUDA kernels (K1 and K1-int16; K3,
K4, K5 of the fused pk build; K2 of the MisScore path; the row,
fusion-body and int16 probes) against their plain torch versions, and the
slices' device paths and the measurement tools, on the card.

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
    errs = chip_smoke.pk_compare(ops, st, an, asx, ke)
    assert not any(errs.values()), errs


def test_pk_kernels_count_launches_and_reject_bad_input(pk_rounds):
    ops, st, an, asx, ke = pk_rounds[5]
    charsr, sinksr, predsp, chainw, gminr, seqv, lb, nn_eff = ops
    before = dict(tpk.LAUNCHES)
    tpk.align_tb(charsr, sinksr, predsp, chainw, seqv, lb, nn_eff)
    tpk.fusion(an, asx, ke, gminr, seqv[:, 1:].contiguous(), st.clone())
    assert tpk.LAUNCHES["K3"] == before["K3"] + 1
    assert tpk.LAUNCHES["K4"] == before["K4"] + 1
    with pytest.raises(TypeError):
        tpk.align_tb_cuda(charsr.long(), sinksr, predsp, chainw, seqv, lb,
                          nn_eff)
    with pytest.raises(ValueError):               # not contiguous
        tpk.fusion_cuda(an, asx.t().contiguous().t(), ke, gminr,
                        seqv[:, 1:].contiguous(), st.clone())


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
    assert tpk.LAUNCHES["K3"] > 0 and tpk.LAUNCHES["K4"] > 0
    assert tpf.COUNTS["fallbacks"] == 1          # the IUPAC window


def test_fused_slice_on_card(dev, monkeypatch):
    from torch_workloads import make_window_payloads
    wins = make_window_payloads(8, np.random.default_rng(4))
    want = process_window_batch(wins, device=dev, device_poa=False)
    tpk.reset_launches()
    assert process_window_batch(wins, device=dev, device_poa="fused") == want
    assert tpk.LAUNCHES["K3"] > 0 and tpk.LAUNCHES["K4"] > 0
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
        nw_kernel.nw_stats_cuda(*args, 8192)          # shared memory


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


def test_int16_probe_ops_match_plain(dev):
    from svscope_tpu_torch.tools.probe import int16_probe as ip
    for inputs in (ip.probe_inputs(dev), ip.large_inputs(1000, dev)):
        for op in ip.ALL_OPS:
            got = ip.int16_op(op, *inputs)
            assert torch.equal(got.cpu(), ip.int16_op_reference(
                op, *inputs).cpu()), op
    res = ip.main(["--device", "cuda", "--rows", "4096", "--reps", "2"])
    assert all(r["ok"] for r in res.values())
