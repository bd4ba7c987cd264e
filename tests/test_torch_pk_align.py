"""K3's layout on the CPU.  The plain K3 (align_tb_reference) against JAX's
align_tb_call in interpret mode on hand-built pk-layout edge windows
(chip_smoke.k3_edge_case through chip_smoke.pk_layout, with JAX's packed
pred rows and chain flags built as _pk_round_prep lays them out), one case
per window; and K1's launch configuration, which K3 shares, at every pk
bucket.  The CUDA kernel itself runs in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import chip_smoke
from svscope_tpu.ops import poa_fused_kernel as jpk
from svscope_tpu_torch.ops import poa_align
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops import poa_fused_kernel as tpk

N, L_MAX = 80, 64
CASES = ("nn_eff 0", "lb 0", "8 distinct preds", "read longer than graph",
         "no sink", "source past rank 0", "bubbles", "bubbles, full read")
ROW_MASK = (1 << 13) - 1     # the staged row field (csrc/poa_row.cuh)


def jax_operands(arrs):
    """K3's pk-layout operands as JAX's align_tb_call takes them: the pred
    table padded to 16-rank rows of 128 lanes, the chain-row flags chainw
    and chain_all, their AND over each group of 8 windows, lb and nn_eff as
    (B, 1)."""
    charsr, sinksr, predsp, seqv, lb, nn_eff = arrs
    B = len(lb)
    n16 = -(-N // 16)
    packed = np.full((B, n16 * 16, 8), -1, np.int32)
    packed[:, :N] = predsp
    chainw = chip_smoke.chain_flags(predsp, nn_eff)
    chain_all = chainw.reshape(B // 8, 8, N).all(axis=1).astype(
        np.int32).reshape(B // 8, 1, N)
    return (charsr, sinksr, packed.reshape(B, n16, 128), chain_all, chainw,
            seqv, lb[:, None], nn_eff[:, None])


@pytest.fixture(scope="module")
def edge():
    arrs = chip_smoke.pk_layout(*chip_smoke.k3_edge_case(N, L_MAX), L_MAX)
    want = [np.asarray(x) for x in jpk.align_tb_call(
        *jax_operands(arrs), n_max=N, l_max=L_MAX, interpret=True)]
    got = [t.numpy() for t in tpk.align_tb_reference(
        *[torch.from_numpy(a) for a in arrs])]
    return arrs, got, want


def test_edge_windows_are_the_cases():
    charsr, sinksr, predsp, seqv, lb, nn_eff = chip_smoke.pk_layout(
        *chip_smoke.k3_edge_case(N, L_MAX), L_MAX)
    chainw = chip_smoke.chain_flags(predsp, nn_eff)
    assert nn_eff[0] == 0 and lb[0] > 0
    assert lb[1] == 0 and nn_eff[1] > 0
    assert len(set(predsp[2, 8])) == 8 and (predsp[2, 1:8] == -1).all()
    assert len(set(predsp[2, 30])) == 3 and (predsp[2, 30, 3:] == 29).all()
    assert lb[3] > nn_eff[3]
    assert sinksr[4].sum() == 0 and sinksr[[2, 3, 5, 6, 7]].any(1).all()
    assert (predsp[5, 15] == -1).all() and sinksr[5, 14] == 1
    assert (lb[6:] == L_MAX).all() and seqv[:, 0].tolist() == [255] * 8
    assert not chainw[2, 8] and chainw[2, 9] and not chainw[5, 15]


@pytest.mark.parametrize("w", range(len(CASES)), ids=CASES)
def test_align_tb_reference_matches_jax_on_edge_windows(edge, w):
    _arrs, (an, asx, ke), (j_an, j_asx, j_ke) = edge
    np.testing.assert_array_equal(an[w], j_an[w])
    np.testing.assert_array_equal(asx[w], j_asx[w])
    assert ke[w] == j_ke[w, 0]


@pytest.mark.parametrize("ncap,l_max", [(n + 1, l) for n in tpf.N_LADDER
                                        for l in tpf.L_LADDER])
def test_every_pk_bucket_has_a_k3_launch(ncap, l_max):
    """K3 launches with K1's configuration: TILES 1-4 (the kernel's own
    ceil((l_max+1) / threads)), whole warps within the launch bound, a ring
    of at least one row, the deepest that fits, and the staged topology
    within a block's shared memory and the staged row field."""
    tiles = poa_align.launch_tiles(l_max)
    threads = poa_align.launch_threads(l_max)
    assert 1 <= tiles <= poa_align.MAX_TILES
    assert -(-(l_max + 1) // threads) == tiles
    assert threads % 32 == 0
    assert threads <= (512 if tiles <= 2 else 1024)
    ring = poa_align.ring_rows(ncap, l_max)
    assert ring >= 1
    assert poa_align.smem_bytes(ncap, l_max, ring) <= poa_align.SMEM_MAX
    assert ring == poa_align.RING_MAX or \
        poa_align.smem_bytes(ncap, l_max, 2 * ring) > poa_align.SMEM_MAX
    assert ncap <= ROW_MASK
