"""K1-int16 parity: the port's plain int16 POA aligner against the JAX
package's int16 Pallas kernel.

On the CPU `svscope_tpu_torch.ops.poa_align.align_batch(..., int16_mode=
True)` runs the plain torch version (`align_batch_reference`); its outputs
(an, asp, k_end, score) must be identical to `align_batch_pallas(...,
int16_mode=True, interpret=True)`, including the NEG16 score of a window
with no valid sink, and it must refuse N or l_max past 1024 as JAX does.
The CUDA kernel is compared with the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from svscope_tpu.native.poa import NativePoaGraph
from svscope_tpu.ops.poa_pallas import align_batch_pallas
from svscope_tpu_torch.ops import poa_align
from svscope_tpu_torch.ops import poa_device as tpdev

from test_poa_pallas import _build_cases, _pack

torch.set_num_threads(1)

OUTS = ("an", "asp", "k_end", "score")


def _port(arrs, lb, int16_mode=True):
    args = tpdev.to_torch_packed(*arrs, "cpu")
    return [t.numpy() for t in poa_align.align_batch(*args, lb,
                                                     int16_mode=int16_mode)]


def _jax16(arrs, lb):
    return [np.asarray(x) for x in align_batch_pallas(
        *arrs, lb, interpret=True, int16_mode=True)]


def _assert_equal(want, got):
    for w, g, what in zip(want, got, OUTS):
        assert w.shape == g.shape, what
        assert (w == g).all(), what


@pytest.mark.parametrize("seed,windows", [(23, 16), (31, 9)])
def test_plain16_matches_pallas16_interpret(seed, windows):
    """N=128, L=64: B=16 fills one int16 grid step; B=9 makes JAX pad the
    batch with copies of window 0."""
    graphs, seqs = _build_cases(np.random.default_rng(seed), windows, 40, 6)
    packed, *arrs = _pack(graphs, seqs, 128, 64)
    got = _port(arrs, 64)
    _assert_equal(_jax16(arrs, 64), got)
    # and the int32 mode's outputs, score included (every window has a sink)
    _assert_equal(_port(arrs, 64, int16_mode=False), got)
    for i, g in enumerate(graphs):
        assert tpdev.unpack_alignment(got[0][i], got[1][i], got[2][i],
                                      packed[i][4]) == g.align_only(seqs[i])


def _divergent_case(windows=16):
    """A divergent 500 bp read against a 500-node chain at N=L=512: the most
    negative scores the gate allows room for."""
    rng = np.random.default_rng(29)
    g = NativePoaGraph()
    ref = "".join(rng.choice(list("ACGT"), 500))
    g.add_sequence(ref)
    read = "".join(rng.choice(list("ACGT"), 500))
    p = g.pack(512, 8)
    sq = np.zeros((windows, 512), np.uint8)
    sq[:, :len(read)] = np.frombuffer(read.encode(), np.uint8)
    arrs = [np.stack([p[0]] * windows), np.stack([p[1]] * windows),
            np.stack([p[2]] * windows), np.full(windows, p[3], np.int32),
            sq, np.full(windows, len(read), np.int32)]
    return g, read, p, arrs


def test_plain16_divergent_read_matches_pallas16():
    g, read, p, arrs = _divergent_case()
    got = _port(arrs, 512)
    _assert_equal(_jax16(arrs, 512), got)
    assert int(got[3][0]) < 0
    assert tpdev.unpack_alignment(got[0][0], got[1][0], got[2][0],
                                  p[4]) == g.align_only(read)


def test_plain16_window_without_sink_scores_neg16():
    """Window 0 has no sink: score NEG16 (int32 mode: NEG); its traceback
    and every other output are the int32 mode's and JAX's."""
    graphs, seqs = _build_cases(np.random.default_rng(37), 16, 40, 6)
    packed, *arrs = _pack(graphs, seqs, 128, 64)
    arrs[2] = arrs[2].copy()
    arrs[2][0] = False
    got = _port(arrs, 64)
    _assert_equal(_jax16(arrs, 64), got)
    assert got[3][0] == tpdev.NEG16 == -20000
    got32 = _port(arrs, 64, int16_mode=False)
    assert got32[3][0] == tpdev.NEG
    got32[3][0] = tpdev.NEG16
    _assert_equal(got32, got)


def test_int16_gate_raises_before_running():
    args = list(tpdev.to_torch_packed(
        np.zeros((2, 2048), np.uint8), np.full((2, 2048, 8), -1, np.int32),
        np.zeros((2, 2048), bool), np.full(2, 4, np.int32),
        np.zeros((2, 8), np.uint8), np.full(2, 4, np.int32), "cpu"))
    for fn in (poa_align.align_batch, tpdev.align_batch_reference,
               poa_align.align_batch_cuda):
        with pytest.raises(ValueError, match="int16"):
            fn(*args, 8, int16_mode=True)
    with pytest.raises(ValueError):                  # JAX refuses it too
        align_batch_pallas(*[a.numpy() for a in args], 8, int16_mode=True)
    small = list(tpdev.to_torch_packed(
        np.zeros((2, 64), np.uint8), np.full((2, 64, 8), -1, np.int32),
        np.zeros((2, 64), bool), np.full(2, 4, np.int32),
        np.zeros((2, 8), np.uint8), np.full(2, 4, np.int32), "cpu"))
    with pytest.raises(ValueError, match="int16"):   # l_max past 1024
        poa_align.align_batch(*small, 1025, int16_mode=True)
    assert len(poa_align.align_batch(*small, 1024, int16_mode=True)) == 4


def test_plain16_leaves_launch_counts():
    graphs, seqs = _build_cases(np.random.default_rng(3), 4, 30, 3)
    packed, *arrs = _pack(graphs, seqs, 64, 64)
    before = (poa_align.LAUNCHES, poa_align.LAUNCHES16)
    _port(arrs, 64)
    assert (poa_align.LAUNCHES, poa_align.LAUNCHES16) == before


def test_plane_bytes_int16():
    # H (B, N+1, L+1) int16 + directions (B, N, L+1) int8: B=256, N=1024,
    # L=512 halves H from ~538 MB to ~269 MB
    assert poa_align.plane_bytes(2, 4, 3, int16_mode=True) == \
        2 * (5 * 4 * 2 + 4 * 4)
    h32 = poa_align.plane_bytes(256, 1024, 512) - 256 * 1024 * 513
    h16 = poa_align.plane_bytes(256, 1024, 512, True) - 256 * 1024 * 513
    assert h32 == 2 * h16 == 256 * 1025 * 513 * 4
