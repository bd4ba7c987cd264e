"""K1 parity: the port's POA aligner against the JAX package.

On the CPU `svscope_tpu_torch.ops.poa_align.align_batch` runs the kernel's
plain torch version; its outputs (an, asp, k_end, score) must be identical
to the Pallas kernel (`align_batch_pallas`, interpret mode), the XLA
aligner (`poa_device.align_batch`) and the native C++ engine's own
alignment.  The CUDA kernel itself is compared with the plain version on
the card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from svscope_tpu.ops import poa_device as jpdev
from svscope_tpu.ops.poa_pallas import align_batch_pallas
from svscope_tpu_torch.ops import poa_align
from svscope_tpu_torch.ops import poa_device as tpdev
from svscope_tpu_torch.utils.device import resolve_device

from test_poa_pallas import _build_cases, _pack

torch.set_num_threads(1)

# (seed, windows, read length, reads per graph, N bucket, L bucket):
# branch rows with B not a multiple of 8; an all-chain batch (backbone
# only); n_nodes < n_max and seq_len < l_max throughout
CASES = {
    "branch_b9": (7, 9, 40, 6, 128, 64),
    "chain_only": (13, 8, 40, 0, 64, 64),
    "branch_b12_l128": (19, 12, 60, 8, 256, 128),
}


def _case(name):
    seed, nw, rl, nr, nb, lb = CASES[name]
    graphs, seqs = _build_cases(np.random.default_rng(seed), nw, rl, nr)
    packed, *arrs = _pack(graphs, seqs, nb, lb)
    return graphs, seqs, packed, arrs, lb


def _port(arrs, lb, device="cpu"):
    args = tpdev.to_torch_packed(*arrs, device)
    return [t.cpu().numpy() for t in poa_align.align_batch(*args, lb)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name):
    graphs, seqs, packed, arrs, lb = _case(name)
    want = [np.asarray(x) for x in align_batch_pallas(*arrs, lb,
                                                      interpret=True)]
    got = _port(arrs, lb)
    for w, g, what in zip(want, got, ("an", "asp", "k_end", "score")):
        assert w.shape == g.shape, what
        assert (w == g).all(), what


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_xla_aligner(name):
    graphs, seqs, packed, arrs, lb = _case(name)
    want = [np.asarray(x) for x in jpdev.align_batch(
        *[jnp.asarray(a) for a in arrs], lb)]
    got = _port(arrs, lb)
    for w, g, what in zip(want, got, ("an", "asp", "k_end", "score")):
        assert (w == g).all(), what


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_native_engine(name):
    graphs, seqs, packed, arrs, lb = _case(name)
    an, asp, ke, _sc = _port(arrs, lb)
    for i, g in enumerate(graphs):
        aln = tpdev.unpack_alignment(an[i], asp[i], ke[i], packed[i][4])
        assert aln == g.align_only(seqs[i]), f"window {i}"
        # the port's unpack is the JAX one's
        assert aln == jpdev.unpack_alignment(an[i], asp[i], int(ke[i]),
                                             packed[i][4])


def test_plain_path_leaves_launch_count():
    graphs, seqs, packed, arrs, lb = _case("branch_b9")
    before = poa_align.LAUNCHES
    _port(arrs, lb)
    assert poa_align.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    graphs, seqs, packed, arrs, lb = _case("chain_only")
    args = tpdev.to_torch_packed(*arrs, "cpu")
    with pytest.raises(ValueError):
        poa_align.align_batch_cuda(*args, lb)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_plane_bytes():
    # H (B, N+1, L+1) int32 + directions (B, N, L+1) int8
    assert poa_align.plane_bytes(2, 4, 3) == 2 * (5 * 4 * 4 + 4 * 4)


def test_pack_graph_matches_jax_and_aligns():
    """pack_graph on the NumPy-oracle PoaGraph equals the JAX package's, and
    the plain aligner on it reproduces PoaGraph.align."""
    from svscope_tpu.ops.poa import PoaGraph, _fused_path
    rng = np.random.default_rng(5)
    ref = "".join(rng.choice(list("ACGT"), 30))
    g = PoaGraph()
    prev = -1
    for ch in ref:                      # backbone, as ops.poa.poa builds it
        cur = g._add_node(ch)
        if prev >= 0:
            g._add_edge(prev, cur)
        prev = cur
    for s in (ref[:10] + "TTT" + ref[10:], ref[:20] + ref[24:]):
        _fused_path(g, g.align(s), s)
    mine = tpdev.pack_graph(g, 64)
    theirs = jpdev.pack_graph(g, 64)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64))
    read = ref[:15] + "GG" + ref[15:]
    chars, preds, sinks, n, nor = mine
    sq = np.zeros((1, 64), np.uint8)
    sq[0, :len(read)] = np.frombuffer(read.encode(), np.uint8)
    an, asp, ke, _ = _port((chars[None], preds[None], sinks[None],
                            np.array([n]), sq, np.array([len(read)])), 64)
    assert tpdev.unpack_alignment(an[0], asp[0], ke[0], nor) == \
        list(g.align(read))
