"""K2's plain torch version (ops/nw_kernel.nw_stats_reference) and the
MisScore / edit-distance entry points (ops/nw_batch) against the JAX package:
the Pallas kernel in interpret mode (l_max <= 256), the XLA
nw_stats_batch at every bucket, and the host DP (ops/nw.nw_align_stats).
All outputs are integers: every comparison is exact."""
import numpy as np
import pytest
import torch

import alnfeature_golden as ag
import torch_workloads as tw
from svscope_tpu.ops import nw as jnw
from svscope_tpu.ops import nw_batch as jnb
from svscope_tpu.ops.nw_pallas import nw_stats_pallas
from svscope_tpu_torch.ops import nw, nw_batch, nw_kernel

torch.set_num_threads(1)
EDGE = [("", "ACGT"), ("A", ""), ("", ""), ("ACGT", "ACGT"), ("A", "C"),
        ("ACGTACGT", "TGCA"), ("GATTACA", "GCATGCT")]


def plain(pairs, l_max, scoring):
    args = [torch.from_numpy(x) for x in ag.pad_pairs(pairs, l_max)]
    return np.stack([t.numpy() for t in
                     nw_kernel.nw_stats_reference(*args, l_max, *scoring)], 1)


@pytest.mark.parametrize("l_max", [128, 256])
def test_plain_matches_pallas_interpret(l_max):
    """The TPU kernel itself (scoring fixed at (1, 0, -1)) on 13 pairs: not
    a multiple of its 8-pair block, with the bucket-edge and empty-side
    cases."""
    pairs = EDGE + tw.bucket_pairs(np.random.default_rng(l_max), l_max, 6)
    s, m, al = nw_stats_pallas(*ag.pad_pairs(pairs, l_max), l_max,
                               interpret=True)
    want = np.stack([np.asarray(s), np.asarray(m), np.asarray(al)], 1)
    assert (plain(pairs, l_max, ag.SCORINGS["misscore"]) == want).all()


@pytest.mark.parametrize("scoring", sorted(ag.SCORINGS))
@pytest.mark.parametrize("bucket", ag.BUCKETS)
def test_plain_matches_jax_batch(bucket, scoring):
    """Every bucket on the golden's seeded pairs (3-12 per bucket): plain K2
    == a fresh JAX nw_stats_batch == the golden's stats."""
    pairs, sha = ag.nw_case(bucket)
    sc = ag.SCORINGS[scoring]
    golden = ag.load_golden()["nw"]["buckets"][str(bucket)]
    assert sha == golden["pairs_sha256"]
    got = plain(pairs, bucket, sc)
    assert got.tolist() == ag.jax_nw_stats(pairs, bucket, sc) \
        == golden[scoring]


@pytest.mark.parametrize("scoring", sorted(ag.SCORINGS))
def test_plain_matches_host_dp(scoring):
    sc = ag.SCORINGS[scoring]
    rng = np.random.default_rng(5)
    for bucket, n in ((128, 24), (512, 6), (4096, 1)):
        pairs = EDGE + tw.bucket_pairs(rng, bucket, n)
        want = [list(nw.nw_align_stats(a, b, *sc)) for a, b in pairs]
        assert plain(pairs, bucket, sc).tolist() == want
        assert want == [list(jnw.nw_align_stats(a, b, *sc))
                        for a, b in pairs]


def test_misscore_batch_matches_jax():
    """Pairs over every bucket plus one past 4096 (host DP, counted)."""
    rng = np.random.default_rng(9)
    pairs = EDGE[:2] + [p for b in (128, 512, 1024) for p in
                        tw.bucket_pairs(rng, b, 3)]
    pairs.append((tw.rand_seq(rng, 4100), tw.rand_seq(rng, 30)))
    nw_batch.reset_counts()
    got = nw_batch.misscore_batch(pairs, device="cpu")
    assert nw_batch.COUNTS["host_dp_pairs"] == 1
    assert got.tolist() == jnb.misscore_batch(pairs).tolist()
    assert got.tolist() == [nw.alignment_misscore(a, b) for a, b in pairs]


def test_edit_distance_matches_jax():
    rng = np.random.default_rng(3)
    pairs = EDGE + tw.nw_pairs(rng, 12, 5, 200)
    assert nw_batch.edit_distance_batch(pairs, device="cpu").tolist() == \
        jnb.edit_distance_batch(pairs).tolist()
    seqs = ["ACGT", "AGT", "TTTT", "", "GATTACA"]
    assert (nw_batch.pairwise_edit_distance_matrix(seqs, device="cpu")
            == jnb.pairwise_edit_distance_matrix(seqs)).all()
    assert nw_batch.pairwise_edit_distance_matrix([], device="cpu").shape \
        == (0, 0)
    with pytest.raises(ValueError):
        nw_batch.edit_distance_batch([("A" * 4097, "A")], device="cpu")


def test_misscore_helpers_match_jax():
    som = ["ACGTACGTTT", "ACG"]
    germ = ["ACGTTCGT", "ACGTACGTTTAAAA"]
    assert nw.calculate_misscore(som, germ) == \
        jnw.calculate_misscore(som, germ)
    for scores in ([3, -3], [-3, 3], [5, 2, -2], [0]):
        assert nw.pick_misscore(scores) == jnw.pick_misscore(scores)
    assert (nw.MATCH, nw.MISMATCH, nw.GAP) == (1, 0, -1)


def test_nw_stats_batch_api():
    pairs = EDGE + tw.bucket_pairs(np.random.default_rng(2), 128, 4)
    s, m, al = nw_batch.nw_stats_batch(*ag.pad_pairs(pairs, 128), 128,
                                       device="cpu")
    assert s.dtype == torch.int32 and s.device.type == "cpu"
    assert np.stack([s, m, al], 1).tolist() == \
        [list(nw.nw_align_stats(a, b)) for a, b in pairs]
    empty = nw_batch.nw_stats_batch(np.zeros((0, 128), np.uint8),
                                    np.zeros((0, 128), np.uint8),
                                    np.zeros(0, np.int32),
                                    np.zeros(0, np.int32), 128, device="cpu")
    assert [t.shape[0] for t in empty] == [0, 0, 0]


@pytest.mark.parametrize("l_max", [128, 256, 512, 1024, 2048, 4096])
def test_launch_config_bands_cover_the_bucket(l_max):
    """K2's bands of 32 x R rows cover every la <= l_max; the 128-512
    buckets take one band and no scratch; longer ones one (H, M << 16 | A)
    int32 pair per column and pair, in device memory (K2 uses no shared
    memory), and run their pairs longest first."""
    rows, bands, lpt = nw_kernel.launch_config(l_max)
    assert rows in (4, 8, 16)
    assert bands * 32 * rows >= l_max > (bands - 1) * 32 * rows
    shape = nw_kernel.scratch_shape(3, l_max)
    assert lpt == (l_max >= 1024)
    if l_max <= 512:
        assert bands == 1 and shape is None
    else:
        assert shape == (3, l_max + 1, 2)
    # (M, A) share an int32: A <= 2 * l_max must stay below 65536
    assert 2 * nw_kernel.MAX_LEN < 1 << 16 <= 2 * (nw_kernel.MAX_LEN + 1)


def test_cuda_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(x) for x in ag.pad_pairs(EDGE, 128)]
    with pytest.raises(ValueError):
        nw_kernel.nw_stats_cuda(*args, 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            nw_batch.misscore_batch(EDGE, device="cuda")
