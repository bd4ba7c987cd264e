"""The traffic generator: deterministic in the seed, the same sizes for
every seed and batch, and both mixes inside the device engines' buckets."""
import numpy as np
import pytest

from benchmark import generator, manifest

MIXES = ["typical", "pileup"]


def sizes(batch):
    return sorted((len(w.sequences[0]), len(w.sequences)) for w in batch)


@pytest.mark.parametrize("mix", MIXES)
def test_deterministic_in_seed(mix):
    p = manifest.traffic(mix)
    a = generator.make_batch(p, 2 ** 31 + 5, 1)
    b = generator.make_batch(p, 2 ** 31 + 5, 1)
    c = generator.make_batch(p, 2 ** 31 + 6, 1)
    assert a == b
    assert a != c
    # the seed changes the bases and the order, not the sizes
    assert sizes(a) == sizes(c)
    assert len(a) == p["windows_per_call"]


def test_batches_of_a_pool_differ():
    p = dict(manifest.traffic("pileup"), pool_calls=2)
    pool = generator.make_pool(p, 7)
    assert len(pool) == 2 and pool[0] != pool[1]


def test_typical_mix_shares():
    """Exact shares in every batch: 40/30/30 % classes, INS:DEL 1:1, and
    the lengths and carriers inside their ranges."""
    p = manifest.traffic("typical")
    pl = generator.plan(p, generator.rng_for(3, 1, 0))
    n = p["windows_per_call"]
    counts = np.bincount(pl["cls"], minlength=3)
    assert abs(counts - np.array([0.4, 0.3, 0.3]) * n).max() <= 1
    sv = pl["t_car"] + pl["n_car"] > 0
    assert (sv == (pl["cls"] < 2)).all()
    assert abs((pl["sv_type"][sv] == "INS").sum()
               - (pl["sv_type"][sv] == "DEL").sum()) <= 1
    assert pl["win_len"].min() >= 200 and pl["win_len"].max() <= 600
    assert pl["sv_len"][sv].min() >= 50 and pl["sv_len"][sv].max() <= 400
    som = pl["cls"] == 0
    assert pl["t_car"][som].min() >= 10 and pl["t_car"][som].max() <= 20
    assert (pl["n_car"][som] == 0).all()


@pytest.mark.parametrize("mix", MIXES)
def test_mix_fits_device_buckets(mix):
    """Every read fits the largest length bucket and the windows with the
    longest reads build graphs under the largest node bucket of the
    per-round engine (2048), so no window leaves the device path."""
    from svscope_tpu_torch.native.poa import NativePoaGraph
    p = manifest.traffic(mix)
    batch = generator.make_batch(p, 2 ** 31 + 1, 0)
    longest = max(len(s) for w in batch for s in w.sequences)
    assert longest <= 2048
    order = np.argsort([-max(map(len, w.sequences)) for w in batch])
    for i in order[:4]:
        g = NativePoaGraph()
        for s in batch[i].sequences:
            g.add_sequence(s)
        assert g.n_nodes() <= 2048


def test_sample_covers_every_stratum():
    """The judge's sample takes every class and length quartile of window
    that the completed calls hold, the same pairs for the same seed."""
    from benchmark import check
    p = dict(manifest.traffic("typical"), windows_per_call=64, pool_calls=2)
    pool = generator.make_pool(p, 11)
    calls = [(b % 2, 0, 0, []) for b in range(5)]
    strata = {w.stratum for batch in pool for w in batch}
    assert len(strata) == 12          # 3 classes x 4 length quartiles
    for k in (12, 16, 40):
        picked = check.sample(calls, pool, 2 ** 31 + 8, k)
        assert len(picked) == k == len(set(picked))
        assert {pool[calls[c][0]][w].stratum for c, w in picked} == strata
        assert picked == check.sample(calls, pool, 2 ** 31 + 8, k)
