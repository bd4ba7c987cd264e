"""EM parity: the port's folded EM against svscope_tpu.models.mixture.

The port takes the M-step's random draws as an input; fed JAX's own draws
(`jax_uniforms`), K and labels must be identical and the BICs agree within
rtol 1e-10 in float64 and 1e-4 in float32 (the batched products sum in
another order).  With the port's own torch.Generator, K and labels must
still be identical on the engine's bench features.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import svscope_tpu.models.mixture as jmx
import svscope_tpu_torch.models.mixture as tmx
from svscope_tpu.engine import localgraph as jlg

from bench import make_window_payloads
from test_mixture import _make_two_cluster

torch.set_num_threads(1)

DTYPES = {"float64": (jnp.float64, torch.float64, 1e-10),
          "float32": (jnp.float32, torch.float32, 1e-4)}


def jax_uniforms(seed, attempt, nf_pad, nsteps, dtype, device):
    """The draws JAX's folded EM makes for (seed, attempt): one
    uniform(minval=1e-12) per split key."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    keys = jax.random.split(jnp.asarray(jmx._host_prng_key(seed, attempt)),
                            nsteps + 1)
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (tmx.R_TOTAL, nf_pad, tmx.ALPHA), dtype=jdt,
        minval=tmx.UNIFORM_MIN))(keys)
    return torch.tensor(np.asarray(u), device=device)


def _random_windows(seed, count, n_lo, n_hi, nf_lo, nf_hi, flip_p):
    rng = np.random.default_rng(seed)
    feats = []
    for _ in range(count):
        n = int(rng.integers(n_lo, n_hi))
        nf = int(rng.integers(nf_lo, nf_hi))
        k_true = int(rng.integers(1, 4))
        protos = rng.integers(0, 4, (k_true, nf))
        x = protos[rng.integers(0, k_true, n)]
        flip = rng.random(x.shape) < flip_p
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    return feats


def _bench_feats():
    wins = make_window_payloads(16, np.random.default_rng(0))
    _entries, ready = jlg._stage_a(wins, "tumor", 3, 0.05, False, None)
    return [feat for (_, _, _, feat, _) in ready]


FEATS = {
    # test_mixture.py's labels-only and small-window randomized windows
    "random_4_40": lambda: _random_windows(11, 20, 4, 40, 10, 70, 0.05),
    "small_below_maxk": lambda: _random_windows(123, 12, 4, 10, 12, 60,
                                                0.04),
    "bench16": _bench_feats,
}


def _assert_match(want, got, rtol, restart_flips=False):
    """K and labels identical; BICs within rtol.

    restart_flips: float32 on the bench features, where K-runs with a
    one-read cluster sit exactly on the M-step's `pi*N < 1` restart
    threshold.  XLA's float32 exp/log differ from torch's by an ulp, which
    decides the restart either way and so that run's BIC (by thousands).
    Such a run is allowed to differ only when it is below the selected K's
    BIC on both sides, i.e. when it cannot change the selection."""
    assert len(want) == len(got)
    flips = 0
    for w, g in zip(want, got):
        assert w[0] == g[0]                          # K
        assert np.array_equal(w[2], g[2])            # labels
        wb, gb = np.asarray(w[6]), np.asarray(g[6])
        close = np.isclose(gb, wb, rtol=rtol, atol=0, equal_nan=True)
        if restart_flips and not close.all():
            sel = w[0] - 1
            assert close[sel]
            assert (wb[~close] < wb[sel]).all() and (gb[~close] < gb[sel]).all()
            flips += int((~close).sum())
            continue
        np.testing.assert_allclose(gb, wb, rtol=rtol, atol=0, equal_nan=True)
    return flips


@pytest.mark.parametrize("labels_only", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("feats", sorted(FEATS))
def test_em_matches_jax_with_jax_draws(feats, dtype, labels_only):
    jdt, tdt, rtol = DTYPES[dtype]
    x = FEATS[feats]()
    want = jmx.em_cluster_batch_dispatch(x, dtype=jdt,
                                         labels_only=labels_only)()
    got = tmx.em_cluster_batch_dispatch(x, dtype=tdt,
                                        labels_only=labels_only,
                                        uniforms=jax_uniforms,
                                        device="cpu")()
    _assert_match(want, got, rtol,
                  restart_flips=(dtype == "float32" and feats == "bench16"))


def test_em_own_generator_matches_jax_labels():
    x = _bench_feats()
    want = jmx.em_cluster_batch_dispatch(x, labels_only=True)()
    got = tmx.em_cluster_batch_dispatch(x, labels_only=True,
                                        device="cpu")()
    for w, g in zip(want, got):
        assert w[0] == g[0] and np.array_equal(w[2], g[2])


def test_torch_uniforms_shape_and_range():
    u = tmx.torch_uniforms(2023, 1, 16, 3, torch.float32, "cpu")
    assert u.shape == (4, tmx.R_TOTAL, 16, tmx.ALPHA)
    assert float(u.min()) >= tmx.UNIFORM_MIN and float(u.max()) < 1.0
    again = tmx.torch_uniforms(2023, 1, 16, 3, torch.float32, "cpu")
    other = tmx.torch_uniforms(2023, 2, 16, 3, torch.float32, "cpu")
    assert torch.equal(u, again) and not torch.equal(u, other)


def _flaky(real, calls, nan_calls):
    """Wrap an EM batch function so the listed calls return NaN BICs."""
    def run(*args, **kw):
        calls["n"] += 1
        bics, out = real(*args, **kw)
        if calls["n"] in nan_calls:
            bics = bics * float("nan")
        return bics, out
    return run


@pytest.mark.parametrize("labels_only", [False, True])
def test_nan_bic_retry_recovers(monkeypatch, labels_only):
    """A NaN BIC re-runs EM with the next attempt's draws
    (src/ReadsCluster.py:247-252): poison the first call; one retry round
    recovers the clean result, and both packages agree."""
    rng = np.random.default_rng(7)
    feats = [_make_two_cluster(rng, n1=5, n2=5, nf=20) for _ in range(3)]
    name = "_em_folded_batch_light" if labels_only else "_em_folded_batch"
    clean = tmx.em_cluster_batch_dispatch(feats, dtype=torch.float64,
                                          labels_only=labels_only,
                                          uniforms=jax_uniforms,
                                          device="cpu")()
    jcalls, tcalls = {"n": 0}, {"n": 0}
    monkeypatch.setattr(jmx, name, _flaky(getattr(jmx, name), jcalls, {1}))
    monkeypatch.setattr(tmx, name, _flaky(getattr(tmx, name), tcalls, {1}))
    want = jmx.em_cluster_batch_dispatch(feats, dtype=jnp.float64,
                                         labels_only=labels_only)()
    got = tmx.em_cluster_batch_dispatch(feats, dtype=torch.float64,
                                        labels_only=labels_only,
                                        uniforms=jax_uniforms,
                                        device="cpu")()
    assert tcalls["n"] == jcalls["n"] == 2
    _assert_match(want, got, 1e-10)
    for c, o in zip(clean, got):
        assert o[0] == c[0] and (o[2] == c[2]).all()


def test_nan_bic_retry_exhausts_to_k1(monkeypatch):
    """Every attempt NaN: exactly MAX_EM_ATTEMPTS dispatches, then K=1 with
    all-zero labels (where the reference would crash at nanargmax)."""
    rng = np.random.default_rng(8)
    feats = [_make_two_cluster(rng, n1=4, n2=4, nf=16)]
    calls = {"n": 0}
    monkeypatch.setattr(tmx, "_em_folded_batch",
                        _flaky(tmx._em_folded_batch, calls,
                               set(range(1, 10))))
    out = tmx.em_cluster_batch(feats, dtype=torch.float64, device="cpu")
    assert calls["n"] == tmx.MAX_EM_ATTEMPTS == jmx.MAX_EM_ATTEMPTS
    K, _, labels, *_ = out[0]
    assert K == 1 and (labels == 0).all()


def test_ward_init_matches_jax_prep():
    """The port's host prep feeds the EM the JAX package's Ward cuts and
    zero-parameter counts."""
    x = _random_windows(5, 6, 6, 30, 12, 40, 0.05)
    for f in x:
        assert tmx.zero_param_count(f) == jmx.zero_param_count(f)
        np.testing.assert_array_equal(tmx.pairwise_identity(f),
                                      jmx.pairwise_identity(f))
    sims = [jmx.pairwise_identity(f) for f in x]
    for a, b in zip(tmx.ward_cut_many(sims, 9), jmx.ward_cut_many(sims, 9)):
        np.testing.assert_array_equal(a, b)
