"""The port's per-K em_cluster against svscope_tpu.models.mixture.em_cluster.

Fed JAX's own Gamma(1) draws (`jax_gammas`: the keys em_cluster splits per
K-run, then per step), K and labels must be identical; BICs agree within
rtol 1e-12 in float64 and 1e-5 in float32.  JAX's float32 reference runs
with x64 off: in x64 mode its re-init draws come out float64 and the run
goes on in float64.  In float32 a K-run whose one-read cluster sits on the
M-step's `pi*N < 1` threshold can restart on one side only (an ulp of
XLA's exp/log against torch's); such a run may differ, only below the
selected K's BIC on both sides (dataprepare_golden.bics_match).  With the
port's own torch.Generator, K and labels equal JAX's where no re-init
fires, and equal the folded em_cluster_batch's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataprepare_golden as dg
import svscope_tpu.models.mixture as jmx
import svscope_tpu_torch.models.mixture as tmx
from test_mixture import _make_two_cluster

torch.set_num_threads(1)

RTOL = {"float64": 1e-12, "float32": 1e-5}
ATOL = {"float64": 1e-12, "float32": 1e-5}     # theta, gamma, pi near 0
TDT = {"float64": torch.float64, "float32": torch.float32}


@functools.lru_cache(maxsize=None)
def _gamma_fn(nf_pad, nsteps, jdt):
    one = jnp.ones((tmx.MAX_K, nf_pad, tmx.ALPHA), jdt)
    return jax.jit(lambda keys: jax.vmap(lambda k: jax.vmap(
        lambda kk: jax.random.gamma(kk, one, dtype=jdt))(
            jax.random.split(k, nsteps + 1)))(keys))


def jax_gammas(seed, attempt, nf_pad, nsteps, dtype, device):
    """The draws JAX em_cluster makes for (seed, attempt): its key split
    into MAX_K run keys, each into nsteps + 1 step keys, one
    jax.random.gamma(key, ones((MAX_K, nf_pad, 5))) per step key."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    keys = jax.random.split(jnp.asarray(jmx._host_prng_key(seed, attempt)),
                            tmx.MAX_K)
    g = _gamma_fn(nf_pad, nsteps, jdt)(keys)
    return torch.tensor(np.asarray(g), device=device)


def _windows():
    rng = np.random.default_rng(4)
    return dg.em_windows() + [_make_two_cluster(rng, n1=5, n2=5, nf=20)]


@functools.lru_cache(maxsize=None)
def _jax_results(dtype_name):
    return [dg.jax_em_cluster(x, dtype_name) for x in _windows()]


def _with_x64(dtype_name):
    return jax.enable_x64(dtype_name == "float64")


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_em_cluster_matches_jax_with_jax_draws(dtype_name):
    flips = 0
    with _with_x64(dtype_name):
        for x, want in zip(_windows(), _jax_results(dtype_name)):
            got = tmx.em_cluster(x, dtype=TDT[dtype_name], device="cpu",
                                 gammas=jax_gammas)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[2], want[2])
            # theta, gamma, pi of the selected K-run
            for k in (3, 4, 5):
                np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                           rtol=RTOL[dtype_name],
                                           atol=ATOL[dtype_name])
            flips += dg.bics_match(want[6], got[6], want[0],
                                   RTOL[dtype_name])
    if dtype_name == "float64":
        assert flips == 0


def test_em_cluster_own_generator_matches_jax_labels():
    """The port's torch.Generator draws: K and labels equal JAX's on every
    window of the golden in which JAX fires no re-init (and on the rest
    too, on these windows)."""
    golden = dg.load_golden()["em_cluster"]["windows"]
    for entry, want in zip(golden, _jax_results("float32")):
        x = dg.decode_window(entry["x"])
        got = tmx.em_cluster(x, device="cpu")
        assert got[0] == entry["K"] == want[0]
        assert list(got[2]) == entry["labels"] == list(want[2])
    assert any(not any(e["reinit_runs"]) for e in golden)
    assert any(any(e["reinit_runs"]) for e in golden)


def test_golden_em_entries_are_fresh():
    golden = dg.load_golden()["em_cluster"]
    assert golden["seed"] == dg.EM_SEED
    assert golden["windows"] == dg.jax_em_entries()


def test_em_cluster_matches_em_cluster_batch():
    """The per-K path and the folded batch path select the same K and
    labels on the same windows (each with its own default draws)."""
    feats = _windows()
    batch = tmx.em_cluster_batch(feats, device="cpu")
    for x, b in zip(feats, batch):
        one = tmx.em_cluster(x, device="cpu")
        assert one[0] == b[0]
        np.testing.assert_array_equal(one[2], b[2])


def test_torch_gammas_shape_and_stream():
    g = tmx.torch_gammas(2023, 1, 16, 3, torch.float32, "cpu")
    assert g.shape == (tmx.MAX_K, 4, tmx.MAX_K, 16, tmx.ALPHA)
    assert float(g.min()) > 0 and torch.isfinite(g).all()
    assert torch.equal(g, tmx.torch_gammas(2023, 1, 16, 3, torch.float32,
                                           "cpu"))
    assert not torch.equal(g, tmx.torch_gammas(2023, 2, 16, 3,
                                               torch.float32, "cpu"))
    with pytest.raises(ValueError):
        tmx.em_cluster(_windows()[0], device="cpu",
                       gammas=lambda *a: g)


def _flaky(real, calls, nan_calls):
    """Wrap an _em_all_k so the listed calls return NaN BICs."""
    def run(*args, **kw):
        calls["n"] += 1
        bics, *rest = real(*args, **kw)
        if calls["n"] in nan_calls:
            bics = bics * float("nan")
        return (bics, *rest)
    return run


def test_nan_bic_retry_recovers(monkeypatch):
    """A NaN BIC re-runs every K-run with the next attempt's draws
    (src/ReadsCluster.py:247-252): poison the first call; one retry
    recovers the clean result in both packages, and they agree."""
    x = _make_two_cluster(np.random.default_rng(9), n1=5, n2=5, nf=20)
    clean = tmx.em_cluster(x, dtype=torch.float64, device="cpu",
                           gammas=jax_gammas)
    jcalls, tcalls = {"n": 0}, {"n": 0}
    monkeypatch.setattr(jmx, "_em_all_k", _flaky(jmx._em_all_k, jcalls, {1}))
    monkeypatch.setattr(tmx, "_em_all_k", _flaky(tmx._em_all_k, tcalls, {1}))
    want = jmx.em_cluster(x, dtype=jnp.float64)
    got = tmx.em_cluster(x, dtype=torch.float64, device="cpu",
                         gammas=jax_gammas)
    assert tcalls["n"] == jcalls["n"] == 2
    assert got[0] == want[0] == clean[0]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], clean[2])
    dg.bics_match(want[6], got[6], want[0], RTOL["float64"])


def test_nan_bic_retry_exhausts_to_k1(monkeypatch):
    """Every attempt NaN: exactly MAX_EM_ATTEMPTS runs, then K=1 with
    all-zero labels (where the reference would crash at nanargmax)."""
    x = _make_two_cluster(np.random.default_rng(8), n1=4, n2=4, nf=16)
    calls = {"n": 0}
    monkeypatch.setattr(tmx, "_em_all_k",
                        _flaky(tmx._em_all_k, calls, set(range(1, 10))))
    K, _, labels, theta, _gamma, pi, bics = tmx.em_cluster(
        x, dtype=torch.float64, device="cpu")
    assert calls["n"] == tmx.MAX_EM_ATTEMPTS
    assert K == 1 and (labels == 0).all() and theta is None and pi is None
    assert np.isnan(bics).all()
