"""The torch forest (models/forest.py) against the JAX package's Forest with
x64 (tests/conftest.py): predict_proba equal bit for bit in float64,
predict equal, on the frozen artifact and on freshly trained sklearn
forests."""
import filecmp

import numpy as np
import pytest
import torch

from svscope_tpu.models import forest as jforest
from svscope_tpu_torch.models import forest

torch.set_num_threads(1)


def _features(f, rng, n):
    """Samples around the forest's own split thresholds, some exactly on
    one (the `<=` tie goes left)."""
    X = rng.normal(size=(n, 10)) * 3
    live = f.feature >= 0
    feats, thrs = f.feature[live], f.threshold[live]
    pick = rng.integers(0, len(feats), size=(n, 4))
    for c in range(4):
        X[np.arange(n), feats[pick[:, c]]] = thrs[pick[:, c]]
    return X


def test_artifact_is_the_jax_artifact():
    assert filecmp.cmp(forest.ARTIFACT, jforest.ARTIFACT, shallow=False)


def test_predict_proba_bit_exact_on_artifact():
    jf = jforest.Forest.from_npz()
    tf = forest.Forest.from_npz(device="cpu")
    assert tf.max_depth == jf.max_depth
    X = _features(tf, np.random.default_rng(0), 400)
    got = tf.predict_proba(X)
    assert got.dtype == np.float64
    assert np.array_equal(got, jf.predict_proba(X))
    assert np.array_equal(tf.predict(X), jf.predict(X))


@pytest.mark.parametrize("n_trees", [3, 10, 13])
def test_predict_proba_bit_exact_from_sklearn(n_trees):
    sk = pytest.importorskip("sklearn.ensemble")
    rng = np.random.default_rng(n_trees)
    X = rng.normal(size=(300, 10))
    y = (X[:, 0] + X[:, 3] * 0.5 + rng.normal(0, 0.3, 300)) > 0
    m = sk.RandomForestClassifier(
        n_estimators=n_trees, criterion="entropy", max_depth=32,
        min_samples_split=16, min_samples_leaf=4, max_features="log2",
        random_state=42).fit(X, y)
    tf = forest.Forest.from_sklearn(m, device="cpu")
    Xt = _features(tf, rng, 80)
    got = tf.predict_proba(Xt)
    assert np.array_equal(got, jforest.Forest.from_sklearn(m)
                          .predict_proba(Xt))
    assert np.array_equal(tf.predict(Xt), jforest.Forest.from_sklearn(m)
                          .predict(Xt))
    # sklearn compares in float32, so only off-threshold samples here
    Xs = rng.normal(size=(50, 10))
    np.testing.assert_allclose(tf.predict_proba(Xs), m.predict_proba(Xs),
                               atol=1e-12)
    assert (tf.predict(Xs) == m.predict(Xs)).all()


def test_forest_needs_cuda_when_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        forest.Forest.from_npz(device="cuda")
