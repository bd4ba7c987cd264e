"""Random-forest confidence filter as a batched torch tree traversal
(counterpart of svscope_tpu/models/forest.py).

The reference loads a frozen sklearn RandomForestClassifier and calls
predict_proba/predict on the 10-feature window table
(src/SVscope.py:309-315).  The trees live as flattened arrays (children,
split feature, threshold, leaf class counts), padded to a common node
count, in the port's own copy of the artifact (models/rf_artifact.npz).
Prediction is a fixed-depth gather loop over (tree, sample): each step
moves every cursor one level down; leaves self-loop, so `max_depth` steps
suffice.  It runs in float64 on an explicit device.  This is plain XLA in
the JAX package, not a TPU kernel, so it is torch ops here.

predict_proba equals the JAX package's bit for bit (float64; tests): each
tree's leaf counts are divided by their sum, and the trees are averaged
as XLA on the CPU does: summed in tree order, then multiplied by the
reciprocal of the tree count (XLA rewrites the division by a constant).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import resolve_device

ARTIFACT = os.path.join(os.path.dirname(__file__), "rf_artifact.npz")


class Forest:
    def __init__(self, left, right, feature, threshold, value, classes,
                 feature_names=None, device="cuda"):
        # all padded to (n_trees, max_nodes)
        self.left = left
        self.right = right
        self.feature = feature
        self.threshold = threshold
        self.value = value  # (n_trees, max_nodes, n_classes)
        self.classes = classes
        self.feature_names = feature_names
        self.max_depth = int(_forest_depth(left, right))
        self.device = resolve_device(device)
        # one upload, reused by every predict call
        self._dev = tuple(torch.as_tensor(x).to(self.device) for x in (
            left.astype(np.int64), right.astype(np.int64),
            feature.astype(np.int64), threshold, value))

    @classmethod
    def from_npz(cls, path: str = ARTIFACT, device="cuda") -> "Forest":
        z = np.load(path, allow_pickle=False)
        n = int(z["n_trees"])
        counts = [len(z[f"t{i}_left"]) for i in range(n)]
        mx = max(counts)
        left = np.full((n, mx), -1, np.int32)
        right = np.full((n, mx), -1, np.int32)
        feat = np.full((n, mx), -2, np.int32)
        thr = np.zeros((n, mx), np.float64)
        val = np.zeros((n, mx, z["t0_value"].shape[-1]), np.float64)
        for i in range(n):
            c = counts[i]
            left[i, :c] = z[f"t{i}_left"]
            right[i, :c] = z[f"t{i}_right"]
            feat[i, :c] = z[f"t{i}_feature"]
            thr[i, :c] = z[f"t{i}_threshold"]
            val[i, :c] = z[f"t{i}_value"]
        names = None
        if "feature_names" in z.files:
            names = [str(x) for x in z["feature_names"]]
        return cls(left, right, feat, thr, val, np.asarray(z["classes"]),
                   names, device=device)

    @classmethod
    def from_sklearn(cls, model, device="cuda") -> "Forest":
        trees = [e.tree_ for e in model.estimators_]
        mx = max(t.node_count for t in trees)
        n = len(trees)
        ncls = model.n_classes_
        left = np.full((n, mx), -1, np.int32)
        right = np.full((n, mx), -1, np.int32)
        feat = np.full((n, mx), -2, np.int32)
        thr = np.zeros((n, mx), np.float64)
        val = np.zeros((n, mx, ncls), np.float64)
        for i, t in enumerate(trees):
            c = t.node_count
            left[i, :c] = t.children_left
            right[i, :c] = t.children_right
            feat[i, :c] = t.feature
            thr[i, :c] = t.threshold
            val[i, :c] = t.value[:, 0, :]
        return cls(left, right, feat, thr, val, np.asarray(model.classes_),
                   device=device)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        X = torch.as_tensor(np.asarray(X, np.float64)).to(self.device)
        return forest_proba(*self._dev, X, self.max_depth).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        proba = self.predict_proba(X)
        return self.classes[np.argmax(proba, axis=1)]


def _forest_depth(left, right) -> int:
    depth = 0
    for t in range(left.shape[0]):
        def rec(node, d):
            if node < 0 or left[t][node] < 0:
                return d
            return max(rec(left[t][node], d + 1), rec(right[t][node], d + 1))
        depth = max(depth, rec(0, 0))
    return depth


def forest_proba(left, right, feature, threshold, value, X,
                 max_depth: int):
    """(n_samples, n_classes) float64 class probabilities: every (tree,
    sample) cursor walks `max_depth` levels (leaves self-loop), then each
    tree's leaf counts are normalised and the trees averaged."""
    n_trees = left.shape[0]
    n = X.shape[0]
    tree = torch.arange(n_trees, device=X.device)[:, None].expand(n_trees, n)
    sample = torch.arange(n, device=X.device)[None, :].expand(n_trees, n)
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        tl = left[tree, node]
        f = feature[tree, node].clamp(min=0)
        go_left = X[sample, f] <= threshold[tree, node]
        node = torch.where(tl < 0, node,
                           torch.where(go_left, tl, right[tree, node]))
    counts = value[tree, node]                       # (n_trees, n, n_classes)
    probs = counts / counts.sum(-1, keepdim=True)
    acc = probs[0]
    for t in range(1, n_trees):
        acc = acc + probs[t]
    return acc * (1.0 / n_trees)
