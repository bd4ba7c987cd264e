"""Grid-hashed DBSCAN for 2-D linearized breakpoint coordinates.

Replaces sklearn.cluster.DBSCAN in the reference's breakpoint clustering
(src/WindowSelection_v8.py:437-447, eps=500, min_samples=3) with a
dependency-free implementation whose labels match sklearn's exactly
(verified in tests/test_select.py): points are scanned in index order, core
points seed clusters, clusters grow by stack expansion, border points take
the label of the first core cluster that reaches them, noise = -1.

Neighborhoods use a uniform grid with cell size eps, so each query touches
at most 9 cells — O(n * k) overall instead of O(n^2).
"""
from __future__ import annotations

import numpy as np


def dbscan_labels(points: np.ndarray, eps: float = 500.0,
                  min_samples: int = 3) -> np.ndarray:
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    eps2 = eps * eps
    cell = np.floor(pts / eps).astype(np.int64)
    grid: dict[tuple[int, int], list[int]] = {}
    for i, (cx, cy) in enumerate(cell):
        grid.setdefault((int(cx), int(cy)), []).append(i)

    def neighbors(i: int) -> np.ndarray:
        cx, cy = cell[i]
        cand: list[int] = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cand.extend(grid.get((int(cx) + dx, int(cy) + dy), ()))
        cand_a = np.array(cand, np.int64)
        d = pts[cand_a] - pts[i]
        return cand_a[(d * d).sum(axis=1) <= eps2]

    neigh = [neighbors(i) for i in range(n)]
    core = np.array([len(nb) >= min_samples for nb in neigh])
    cluster = 0
    visited = np.zeros(n, bool)
    for i in range(n):
        if visited[i] or not core[i]:
            continue
        # new cluster seeded at i, expanded through core points
        stack = [i]
        visited[i] = True
        labels[i] = cluster
        while stack:
            j = stack.pop()
            for q in neigh[j]:
                if labels[q] == -1:
                    labels[q] = cluster
                if not visited[q] and core[q]:
                    visited[q] = True
                    stack.append(q)
        cluster += 1
    return labels
