"""Binary-tree point clustering and approximate nearest neighbors.

A copy of ``strumpack_tpu/kernel/clustering.py``: numpy only, the same
``default_rng(seed)`` draws, so the same orders and neighbours.  Role of
the reference's ``clustering/`` directory: ``binary_tree_clustering``
dispatch (Clustering.hpp:51-104) over NATURAL / 2_MEANS (KMeans.cpp) /
KD_TREE (KDTree.cpp) / PCA (PCAPartitioning.cpp) / COBBLE
(CobblePartitioning.cpp), and randomized-projection-tree approximate
nearest neighbors (NeighborSearch.cpp) used by HSS ANN compression and
kernel clustering.
"""
from __future__ import annotations

import sys

import numpy as np


def binary_tree_clustering(method, X, leaf=64, seed=0):
    """Return an ordering permutation: points reordered so each recursive
    cluster is contiguous.  method in {natural, kd, 2means, pca, cobble}."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    if method == "natural":
        return np.arange(n, dtype=np.int64)
    if method == "pca":
        from .kernel import recursive_pca_order
        return recursive_pca_order(X, leaf=leaf)

    rng = np.random.default_rng(seed)
    order = np.empty(n, dtype=np.int64)
    pos = [0]

    def split(idx):
        P = X[idx]
        if method == "kd":
            # split along the widest coordinate at the median
            ax = int(np.argmax(P.max(0) - P.min(0)))
            v = P[:, ax]
            med = np.median(v)
            mask = v <= med
        elif method == "2means":
            # two-means with random init, a few Lloyd iterations
            c = P[rng.choice(len(P), 2, replace=False)]
            for _ in range(8):
                d0 = ((P - c[0]) ** 2).sum(1)
                d1 = ((P - c[1]) ** 2).sum(1)
                mask = d0 <= d1
                if mask.all() or (~mask).all():
                    break
                c = np.stack([P[mask].mean(0), P[~mask].mean(0)])
        else:  # cobble: split at median distance from the centroid
            d = ((P - P.mean(0)) ** 2).sum(1)
            mask = d <= np.median(d)
        if mask.all() or (~mask).all():
            half = len(idx) // 2
            mask = np.zeros(len(idx), bool)
            mask[:half] = True
        return idx[mask], idx[~mask]

    def rec(idx):
        if len(idx) <= leaf:
            order[pos[0]:pos[0] + len(idx)] = idx
            pos[0] += len(idx)
            return
        a, b = split(idx)
        rec(a)
        rec(b)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old)
    return order


def approximate_knn(X, k=8, n_trees=4, seed=0):
    """Randomized-projection-tree approximate k-nearest-neighbors
    (NeighborSearch.cpp role): each tree recursively splits on a random
    direction; candidate neighbors are leaf co-members across trees."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    cand = [set() for _ in range(n)]

    def build(idx, depth=0):
        if len(idx) <= max(2 * k, 16):
            for i in idx:
                cand[i].update(int(j) for j in idx if j != i)
            return
        v = rng.standard_normal(X.shape[1])
        proj = X[idx] @ v
        med = np.median(proj)
        mask = proj <= med
        if mask.all() or (~mask).all():
            half = len(idx) // 2
            mask = np.zeros(len(idx), bool)
            mask[:half] = True
        build(idx[mask], depth + 1)
        build(idx[~mask], depth + 1)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        for _ in range(n_trees):
            build(np.arange(n))
    finally:
        sys.setrecursionlimit(old)

    nbr = np.full((n, k), -1, dtype=np.int64)
    dst = np.full((n, k), np.inf)
    for i in range(n):
        cs = np.fromiter(cand[i], dtype=np.int64)
        if len(cs) == 0:
            continue
        d = ((X[cs] - X[i]) ** 2).sum(1)
        topk = np.argsort(d)[:k]
        nbr[i, :len(topk)] = cs[topk]
        dst[i, :len(topk)] = d[topk]
    return nbr, np.sqrt(dst)
