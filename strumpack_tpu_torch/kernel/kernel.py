"""Kernel-matrix machine learning: kernel ridge regression and
classification (PyTorch).

The counterpart of ``strumpack_tpu/kernel/kernel.py``, the role of the
reference's ``kernel/Kernel.hpp:73`` (the Kernel base, GaussKernel:333,
LaplaceKernel:378, ANOVAKernel:424, DenseKernel:486; ``fit_HSS:189``,
``fit_HODLR:264``, ``predict:203``) and of the scikit-learn estimator
``python/STRUMPACKKernel.py.in:10``.

fit: order the training points by recursive PCA bisection (host numpy,
so nearby points are contiguous), compress K + lambda I as HSS or HODLR
on the device -- from the dense kernel matrix in the points' float64, or
matrix-free in float32 from a row-tiled product and element closure (the
sketch) or from approximate nearest neighbours ("ann") -- factor it and
solve for the weights.  predict: K(test, train) @ weights in row tiles.
Every fit and predict runs full-f32 matmuls (no TF32), as the JAX package
pins ``float32`` matmul precision.  Fitted state (``_Xtrain``,
``_weights``, ``_order``, ``_M``) lives on the kernel's device; ``times``
holds the last fit's host seconds by step.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..frontal.numeric import use_full_fp32_matmul
from ..solver import resolve_device


# ---------------------------------------------------------------------------
# clustering (role of clustering/Clustering.hpp binary_tree_clustering)
# ---------------------------------------------------------------------------

def recursive_pca_order(X, leaf=64):
    """An index permutation ordering points by recursive PCA bisection
    (the clustering 'PCA' option, PCAPartitioning.cpp), host numpy with
    the JAX package's draws, so the same order."""
    n = X.shape[0]
    order = np.empty(n, dtype=np.int64)
    pos = [0]

    def rec(idx):
        if len(idx) <= leaf:
            order[pos[0]:pos[0] + len(idx)] = idx
            pos[0] += len(idx)
            return
        P = X[idx]
        c = P - P.mean(axis=0)
        # leading principal direction via a few power iterations
        v = np.random.default_rng(0).standard_normal(P.shape[1])
        for _ in range(8):
            v = c.T @ (c @ v)
            v /= np.linalg.norm(v) + 1e-300
        proj = c @ v
        med = np.median(proj)
        left = idx[proj <= med]
        right = idx[proj > med]
        if len(left) == 0 or len(right) == 0:
            half = len(idx) // 2
            left, right = idx[:half], idx[half:]
        rec(left)
        rec(right)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old)
    return order


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

class Kernel:
    """Base kernel (kernel/Kernel.hpp:73) on ``device`` (None: CUDA)."""

    def __init__(self, h: float = 1.0, lam: float = 1.0, device=None):
        self.h = float(h)
        self.lam = float(lam)
        self.device = resolve_device(device)
        self.times = {}

    def _t(self, X):
        return torch.as_tensor(X if torch.is_tensor(X) else np.asarray(X),
                               device=self.device)

    def eval(self, X, Y):
        """The kernel block K(X, Y) [nx, ny] on the device."""
        raise NotImplementedError

    def eval_pairs(self, Xi, Xj):
        """Elementwise k(Xi[..., :], Xj[..., :]) for broadcasting point
        tensors [..., d]: the element closure of the matrix-free fit."""
        raise NotImplementedError

    def _sqdist(self, X, Y):
        X, Y = self._t(X), self._t(Y)
        d = ((X * X).sum(1)[:, None] + (Y * Y).sum(1)[None, :]
             - 2.0 * X @ Y.T)
        # clamp keeps a NaN (the +inf-padded rows), as jnp.maximum does
        return torch.clamp(d, min=0.0)

    # ---- fitting ------------------------------------------------------
    def fit_HSS(self, X, y, leaf_size=128, max_rank=None, rel_tol=1e-4,
                cluster_leaf=64, matrix_free=None, compression="sketch"):
        """``matrix_free`` None compresses matrix-free above n = 8192 (or
        with ``compression`` "ann"); "sketch" is randomized sampling,
        "ann" interpolative bases from approximate nearest neighbours."""
        return self._fit(X, y, "hss", leaf_size, max_rank, rel_tol,
                         cluster_leaf, matrix_free=matrix_free,
                         compression=compression)

    def fit_HODLR(self, X, y, leaf_size=128, max_rank=None, rel_tol=1e-4,
                  cluster_leaf=64):
        return self._fit(X, y, "hodlr", leaf_size, max_rank, rel_tol,
                         cluster_leaf)

    def _fit(self, X, y, fmt, leaf_size, max_rank, rel_tol, cluster_leaf,
             matrix_free=None, dtype=np.float32, compression="sketch"):
        # full f32 matmuls for the whole fit: TF32 would ruin the
        # compression and ULV numerics (kernel.py:111-119)
        use_full_fp32_matmul()
        return self._fit_inner(X, y, fmt, leaf_size, max_rank, rel_tol,
                               cluster_leaf, matrix_free, dtype, compression)

    def _fit_inner(self, X, y, fmt, leaf_size, max_rank, rel_tol,
                   cluster_leaf, matrix_free, dtype, compression="sketch"):
        from ..structured.hodlr import HODLRMatrix
        from ..structured.hss import HSSMatrix
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n = len(X)
        self.times = {}
        t0 = time.perf_counter()
        order = recursive_pca_order(X, leaf=cluster_leaf)
        self.times["cluster"] = time.perf_counter() - t0
        Xo = self._t(X[order])
        if matrix_free is None:
            matrix_free = fmt == "hss" and (n > 8192 or compression == "ann")
        t0 = time.perf_counter()
        if matrix_free and fmt == "hss":
            M = self._compress_matrix_free(Xo, leaf_size, max_rank, rel_tol,
                                           dtype=dtype,
                                           compression=compression)
        else:
            # the dense kernel matrix in the points' float64, as the JAX
            # package computes it under x64
            K = self.eval(Xo, Xo)
            K = K + self.lam * torch.eye(n, dtype=K.dtype, device=K.device)
            cls = HSSMatrix if fmt == "hss" else HODLRMatrix
            M = cls(K[None], leaf_size=leaf_size, max_rank=max_rank,
                    rel_tol=rel_tol)
            del K
        self._sync()
        self.times["compress"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        M.factor()
        self._sync()
        self.times["factor"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        yo = torch.as_tensor(y[order], device=self.device).to(M.dtype)
        w = M.solve(yo[None, :, None])[0, :, 0]
        self._sync()
        self.times["solve"] = time.perf_counter() - t0
        self._Xtrain = Xo
        self._weights = w
        self._order = torch.as_tensor(order, device=self.device)
        self._M = M
        return w.cpu().numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _compress_matrix_free(self, Xo, leaf_size, max_rank, rel_tol,
                              dtype=np.float32, block=1024,
                              compression="sketch"):
        """HSS of K + lam I without the n x n kernel matrix (the
        reference's matrix-free kernel compression,
        HSSMatrix.compress_kernel.hpp): a product closure evaluating
        K(tile, X) @ V in row tiles of ``block`` (one [block, n] kernel
        panel at a time) and an element closure of single entries, or,
        with ``compression`` "ann", the neighbour-built HSS (no
        products).  The rows past n are +inf points: their kernel values
        are NaN or 0 and the ``isfinite`` mask zeroes them."""
        from ..structured.hss_sample import (hss_from_neighbors,
                                             hss_from_sampling)
        from .clustering import approximate_knn
        n, d = Xo.shape
        dt = _TORCH_DTYPE[np.dtype(dtype)]
        Xd = Xo.to(dt)
        lam = self.lam
        nb = -(-n // block)
        npad = nb * block
        Xp = torch.cat([Xd, torch.full((npad - n, d), float("inf"),
                                       dtype=dt, device=Xd.device)]
                       ).reshape(nb, block, d)

        def mult(V, trans):
            # K is symmetric: K V == K^H V; V [1, n, k]
            out = []
            for xb in Xp:
                Kb = self.eval(xb, Xd).to(dt)
                Kb = torch.where(torch.isfinite(Kb), Kb, 0)
                out.append(torch.matmul(Kb, V[0]))
            return (torch.cat(out)[:n] + lam * V[0])[None]

        def elem(I, J):
            I2, J2 = torch.broadcast_tensors(I, J)
            v = self.eval_pairs(Xd[I2], Xd[J2]).to(dt)
            return v + lam * (I2 == J2).to(dt)

        r = int(max_rank) if max_rank else max(16, int(leaf_size) // 2)
        if compression == "ann":
            t0 = time.perf_counter()
            nbr, _ = approximate_knn(Xo.cpu().numpy(),
                                     k=min(16, max(8, r // 2)))
            self.times["knn"] = time.perf_counter() - t0
            return hss_from_neighbors(elem, nbr, n, leaf_size=int(leaf_size),
                                      max_rank=r, rel_tol=rel_tol, dtype=dt,
                                      device=self.device)
        return hss_from_sampling(mult, elem, n, 1, leaf_size=int(leaf_size),
                                 max_rank=r, oversample=16, rel_tol=rel_tol,
                                 dtype=dt, device=self.device)

    def predict(self, Xtest, weights=None, block=4096):
        """K(test, train) @ weights in row tiles (kernel/Kernel.hpp:203),
        as numpy."""
        use_full_fp32_matmul()
        w = self._weights if weights is None else self._t(weights)
        Xtest = np.asarray(Xtest, np.float64)
        outs = []
        for lo in range(0, len(Xtest), block):
            Kb = self.eval(self._t(Xtest[lo:lo + block]), self._Xtrain)
            outs.append(Kb @ w.to(Kb.dtype))
        return torch.cat(outs).cpu().numpy()


class GaussKernel(Kernel):
    """exp(-|x-y|^2 / (2 h^2)) (Kernel.hpp:333)."""

    def eval(self, X, Y):
        return torch.exp(-self._sqdist(X, Y) / (2.0 * self.h * self.h))

    def eval_pairs(self, Xi, Xj):
        d2 = ((Xi - Xj) ** 2).sum(-1)
        return torch.exp(-d2 / (2.0 * self.h * self.h))


class LaplaceKernel(Kernel):
    """exp(-|x-y|_1 / h) (Kernel.hpp:378)."""

    def eval(self, X, Y):
        X, Y = self._t(X), self._t(Y)
        d1 = torch.abs(X[:, None, :] - Y[None, :, :]).sum(-1)
        return torch.exp(-d1 / self.h)

    def eval_pairs(self, Xi, Xj):
        return torch.exp(-torch.abs(Xi - Xj).sum(-1) / self.h)


class ANOVAKernel(Kernel):
    """The ANOVA kernel of degree p (Kernel.hpp:424)."""

    def __init__(self, h=1.0, lam=1.0, p=1, device=None):
        super().__init__(h, lam, device)
        self.p = int(p)

    def eval(self, X, Y):
        X, Y = self._t(X), self._t(Y)
        ker = torch.exp(-((X[:, None, :] - Y[None, :, :]) ** 2)
                        / (2.0 * self.h * self.h))
        return ker.sum(-1) ** self.p

    def eval_pairs(self, Xi, Xj):
        ker = torch.exp(-((Xi - Xj) ** 2) / (2.0 * self.h * self.h))
        return ker.sum(-1) ** self.p


class DenseKernel(Kernel):
    """A user-supplied dense matrix (Kernel.hpp:486); the "points" are
    indices into it."""

    def __init__(self, K, lam=1.0, device=None):
        super().__init__(1.0, lam, device)
        self.K = self._t(K)

    def eval(self, X, Y):
        I = self._t(X).long().reshape(-1)
        J = self._t(Y).long().reshape(-1)
        return self.K[I[:, None], J[None, :]]


class KernelRegressionClassifier:
    """A scikit-learn style estimator (python/STRUMPACKKernel.py.in:10):
    binary classification by the sign of kernel ridge regression on
    +/-1 labels."""

    def __init__(self, h=1.0, lam=4.0, kernel="rbf", p=1, fmt="hss",
                 leaf_size=128, max_rank=None, rel_tol=1e-4, device=None):
        self.h, self.lam, self.kernel, self.p = h, lam, kernel, p
        self.fmt, self.leaf_size = fmt, leaf_size
        self.max_rank, self.rel_tol = max_rank, rel_tol
        self.device = resolve_device(device)

    def _make(self):
        if self.kernel in ("rbf", "gauss"):
            return GaussKernel(self.h, self.lam, device=self.device)
        if self.kernel == "laplace":
            return LaplaceKernel(self.h, self.lam, device=self.device)
        if self.kernel == "anova":
            return ANOVAKernel(self.h, self.lam, self.p, device=self.device)
        raise ValueError(self.kernel)

    def fit(self, X, y):
        self._classes = np.unique(y)
        if len(self._classes) != 2:
            raise ValueError("binary classification only")
        z = np.where(np.asarray(y) == self._classes[1], 1.0, -1.0)
        self._k = self._make()
        fit = self._k.fit_HSS if self.fmt == "hss" else self._k.fit_HODLR
        fit(X, z, leaf_size=self.leaf_size, max_rank=self.max_rank,
            rel_tol=self.rel_tol)
        return self

    def decision_function(self, X):
        return self._k.predict(X)

    def predict(self, X):
        return np.where(self.decision_function(X) >= 0,
                        self._classes[1], self._classes[0])

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))
