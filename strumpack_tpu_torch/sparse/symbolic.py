"""Symbolic multifrontal factorization (host).

Role of the reference's ``sparse/EliminationTree.cpp:65-123`` (bottom-up merge
of child update-index sets over the separator tree).  Output per front i:
``upd[i]`` — the sorted global (permuted) indices of the Schur-complement
(contribution-block) rows/cols, all >= sep_end[i].

The permuted matrix pattern must be structurally symmetric (the solver
symmetrizes first, as SparseSolverBase.cpp:353 does).
"""
from __future__ import annotations

import numpy as np

from .csr import CSRMatrix
from .separator_tree import SeparatorTree


def symbolic_factorization(Ap: CSRMatrix, tree: SeparatorTree) -> list[np.ndarray]:
    """Compute per-front update index sets, postorder (children first).

    Uses the native C++ implementation (native/hostsym.cpp) when a host
    compiler is available, NumPy otherwise."""
    from ..native import symbolic_factorization_native
    out = symbolic_factorization_native(Ap, tree)
    if out is not None:
        return out
    upd: list[np.ndarray] = [None] * tree.nseps
    rp, ci = Ap.rowptr, Ap.colind
    for i in range(tree.nseps):
        sb, se = int(tree.sep_begin[i]), int(tree.sep_end[i])
        pieces = []
        if se > sb:
            cols = ci[rp[sb]:rp[se]]
            pieces.append(cols[cols >= se])
        l, r = int(tree.lch[i]), int(tree.rch[i])
        if l >= 0:
            u = upd[l]
            pieces.append(u[u >= se])
        if r >= 0:
            u = upd[r]
            pieces.append(u[u >= se])
        if pieces:
            upd[i] = np.unique(np.concatenate(pieces))
        else:
            upd[i] = np.empty(0, dtype=np.int64)
    return upd


def factor_nonzeros(tree: SeparatorTree, upd: list[np.ndarray]) -> int:
    """Exact LU factor nonzeros (dense fronts): per front the (ds+du)^2 - du^2
    entries that are stored (F11, F12, F21). Role of the reference's
    'factor nonzeros' statistic (SparseSolverBase.cpp:596)."""
    tot = 0
    for i in range(tree.nseps):
        ds = tree.sep_size(i)
        du = len(upd[i])
        tot += ds * ds + 2 * ds * du
    return tot


def factor_flops(tree: SeparatorTree, upd: list[np.ndarray]) -> int:
    """Exact dense-multifrontal factorization flop count: per front
    LU(ds) + 2 trsm(ds,du) + gemm Schur update (du,du,ds)."""
    tot = 0.0
    for i in range(tree.nseps):
        ds = tree.sep_size(i)
        du = len(upd[i])
        tot += (2.0 / 3.0) * ds**3 + 2.0 * ds * ds * du + 2.0 * du * du * ds
    return int(tot)
