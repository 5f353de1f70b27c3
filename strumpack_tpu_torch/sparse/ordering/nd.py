"""General-graph nested dissection (BFS level-set bisection).

Role of the reference's ``sparse/ordering/ANDSparspak.{hpp,cpp}`` (SPARSPAK
style automatic nested dissection) and the METIS dispatch in
``MatrixReordering.cpp:73-135``: the native C++ BFS or multilevel splitter
(``native/hostsym.cpp``) first, and a self-contained recursive bisection in
Python (pseudo-peripheral BFS, median-level split, separator = boundary of
the smaller side) when no compiler is available, or the Fiedler-vector
splitter for SPECTRAL.  Works on any structurally-symmetric sparsity
graph.  The BFS helpers also serve separator reordering.
"""
from __future__ import annotations

import numpy as np

from ..separator_tree import TreeAssembler


def _bfs_levels(rowptr, colind, mask_ids, start):
    """BFS over the subgraph induced by mask_ids (global ids), returns
    level array aligned with mask_ids and the last-level vertices."""
    gid_to_local = {int(g): i for i, g in enumerate(mask_ids)}
    n = len(mask_ids)
    lev = np.full(n, -1, dtype=np.int64)
    frontier = [gid_to_local[int(start)]]
    lev[frontier[0]] = 0
    d = 0
    while frontier:
        nxt = []
        for ul in frontier:
            g = mask_ids[ul]
            for p in range(rowptr[g], rowptr[g + 1]):
                v = int(colind[p])
                vl = gid_to_local.get(v)
                if vl is not None and lev[vl] == -1:
                    lev[vl] = d + 1
                    nxt.append(vl)
        frontier = nxt
        d += 1
    return lev


def _pseudo_peripheral(rowptr, colind, ids):
    """Find a pseudo-peripheral vertex of the induced subgraph."""
    start = ids[0]
    best_ecc = -1
    for _ in range(4):
        lev = _bfs_levels(rowptr, colind, ids, start)
        reach = lev >= 0
        ecc = int(lev[reach].max()) if reach.any() else 0
        if ecc <= best_ecc:
            break
        best_ecc = ecc
        last = ids[reach & (lev == ecc)]
        # pick min-degree vertex of the last level
        degs = rowptr[last + 1] - rowptr[last]
        start = last[int(np.argmin(degs))]
    return start


def _bisect(rowptr, colind, ids):
    """Split induced subgraph into (left_ids, right_ids, sep_ids)."""
    lev = _bfs_levels(rowptr, colind, ids,
                      _pseudo_peripheral(rowptr, colind, ids))
    unreached = lev < 0
    if unreached.any():
        # disconnected: one component vs the rest, empty separator
        return ids[~unreached], ids[unreached], ids[:0]
    maxlev = int(lev.max())
    if maxlev < 2:
        # graph too tight to split by levels: median cut on id order
        half = len(ids) // 2
        part_a = np.zeros(len(ids), dtype=bool)
        part_a[:half] = True
    else:
        # choose split level balancing the halves
        counts = np.bincount(lev, minlength=maxlev + 1)
        cum = np.cumsum(counts)
        split = int(np.argmin(np.abs(cum - len(ids) / 2)))
        split = min(max(split, 0), maxlev - 1)
        part_a = lev <= split
    # separator = vertices of side A adjacent to side B
    gid_set_b = set(int(g) for g in ids[~part_a])
    sep_mask = np.zeros(len(ids), dtype=bool)
    for il in np.nonzero(part_a)[0]:
        g = ids[il]
        for p in range(rowptr[g], rowptr[g + 1]):
            if int(colind[p]) in gid_set_b:
                sep_mask[il] = True
                break
    left = ids[part_a & ~sep_mask]
    right = ids[~part_a]
    sep = ids[sep_mask]
    return left, right, sep


def _bisect_spectral(rowptr, colind, ids):
    """Fiedler-vector bisection (the reference's SPECTRAL ordering role):
    sign-split on the second Laplacian eigenvector of the induced
    subgraph, separator = boundary of side A.  Falls back to the BFS
    split when the eigensolve fails or the subgraph is tiny."""
    m = len(ids)
    if m < 16:
        return _bisect(rowptr, colind, ids)
    gid_to_local = {int(g): i for i, g in enumerate(ids)}
    rows, cols = [], []
    for il, g in enumerate(ids):
        for p in range(rowptr[g], rowptr[g + 1]):
            jl = gid_to_local.get(int(colind[p]))
            if jl is not None and jl != il:
                rows.append(il)
                cols.append(jl)
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    A = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(m, m))
    deg = np.asarray(A.sum(axis=1)).ravel()
    L = sp.diags(deg) - A
    try:
        _, vecs = spla.eigsh(L, k=2, sigma=-1e-3, which="LM",
                             maxiter=500, tol=1e-4)
    except RuntimeError:    # no convergence, or a singular shift-invert
        return _bisect(rowptr, colind, ids)
    fiedler = vecs[:, 1]
    part_a = fiedler <= np.median(fiedler)
    gid_set_b = set(int(g) for g in ids[~part_a])
    sep_mask = np.zeros(m, dtype=bool)
    for il in np.nonzero(part_a)[0]:
        g = ids[il]
        for p in range(rowptr[g], rowptr[g + 1]):
            if int(colind[p]) in gid_set_b:
                sep_mask[il] = True
                break
    left = ids[part_a & ~sep_mask]
    right = ids[~part_a]
    sep = ids[sep_mask]
    if len(left) == 0 or len(right) == 0:
        return _bisect(rowptr, colind, ids)
    return left, right, sep


def nested_dissection(rowptr, colind, n, leaf: int = 32,
                      splitter: str = "bfs"):
    """Return (perm, iperm, SeparatorTree) for a general symmetric graph.

    The diagonal is ignored; rowptr/colind must be the structurally
    symmetrized pattern (reference symmetrizes before ND too,
    SparseSolverBase.cpp:353).  splitter: "bfs" (ANDSparspak role), "ml"
    (native multilevel bisection with vertex-cover separators, the
    METIS_NodeND role) or "spectral" (Fiedler bisection,
    ReorderingStrategy::SPECTRAL role).
    """
    if splitter in ("bfs", "ml"):
        from ...native import nested_dissection_native
        out = nested_dissection_native(rowptr, colind, n, leaf=leaf,
                                       method=splitter)
        if out is not None:
            return out
        splitter = "bfs"  # without a compiler: the Python BFS bisection
    rowptr = np.asarray(rowptr)
    colind = np.asarray(colind)
    tb = TreeAssembler()

    def rec(ids):
        if len(ids) <= leaf:
            lo, hi = tb.emit(ids)
            return tb.add_node(lo, hi, -1, -1)
        bis = _bisect_spectral if splitter == "spectral" else _bisect
        left_ids, right_ids, sep_ids = bis(rowptr, colind, ids)
        if len(sep_ids) == 0 and (len(left_ids) == 0 or len(right_ids) == 0):
            # could not split: make a leaf
            lo, hi = tb.emit(ids)
            return tb.add_node(lo, hi, -1, -1)
        left = rec(left_ids) if len(left_ids) else -1
        right = rec(right_ids) if len(right_ids) else -1
        lo, hi = tb.emit(sep_ids)
        return tb.add_node(lo, hi, left, right)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        rec(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old)
    return tb.finish(n)
