"""Column matching for numerical stability (host).

Role of the reference's MC64 integration (``sparse/MC64ad.cpp`` — HSL MC64
max-product bipartite matching with row/column scalings, dispatched via
``MatchingJob`` StrumpackOptions.hpp:120-130 and applied in
``SparseSolverBase::reorder`` :327-344).

Implementation: maximum product-of-diagonals matching computed as a
min-weight perfect bipartite matching on w_ij = log(max_i|a_ij|) - log|a_ij|
(scipy's Jonker-Volgenant solver), followed by Sinkhorn-style row/column
scaling of the matched matrix so the matched diagonal is ~1 and off-diagonals
are O(1) — the same normalization MC64 job 5's dual variables produce.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRMatrix


def max_product_matching(A: CSRMatrix):
    """Return (colperm q, dr, dc): A[:, q] has a structurally nonzero
    diagonal maximizing prod|a_{i,q[i]}|; dr/dc scale so diag(dr)A[:,q]diag
    becomes ~unit-diagonal.  q[i] = original column matched to row i."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    n = A.n
    absA = np.abs(A.data).astype(np.float64)
    if (absA == 0).any():
        # explicit zeros cannot be matched; drop them from the graph
        keep = absA > 0
    else:
        keep = slice(None)
    rows = np.repeat(np.arange(n), np.diff(A.rowptr))[keep]
    cols = A.colind[keep]
    vals = absA[keep]
    cmax = np.zeros(n)
    np.maximum.at(cmax, cols, vals)
    w = np.log(cmax[cols]) - np.log(vals)
    # strictly positive weights required by the scipy solver's sparsity
    # convention (0 == no edge); shift by epsilon
    w = w + 1e-300
    B = csr_matrix((w, (rows, cols)), shape=(n, n))
    r, c = min_weight_full_bipartite_matching(B)
    q = np.empty(n, dtype=np.int64)
    q[r] = c
    dr, dc = matching_scaling(A, q)
    return q, dr, dc


def matching_scaling(A: CSRMatrix, q):
    """Row/col scalings for a fixed matching q (recomputed on value updates
    while q — and hence the sparsity plan — stays fixed)."""
    n = A.n
    absA = np.abs(A.data).astype(np.float64)
    dr = np.ones(n)
    dc = np.ones(n)
    iq = np.empty(n, dtype=np.int64)
    iq[q] = np.arange(n)
    rows_all = np.repeat(np.arange(n), np.diff(A.rowptr))
    diag_mask = iq[A.colind] == rows_all
    for _ in range(5):
        # scale matched diagonal toward 1 (sqrt split between row and col)
        scaled = absA * dr[rows_all] * dc[A.colind]
        dvals = np.ones(n)
        dvals[rows_all[diag_mask]] = scaled[diag_mask]
        dvals[dvals == 0] = 1.0
        dr *= 1.0 / np.sqrt(dvals)
        dc[q] *= 1.0 / np.sqrt(dvals)
    return dr, dc


def apply_matching(A: CSRMatrix, q, dr, dc) -> CSRMatrix:
    """Return diag(dr) @ A @ diag(dc) with columns permuted so that matched
    entries land on the diagonal: out[:, i] = (scaled A)[:, q[i]]."""
    S = A.scale_rows_cols(dr, dc).to_scipy()
    iq = np.empty(A.n, dtype=np.int64)
    iq[q] = np.arange(A.n)
    out = S[:, q].tocsr()
    out.sort_indices()
    return CSRMatrix(A.n, out.indptr, out.indices, out.data)


def max_cardinality_matching(A: CSRMatrix):
    """MC64 job 1: maximum-cardinality matching (structural nonzero
    diagonal), no scaling."""
    from scipy.sparse.csgraph import maximum_bipartite_matching
    n = A.n
    m = maximum_bipartite_matching(A.to_scipy(), perm_type="column")
    q = np.asarray(m, dtype=np.int64)
    if (q < 0).any():      # structurally singular: patch with free columns
        free = np.setdiff1d(np.arange(n), q[q >= 0])
        q[q < 0] = free
    return q, np.ones(n), np.ones(n)


def max_smallest_diagonal_matching(A: CSRMatrix):
    """MC64 jobs 2/3: bottleneck matching — maximize min_i |a_{i,q[i]}|
    by binary search over a threshold with perfect-cardinality tests."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching
    n = A.n
    rows = np.repeat(np.arange(n), np.diff(A.rowptr))
    vals = np.abs(A.data).astype(np.float64)
    cand = np.unique(vals)
    lo, hi = 0, len(cand) - 1
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        keep = vals >= cand[mid]
        B = csr_matrix((np.ones(int(keep.sum())),
                        (rows[keep], A.colind[keep])), shape=(n, n))
        m = maximum_bipartite_matching(B, perm_type="column")
        if (m >= 0).all():
            best = np.asarray(m, dtype=np.int64)
            lo = mid + 1
        else:
            hi = mid - 1
    if best is None:
        return max_cardinality_matching(A)
    return best, np.ones(n), np.ones(n)


def max_diagonal_sum_matching(A: CSRMatrix):
    """MC64 job 4: maximize sum_i |a_{i,q[i]}| (linear assignment on the
    sparse pattern), no scaling."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    n = A.n
    rows = np.repeat(np.arange(n), np.diff(A.rowptr))
    vals = np.abs(A.data).astype(np.float64)
    keep = vals > 0
    w = vals.max() - vals[keep] + 1e-300
    B = csr_matrix((w, (rows[keep], A.colind[keep])), shape=(n, n))
    r, c = min_weight_full_bipartite_matching(B)
    q = np.empty(n, dtype=np.int64)
    q[r] = c
    return q, np.ones(n), np.ones(n)


def awpm_matching(A: CSRMatrix, eps=1e-2, max_rounds=50):
    """Approximate-weight perfect matching by an auction algorithm on
    log-weights — the role of the reference's optional CombBLAS AWPM
    (AWPMCombBLAS.hpp: distributed approximation of MC64 job 5).  Cheaper
    than the exact assignment at a small optimality loss; falls back to
    cardinality patching for rows the auction leaves unmatched.  Returns
    the same (q, dr, dc) contract as max_product_matching."""
    n = A.n
    rows = np.repeat(np.arange(n), np.diff(A.rowptr))
    vals = np.abs(A.data).astype(np.float64)
    keep = vals > 0
    rows, cols, vals = rows[keep], A.colind[keep], vals[keep]
    cmax = np.zeros(n)
    np.maximum.at(cmax, cols, vals)
    benefit = np.log(vals) - np.log(cmax[cols])     # <= 0, 0 = best
    price = np.zeros(n)
    owner = np.full(n, -1, dtype=np.int64)          # column -> row
    q = np.full(n, -1, dtype=np.int64)              # row -> column
    rowptr = A.rowptr
    order = np.argsort(rows, kind="stable")
    for _ in range(max_rounds):
        unmatched = np.nonzero(q < 0)[0]
        if len(unmatched) == 0:
            break
        for i in unmatched:
            lo, hi = rowptr[i], rowptr[i + 1]
            sel = keep[lo:hi]
            cj = A.colind[lo:hi][sel]
            if len(cj) == 0:
                continue
            bv = (np.log(np.abs(A.data[lo:hi][sel]))
                  - np.log(cmax[cj])) - price[cj]
            k = int(np.argmax(bv))
            second = np.partition(bv, -2)[-2] if len(bv) > 1 else bv[k] - eps
            price[cj[k]] += (bv[k] - second) + eps
            prev = owner[cj[k]]
            if prev >= 0:
                q[prev] = -1
            owner[cj[k]] = i
            q[i] = cj[k]
    if (q < 0).any():   # patch remaining rows to keep the matching perfect
        free = np.setdiff1d(np.arange(n), q[q >= 0])
        q[q < 0] = free[:int((q < 0).sum())]
    dr, dc = matching_scaling(A, q)
    return q, dr, dc
