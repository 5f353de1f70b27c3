"""Dense matrices distributed over the process grid.

The counterpart of ``strumpack_tpu/parallel/dist_matrix.py``
(``DistributedMatrix``, :45-204), the role of the reference's
``dense/DistributedMatrix`` over a BLACS grid (DistributedMatrix.hpp:84,
the p?geadd / p?gemm / p?trsm / p?getrf / p?laswp / p?potrf surface).
Each rank holds one contiguous block of the matrix: rows over the grid
rows, columns over the grid columns (``dist2d._Blocks``).  Elementwise
operations and norms work on the blocks (norms with one all-reduce);
products, solves and re-layouts put the operands together with the
gathers of ``parallel/dist.py``; ``getrf`` and ``solve`` run the grid LU
of ``dist2d`` (pgetrf with full partial pivoting) and its solve.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import dist as D
from .dist2d import _Blocks


class DistributedMatrix:
    """A dense [m, n] matrix in contiguous blocks over a Grid."""

    def __init__(self, A, grid, device=None):
        """``A`` (array or tensor, replicated) distributed over ``grid`` on
        ``device`` (None: this rank's CUDA device,
        ``D.resolve_rank_device``; raises without CUDA)."""
        A = torch.as_tensor(np.asarray(A) if not torch.is_tensor(A) else A,
                            device=D.resolve_rank_device(device))
        if A.ndim != 2:
            raise ValueError("DistributedMatrix takes a 2-D array")
        self.grid = grid
        self.m, self.n = A.shape
        self._set_layout()
        self.local = A[self.r0:self.r1, self.c0:self.c1].clone()

    def _set_layout(self):
        rows = _Blocks(self.grid, self.m)
        cols = _Blocks(self.grid, self.n)
        self.r0, self.r1 = rows.r0, rows.r1
        self.c0, self.c1 = cols.c0, cols.c1
        self._rows, self._cols = rows.rows, cols.cols

    def _new(self, A):
        """``A`` (replicated) distributed as this matrix is."""
        return DistributedMatrix(A, self.grid, self.device)

    def _like(self, local):
        out = object.__new__(DistributedMatrix)
        out.grid, out.m, out.n = self.grid, self.m, self.n
        out._set_layout()
        out.local = local
        return out

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def full(self):
        """The whole matrix on every rank (one all-gather of the
        blocks)."""
        g = self.grid
        sizes, cuts = [], []
        for r in sorted(g.ranks):
            ri, ci = divmod(g.ranks.index(r), g.pc)
            rr, cc = self._rows[ri], self._cols[ci]
            cuts.append((rr, cc))
            sizes.append((rr[1] - rr[0]) * (cc[1] - cc[0]))
        parts = D.all_gather(self.local.reshape(-1), g.group, sizes=sizes)
        out = self.local.new_empty((self.m, self.n))
        for (rr, cc), part in zip(cuts, parts):
            out[rr[0]:rr[1], cc[0]:cc[1]] = part.view(rr[1] - rr[0],
                                                      cc[1] - cc[0])
        return out

    def to_host(self):
        return self.full().cpu().numpy()

    # -- re-layout (p?gemr2d role) -----------------------------------------
    def redistribute(self, grid=None):
        """The same matrix over another grid (the whole matrix gathered,
        then each rank keeps its new block)."""
        return DistributedMatrix(self.full(), grid or self.grid,
                                 self.device)

    # -- elementwise (p?geadd, scale, axpby) -------------------------------
    def _other(self, B):
        if isinstance(B, DistributedMatrix):
            return B.local
        B = torch.as_tensor(np.asarray(B) if not torch.is_tensor(B) else B,
                            device=self.local.device)
        return B[self.r0:self.r1, self.c0:self.c1]

    def scale(self, alpha):
        return self._like(self.local * alpha)

    def add(self, B, alpha=1.0):
        """self + alpha * B (geadd role)."""
        return self._like(self.local + alpha * self._other(B))

    def axpby(self, alpha, B, beta):
        return self._like(alpha * self.local + beta * self._other(B))

    def transpose(self):
        return self._new(self.full().T)

    # -- norms (p?lange) ---------------------------------------------------
    def normF(self):
        s = (self.local.abs() ** 2).sum().reshape(1)
        return float(D.all_reduce(s, group=self.grid.group).sqrt())

    def norm1(self):
        """Largest column sum of |A|: the column sums all-reduced over the
        ranks of each column block, then the largest over all."""
        c = self.local.abs().sum(dim=0)
        D.all_reduce(c, group=self.grid.row_group)
        m = c.max().reshape(1) if c.numel() else c.new_zeros(1)
        return float(D.all_reduce(m, dist.ReduceOp.MAX, self.grid.group))

    def normI(self):
        """Largest row sum of |A|."""
        r = self.local.abs().sum(dim=1)
        D.all_reduce(r, group=self.grid.col_group)
        m = r.max().reshape(1) if r.numel() else r.new_zeros(1)
        return float(D.all_reduce(m, dist.ReduceOp.MAX, self.grid.group))

    # -- products and solves -----------------------------------------------
    def _full_of(self, B):
        if isinstance(B, DistributedMatrix):
            return B.full()
        return torch.as_tensor(np.asarray(B) if not torch.is_tensor(B)
                               else B, device=self.local.device)

    def gemm(self, B, ta=False, tb=False, alpha=1.0, beta=0.0, C=None):
        """alpha op(A) op(B) + beta C (p?gemm role), distributed as C."""
        A = self.full()
        Bf = self._full_of(B)
        Y = alpha * torch.matmul(A.T if ta else A, Bf.T if tb else Bf)
        if C is not None:
            Y = Y + beta * self._full_of(C)
        return self._new(Y)

    def trsm(self, B, lower=True, unit=False, left=True):
        """op(self)^-1 B (or B op(self)^-1), self triangular (p?trsm)."""
        X = torch.linalg.solve_triangular(self.full(), self._full_of(B),
                                          upper=not lower, left=left,
                                          unitriangular=unit)
        return self._new(X)

    def laswp(self, perm, fwd=True):
        """Rows permuted (p?laswp role): row i of the result is row perm[i]
        (``fwd``), or the inverse."""
        perm = torch.as_tensor(np.asarray(perm), device=self.local.device)
        if not fwd:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.numel(), device=perm.device)
            perm = inv
        return self._new(self.full()[perm])

    def getrf(self, blk: int = 256, thresh: float = 0.0):
        """Grid LU with partial pivoting across panels (pgetrf role,
        ``dist2d.sharded_blocked_lu_pivoted``); returns (LU
        DistributedMatrix, perm) and keeps them for ``solve``."""
        from .dist2d import sharded_blocked_lu_pivoted
        m = self.m
        blk = min(blk, m)
        while m % blk:           # largest divisor of m not above blk
            blk -= 1
        LU, perm = sharded_blocked_lu_pivoted(self.full(), self.grid,
                                              blk=blk, thresh=thresh)
        self._lu = (self._new(LU), perm, blk)
        return self._lu[0], perm

    def solve(self, b):
        """x = A^-1 b after getrf (p?getrs role), replicated."""
        from .dist2d import sharded_lu_solve_pivoted
        if not hasattr(self, "_lu"):
            self.getrf()
        LU, perm, blk = self._lu
        b = torch.as_tensor(np.asarray(b) if not torch.is_tensor(b) else b,
                            device=self.local.device)
        return sharded_lu_solve_pivoted(LU.full(), perm, b, blk=blk)

    def potrf(self):
        """Lower Cholesky factor (p?potrf role)."""
        self._chol = self._new(torch.linalg.cholesky(self.full()))
        return self._chol

    # -- sub-blocks --------------------------------------------------------
    def extract(self, r0, r1, c0, c1):
        """Copy of rows [r0, r1) x cols [c0, c1), distributed."""
        return self._new(self.full()[r0:r1, c0:c1])

    def assign(self, r0, c0, B):
        """The matrix with B written at (r0, c0)."""
        Bf = self._full_of(B)
        out = self.local.clone()
        rr0, rr1 = max(self.r0, r0), min(self.r1, r0 + Bf.shape[0])
        cc0, cc1 = max(self.c0, c0), min(self.c1, c0 + Bf.shape[1])
        if rr1 > rr0 and cc1 > cc0:
            out[rr0 - self.r0:rr1 - self.r0, cc0 - self.c0:cc1 - self.c0] = \
                Bf[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0]
        return self._like(out)
