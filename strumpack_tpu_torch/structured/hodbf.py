"""HODBF: HODLR with butterfly off-diagonal blocks (PyTorch).

The counterpart of ``strumpack_tpu/structured/hodbf.py`` (the role of
ButterflyPACK's HODBF format behind the reference's ``HODLR/HODLRMatrix``
with butterfly levels > 0, the HODBF fronts of FrontHODLR), with a
leading front axis in the place of the JAX package's vmap: one
``HODBFMatrix`` holds ``nf`` matrices of one size.

* a perfect binary tree over an identity-padded range; at each level the
  two sibling off-diagonal blocks of every node are butterflies
  (``butterfly.py``), of the depth the block size allows and a rank
  capped at what the block can use;
* the direct factorization (the bpack_factor role) is the multiplicative
  telescoping A_node = blkdiag(A_1, A_2) [[I, G12], [G21, I]] with
  G12 = A_1^-1 B12 and G21 = A_2^-1 B21, bottom-up: the G blocks are
  butterflies fit from products (``bf_compress_rand``), and the
  correction is solved through W = I - G21 G12, itself compressed from
  products as a half-size HODBF and factored by the same scheme; nodes
  up to ``dense_cutoff`` (or too small for a butterfly) keep dense G and
  an LU of W.  It stays a recursion of plain Python over tensors.

The small LUs keep their permutation in applied form (``hss._lu``).  The
random draws are named by the JAX package's keys (``draws.py``): every
front of the batch shares them, as under the JAX package's vmap.
"""
from __future__ import annotations

import torch

from . import draws
from .butterfly import (bf_compress, bf_compress_rand,
                        bf_compress_rand_adaptive, bf_depth, bf_matvec,
                        bf_max_rank, bf_memory, bf_rmatvec)
from .hss import _ident_pad, _lu, _lu_solve, _pad_pow2


def _lu_rsolve(lu, perm, b):
    """Solve A^H x = b with A's packed LU and applied-form permutation
    (A[perm] = L U): U^H z = b, L^H w = z, x[perm] = w."""
    if lu.shape[-1] == 0:
        return b
    z = torch.linalg.solve_triangular(lu.mH, b, upper=False)
    w = torch.linalg.solve_triangular(lu.mH, z, upper=True,
                                      unitriangular=True)
    return torch.empty_like(w).scatter_(
        -2, perm[..., None].expand(perm.shape + (b.shape[-1],)), w)


def _tslice(bf, q):
    """Pair ``q`` of a level's butterflies [nf, half, ...]."""
    if isinstance(bf, dict):
        return {k: _tslice(v, q) for k, v in bf.items()}
    return bf[:, q]


def _blk_mv(op, X, lo, ro, ml, mp):
    """Rows ro..ro+ml of op applied to X [nf, ml, k] placed at rows
    lo..lo+ml of a zero [nf, mp, k] (a block of the operator)."""
    Z = X.new_zeros((X.shape[0], mp, X.shape[-1]))
    Z[:, lo:lo + ml] = X
    return op(Z)[:, ro:ro + ml]


class FNode:
    """One node of the factor chain: "leaf" (an LU of the diagonal
    block), "dense" (dense G12, G21 and the LU of W) or "bf" (butterfly
    G12 and G21 of depth Dg and ranks rg12, rg21, and W a factored
    HODBFMatrix); f1 and f2 are the children's nodes."""

    def __init__(self, kind, ml=0, Dg=0, rg12=0, rg21=0, lu=None, G12=None,
                 G21=None, W=None, f1=None, f2=None):
        self.kind = kind
        self.ml, self.Dg, self.rg12, self.rg21 = ml, Dg, rg12, rg21
        self.lu, self.G12, self.G21, self.W = lu, G12, G21, W
        self.f1, self.f2 = f1, f2


def _bf_fit(mv, rmv, ml, Dh, r, tol, key, dtype, use_rand, gen, nf, device,
            fixed=False):
    """Butterfly fit of a black-box [ml, ml] block at rank >= r: sampled
    when ``use_rand``, else from the densified block; rank-adaptive unless
    ``fixed``.  Returns (dict, rank)."""
    if use_rand:
        if fixed:
            return bf_compress_rand(mv, rmv, ml, ml, Dh, r, tol, key=key,
                                    dtype=dtype, gen=gen, lead=(nf,),
                                    device=device), r
        bf, ru, _ = bf_compress_rand_adaptive(mv, rmv, ml, ml, Dh, r, tol,
                                              key=key, dtype=dtype, gen=gen,
                                              lead=(nf,), device=device)
        return bf, ru
    I = torch.eye(ml, dtype=dtype, device=device).expand(nf, ml, ml)
    M = mv(I)
    rmax = max(r, ml // max(1, 2 ** (Dh // 2)))
    while True:
        bf = bf_compress(M, Dh, r, tol)
        if fixed or r >= rmax:
            return bf, r
        nrm = float(torch.linalg.vector_norm(M))
        err = (float(torch.linalg.vector_norm(bf_matvec(bf, I, Dh, r) - M))
               / max(nrm, 1e-300))
        if err <= 30.0 * float(tol):
            return bf, r
        r = min(2 * r, rmax)


def _stack(bfs):
    """Pair butterflies [nf, ...] stacked on a new pair axis 1."""
    b0 = bfs[0]
    if isinstance(b0, dict):
        return {k: _stack([b[k] for b in bfs]) for k in b0}
    return torch.stack(bfs, dim=1)


class HODBFMatrix:
    """HODBF forms of ``nf`` square matrices A [nf, m, m] of one size."""

    def __init__(self, A, leaf_size=64, max_rank=None, rel_tol=1e-6):
        self.nf, self.m = A.shape[0], A.shape[-1]
        self.t = int(leaf_size)
        self.mp, self.L = _pad_pow2(self.m, self.t)
        self.r = int(max_rank) if max_rank else max(8, self.t // 2)
        self.rel_tol = rel_tol
        self.dtype = A.dtype
        self._compress(A)
        self._froot = None

    def _compress(self, A):
        """The leaf diagonal blocks and, per level, the butterflies of the
        sibling blocks of every node pair ([nf, half, ...]), the depth
        from the block size and the rank capped at max(8, ml / 2)."""
        nf, mp, t, L = self.nf, self.mp, self.t, self.L
        Ap = _ident_pad(A, mp)
        nl = 2 ** L
        ar = torch.arange(nl, device=A.device)
        self.D = Ap.reshape(nf, nl, t, nl, t).permute(0, 1, 3, 2, 4)[
            :, ar, ar].contiguous()
        self.bf12, self.bf21, self.bf_D, self.bf_r = [], [], [], []
        for lev in range(L - 1, -1, -1):
            half = 2 ** lev
            ml = mp // (2 * half)
            Ar = Ap.reshape(nf, 2 * half, ml, 2 * half, ml).permute(
                0, 1, 3, 2, 4)
            i1 = 2 * torch.arange(half, device=A.device)
            Dh = bf_depth(ml, t)
            rl = min(self.r, max(8, ml // 2))
            self.bf12.append(bf_compress(Ar[:, i1, i1 + 1], Dh, rl,
                                         self.rel_tol))
            self.bf21.append(bf_compress(Ar[:, i1 + 1, i1], Dh, rl,
                                         self.rel_tol))
            self.bf_D.append(Dh)
            self.bf_r.append(rl)

    # ------------------------------------------------------------------
    @classmethod
    def from_matvec(cls, matvec, rmatvec, m, nf, dtype, device,
                    leaf_size=64, max_rank=None, rel_tol=1e-6, key=None,
                    dense_block_cutoff=128, fixed_rank=False, gen=None):
        """HODBF compression from products only
        (``strumpack_tpu/structured/hodbf.py:180-303``; the reference's
        compress-from-multiply, HODLRMatrix.hpp:215): ``matvec`` and
        ``rmatvec`` map [nf, m, k] through A and A^H.  Leaf diagonal
        blocks come exactly from block-identity products; a level's
        sibling blocks are butterflies fit from column-restricted
        products, sampled (``bf_compress_rand``) where the block is deep
        and wider than ``dense_block_cutoff``, else from the densified
        block.  ``key`` defaults to the JAX package's PRNGKey(11)."""
        self = cls.__new__(cls)
        self.nf, self.m = int(nf), int(m)
        self.t = int(leaf_size)
        self.mp, self.L = _pad_pow2(self.m, self.t)
        self.r = int(max_rank) if max_rank else max(8, self.t // 2)
        self.rel_tol = rel_tol
        self.dtype = dtype
        if key is None:
            key = (11,)
        if gen is None:
            gen = draws.generator(device, 11)
        mp, L, t = self.mp, self.L, self.t
        if mp != m:
            def pad(op):
                def pmv(X):
                    Y = X.new_zeros(X.shape)
                    Y[:, :m] = op(X[:, :m])
                    Y[:, m:] = X[:, m:]
                    return Y
                return pmv
            pmv, prmv = pad(matvec), pad(rmatvec)
        else:
            pmv, prmv = matvec, rmatvec
        nl = 2 ** L
        diags = []
        for q in range(nl):
            E = torch.zeros((nf, mp, t), dtype=dtype, device=device)
            E[:, q * t:(q + 1) * t] = torch.eye(t, dtype=dtype,
                                                device=device)
            diags.append(pmv(E)[:, q * t:(q + 1) * t])
        self.D = torch.stack(diags, dim=1)
        self.bf12, self.bf21, self.bf_D, self.bf_r = [], [], [], []
        for lev in range(L - 1, -1, -1):
            half = 2 ** lev
            ml = mp // (2 * half)
            Dh = bf_depth(ml, t)
            rl = min(self.r, max(8, ml // 2))
            use_rand = Dh >= 2 and ml > dense_block_cutoff

            def fit(lo, ro, r, k, fixed):
                return _bf_fit(
                    lambda X: _blk_mv(pmv, X, lo, ro, ml, mp),
                    lambda X: _blk_mv(prmv, X, ro, lo, ml, mp),
                    ml, Dh, r, rel_tol, k, dtype, use_rand, gen, nf, device,
                    fixed=fixed)
            p12, p21 = [], []
            for p in range(half):
                r0 = 2 * p * ml          # child-1 rows
                r1 = r0 + ml             # child-2 rows
                key, k1, k2 = draws.split(key, 3)
                b12, r12 = fit(r1, r0, rl, k1, fixed_rank)
                b21, r21 = fit(r0, r1, rl, k2, fixed_rank)
                rl = max(rl, r12, r21)
                p12.append((b12, r12))
                p21.append((b21, r21))
            # the level's pairs share one rank: refit any pair built below
            # the level's converged rank
            for ps, (a, b) in ((p12, (1, 0)), (p21, (0, 1))):
                for p in range(half):
                    if ps[p][1] == rl:
                        continue
                    key, k1 = draws.split(key)
                    ps[p] = (fit(2 * p * ml + a * ml, 2 * p * ml + b * ml,
                                 rl, k1, True)[0], rl)
            self.bf12.append(_stack([b for b, _ in p12]))
            self.bf21.append(_stack([b for b, _ in p21]))
            self.bf_D.append(Dh)
            self.bf_r.append(rl)
        self._froot = None
        return self

    # ------------------------------------------------------------------
    def matvec(self, x):
        """y = A_hodbf x for x [nf, m, k]."""
        nf, m, mp, t, L = self.nf, self.m, self.mp, self.t, self.L
        k = x.shape[-1]
        xp = x.new_zeros((nf, mp, k))
        xp[:, :m] = x
        y = torch.matmul(self.D, xp.reshape(nf, 2 ** L, t, k)).reshape(
            nf, mp, k)
        for li, lev in enumerate(range(L - 1, -1, -1)):
            half = 2 ** lev
            Dh, rl = self.bf_D[li], self.bf_r[li]
            xb = xp.reshape(nf, half, 2, mp // (2 * half), k)
            y12 = bf_matvec(self.bf12[li], xb[:, :, 1], Dh, rl)
            y21 = bf_matvec(self.bf21[li], xb[:, :, 0], Dh, rl)
            y = y + torch.stack([y12, y21], dim=2).reshape(nf, mp, k)
        return y[:, :m]

    # ------------------------------------------------------------------
    # direct factorization (the bpack_factor role)
    def _factor_node(self, d, q, key, dense_cutoff, fixed, gen):
        """The factor chain of tree node (depth d, index q)
        (``strumpack_tpu/structured/hodbf.py:334-395``)."""
        if d == self.L:
            return FNode("leaf", lu=_lu(self.D[:, q]))
        li = self.L - 1 - d
        ml = self.mp >> (d + 1)
        key, k1, k2, k3, k4, k5 = draws.split(key, 6)
        f1 = self._factor_node(d + 1, 2 * q, k1, dense_cutoff, fixed, gen)
        f2 = self._factor_node(d + 1, 2 * q + 1, k2, dense_cutoff, fixed,
                               gen)
        b12 = _tslice(self.bf12[li], q)
        b21 = _tslice(self.bf21[li], q)
        Dh, rl = self.bf_D[li], self.bf_r[li]

        def mv12(X):
            return self._node_solve(f1, bf_matvec(b12, X, Dh, rl))

        def rmv12(Y):
            return bf_rmatvec(b12, self._node_rsolve(f1, Y), Dh, rl)

        def mv21(X):
            return self._node_solve(f2, bf_matvec(b21, X, Dh, rl))

        def rmv21(Y):
            return bf_rmatvec(b21, self._node_rsolve(f2, Y), Dh, rl)
        Dg = bf_depth(ml, self.t)
        dev = self.D.device
        if ml <= dense_cutoff or Dg < 2:
            I = torch.eye(ml, dtype=self.dtype, device=dev).expand(
                self.nf, ml, ml)
            G12 = mv12(I)
            G21 = mv21(I)
            W = I - torch.matmul(G21, G12)
            return FNode("dense", ml=ml, G12=G12, G21=G21, W=_lu(W),
                         f1=f1, f2=f2)
        rg0 = min(2 * rl, ml // 2)
        tg = self.rel_tol
        kw = dict(dtype=self.dtype, gen=gen, lead=(self.nf,), device=dev)
        if fixed:
            G12 = bf_compress_rand(mv12, rmv12, ml, ml, Dg, rg0, tg, key=k3,
                                   **kw)
            G21 = bf_compress_rand(mv21, rmv21, ml, ml, Dg, rg0, tg, key=k4,
                                   **kw)
            rg12 = rg21 = rg0
        else:
            G12, rg12, _ = bf_compress_rand_adaptive(
                mv12, rmv12, ml, ml, Dg, rg0, tg, key=k3, **kw)
            G21, rg21, _ = bf_compress_rand_adaptive(
                mv21, rmv21, ml, ml, Dg, rg0, tg, key=k4, **kw)

        def wmv(X):
            return X - bf_matvec(G21, bf_matvec(G12, X, Dg, rg12), Dg, rg21)

        def wrmv(Y):
            return Y - bf_rmatvec(G12, bf_rmatvec(G21, Y, Dg, rg21), Dg,
                                  rg12)
        # the Schur correction W: a fresh half-size HODBF compressed from
        # its products and factored by the same scheme
        Wm = HODBFMatrix.from_matvec(
            wmv, wrmv, ml, self.nf, self.dtype, dev, leaf_size=self.t,
            max_rank=max(self.r, rg12, rg21), rel_tol=self.rel_tol, key=k5,
            dense_block_cutoff=dense_cutoff, fixed_rank=fixed, gen=gen)
        Wm.factor(dense_cutoff=dense_cutoff, key=k5, fixed=fixed, gen=gen)
        return FNode("bf", ml=ml, Dg=Dg, rg12=rg12, rg21=rg21, G12=G12,
                     G21=G21, W=Wm, f1=f1, f2=f2)

    @staticmethod
    def _g_apply(f, which, x, adjoint=False):
        G = getattr(f, which)
        if f.kind == "dense":
            return torch.matmul(G.mH if adjoint else G, x)
        rg = f.rg12 if which == "G12" else f.rg21
        if adjoint:
            return bf_rmatvec(G, x, f.Dg, rg)
        return bf_matvec(G, x, f.Dg, rg)

    @staticmethod
    def _w_solve(f, b, adjoint=False):
        if f.kind == "dense":
            return (_lu_rsolve if adjoint else _lu_solve)(*f.W, b)
        return (f.W._rsolve_padded(b) if adjoint
                else f.W._solve_padded(b))

    def _node_solve(self, f, b):
        """x = A_node^-1 b: the children's solves, then the correction
        z2 = W^-1 (u2 - G21 u1), z1 = u1 - G12 z2."""
        if f.kind == "leaf":
            return _lu_solve(*f.lu, b)
        ml = f.ml
        u1 = self._node_solve(f.f1, b[:, :ml])
        u2 = self._node_solve(f.f2, b[:, ml:])
        z2 = self._w_solve(f, u2 - self._g_apply(f, "G21", u1))
        z1 = u1 - self._g_apply(f, "G12", z2)
        return torch.cat([z1, z2], dim=1)

    def _node_rsolve(self, f, b):
        """x = A_node^-H b: the correction's adjoint through W^H first,
        then the children's adjoint solves."""
        if f.kind == "leaf":
            return _lu_rsolve(*f.lu, b)
        ml = f.ml
        b1, b2 = b[:, :ml], b[:, ml:]
        v2 = self._w_solve(
            f, b2 - self._g_apply(f, "G12", b1, adjoint=True), adjoint=True)
        v1 = b1 - self._g_apply(f, "G21", v2, adjoint=True)
        return torch.cat([self._node_rsolve(f.f1, v1),
                          self._node_rsolve(f.f2, v2)], dim=1)

    # ------------------------------------------------------------------
    def factor(self, dense_cutoff=256, key=None, fixed=False, gen=None):
        """The direct factorization: a bottom-up multiplicative sweep
        with butterfly G blocks and recursively factored corrections;
        ``fixed`` keeps every rank at its start (the sparse fronts' mode).
        ``key`` defaults to the JAX package's PRNGKey(7)."""
        if key is None:
            key = (7,)
        if gen is None:
            gen = draws.generator(self.D.device, 7)
        with torch.profiler.record_function("hodbf_factor"):
            self._froot = self._factor_node(0, 0, key, int(dense_cutoff),
                                            fixed, gen)

    def _pad(self, b):
        bp = b.new_zeros((self.nf, self.mp, b.shape[-1]))
        bp[:, :self.m] = b
        return bp

    def _solve_padded(self, b):
        return self._node_solve(self._froot, b)

    def _rsolve_padded(self, b):
        return self._node_rsolve(self._froot, b)

    def solve_direct(self, b):
        """x = A^-1 b for b [nf, m, k] through the factor chain alone
        (the bpack_solve role; the sparse solver's outer Krylov mops up
        the truncation)."""
        return self._solve_padded(self._pad(b.to(self.dtype)))[:, :self.m]

    def solve(self, b, rtol=None, maxit=3):
        """The direct solve plus up to ``maxit`` sweeps of refinement on
        the HODBF product (``iterations`` records them)."""
        if self._froot is None:
            self.factor()
        rtol = self.rel_tol if rtol is None else rtol
        m = self.m
        bp = self._pad(b.to(self.dtype))
        x = self._solve_padded(bp)
        bn = float(torch.linalg.vector_norm(bp))
        self.iterations = 0
        for _ in range(maxit):
            res = bp.clone()
            res[:, :m] -= self.matvec(x[:, :m])
            res[:, m:] -= x[:, m:]
            if float(torch.linalg.vector_norm(res)) <= rtol * bn:
                break
            x = x + self._solve_padded(res)
            self.iterations += 1
        return x[:, :m]

    def rsolve(self, b):
        """x = A^-H b through the factor chain."""
        if self._froot is None:
            self.factor()
        return self._rsolve_padded(self._pad(b.to(self.dtype)))[:, :self.m]

    def solve_iterative(self, b, rtol=None, maxit=200):
        """GMRES on the HODBF product, preconditioned by a HODLR-SMW
        factorization of the densified matrix
        (``strumpack_tpu/structured/hodbf.py:529-562``), column by column
        of each front.  ``iterations`` records the largest count."""
        from ..krylov.solvers import gmres
        from .hodlr import HODLRMatrix
        if getattr(self, "_prec", None) is None:
            I = torch.eye(self.m, dtype=self.dtype,
                          device=self.D.device).expand(self.nf, self.m,
                                                       self.m)
            self._prec = HODLRMatrix(self.matvec(I), leaf_size=self.t,
                                     max_rank=self.r,
                                     rel_tol=max(self.rel_tol, 1e-8))
            self._prec.factor()
        rtol = self.rel_tol if rtol is None else rtol
        b = b.to(self.dtype)
        x = torch.empty_like(b)
        self.iterations = 0
        for f in range(self.nf):
            def mv(v, f=f):
                return self.matvec(
                    v[None, :, None].expand(self.nf, -1, 1))[f, :, 0]

            def pr(v, f=f):
                return self._prec.solve(
                    v[None, :, None].expand(self.nf, -1, 1))[f, :, 0]
            for j in range(b.shape[-1]):
                x[f, :, j], its, _ = gmres(mv, pr, b[f, :, j], rtol=rtol,
                                           atol=0.0, maxit=maxit)
                self.iterations = max(self.iterations, its)
        return x

    # ------------------------------------------------------------------
    def memory(self) -> int:
        """Values of the compressed form (leaf blocks and butterflies)."""
        return int(self.D.numel()) + sum(bf_memory(b)
                                         for b in self.bf12 + self.bf21)

    def max_rank(self) -> int:
        return max((bf_max_rank(b) for b in self.bf12 + self.bf21),
                   default=0)
