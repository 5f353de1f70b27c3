"""HODLR matrices with a Sherman-Morrison-Woodbury factorization (PyTorch).

The counterpart of ``strumpack_tpu/structured/hodlr.py`` (the role of the
reference's ``HODLR/HODLRMatrix``, HODLRMatrix.hpp:144-187), with a
leading front axis in the place of the JAX package's vmap:

* a perfect binary tree over an identity-padded range; at each level the
  two sibling off-diagonal blocks of every node are compressed on their
  own to rank <= r (truncated SVD, or a randomized range finder for
  blocks of at least ``RSVD_MIN`` columns), no nested bases;
* the factorization is recursive Sherman-Morrison-Woodbury: leaf LUs,
  then per level one batched [2r, 2r] capacitance LU per node pair.
"""
from __future__ import annotations

import torch

from . import draws
from .hss import _ident_pad, _lu, _lu_solve, _pad_pow2, _svd, _tiny

# blocks at least this wide are compressed by the randomized range finder
# (strumpack_tpu/structured/hodlr.py:35)
RSVD_MIN = 512

# the JAX package's base seed of the range finder's sketches
SKETCH_SEED = 17


def _rand_lowrank_svd(A, Om):
    """Randomized rank-q factorization of A [..., m, n] from the sketch
    Om [..., n, q]: one power iteration (Halko-Martinsson-Tropp), then the
    SVD of the [q, n] projection.  Returns (U, S, Vh)."""
    Q, _ = torch.linalg.qr(torch.matmul(A, Om))
    Qz, _ = torch.linalg.qr(torch.matmul(A.conj().transpose(-1, -2), Q))
    Q, _ = torch.linalg.qr(torch.matmul(A, Qz))
    Ub, S, Vh = _svd(torch.matmul(Q.conj().transpose(-1, -2), A))
    return torch.matmul(Q, Ub), S, Vh


def _sketch_keys(A12, lev):
    """The JAX package's key of each front's level sketch: PRNGKey(17)
    folded with the level and with the bits of the front's first A12
    entry as float32 (``strumpack_tpu/structured/hodlr.py:73-83``)."""
    first = A12.reshape(A12.shape[0], -1)[:, 0].real.to(torch.float32)
    mix = first.contiguous().view(torch.int32).tolist()
    return [(SKETCH_SEED, "fold", lev, "fold", m) for m in mix]


def _compress_level(A12, A21, r, tol, lev, gen):
    """Compress one level's sibling off-diagonal blocks A12/A21
    [nf, half, ml, ml] to rank-r factors (P [.., ml, r], Q [.., r, ml])
    and the level's largest rank of each front [nf]."""
    nf, half, ml, _ = A12.shape
    dt = A12.dtype
    if ml >= RSVD_MIN and r + 8 < ml:
        q = r + 8
        keys = _sketch_keys(A12, lev)

        def sketch(i):
            return torch.stack([
                draws.draw("normal", (half, ml, q), dt, gen,
                           key + ("split", i)) for key in keys])
        U12, S12, V12 = _rand_lowrank_svd(A12, sketch(0))
        U21, S21, V21 = _rand_lowrank_svd(A21, sketch(1))
    else:
        U12, S12, V12 = _svd(A12)
        U21, S21, V21 = _svd(A21)

    def trunc(U, S, Vh):
        q = S.shape[-1]
        if q < r:
            U = torch.nn.functional.pad(U, (0, r - q))
            S = torch.nn.functional.pad(S, (0, r - q))
            Vh = torch.nn.functional.pad(Vh, (0, 0, 0, r - q))
        keep = (S > tol * torch.clamp(S[..., :1], min=_tiny(dt)))[..., :r]
        P = (torch.where(keep[..., None, :], U[..., :, :r], 0)
             * torch.where(keep, S[..., :r], 0).to(dt)[..., None, :])
        Q = torch.where(keep[..., :, None], Vh[..., :r, :], 0)
        return P, Q, keep.sum(-1)

    P12, Q12, k1 = trunc(U12, S12, V12)
    P21, Q21, k2 = trunc(U21, S21, V21)
    rk = torch.maximum(k1.amax(dim=-1), k2.amax(dim=-1))
    return P12, Q12, P21, Q21, rk


class HODLRMatrix:
    """HODLR forms of ``nf`` square matrices A [nf, m, m] of one size."""

    def __init__(self, A, leaf_size=64, max_rank=None, rel_tol=1e-6):
        self.nf, self.m = A.shape[0], A.shape[-1]
        self.t = int(leaf_size)
        self.mp, self.L = _pad_pow2(self.m, self.t)
        self.r = int(max_rank) if max_rank else max(8, self.t // 2)
        self.rel_tol = rel_tol
        self.dtype = A.dtype
        self._compress(A, draws.generator(A.device, SKETCH_SEED))
        self._factored = False

    def _compress(self, A, gen):
        nf, mp, t, r, L = self.nf, self.mp, self.t, self.r, self.L
        dev = A.device
        Ap = _ident_pad(A, mp)
        nl = 2 ** L
        ar = torch.arange(nl, device=dev)
        self.D = Ap.reshape(nf, nl, t, nl, t).permute(0, 1, 3, 2, 4)[
            :, ar, ar].contiguous()
        self.P12, self.Q12, self.P21, self.Q21 = [], [], [], []
        # per level, the largest rank of each front [nf] (the JAX
        # package's rank_arrays, one per front)
        self.ranks = []
        for lev in range(L - 1, -1, -1):
            half = 2 ** lev
            ml = mp // (2 * half)
            Ar = Ap.reshape(nf, 2 * half, ml, 2 * half, ml).permute(
                0, 1, 3, 2, 4)
            i1 = 2 * torch.arange(half, device=dev)
            P12, Q12, P21, Q21, rk = _compress_level(
                Ar[:, i1, i1 + 1], Ar[:, i1 + 1, i1], r, self.rel_tol, lev,
                gen)
            self.ranks.append(rk)
            self.P12.append(P12)
            self.Q12.append(Q12)
            self.P21.append(P21)
            self.Q21.append(Q21)

    # ------------------------------------------------------------------
    def matvec(self, x):
        """y = A_hodlr x for x [nf, m, k]."""
        nf, m, mp, t, L = self.nf, self.m, self.mp, self.t, self.L
        k = x.shape[-1]
        xp = x.new_zeros((nf, mp, k))
        xp[:, :m] = x
        y = torch.matmul(self.D, xp.reshape(nf, 2 ** L, t, k)).reshape(
            nf, mp, k)
        for li, lev in enumerate(range(L - 1, -1, -1)):
            half = 2 ** lev
            xb = xp.reshape(nf, half, 2, mp // (2 * half), k)
            y12 = self.P12[li] @ (self.Q12[li] @ xb[:, :, 1])
            y21 = self.P21[li] @ (self.Q21[li] @ xb[:, :, 0])
            y = y + torch.stack([y12, y21], dim=2).reshape(nf, mp, k)
        return y[:, :m]

    # ------------------------------------------------------------------
    @torch.profiler.record_function("hodlr_smw")
    def factor(self):
        """Leaf LUs + per-level SMW capacitance factorizations."""
        nf, mp, t, r, L = self.nf, self.mp, self.t, self.r, self.L
        nl = 2 ** L
        self._leaf = _lu(self.D)
        self._smw = []

        def chain_apply(x, upto):
            """inv(A_level) x with the corrections below index ``upto``."""
            xb = _lu_solve(*self._leaf, x.reshape(nf, nl, t, -1))
            x = xb.reshape(nf, mp, -1)
            for li in range(upto):
                x = self._apply_corr(li, x)
            return x

        for li, lev in enumerate(range(L - 1, -1, -1)):
            half = 2 ** lev
            ml = mp // (2 * half)
            # U = [[P12, 0], [0, P21]] a pair; the pairs' supports are
            # disjoint, so all pairs share one [mp, 2r] right-hand side
            U = self.D.new_zeros((nf, half, 2 * ml, 2 * r))
            U[:, :, :ml, :r] = self.P12[li]
            U[:, :, ml:, r:] = self.P21[li]
            Yp = chain_apply(U.reshape(nf, mp, 2 * r), li).reshape(
                nf, half, 2 * ml, 2 * r)
            Vt = self.D.new_zeros((nf, half, 2 * r, 2 * ml))
            Vt[:, :, :r, ml:] = self.Q12[li]
            Vt[:, :, r:, :ml] = self.Q21[li]
            cap = torch.eye(2 * r, dtype=self.dtype,
                            device=Vt.device) + torch.matmul(Vt, Yp)
            caplu, capperm = _lu(cap)
            self._smw.append(dict(Y=Yp, Vt=Vt, caplu=caplu,
                                  capperm=capperm))
        self._factored = True

    def _apply_corr(self, li, x):
        s = self._smw[li]
        nf, half = s["Y"].shape[:2]
        k = x.shape[-1]
        xb = x.reshape(nf, half, s["Y"].shape[2], k)
        w = _lu_solve(s["caplu"], s["capperm"], torch.matmul(s["Vt"], xb))
        return (xb - torch.matmul(s["Y"], w)).reshape(nf, -1, k)

    def solve(self, b):
        """x = A^-1 b for b [nf, m, k]."""
        if not self._factored:
            self.factor()
        nf, m, mp, t, L = self.nf, self.m, self.mp, self.t, self.L
        k = b.shape[-1]
        x = b.new_zeros((nf, mp, k))
        x[:, :m] = b
        x = _lu_solve(*self._leaf, x.reshape(nf, 2 ** L, t, k)).reshape(
            nf, mp, k)
        for li in range(len(self._smw)):
            x = self._apply_corr(li, x)
        return x[:, :m]

    def memory(self) -> int:
        """Stored entries of one front's compressed form, counted as the
        JAX package counts them (hodlr.py:285-289): the leaf blocks and
        every level's P12, Q12, P21 and Q21 at rank r, padding included."""
        tot = sum(a.numel() for a in [self.D] + self.P12 + self.Q12
                  + self.P21 + self.Q21)
        return int(tot // self.nf)

    def max_rank(self) -> int:
        return max((int(r.max()) for r in self.ranks), default=0)
