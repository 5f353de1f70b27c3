"""HSS (hierarchically semi-separable) matrices, level-batched (PyTorch).

The counterpart of ``strumpack_tpu/structured/hss.py`` (the reference's
``HSS/HSSMatrix`` compression, ULV factorization and solve,
HSSMatrix.compress.hpp, HSSMatrix.factor.hpp:51-147,
HSSMatrix.solve.hpp), with a leading front axis in the place of the JAX
package's vmap: one ``HSSMatrix`` holds the compressed forms of ``nf``
matrices of one size, every generator a tensor ``[nf, nodes, ...]``.

* the cluster tree is a perfect binary tree over an identity-padded range
  (m padded to t * 2^L), so every level's nodes share one shape;
* bases are orthonormal with a fixed maximum rank r and masked actual
  ranks (truncated SVD at a relative tolerance);
* the ULV factorization decouples (ml - r) rows a node by full QR
  transforms, factors the decoupled block by LU and passes the Schur-
  reduced r x r block up; the root is factored dense.  The small LUs are
  ``torch.linalg.lu_factor`` with the permutation kept in applied form
  (``perm[i]`` = source row of row i), where the JAX package runs its
  unrolled TPU LU.
"""
from __future__ import annotations

import torch


def _pad_pow2(m: int, leaf: int):
    """(leaf * 2^L, L) for the smallest L with leaf * 2^L >= m."""
    L = 0
    while leaf * (2 ** L) < m:
        L += 1
    return leaf * (2 ** L), L


def _tiny(dtype):
    return torch.finfo(torch.empty((), dtype=dtype).real.dtype).tiny


def _svd(X):
    """Reduced SVD (U, S, Vh) of X [..., k, m].  A wide or tall X is first
    reduced by a QR to the square SVD of its triangle (X = R^H Q^H, or
    X = Q R): cuSOLVER's SVD of the wide HSS block rows did not converge
    and took minutes on the card, the square SVD does not."""
    k, m = X.shape[-2:]
    if m > k:
        Q, R = torch.linalg.qr(X.conj().transpose(-1, -2))
        U, S, Wh = torch.linalg.svd(R.conj().transpose(-1, -2))
        return U, S, torch.matmul(Wh, Q.conj().transpose(-1, -2))
    if k > m:
        Q, R = torch.linalg.qr(X)
        U, S, Vh = torch.linalg.svd(R)
        return torch.matmul(Q, U), S, Vh
    return torch.linalg.svd(X)


def _trunc_basis(X, tol, r):
    """Orthonormal column basis of each batched block row X [..., k, m],
    rank <= r, masked at relative tolerance ``tol``: returns
    (U [..., k, r], ranks [...]), U zero-padded when min(k, m) < r."""
    Uf, S, _ = _svd(X)
    q = S.shape[-1]
    if q < r:
        Uf = torch.nn.functional.pad(Uf, (0, r - q))
        S = torch.nn.functional.pad(S, (0, r - q))
    keep = (S > tol * torch.clamp(S[..., :1], min=_tiny(X.dtype)))[..., :r]
    U = torch.where(keep[..., None, :], Uf[..., :, :r], 0)
    return U, keep.sum(dim=-1)


def _lu(A):
    """Batched LU with partial pivoting of A [..., k, k]: (packed L\\U,
    applied-form permutation [..., k]), the pair ``jax.lax.linalg.lu``
    returns."""
    k = A.shape[-1]
    if k == 0:
        return A.clone(), torch.zeros(A.shape[:-1], dtype=torch.int64,
                                      device=A.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(A)
    P, _, _ = torch.lu_unpack(lu, piv, unpack_data=False)
    return lu, P.real.argmax(dim=-2)


def _lu_solve(lu, perm, b):
    """Solve with a packed LU and its applied-form permutation:
    b [..., k, n]."""
    if lu.shape[-1] == 0:
        return b
    bp = torch.gather(b, -2, perm[..., None].expand(
        perm.shape + (b.shape[-1],)))
    y = torch.linalg.solve_triangular(lu, bp, upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(lu, y, upper=True)


def _ident_pad(A, mp):
    """A [nf, m, m] embedded in [nf, mp, mp] with ones on the padded
    diagonal."""
    nf, m, _ = A.shape
    if mp == m:
        return A
    Ap = A.new_zeros((nf, mp, mp))
    Ap[:, :m, :m] = A
    ii = torch.arange(m, mp, device=A.device)
    Ap[:, ii, ii] = 1
    return Ap


def _blockdiag2(a, b):
    """[h, ka, ra], [h, kb, rb] (leading dims shared) -> block diagonal
    [h, ka + kb, ra + rb]."""
    out = a.new_zeros(a.shape[:-2] + (a.shape[-2] + b.shape[-2],
                                      a.shape[-1] + b.shape[-1]))
    out[..., :a.shape[-2], :a.shape[-1]] = a
    out[..., a.shape[-2]:, a.shape[-1]:] = b
    return out


def cat_fronts(objs):
    """Concatenate structured matrices of one shape along the front axis
    (the per-front results of a bucket built one front at a time)."""
    first = objs[0]
    out = first.__class__.__new__(first.__class__)

    def cat(vals):
        v0 = vals[0]
        if torch.is_tensor(v0):
            return torch.cat(vals, dim=0)
        if isinstance(v0, list):
            return [cat([v[i] for v in vals]) for i in range(len(v0))]
        if isinstance(v0, tuple):
            return tuple(cat([v[i] for v in vals]) for i in range(len(v0)))
        if isinstance(v0, dict):
            return {k: cat([v[k] for v in vals]) for k in v0}
        if hasattr(v0, "__dict__"):     # nested factor objects (HODBF)
            if hasattr(v0, "nf"):
                return cat_fronts(vals)
            o = v0.__class__.__new__(v0.__class__)
            for k in vars(v0):
                setattr(o, k, cat([getattr(v, k) for v in vals]))
            return o
        return v0
    for k, v in first.__dict__.items():
        out.__dict__[k] = cat([o.__dict__[k] for o in objs])
    out.nf = sum(o.nf for o in objs)
    return out


def tensors(obj):
    """Every tensor a structured matrix holds (generators and factors)."""
    out = []

    def walk(v):
        if torch.is_tensor(v):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif hasattr(v, "__dict__"):    # nested factor objects (HODBF)
            walk(list(vars(v).values()))
    walk(list(obj.__dict__.values()))
    return out


class HSSMatrix:
    """HSS forms of ``nf`` square matrices of one size (built from dense
    ``A [nf, m, m]``, or by ``hss_sample.hss_from_sampling``)."""

    def __init__(self, A, leaf_size=64, max_rank=None, rel_tol=1e-6):
        self.nf, self.m = A.shape[0], A.shape[-1]
        self.t = int(leaf_size)
        self.mp, self.L = _pad_pow2(self.m, self.t)
        self.r = int(max_rank) if max_rank else max(8, self.t // 2)
        self.r = min(self.r, self.t)
        self.rel_tol = rel_tol
        self.dtype = A.dtype
        self._compress(A)
        self._factored = False

    # ------------------------------------------------------------------
    def _compress(self, A):
        nf, mp, t, r, L = self.nf, self.mp, self.t, self.r, self.L
        dev = A.device
        tol = self.rel_tol
        Ap = _ident_pad(A, mp)
        nl = 2 ** L
        ar = torch.arange(nl, device=dev)
        self.D = Ap.reshape(nf, nl, t, nl, t).permute(0, 1, 3, 2, 4)[
            :, ar, ar].contiguous()                       # [nf, nl, t, t]
        # leaf row / column bases of the off-diagonal block rows
        owner = torch.arange(mp, device=dev) // t
        mask = (owner[None, :] != ar[:, None])[None, :, None, :]
        rows_off = Ap.reshape(nf, nl, t, mp) * mask
        U, rksU = _trunc_basis(rows_off, tol, r)          # [nf, nl, t, r]
        cols_off = Ap.transpose(1, 2).reshape(nf, nl, t, mp) * mask
        V, rksV = _trunc_basis(cols_off.conj(), tol, r)
        self.Uleaf, self.Vleaf = U, V
        self.ranks = [(rksU, rksV)]
        Rr = torch.einsum("fntr,fntm->fnrm", U.conj(), rows_off)
        Cc = torch.einsum("fnmt,fntr->fnmr", cols_off.transpose(-1, -2), V)
        del rows_off, cols_off
        Ubig, Vbig = U, V
        self.Ru, self.Rv, self.B12, self.B21 = [], [], [], []
        for lev in range(L - 1, -1, -1):
            nodes = 2 ** lev
            blk = mp // (2 * nodes)
            i1 = 2 * torch.arange(nodes, device=dev)
            i2 = i1 + 1
            # B generators between the two children of each node
            Rr_r = Rr.reshape(nf, 2 * nodes, r, 2 * nodes, blk).permute(
                0, 1, 3, 2, 4)
            Z12, Z21 = Rr_r[:, i1, i2], Rr_r[:, i2, i1]    # [nf, h, r, blk]
            self.B12.append(torch.einsum("fhrb,fhbs->fhrs", Z12,
                                         Vbig[:, i2]))
            self.B21.append(torch.einsum("fhrb,fhbs->fhrs", Z21,
                                         Vbig[:, i1]))
            if lev == 0:
                break
            owner = torch.arange(mp, device=dev) // (2 * blk)
            maskn = owner[None, :] != torch.arange(nodes, device=dev)[:, None]
            S = torch.cat([Rr[:, i1], Rr[:, i2]], dim=2) * maskn[None, :,
                                                                 None, :]
            Ru, _ = _trunc_basis(S, tol, r)               # [nf, h, 2r, r]
            Rr = torch.einsum("fhkr,fhkm->fhrm", Ru.conj(), S)
            T = torch.cat([Cc[:, i1], Cc[:, i2]], dim=3) * maskn[None, :, :,
                                                                 None]
            Rv, _ = _trunc_basis(T.conj().transpose(-1, -2), tol, r)
            Cc = torch.einsum("fhmk,fhkr->fhmr", T, Rv)
            self.Ru.append(Ru)
            self.Rv.append(Rv)
            # explicit big bases for the next level up
            Ubig = torch.matmul(_blockdiag2(Ubig[:, i1], Ubig[:, i2]), Ru)
            Vbig = torch.matmul(_blockdiag2(Vbig[:, i1], Vbig[:, i2]), Rv)

    # ------------------------------------------------------------------
    def matvec(self, x):
        """y = A_hss x for x [nf, m, k]."""
        nf, m, mp, t, r, L = self.nf, self.m, self.mp, self.t, self.r, self.L
        dev = x.device
        k = x.shape[-1]
        xp = x.new_zeros((nf, mp, k))
        xp[:, :m] = x
        nl = 2 ** L
        xb = xp.reshape(nf, nl, t, k)
        y = torch.matmul(self.D, xb)
        g = torch.matmul(self.Vleaf.conj().transpose(-1, -2), xb)
        gs = [g]
        for lev in range(L - 1, 0, -1):
            i1 = 2 * torch.arange(2 ** lev, device=dev)
            stacked = torch.cat([g[:, i1], g[:, i1 + 1]], dim=2)
            g = torch.matmul(self.Rv[L - 1 - lev].conj().transpose(-1, -2),
                             stacked)
            gs.append(g)
        f = None
        for lev in range(0, L):
            half = 2 ** lev
            gl = gs[L - 1 - lev]
            i1 = 2 * torch.arange(half, device=dev)
            i2 = i1 + 1
            fnew = x.new_zeros((nf, 2 * half, r, k))
            fnew[:, i1] = torch.matmul(self.B12[L - 1 - lev], gl[:, i2])
            fnew[:, i2] = torch.matmul(self.B21[L - 1 - lev], gl[:, i1])
            if f is not None:
                fpar = torch.matmul(self.Ru[L - 1 - lev], f)
                fnew[:, i1] += fpar[:, :, :r]
                fnew[:, i2] += fpar[:, :, r:]
            f = fnew
        if f is not None:
            y = y + torch.matmul(self.Uleaf, f)
        return y.reshape(nf, mp, k)[:, :m]

    # ------------------------------------------------------------------
    @torch.profiler.record_function("hss_ulv")
    def factor(self):
        """ULV factorization (HSSMatrix.factor.hpp role)."""
        nf, r, L = self.nf, self.r, self.L
        D, U, V = self.D, self.Uleaf, self.Vleaf
        dev = D.device
        self._ulv = []
        for lev in range(L, 0, -1):
            Qu, RU = torch.linalg.qr(U, mode="complete")   # U = Qu [RU; 0]
            Qv, RV = torch.linalg.qr(V, mode="complete")
            Dp = Qu.conj().transpose(-1, -2) @ D @ Qv
            D11, D12 = Dp[..., :r, :r], Dp[..., :r, r:]
            D21, D22 = Dp[..., r:, :r], Dp[..., r:, r:]
            lu22, p22 = _lu(D22.contiguous())
            X = _lu_solve(lu22, p22, D21)
            Dred = D11 - torch.matmul(D12, X)
            Uhat, Vhat = RU[..., :r, :], RV[..., :r, :]
            self._ulv.append(dict(Qu=Qu, Qv=Qv, D12=D12.contiguous(),
                                  D21=D21.contiguous(), lu22=lu22, p22=p22))
            half = 2 ** (lev - 1)
            i1 = 2 * torch.arange(half, device=dev)
            i2 = i1 + 1
            B12, B21 = self.B12[L - lev], self.B21[L - lev]
            Dn = D.new_zeros((nf, half, 2 * r, 2 * r))
            Dn[..., :r, :r] = Dred[:, i1]
            Dn[..., r:, r:] = Dred[:, i2]
            Dn[..., :r, r:] = Uhat[:, i1] @ B12 @ Vhat[:, i2].conj(
            ).transpose(-1, -2)
            Dn[..., r:, :r] = Uhat[:, i2] @ B21 @ Vhat[:, i1].conj(
            ).transpose(-1, -2)
            D = Dn
            if lev > 1:
                U = torch.matmul(_blockdiag2(Uhat[:, i1], Uhat[:, i2]),
                                 self.Ru[L - lev])
                V = torch.matmul(_blockdiag2(Vhat[:, i1], Vhat[:, i2]),
                                 self.Rv[L - lev])
        self._root = _lu(D)
        self._factored = True

    # ------------------------------------------------------------------
    def solve(self, b):
        """x = A^-1 b through the ULV factorization; b [nf, m, k]."""
        if not self._factored:
            self.factor()
        nf, m, mp, t, r, L = self.nf, self.m, self.mp, self.t, self.r, self.L
        dev = b.device
        k = b.shape[-1]
        bp = b.new_zeros((nf, mp, k))
        bp[:, :m] = b
        bl = bp.reshape(nf, 2 ** L, t, k)
        stack = []
        for lev in range(L, 0, -1):
            s = self._ulv[L - lev]
            bq = torch.matmul(s["Qu"].conj().transpose(-1, -2), bl)
            btop, bbot = bq[..., :r, :], bq[..., r:, :]
            w = _lu_solve(s["lu22"], s["p22"], bbot)
            btop = btop - torch.matmul(s["D12"], w)
            stack.append(w)
            i1 = 2 * torch.arange(2 ** (lev - 1), device=dev)
            bl = torch.cat([btop[:, i1], btop[:, i1 + 1]], dim=2)
        y = _lu_solve(*self._root, bl)                   # [nf, 1, mroot, k]
        for lev in range(1, L + 1):
            s = self._ulv[L - lev]
            half = 2 ** (lev - 1)
            i1 = 2 * torch.arange(half, device=dev)
            rr = y.shape[2] // 2
            ytop = y.new_empty((nf, 2 * half, rr, k))
            ytop[:, i1] = y[:, :, :rr]
            ytop[:, i1 + 1] = y[:, :, rr:]
            w = stack[L - lev]
            ybot = w - _lu_solve(s["lu22"], s["p22"],
                                 torch.matmul(s["D21"], ytop))
            y = torch.matmul(s["Qv"], torch.cat([ytop, ybot], dim=2))
        return y.reshape(nf, mp, k)[:, :m]

    # ------------------------------------------------------------------
    def memory(self) -> int:
        """Stored entries of one front's compressed form, counted as the
        JAX package counts them (hss.py:313-318): D, the leaf bases and
        every level's Ru, Rv, B12 and B21, padding to the power-of-two
        tree and to r included."""
        tot = sum(a.numel() for a in [self.D, self.Uleaf, self.Vleaf]
                  + self.Ru + self.Rv + self.B12 + self.B21)
        return int(tot // self.nf)

    def max_rank(self) -> int:
        rU, rV = self.ranks[0]
        return int(max(int(rU.max()), int(rV.max())))
