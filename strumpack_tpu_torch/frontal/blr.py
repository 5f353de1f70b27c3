"""BLR (block low-rank) front factorization, level-batched (PyTorch).

The counterpart of ``strumpack_tpu/frontal/blr.py`` (the reference's
``BLRMatrix.cpp:740-1245`` construct_and_partial_factor and
``FrontBLR.cpp:329``): fixed tile size ``t``, fixed maximum rank ``r`` with
masked actual ranks, and the tiles of a whole block row/column of every
front in the bucket processed together as batched ``[nf, nt, t, t]``
operations.

* the diagonal tile LU goes through ``ops/panel_lu.batched_lu``: kernel K2
  for tiles up to 64, the blocked LU over kernel K4 above;
* tile compression is ``ops/rrqr.rrqr`` (tolerance-stopped pivoted QR,
  the reference's default), adaptive cross approximation
  (``ops/aca.aca``/``baca``) or a truncated SVD;
* triangular solves, tile GEMMs and einsums are library calls
  (``torch.linalg.solve_triangular``, ``torch.einsum``), as the JAX
  package leaves them to XLA;
* within-tile partial pivoting, no cross-tile pivoting (as the reference);
  the Schur complement (CB) is updated dense.
"""
from __future__ import annotations

import torch

from ..ops.panel_lu import batched_lu


def choose_tile(s_pad: int, u_pad: int, leaf: int) -> int:
    """Largest tile size <= leaf dividing both padded dims, preferring a
    tiling with at least TWO separator tiles: a single-tile "BLR" front
    is a dense front in disguise."""
    if s_pad >= 128:
        for t in (256, 192, 128, 96, 64, 48, 32, 24, 16, 8, 4):
            if (t <= leaf and s_pad % t == 0 and s_pad // t >= 2
                    and (u_pad % t == 0 or u_pad == 0)):
                return t
    for t in (256, 192, 128, 96, 64, 48, 32, 24, 16, 8, 4):
        if t <= leaf and s_pad % t == 0 and (u_pad % t == 0 or u_pad == 0):
            return t
    return max(s_pad, 1)


def _compress_tiles(T, tol, r, algo="rrqr"):
    """Batched low-rank tile compression at relative tolerance.

    Returns (U [..., t, r], V [..., r, t], ranks [...]) with columns beyond
    the numerical rank zero-masked (BLROptions rel_tol semantics)."""
    if algo == "rrqr":
        from ..ops.rrqr import rrqr
        return rrqr(T, tol, r)
    if algo == "aca":
        from ..ops.aca import aca
        return aca(T, tol, r)
    if algo == "baca":
        from ..ops.aca import baca
        return baca(T, tol, r)
    Uf, S, Vh = torch.linalg.svd(T, full_matrices=False)
    s0 = S[..., :1]
    keep = S > tol * torch.clamp(s0, min=torch.finfo(S.dtype).tiny)
    keep = keep[..., :r]
    Sk = torch.where(keep, S[..., :r], 0.0)
    U = Uf[..., :, :r] * Sk[..., None, :].to(Uf.dtype)
    V = torch.where(keep[..., :, None], Vh[..., :r, :], 0.0)
    return U, V, keep.sum(dim=-1)


def blr_factor_bucket(F, thresh, tol, t, r, nts, nt, adm_band=0,
                      variant="rl", lr_algo="rrqr"):
    """Batched BLR partial factorization of [nf, p, p] fronts.

    Tiles: nt x nt of size t (p = nt*t); the leading nts tiles are the
    separator block (eliminated), the rest the Schur part.  Returns
      lud   [nf, nts, t, t]      packed tile LU factors (diagonal tiles)
      perm  [nf, nts, t]         per-tile row permutations
      Uu,Vu [nf, nts, nt, t|r..] compressed U-side tiles (block rows,
                                 cols j>k+adm_band; other slots are zero)
      Ul,Vl [nf, nts, nt, ...]   compressed L-side tiles (block cols)
      Du,Dl [nf, nts, t, t]      dense band tiles at distance 1 from the
                                 diagonal (strong admissibility; empty
                                 when adm_band=0)
      CB    [nf, u, u]           dense Schur complement
      ranks [nf, nts, nt, 2]     actual tile ranks (stats)

    ``variant`` "rl" is right-looking (each step applies its rank-r update
    to the trailing tiles); "ll" is left-looking with LUAR-style
    accumulation (block row/col k receives the k accumulated updates at
    its turn, the Schur block all nts at once); "ll" needs weak
    admissibility and falls back to "rl" otherwise."""
    nf, p, _ = F.shape
    dt, dev = F.dtype, F.device
    tiles = F.reshape(nf, nt, t, nt, t).permute(0, 1, 3, 2, 4).contiguous()
    band = adm_band if nt > 1 else 0
    ll = variant == "ll" and band == 0 and nts > 0
    lud = torch.zeros((nf, nts, t, t), dtype=dt, device=dev)
    perms = torch.zeros((nf, nts, t), dtype=torch.int64, device=dev)
    Uu = torch.zeros((nf, nts, nt, t, r), dtype=dt, device=dev)
    Vu = torch.zeros((nf, nts, nt, r, t), dtype=dt, device=dev)
    Ul = torch.zeros_like(Uu)
    Vl = torch.zeros_like(Vu)
    Du = torch.zeros((nf, nts, t, t) if band else (nf, nts, 0, 0),
                     dtype=dt, device=dev)
    Dl = torch.zeros_like(Du)
    rk = torch.zeros((nf, nts, nt, 2), dtype=torch.int64, device=dev)

    for k in range(nts):
        if ll:
            if k == 0:
                rowk = tiles[:, 0]                     # [nf, nt, t, t]
                colk = tiles[:, :, 0]
            else:
                # accumulated low-rank updates of steps m < k to block row
                # k and block column k, one contraction each (LUAR)
                midr = torch.einsum("fmat,fmjtb->fmjab", Vl[:, :k, k],
                                    Uu[:, :k])
                rowk = tiles[:, k] - torch.einsum(
                    "fmta,fmjab,fmjbs->fjts", Ul[:, :k, k], midr, Vu[:, :k])
                midc = torch.einsum("fmiat,fmtb->fmiab", Vl[:, :k],
                                    Uu[:, :k, k])
                colk = tiles[:, :, k] - torch.einsum(
                    "fmita,fmiab,fmbs->fits", Ul[:, :k], midc, Vu[:, :k, k])
            Akk = rowk[:, k]
        else:
            rowk = tiles[:, k]
            colk = tiles[:, :, k]
            Akk = tiles[:, k, k]
        lu, perm = batched_lu(Akk.contiguous(), thresh)
        lud[:, k] = lu
        perms[:, k] = perm

        lub = lu[:, None].expand(nf, nt, t, t)
        # block row k: W = L^-1 P A[k, j]; block col k: Z = A[i, k] U^-1
        rowk = torch.gather(rowk, 2, perm[:, None, :, None].expand(
            nf, nt, t, t))
        W = torch.linalg.solve_triangular(lub, rowk, upper=False,
                                          unitriangular=True)
        Z = torch.linalg.solve_triangular(lub, colk, upper=True, left=False)

        # compress the eliminated block row/col tiles j >= j0 = k+band+1;
        # the other slots stay zero.  (The JAX package compresses all nt
        # tiles and masks; only the kept ones are compressed here, which
        # gives the same factors and lets RRQR stop at their ranks.)
        j0 = k + band + 1
        rmax = 0
        if j0 < nt:
            Uu[:, k, j0:], Vu[:, k, j0:], rw = _compress_tiles(
                W[:, j0:], tol, r, algo=lr_algo)
            Ul[:, k, j0:], Vl[:, k, j0:], rz = _compress_tiles(
                Z[:, j0:], tol, r, algo=lr_algo)
            rk[:, k, j0:, 0] = rw
            rk[:, k, j0:, 1] = rz
            rmax = int(torch.maximum(rw.max(), rz.max()))
        Uw, Vw, Uz, Vz = Uu[:, k], Vu[:, k], Ul[:, k], Vl[:, k]

        if not ll and rmax:
            # trailing update: A[i,j] -= Z_i W_j = Uz_i (Vz_i Uw_j) Vw_j on
            # the tiles i, j >= j0 (the only nonzero terms), at the
            # largest tile rank of the step (columns beyond it are zero)
            Uzr, Vzr = Uz[:, j0:, :, :rmax], Vz[:, j0:, :rmax]
            Uwr, Vwr = Uw[:, j0:, :, :rmax], Vw[:, j0:, :rmax]
            mid = torch.einsum("fiab,fjbc->fijac", Vzr, Uwr)
            tiles[:, j0:, j0:] -= torch.einsum(
                "fijtb,fjbs->fijts",
                torch.einsum("fita,fijab->fijtb", Uzr, mid), Vwr)

        if band and k + 1 < nt:
            # strong admissibility: the distance-1 tiles stay dense; their
            # trailing-update contributions are applied densely
            Wd = W[:, k + 1]
            Zd = Z[:, k + 1]
            Du[:, k] = Wd
            Dl[:, k] = Zd
            vzw = torch.einsum("fiab,fbs->fias", Vz, Wd)
            tiles[:, :, k + 1] -= torch.einsum("fita,fias->fits", Uz, vzw)
            zu = torch.einsum("fta,fjar->fjtr", Zd, Uw)
            tiles[:, k + 1, :] -= torch.einsum("fjtr,fjrs->fjts", zu, Vw)
            tiles[:, k + 1, k + 1] -= torch.matmul(Zd, Wd)
    cb_tiles = tiles[:, nts:, nts:]
    if ll and nt > nts:
        # LUAR: the Schur block receives all nts accumulated updates as
        # one contraction over the (step, rank) axes
        mid = torch.einsum("fmiat,fmjtb->fmijab", Vl[:, :, nts:],
                           Uu[:, :, nts:])
        cb_tiles = cb_tiles - torch.einsum(
            "fmita,fmijab,fmjbs->fijts", Ul[:, :, nts:], mid, Vu[:, :, nts:])
    CB = cb_tiles.permute(0, 1, 3, 2, 4).reshape(
        nf, (nt - nts) * t, (nt - nts) * t).contiguous()
    return lud, perms, Uu, Vu, Ul, Vl, Du, Dl, CB, rk


def blr_fwd_bucket(lud, perms, Ul, Vl, Dl, bloc, t, nts, nt, adm_band=0):
    """Forward solve with BLR factors: y_k = Lkk^-1 P_k (b_k - updates);
    then subtract column-k low-rank contributions from the rows below
    (plus the dense band tile under strong admissibility).
    bloc: [nf, p, nrhs].  Returns (y [nf, s, nrhs], cbv [nf, u, nrhs])."""
    nf, p, nrhs = bloc.shape
    band = adm_band if nt > 1 else 0
    bt = bloc.reshape(nf, nt, t, nrhs).clone()
    ys = []
    for k in range(nts):
        bk = torch.gather(bt[:, k], 1,
                          perms[:, k, :, None].expand(nf, t, nrhs))
        y = torch.linalg.solve_triangular(lud[:, k], bk, upper=False,
                                          unitriangular=True)
        ys.append(y)
        # b_i -= Ul[k,i] (Vl[k,i] y)  for i > k (masked slots are zero)
        vy = torch.einsum("fiat,ftr->fiar", Vl[:, k], y)
        bt -= torch.einsum("fita,fiar->fitr", Ul[:, k], vy)
        if band and k + 1 < nt:
            bt[:, k + 1] -= torch.matmul(Dl[:, k], y)
    y = (torch.cat(ys, dim=1) if ys
         else bloc.new_zeros((nf, 0, nrhs)))
    cbv = bt[:, nts:].reshape(nf, (nt - nts) * t, nrhs)
    return y, cbv


def blr_bwd_bucket(lud, Uu, Vu, Du, y, xupd, t, nts, nt, adm_band=0):
    """Backward solve: x_k = Ukk^-1 (y_k - sum_{j>k} T[k,j] x_j).
    xupd: [nf, u, nrhs] solved ancestor values.  Returns x_sep."""
    nf, _, nrhs = y.shape
    band = adm_band if nt > 1 else 0
    xt = torch.cat([y.new_zeros((nf, nts * t, nrhs)), xupd],
                   dim=1).reshape(nf, nt, t, nrhs)
    yt = y.reshape(nf, nts, t, nrhs)
    for k in range(nts - 1, -1, -1):
        # rhs_k = y_k - sum_j Uu[k,j] (Vu[k,j] x_j)
        vx = torch.einsum("fjat,fjtr->fjar", Vu[:, k], xt)
        rhs = yt[:, k] - torch.einsum("fjta,fjar->ftr", Uu[:, k], vx)
        if band and k + 1 < nt:
            rhs = rhs - torch.matmul(Du[:, k], xt[:, k + 1])
        xt[:, k] = torch.linalg.solve_triangular(lud[:, k], rhs, upper=True)
    return xt[:, :nts].reshape(nf, nts * t, nrhs)
