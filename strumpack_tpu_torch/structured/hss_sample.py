"""Randomized-sampling HSS construction (matrix-free, from elements).

The counterpart of ``strumpack_tpu/structured/hss_sample.py`` (the
reference's HSSMatrix.compress.hpp / compress_stable.hpp: sketch S = A R,
Sc = A^H R, bottom-up interpolative bases with element extraction of the
D and B generators; Gaussian or SJLT sketches, HSSMatrix.sketch.hpp:260),
with a leading front axis: the closures take and return ``[nf, ...]``
tensors and every node of a level is one batch.

The adaptive d0 + k dd loop of the reference is one oversampled sketch
with masked ranks, and the interpolative decomposition is a greedy
row-pivoted orthogonalization (the ``geqp3tol`` role).  The result fills
the generators of ``hss.HSSMatrix`` and uses its ULV factorization and
solve.  ``hss_from_neighbors`` builds the same generators for a
symmetric kernel matrix from its approximate nearest neighbours.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import draws
from .hss import HSSMatrix, _pad_pow2, _tiny


def _id_rows(F, tol, r):
    """Batched greedy interpolative decomposition of the rows of
    F [N, k, d]: returns (X [N, k, r], Jloc [N, r], ranks [N]) with
    F ~= X @ F[Jloc, :].  Each step takes the residual row of largest norm
    (the first among equal norms) and deflates the residual by it."""
    N, k, d = F.shape
    tiny = _tiny(F.dtype)
    norms0 = torch.linalg.vector_norm(F, dim=-1).amax(dim=-1)     # [N]
    res = F.clone()
    Jloc = torch.zeros((N, r), dtype=torch.int64, device=F.device)
    sn = torch.zeros((N, r), dtype=norms0.dtype, device=F.device)
    for step in range(r):
        rn = torch.linalg.vector_norm(res, dim=-1)                # [N, k]
        nrm, i = torch.max(rn, dim=-1)
        Jloc[:, step] = i
        sn[:, step] = nrm
        v = torch.gather(res, 1, i[:, None, None].expand(N, 1, d))
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), min=tiny)
        coef = torch.matmul(res, v.conj().transpose(1, 2))        # [N, k, 1]
        res = res - coef * v
    ranks = (sn > tol * torch.clamp(norms0, min=tiny)[:, None]).sum(dim=1)
    rmask = torch.arange(r, device=F.device)[None, :] < ranks[:, None]
    # X = F Fj^H (Fj Fj^H + eps)^-1, masked beyond the rank
    Fj = torch.gather(F, 1, Jloc[:, :, None].expand(N, r, d))
    Fj = torch.where(rmask[:, :, None], Fj, 0)
    G = torch.matmul(Fj, Fj.conj().transpose(1, 2))
    tr = torch.diagonal(G.real, dim1=-2, dim2=-1).sum(-1)
    eps = torch.finfo(tr.dtype).eps * torch.clamp(tr, min=1.0)
    reg = eps[:, None] + (~rmask).to(tr.dtype)
    G = G + torch.diag_embed(reg.to(G.dtype))
    FFj = torch.matmul(F, Fj.conj().transpose(1, 2))              # [N, k, r]
    X = torch.linalg.solve(G.conj().transpose(1, 2),
                           FFj.conj().transpose(1, 2)).conj().transpose(1, 2)
    X = torch.where(rmask[:, None, :], X, 0)
    return X, Jloc, ranks


def _sketch(m, d, dtype, gen, seed, sketch):
    """The [m, d] sketch shared by every front: Gaussian, or a sparse
    Johnson-Lindenstrauss sketch of min(8, m) signed entries a column."""
    if sketch != "sjlt":
        return draws.draw("normal", (m, d), dtype, gen, (seed,))
    nnz_col = min(8, m)
    rows = draws.draw("randint", (d, nnz_col), None, gen,
                      (seed, "split", 0), high=m)
    signs = draws.draw("bernoulli", (d, nnz_col), None, gen,
                       (seed, "split", 1))
    R = torch.zeros((m, d), dtype=dtype, device=rows.device)
    cols = torch.arange(d, device=rows.device)[:, None].expand(d, nnz_col)
    R.index_put_((rows.reshape(-1).long(), cols.reshape(-1)),
                 torch.where(signs, 1.0, -1.0).to(dtype).reshape(-1),
                 accumulate=True)
    return R / math.sqrt(nnz_col)


def hss_from_sampling(mult, elem, m, nf, leaf_size=64, max_rank=32,
                      oversample=16, rel_tol=1e-6, dtype=torch.float32,
                      sketch="gaussian", seed=0, gen=None,
                      device=None) -> HSSMatrix:
    """HSS forms of ``nf`` matrices from a product closure and an element
    closure (StructuredMatrix construct_partially_matrix_free role).

    ``mult(X, trans)``: A X (trans False) or A^H X for X [nf, m, k];
    ``elem(I, J)``: A[f, I, J] for index tensors [nf, ...] (broadcast
    against each other).  ``gen`` serves the sketch (a generator seeded
    with ``seed`` on ``device`` by default); every front takes the same
    sketch, as in the JAX package."""
    t = int(leaf_size)
    mp, L = _pad_pow2(m, t)
    r = int(min(max_rank, t))
    d = r + oversample
    if gen is None:
        gen = draws.generator(device, seed)
    R = _sketch(m, d, dtype, gen, seed, sketch)
    dev = R.device
    Rb_all = R.expand(nf, m, d)
    S = mult(Rb_all, False)
    Sc = mult(Rb_all, True)

    def pad(M):
        out = M.new_zeros((nf, mp, M.shape[-1]))
        out[:, :m] = M
        return out

    Rp, Sp, Scp = pad(Rb_all), pad(S), pad(Sc)
    tol = rel_tol
    nl = 2 ** L
    gidx = torch.arange(nl * t, device=dev).reshape(nl, t)
    leaf_idx = torch.clamp(gidx, max=m - 1)
    in_range = gidx < m
    # leaf D blocks by element extraction (identity on the padded range)
    li = leaf_idx.expand(nf, nl, t)
    D = elem(li[..., :, None], li[..., None, :]).to(dtype)
    inr2 = in_range[:, :, None] & in_range[:, None, :]
    D = torch.where(inr2, D, torch.eye(t, dtype=dtype, device=dev))
    Rb = Rp.reshape(nf, nl, t, d)
    Floc = torch.where(in_range[:, :, None],
                       Sp.reshape(nf, nl, t, d) - torch.matmul(D, Rb), 0)
    X, Jl, rksU = _id_rows(Floc.reshape(nf * nl, t, d), tol, r)
    Gloc = torch.where(in_range[:, :, None],
                       Scp.reshape(nf, nl, t, d)
                       - torch.matmul(D.conj().transpose(-1, -2), Rb), 0)
    Y, Kl, rksV = _id_rows(Gloc.reshape(nf * nl, t, d), tol, r)

    def nodes(a, n):
        return a.reshape((nf, n) + a.shape[1:])

    X, Jl, Y, Kl = nodes(X, nl), nodes(Jl, nl), nodes(Y, nl), nodes(Kl, nl)
    Jg = torch.gather(li, 2, Jl)                        # [nf, nl, r] rows
    Kg = torch.gather(li, 2, Kl)
    Sred = torch.gather(Floc, 2, Jl[..., None].expand(-1, -1, -1, d))
    Gred = torch.gather(Gloc, 2, Kl[..., None].expand(-1, -1, -1, d))
    RredC = torch.matmul(Y.conj().transpose(-1, -2), Rb)     # Y^H R(I)
    RredR = torch.matmul(X.conj().transpose(-1, -2), Rb)     # X^H R(I)

    H = HSSMatrix.__new__(HSSMatrix)
    H.nf, H.m, H.t, H.mp, H.L, H.r = nf, m, t, mp, L, r
    H.rel_tol = rel_tol
    H.dtype = dtype
    H._factored = False
    H.D, H.Uleaf, H.Vleaf = D, X, Y
    H.ranks = [(nodes(rksU, nl), nodes(rksV, nl))]
    H.Ru, H.Rv, H.B12, H.B21 = [], [], [], []
    for lev in range(L - 1, -1, -1):
        half = 2 ** lev
        i1 = 2 * torch.arange(half, device=dev)
        i2 = i1 + 1
        B12 = elem(Jg[:, i1][..., :, None], Kg[:, i2][..., None, :]).to(dtype)
        B21 = elem(Jg[:, i2][..., :, None], Kg[:, i1][..., None, :]).to(dtype)
        H.B12.append(B12)
        H.B21.append(B21)
        if lev == 0:
            break
        Sloc = torch.cat([Sred[:, i1] - torch.matmul(B12, RredC[:, i2]),
                          Sred[:, i2] - torch.matmul(B21, RredC[:, i1])],
                         dim=2)
        Gloc = torch.cat(
            [Gred[:, i1] - torch.matmul(B21.conj().transpose(-1, -2),
                                        RredR[:, i2]),
             Gred[:, i2] - torch.matmul(B12.conj().transpose(-1, -2),
                                        RredR[:, i1])], dim=2)
        Xn, Jl2, _ = _id_rows(Sloc.reshape(nf * half, 2 * r, d), tol, r)
        Yn, Kl2, _ = _id_rows(Gloc.reshape(nf * half, 2 * r, d), tol, r)
        Xn, Jl2 = nodes(Xn, half), nodes(Jl2, half)
        Yn, Kl2 = nodes(Yn, half), nodes(Kl2, half)
        H.Ru.append(Xn)
        H.Rv.append(Yn)
        Jg = torch.gather(torch.cat([Jg[:, i1], Jg[:, i2]], dim=2), 2, Jl2)
        Kg = torch.gather(torch.cat([Kg[:, i1], Kg[:, i2]], dim=2), 2, Kl2)
        Sred = torch.gather(Sloc, 2, Jl2[..., None].expand(-1, -1, -1, d))
        Gred = torch.gather(Gloc, 2, Kl2[..., None].expand(-1, -1, -1, d))
        RredC = torch.matmul(Yn.conj().transpose(-1, -2),
                             torch.cat([RredC[:, i1], RredC[:, i2]], dim=2))
        RredR = torch.matmul(Xn.conj().transpose(-1, -2),
                             torch.cat([RredR[:, i1], RredR[:, i2]], dim=2))
    return H


def _node_neighbor_columns(ann, m, t, L, c, seed=0):
    """Per-level candidate column sets of the neighbour-built HSS, from an
    approximate-kNN graph (host numpy, as
    ``strumpack_tpu/structured/hss_sample.py:204``, the same
    ``default_rng(seed)`` draws): for each node of each level, the nearest
    neighbours of its members that lie outside it (nearest first,
    round-robin over the members), filled with random far-field columns up
    to width ``c``.  Returns {level: [n_nodes, c] int32} for levels L
    (the leaves) .. 1."""
    rng = np.random.default_rng(seed)
    ann = np.asarray(ann)
    out = {}
    for lev in range(L, 0, -1):
        w = t * 2 ** (L - lev)
        n_nodes = 2 ** lev
        cols = np.zeros((n_nodes, c), np.int32)
        for h in range(n_nodes):
            lo, hi = h * w, min((h + 1) * w, m)
            if lo >= m:
                cols[h] = rng.integers(0, m, c)
                continue
            nb = ann[lo:hi].T.ravel()          # nearest-first round-robin
            nb = nb[(nb >= 0) & ((nb < lo) | (nb >= hi))]
            # first occurrences keep the nearest-first order
            _, first = np.unique(nb, return_index=True)
            nb = nb[np.sort(first)][:c]
            k = len(nb)
            cols[h, :k] = nb
            if k < c:
                # far-field fill: random columns outside the node
                fill = rng.integers(0, max(m - (hi - lo), 1), c - k)
                fill = np.where(fill >= lo, fill + (hi - lo), fill)
                cols[h, k:] = np.minimum(fill, m - 1)
        out[lev] = cols
    return out


def hss_from_neighbors(elem, ann, m, leaf_size=64, max_rank=32, n_extra=16,
                       rel_tol=1e-6, dtype=torch.float32, seed=0,
                       device=None) -> HSSMatrix:
    """The HSS form (``nf`` = 1) of a symmetric kernel matrix from its
    approximate nearest neighbours (the reference's neighbour-search
    compression, HSSMatrix.compress_kernel.hpp;
    ``strumpack_tpu/structured/hss_sample.py:240``): each node's
    interpolative basis is the ID of its rows against its candidate
    columns (``_node_neighbor_columns``), no products and no sketch.

    ``elem(I, J)``: A[0, I, J] for index tensors [1, ...] (A real
    symmetric, K(x, y) + lam I); ``ann [m, k]``: the kNN ids in the
    clustered point order.  The V side equals the U side by symmetry."""
    t = int(leaf_size)
    mp, L = _pad_pow2(m, t)
    r = int(min(max_rank, t))
    c = max(2 * r, 32) + int(n_extra)
    cand = _node_neighbor_columns(ann, m, t, L, c, seed=seed)
    dev = torch.device("cpu" if device is None else device)
    tol = rel_tol
    nl = 2 ** L
    gidx = torch.arange(nl * t, device=dev).reshape(nl, t)
    leaf_idx = torch.clamp(gidx, max=m - 1)[None]            # [1, nl, t]
    in_range = gidx < m

    D = elem(leaf_idx[..., :, None], leaf_idx[..., None, :]).to(dtype)
    D = torch.where(in_range[:, :, None] & in_range[:, None, :], D,
                    torch.eye(t, dtype=dtype, device=dev))
    C0 = torch.as_tensor(cand[L], device=dev).long()[None]
    F = elem(leaf_idx[..., :, None], C0[..., None, :]).to(dtype)
    F = torch.where(in_range[:, :, None], F, 0)
    X, Jl, rks = _id_rows(F[0], tol, r)
    Jg = torch.gather(leaf_idx[0], 1, Jl)                   # [nl, r]

    H = HSSMatrix.__new__(HSSMatrix)
    H.nf, H.m, H.t, H.mp, H.L, H.r = 1, m, t, mp, L, r
    H.rel_tol = rel_tol
    H.dtype = dtype
    H._factored = False
    H.D = D
    H.Uleaf = X[None]
    H.Vleaf = X.conj()[None]
    H.ranks = [(rks[None], rks[None])]
    H.Ru, H.Rv, H.B12, H.B21 = [], [], [], []
    Kg = Jg
    rk = rks
    for lev in range(L - 1, -1, -1):
        half = 2 ** lev
        i1 = 2 * torch.arange(half, device=dev)
        i2 = i1 + 1
        H.B12.append(elem(Jg[i1][None, :, :, None],
                          Kg[i2][None, :, None, :]).to(dtype))
        H.B21.append(elem(Jg[i2][None, :, :, None],
                          Kg[i1][None, :, None, :]).to(dtype))
        if lev == 0:
            break
        rows2 = torch.cat([Jg[i1], Jg[i2]], dim=1)            # [half, 2r]
        # rows beyond a child's achieved rank are meaningless selections:
        # zeroed, the parent ID never picks them
        ar = torch.arange(r, device=dev)[None, :]
        rmask2 = torch.cat([ar < rk[i1][:, None], ar < rk[i2][:, None]],
                           dim=1)
        Cp = torch.as_tensor(cand[lev], device=dev).long()
        Fp = elem(rows2[None, :, :, None], Cp[None, :, None, :]).to(dtype)
        Fp = torch.where(rmask2[:, :, None], Fp[0], 0)
        Xn, Jl2, rk = _id_rows(Fp, tol, r)
        H.Ru.append(Xn[None])
        H.Rv.append(Xn.conj()[None])
        Jg = torch.gather(rows2, 1, Jl2)
        Kg = Jg
    return H
