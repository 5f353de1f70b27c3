"""Butterfly factorization of complementary-low-rank matrices (PyTorch).

The counterpart of ``strumpack_tpu/structured/butterfly.py`` (the role of
the reference's ``HODLR/ButterflyMatrix``, ButterflyPACK's butterfly
representation of oscillatory operators; Li et al. 2015).  A matrix
A [m, n] (m = br 2^D, n = bc 2^D, D even) whose blocks pairing a row node
at level l with a column node at level D - l have rank <= r is stored as

* row side: leaf bases Uleaf [2^D, br, r] and transfer tensors
  Tr[l] [2^l, 2^(D-l), 2r, r] for l = D-1 .. D/2;
* column side: Vleaf [2^D, bc, r] and Tv[l] likewise (from A^H);
* the mid-level core B [2^(D/2), 2^(D/2), r, r].

Every array carries any number of leading batch axes where the JAX
package vmaps over a batch of blocks (the level pairs of a HODBF matrix,
the fronts of a bucket): ``bf_compress`` of A [..., m, n] gives
generators [..., 2^D, br, r] and so on, and ``bf_matvec`` applies them to
x [..., n, k].  Ranks are masked below the fixed cap r (truncated SVDs at
a relative tolerance), so shapes depend on (m, n, D, r) alone.  The
randomized construction ``bf_compress_rand`` samples the operator through
``structured/draws.draw``, named by the JAX package's keys.
"""
from __future__ import annotations

import torch

from . import draws
from .hss import _trunc_basis


def bf_depth(m: int, leaf_size=None) -> int:
    """Deepest even butterfly depth keeping leaves >= min(16, leaf_size)."""
    min_leaf = min(16, leaf_size or 16)
    D = 0
    while m % (2 ** (D + 2)) == 0 and (m // (2 ** (D + 2))) >= min_leaf:
        D += 2
    return D


def bf_depth2(m: int, n: int, leaf_size=None) -> int:
    """Even butterfly depth usable by a rectangular [m, n] block: both
    sides split into 2^D blocks with leaves >= min(16, leaf_size)."""
    min_leaf = min(16, leaf_size or 16)
    D = 0
    while (m % (2 ** (D + 2)) == 0 and n % (2 ** (D + 2)) == 0
           and min(m, n) // (2 ** (D + 2)) >= min_leaf):
        D += 2
    return D


def _tp(x, *order):
    """Permute the trailing ``len(order)`` axes of x, batch axes kept."""
    nb = x.dim() - len(order)
    return x.permute(*range(nb), *(nb + o for o in order))


def _ident_leaf(lead, nl, b, r, dtype, device):
    """Identity leaf bases padded to rank r (blocks of b <= r rows)."""
    U = torch.zeros(lead + (nl, b, r), dtype=dtype, device=device)
    U[..., :, :, :b] = torch.eye(b, dtype=dtype, device=device)
    return U, torch.full(lead + (nl,), b, dtype=torch.int64, device=device)


def _col_bases(Vleaf, Tv, n, D, r):
    """The explicit mid-level column bases Vbig [..., 2^h (col j),
    2^h (row i), n / 2^h, r] from the column side's leaves and
    transfers."""
    h = D // 2
    lead = Vleaf.shape[:-3]
    Vbig = Vleaf[..., :, None, :, :]
    for l in range(D - 1, h - 1, -1):
        ni, nj = 2 ** l, 2 ** (D - l)
        blk = n // (2 ** (l + 1))
        Vp = Vbig.reshape(lead + (ni, 2, nj // 2, blk, r))
        Tl = Tv[l]
        bd = Vbig.new_zeros(lead + (ni, nj // 2, 2 * blk, 2 * r))
        bd[..., :blk, :r] = Vp[..., :, 0, :, :, :]
        bd[..., blk:, r:] = Vp[..., :, 1, :, :, :]
        bd = torch.repeat_interleave(bd, 2, dim=-3)
        Vbig = torch.einsum("...ijkr,...ijrs->...ijks", bd, Tl)
    return Vbig


def bf_compress(A, D: int, r: int, tol):
    """Butterfly-compress A [..., m, n] (m = br 2^D, n = bc 2^D, D even)
    at max rank r and relative tolerance ``tol``.  Returns the dict
    {Uleaf, Vleaf, B, Tr: {l: T}, Tv: {l: T}, rkU, rkV}."""
    m, n = A.shape[-2:]
    lead = A.shape[:-2]
    h = D // 2
    nl = 2 ** D

    def sweep(M):
        rows, cols = M.shape[-2:]
        b = rows // nl
        blocks = M.reshape(lead + (nl, b, cols))
        if r >= b:
            U, rk = _ident_leaf(lead, nl, b, r, M.dtype, M.device)
            R = M.new_zeros(lead + (nl, r, cols))
            R[..., :b, :] = blocks
        else:
            U, rk = _trunc_basis(blocks, tol, r)
            R = torch.einsum("...nbr,...nbm->...nrm", U.conj(), blocks)
        R = R[..., :, None, :, :]       # [.., 2^l, 2^(D-l), r, cols_l]
        Ts = {}
        for l in range(D - 1, h - 1, -1):
            ni, nj = 2 ** l, 2 ** (D - l)
            C2 = cols // nj
            Rp = R.reshape(lead + (ni, 2, nj // 2, r, 2, C2))
            S = _tp(Rp, 0, 2, 4, 1, 3, 5).reshape(lead + (ni, nj, 2 * r, C2))
            T, _ = _trunc_basis(S, tol, r)
            R = torch.einsum("...ijkr,...ijkc->...ijrc", T.conj(), S)
            Ts[l] = T
        return U, Ts, R, rk

    Uleaf, Tr, Rrow, rkU = sweep(A)
    Vleaf, Tv, _, rkV = sweep(A.conj().transpose(-1, -2))
    Vbig = _col_bases(Vleaf, Tv, n, D, r)
    B = torch.einsum("...ijrc,...jics->...ijrs", Rrow, Vbig)
    return dict(Uleaf=Uleaf, Vleaf=Vleaf, B=B, Tr=Tr, Tv=Tv, rkU=rkU,
                rkV=rkV)


def _randn(key, shape, dtype, gen):
    """Gaussian test matrix of ``dtype`` (complex: both parts scaled by
    sqrt(1/2)), the JAX package's ``_randn`` at ``key``."""
    return draws.draw("normal", shape, dtype, gen, key)


def _blockdiag_cols(OmB):
    """Per-partner test blocks OmB [nj, C2, k] as one block-diagonal sample
    matrix [nj C2, nj k] (columns j-major), so one operator application
    samples every partner's column block."""
    nj, C2, k = OmB.shape
    eye = torch.eye(nj, dtype=OmB.dtype, device=OmB.device)
    return torch.einsum("jck,jJ->jcJk", OmB, eye).reshape(nj * C2, nj * k)


def bf_compress_rand(matvec, rmatvec, m, n, D: int, r: int, tol, key=None,
                     oversample: int = 8, dtype=None, gen=None, lead=(),
                     device=None):
    """Butterfly-compress a black-box operator from products only
    (``strumpack_tpu/structured/butterfly.py:136-242``; the role of
    ButterflyPACK's matvec-driven construction).  ``matvec(X)`` maps
    X [*lead, n, k] to A X [*lead, m, k], ``rmatvec`` Y [*lead, m, k] to
    A^H Y; the test matrices are shared by the ``lead`` batch (the JAX
    package's vmap draws the same keys for every member).  Per transfer
    level the partner column nodes are sampled at once by one
    block-diagonal Gaussian test matrix, the samples projected into the
    child coordinates by replaying the leaf-basis and transfer chain; the
    mid-level core is fit by least squares against a fresh sample round.
    Returns the dict of ``bf_compress``."""
    assert D >= 2 and D % 2 == 0
    h = D // 2
    nl = 2 ** D
    assert m % nl == 0 and n % nl == 0
    lead = tuple(lead)
    if key is None:
        key = (0,)
    if gen is None:
        gen = draws.generator(device or "cpu", 0)
    k = r + oversample

    def leaf_basis(blocks, b):
        if r >= b:
            return _ident_leaf(lead, nl, b, r, dtype, blocks.device)
        return _trunc_basis(blocks, tol, r)

    def chain(Yp, U, Ts, stop_l, nj):
        """Raw samples Yp [*lead, rows, nj, k] in level-``stop_l``
        compressed coordinates: [*lead, 2^stop_l, nj, r, k]."""
        rows = Yp.shape[-3]
        b = rows // nl
        c = torch.einsum("...nbr,...nbjk->...njrk", U.conj(),
                         Yp.reshape(lead + (nl, b, nj, k)))
        for t in range(D - 1, stop_l - 1, -1):
            ni_t, nj_t = 2 ** t, 2 ** (D - t)
            cp = c.reshape(lead + (ni_t, 2, nj, r, k))
            stacked = torch.cat([cp[..., :, 0, :, :, :],
                                 cp[..., :, 1, :, :, :]], dim=-2)
            Te = torch.repeat_interleave(Ts[t], nj // nj_t, dim=-3)
            c = torch.einsum("...ijkr,...ijkc->...ijrc", Te.conj(), stacked)
        return c

    def apply(mv, X):
        return mv(X.expand(lead + X.shape))

    def sampled_sweep(mv, rows, cols, key):
        b = rows // nl
        key, sk = draws.split(key)
        Y = apply(mv, _randn(sk, (cols, k), dtype, gen))
        U, rk = leaf_basis(Y.reshape(lead + (nl, b, k)), b)
        Ts = {}
        for l in range(D - 1, h - 1, -1):
            ni, nj = 2 ** l, 2 ** (D - l)
            C2 = cols // nj
            key, sk = draws.split(key)
            OmB = _randn(sk, (nj, C2, k), dtype, gen)
            Y = apply(mv, _blockdiag_cols(OmB))
            c = chain(Y.reshape(lead + (rows, nj, k)), U, Ts, l + 1, nj)
            S = _tp(c.reshape(lead + (ni, 2, nj, r, k)), 0, 2, 1, 3, 4)
            T, _ = _trunc_basis(S.reshape(lead + (ni, nj, 2 * r, k)), tol, r)
            Ts[l] = T
        return U, Ts, rk, key

    Uleaf, Tr, rkU, key = sampled_sweep(matvec, m, n, key)
    Vleaf, Tv, rkV, key = sampled_sweep(rmatvec, n, m, key)
    Vbig = _col_bases(Vleaf, Tv, n, D, r)

    # a fresh sample round at the mid level fits the core
    njh = 2 ** h
    Ch = n // njh
    key, sk = draws.split(key)
    OmB = _randn(sk, (njh, Ch, k), dtype, gen)
    Y = apply(matvec, _blockdiag_cols(OmB))
    Rs = chain(Y.reshape(lead + (m, njh, k)), Uleaf, Tr, h, njh)
    W = torch.einsum("...jibr,jbk->...jirk", Vbig.conj(), OmB)
    G = torch.einsum("...jirk,...jisk->...jirs", W, W.conj())
    Brhs = torch.einsum("...ijrk,...jisk->...ijrs", Rs, W.conj())
    dg = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1).abs()
    eps = (1e-10 * torch.clamp(dg, min=1.0) / r)[..., None, None]
    eye = torch.eye(r, dtype=dtype, device=G.device)
    Ginv = torch.linalg.inv(G + eps * eye)
    B = torch.einsum("...ijrs,...jist->...ijrt", Brhs, Ginv)
    return dict(Uleaf=Uleaf, Vleaf=Vleaf, B=B, Tr=Tr, Tv=Tv, rkU=rkU,
                rkV=rkV)


def bf_compress_rand_adaptive(matvec, rmatvec, m, n, D: int, r0: int, tol,
                              key=None, vtol=None, rmax=None,
                              oversample: int = 8, probes: int = 4,
                              dtype=None, gen=None, lead=(), device=None):
    """Adaptive-rank randomized butterfly compression
    (``strumpack_tpu/structured/butterfly.py:245-275``): compress at rank
    r, check against ``probes`` fresh products, and double r until the
    relative probe error meets ``vtol`` (default 30 tol) or r reaches
    ``rmax`` (default: the rank at which the core is as large as the
    block).  The error is taken over the whole ``lead`` batch.  Returns
    (dict, rank, probe error)."""
    if key is None:
        key = (0,)
    if gen is None:
        gen = draws.generator(device or "cpu", 0)
    if rmax is None:
        rmax = max(r0, min(m, n) // (2 ** (D // 2)))
    if vtol is None:
        vtol = 30.0 * float(tol)
    r = min(r0, rmax)
    while True:
        key, kc, kv = draws.split(key, 3)
        bf = bf_compress_rand(matvec, rmatvec, m, n, D, r, tol, key=kc,
                              oversample=oversample, dtype=dtype, gen=gen,
                              lead=lead, device=device)
        X = _randn(kv, (n, probes), dtype, gen).expand(tuple(lead)
                                                       + (n, probes))
        Y = matvec(X)
        err = float(torch.linalg.vector_norm(bf_matvec(bf, X, D, r) - Y)
                    / max(float(torch.linalg.vector_norm(Y)), 1e-300))
        if err <= vtol or r >= rmax:
            return bf, r, err
        r = min(2 * r, rmax)


def bf_matvec(bf, x, D: int, r: int):
    """Apply a butterfly factorization to x [..., n, k] -> [..., m, k]."""
    h = D // 2
    nl = 2 ** D
    m = bf["Uleaf"].shape[-3] * bf["Uleaf"].shape[-2]
    bc = bf["Vleaf"].shape[-2]
    lead = x.shape[:-2]
    k = x.shape[-1]
    # column-side upsweep: c[j, i] = V_{j,i}^H x(cols_j)
    c = torch.einsum("...nbr,...nbk->...nrk", bf["Vleaf"].conj(),
                     x.reshape(lead + (nl, bc, k)))[..., :, None, :, :]
    for l in range(D - 1, h - 1, -1):
        ni, nj = 2 ** l, 2 ** (D - l)
        cp = c.reshape(lead + (ni, 2, nj // 2, r, k))
        stacked = torch.cat([cp[..., :, 0, :, :, :], cp[..., :, 1, :, :, :]],
                            dim=-2)
        stacked = torch.repeat_interleave(stacked, 2, dim=-3)
        c = torch.einsum("...ijkr,...ijkc->...ijrc", bf["Tv"][l].conj(),
                         stacked)
    # mid: d[i, j] = B[i, j] c[j, i]
    e = torch.einsum("...ijrs,...jisk->...ijrk", bf["B"], c)
    # row-side downsweep
    for l in range(h, D):
        ni, nj = 2 ** l, 2 ** (D - l)
        w = torch.einsum("...ijkr,...ijrc->...ijkc", bf["Tr"][l], e)
        w = w.reshape(lead + (ni, nj // 2, 2, 2, r, k)).sum(dim=-4)
        e = _tp(w, 0, 2, 1, 3, 4).reshape(lead + (2 * ni, nj // 2, r, k))
    y = torch.einsum("...nbr,...nrk->...nbk", bf["Uleaf"],
                     e[..., :, 0, :, :])
    return y.reshape(lead + (m, k))


def bf_rmatvec(bf, y, D: int, r: int):
    """Apply the conjugate transpose, y [..., m, k] -> A^H y: the row and
    column sides swap and the core is conjugate-transposed."""
    swapped = dict(Uleaf=bf["Vleaf"], Vleaf=bf["Uleaf"],
                   B=_tp(bf["B"], 1, 0, 3, 2).conj(), Tr=bf["Tv"],
                   Tv=bf["Tr"], rkU=bf["rkV"], rkV=bf["rkU"])
    return bf_matvec(swapped, y, D, r)


def bf_memory(bf) -> int:
    """Values a butterfly (batch) holds."""
    tot = bf["Uleaf"].numel() + bf["Vleaf"].numel() + bf["B"].numel()
    for T in list(bf["Tr"].values()) + list(bf["Tv"].values()):
        tot += T.numel()
    return int(tot)


def bf_max_rank(bf) -> int:
    """Largest masked rank of the leaf bases."""
    return int(max(int(bf["rkU"].max()), int(bf["rkV"].max())))


class ButterflyMatrix:
    """A dense A [..., m, n] butterfly-compressed (the reference's
    ButterflyMatrix): depth from ``bf_depth2`` unless ``levels`` is
    given, rank cap ``max_rank`` (it may exceed the leaf size: leaves then
    use identity-padded bases)."""

    def __init__(self, A, levels=None, leaf_size=None, max_rank=16,
                 rel_tol=1e-8):
        m, n = A.shape[-2:]
        if levels is None:
            D = bf_depth2(m, n, leaf_size)
        else:
            D = int(levels)
            assert D % 2 == 0 and m % (2 ** D) == 0 and n % (2 ** D) == 0
        self.m, self.n, self.D = m, n, D
        self.h = D // 2
        self.b = m // (2 ** D)
        self.r = int(max_rank)
        self.dtype = A.dtype
        self.rel_tol = rel_tol
        self.bf = bf_compress(A, D, self.r, rel_tol)
        self.ranks = (self.bf["rkU"], self.bf["rkV"])

    def matvec(self, x):
        squeeze = x.dim() == 1
        x = x.to(self.dtype)
        if squeeze:
            x = x[:, None]
        y = bf_matvec(self.bf, x, self.D, self.r)
        return y[..., 0] if squeeze else y

    def rmatvec(self, y):
        """A^H y."""
        squeeze = y.dim() == 1
        y = y.to(self.dtype)
        if squeeze:
            y = y[:, None]
        x = bf_rmatvec(self.bf, y, self.D, self.r)
        return x[..., 0] if squeeze else x

    def memory(self) -> int:
        return bf_memory(self.bf)

    def max_rank(self) -> int:
        return bf_max_rank(self.bf)
