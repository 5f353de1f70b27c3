"""The structured dense matrix facade (PyTorch).

The counterpart of ``strumpack_tpu/structured/structured.py``, the role of
the reference's ``structured::StructuredMatrix`` (StructuredMatrix.hpp:209:
a runtime facade over HSS / BLR / HODLR / LR / LOSSY with
``construct_from_dense`` :464, ``construct_from_elements`` :562 and
mult / factor / solve / memory / rank; the type enum
StructuredOptions.hpp:60-81).

Each wrapper keeps the JAX package's single-matrix API -- a 1-D ``x``
gives a 1-D result, an ``[n, k]`` one an ``[n, k]`` one -- over the port's
batched objects with one front (``nf`` = 1): every call adds the front
axis and drops it again.  The matrix lives on ``device`` (None means
CUDA, see ``solver.resolve_device``); the results are tensors there.
``rank()`` is the largest masked rank, ``memory()`` the stored-entry count
the JAX package reports, padding to the tree and to the rank cap
included.  ``_BLRDense`` runs the port's BLR tile kernels (its diagonal
tile LUs on K2 at tiles up to 64 and the blocked LU over K4 at 128).
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from ..solver import resolve_device


class Type(enum.Enum):
    HSS = "hss"
    BLR = "blr"
    HODLR = "hodlr"
    HODBF = "hodbf"
    BUTTERFLY = "butterfly"
    LR = "lr"
    LOSSY = "lossy"


class StructuredOptions:
    """structured/StructuredOptions.hpp:43-54 defaults."""

    def __init__(self, type=Type.BLR, rel_tol=1e-4, abs_tol=1e-10,
                 leaf_size=128, max_rank=None):
        self.type = Type(type)
        self.rel_tol = rel_tol
        self.abs_tol = abs_tol
        self.leaf_size = leaf_size
        self.max_rank = max_rank


class StructuredMatrix:
    """Base interface: mult / factor / solve / shift / rank / memory."""

    rows: int
    cols: int

    def mult(self, x):
        raise NotImplementedError

    def factor(self):
        raise NotImplementedError

    def solve(self, b):
        raise NotImplementedError

    def shift(self, sigma):
        raise NotImplementedError

    def rank(self) -> int:
        raise NotImplementedError

    def memory(self) -> int:
        raise NotImplementedError

    def nonzeros(self) -> int:
        return self.memory()

    def __matmul__(self, x):
        return self.mult(x)


def _as_tensor(A, device, dtype=None):
    """A (numpy, list or tensor) as a tensor on ``device``."""
    if not torch.is_tensor(A):
        A = torch.as_tensor(np.asarray(A))
    return A.to(device=device, dtype=dtype)


def _front_call(fn, x, dtype, device):
    """``fn`` of the batched object on x [n] or [n, k]: the front axis
    added and dropped, the shape kept."""
    x = _as_tensor(x, device, dtype)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    y = fn(x[None])[0]
    return y[:, 0] if squeeze else y


def construct_from_dense(A, opts: StructuredOptions | None = None,
                         device=None, **kw) -> StructuredMatrix:
    """Factory, StructuredMatrix.hpp:464.  ``A`` a numpy array or tensor,
    kept in its dtype (LOSSY stores float32)."""
    opts = opts if opts is not None else StructuredOptions(**kw)
    A = _as_tensor(A, resolve_device(device))
    t = opts.type
    if t == Type.HSS:
        return _HSSWrap(A, opts)
    if t == Type.HODLR:
        return _HODLRWrap(A, opts)
    if t == Type.HODBF:
        return _HODBFWrap(A, opts)
    if t == Type.BLR:
        return _BLRDense(A, opts)
    if t == Type.LR:
        return _LRMatrix(A, opts)
    if t == Type.LOSSY:
        return _LossyMatrix(A, opts)
    if t == Type.BUTTERFLY:
        return _ButterflyWrap(A, opts)
    raise ValueError(t)


def construct_partially_matrix_free(mult, elem, n,
                                    opts: StructuredOptions | None = None,
                                    device=None, **kw) -> StructuredMatrix:
    """HSS in float64 from a product closure and an element closure by
    randomized sampling (StructuredMatrix.hpp
    construct_partially_matrix_free).  ``mult(X, trans)``: A X or A^H X
    for X [n, d]; ``elem(I, J)``: A[I, J] for broadcasting index tensors;
    both on ``device``."""
    from .hss_sample import hss_from_sampling
    opts = opts or StructuredOptions(**kw)
    if opts.type != Type.HSS:
        raise ValueError("matrix-free construction is HSS-only")
    dev = resolve_device(device)
    w = _HSSWrap.__new__(_HSSWrap)
    w.rows = w.cols = n
    w.h = hss_from_sampling(
        lambda X, trans: mult(X[0], trans)[None],
        lambda I, J: elem(I[0], J[0])[None], n, 1,
        leaf_size=opts.leaf_size,
        max_rank=opts.max_rank or max(16, opts.leaf_size // 2),
        rel_tol=opts.rel_tol, dtype=torch.float64, device=dev)
    return w


def construct_matrix_free(mult, n, opts=None, device=None,
                          **kw) -> StructuredMatrix:
    """HSS from a product closure only: an element is read from the
    product with the unit vectors of its columns (exact, O(n / leaf)
    extra products), StructuredMatrix.hpp construct_matrix_free."""
    dev = resolve_device(device)

    def elem(I, J):
        I, J = torch.broadcast_tensors(I, J)
        cols = torch.unique(J)
        E = torch.zeros((n, len(cols)), dtype=torch.float64, device=dev)
        E[cols, torch.arange(len(cols), device=dev)] = 1.0
        AE = mult(E, False)                                  # [n, ncols]
        return AE[I, torch.searchsorted(cols, J.contiguous())]

    return construct_partially_matrix_free(mult, elem, n, opts, device=dev,
                                           **kw)


def construct_from_elements(elem, rows, cols,
                            opts: StructuredOptions | None = None,
                            device=None, **kw) -> StructuredMatrix:
    """Factory from an element function ``elem(i, j)`` of numpy index
    arrays (StructuredMatrix.hpp:562): the dense matrix is built from all
    elements, then compressed as ``construct_from_dense``."""
    I, J = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return construct_from_dense(elem(I, J), opts, device=device, **kw)


# ---------------------------------------------------------------------------

class _FrontWrap(StructuredMatrix):
    """A batched HSS / HODLR / HODBF object ``h`` of one front."""

    def mult(self, x):
        return _front_call(self.h.matvec, x, self.h.dtype, self.h.D.device)

    def factor(self):
        self.h.factor()

    def solve(self, b):
        return _front_call(self.h.solve, b, self.h.dtype, self.h.D.device)

    def rank(self):
        return self.h.max_rank()

    def memory(self):
        return self.h.memory()


class _HSSWrap(_FrontWrap):
    def __init__(self, A, opts):
        from .hss import HSSMatrix
        self.rows, self.cols = A.shape
        self.h = HSSMatrix(A[None], leaf_size=opts.leaf_size,
                           max_rank=opts.max_rank, rel_tol=opts.rel_tol)


class _HODLRWrap(_FrontWrap):
    def __init__(self, A, opts):
        from .hodlr import HODLRMatrix
        self.rows, self.cols = A.shape
        self.h = HODLRMatrix(A[None], leaf_size=opts.leaf_size,
                             max_rank=opts.max_rank, rel_tol=opts.rel_tol)


class _HODBFWrap(_FrontWrap):
    """HODLR with butterfly off-diagonal blocks (the ButterflyPACK HODBF
    role); factor / solve are the direct butterfly factorization
    (bpack_factor / bpack_solve) plus a short refinement."""

    def __init__(self, A, opts):
        from .hodbf import HODBFMatrix
        self.rows, self.cols = A.shape
        self.h = HODBFMatrix(A[None], leaf_size=opts.leaf_size,
                             max_rank=opts.max_rank, rel_tol=opts.rel_tol)


class _BLRDense(StructuredMatrix):
    """A standalone dense BLR matrix through the level-batched tile
    kernels (BLR/BLRMatrix.hpp:68: compress, factor, solve), one front of
    ``frontal/blr.py``'s buckets."""

    def __init__(self, A, opts):
        from ..frontal.blr import choose_tile
        self.rows, self.cols = A.shape
        m = self.rows
        t = choose_tile(_pad_to(m, opts.leaf_size), 0, opts.leaf_size)
        self.mpad = ((m + t - 1) // t) * t
        self.t = t
        self.r = min(opts.max_rank or t // 2, t)
        self.opts = opts
        Ap = A.new_zeros((self.mpad, self.mpad))
        Ap[:m, :m] = A
        ii = torch.arange(m, self.mpad, device=A.device)
        Ap[ii, ii] = 1
        self.Ap = Ap
        self._fac = None
        self._compress()

    def _compress(self):
        from ..frontal.blr import _compress_tiles
        t = self.t
        nt = self.mpad // t
        tiles = self.Ap.reshape(nt, t, nt, t).permute(0, 2, 1, 3)
        U, V, ranks = _compress_tiles(tiles, self.opts.rel_tol, self.r)
        ii = torch.arange(nt, device=self.Ap.device)
        self._tiles = (tiles[ii, ii].contiguous(), U, V)
        offdiag = ~torch.eye(nt, dtype=torch.bool, device=ranks.device)
        self._ranks = ranks[offdiag]

    def mult(self, x):
        diag, U, V = self._tiles
        t = self.t
        nt = self.mpad // t
        x = _as_tensor(x, self.Ap.device, self.Ap.dtype)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[:, None]
        xp = x.new_zeros((self.mpad, x.shape[1]))
        xp[:self.rows] = x
        xb = xp.reshape(nt, t, -1)
        vx = torch.einsum("ijrt,jtk->ijrk", V, xb)
        y = torch.einsum("ijtr,ijrk->itk", U, vx)
        # the diagonal tiles' low-rank terms replaced by the dense tiles
        ii = torch.arange(nt, device=x.device)
        y = (y - torch.matmul(U[ii, ii], vx[ii, ii])
             + torch.matmul(diag, xb))
        y = y.reshape(self.mpad, -1)[:self.rows]
        return y[:, 0] if squeeze else y

    def factor(self):
        from ..frontal.blr import blr_factor_bucket
        nt = self.mpad // self.t
        self._fac = blr_factor_bucket(self.Ap[None], 0.0, self.opts.rel_tol,
                                      t=self.t, r=self.r, nts=nt, nt=nt)

    def solve(self, b):
        from ..frontal.blr import blr_bwd_bucket, blr_fwd_bucket
        if self._fac is None:
            self.factor()
        lud, perms, Uu, Vu, Ul, Vl, Du, Dl, _, _ = self._fac
        t = self.t
        nt = self.mpad // t
        b = _as_tensor(b, self.Ap.device, self.Ap.dtype)
        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        bp = b.new_zeros((1, self.mpad, b.shape[1]))
        bp[0, :self.rows] = b
        y, _ = blr_fwd_bucket(lud, perms, Ul, Vl, Dl, bp, t=t, nts=nt, nt=nt)
        x = blr_bwd_bucket(lud, Uu, Vu, Du, y, b.new_zeros((1, 0, b.shape[1])),
                           t=t, nts=nt, nt=nt)[0, :self.rows]
        return x[:, 0] if squeeze else x

    def rank(self):
        return int(self._ranks.max()) if self._ranks.numel() else 0

    def memory(self):
        # the dense diagonal tiles and the masked-rank tile storage
        return int(self._tiles[0].numel()
                   + 2 * self.t * int(self._ranks.sum()))


class _ButterflyWrap(StructuredMatrix):
    """A butterfly (the HODBF off-diagonal block role), mult only:
    ButterflyMatrix has no standalone factor / solve in the reference
    either."""

    def __init__(self, A, opts):
        from .butterfly import ButterflyMatrix
        self.rows, self.cols = A.shape
        self.bf = ButterflyMatrix(A[None], leaf_size=min(opts.leaf_size, 64),
                                  max_rank=opts.max_rank or 32,
                                  rel_tol=opts.rel_tol)

    def mult(self, x):
        return _front_call(self.bf.matvec, x, self.bf.dtype,
                           self.bf.bf["B"].device)

    def rank(self):
        return self.bf.max_rank()

    def memory(self):
        return self.bf.memory()


class _LRMatrix(StructuredMatrix):
    """A global low-rank A ~= U V from the full SVD of A (StructuredOptions
    Type LR): rank the singular values above ``rel_tol`` times the
    largest, capped at ``max_rank``."""

    def __init__(self, A, opts):
        self.rows, self.cols = A.shape
        U, S, Vh = torch.linalg.svd(A, full_matrices=False)
        s0 = float(S[0]) if S.numel() else 0.0
        k = int((S > opts.rel_tol * max(s0, 1e-300)).sum())
        k = min(k, opts.max_rank or k)
        self.U = U[:, :k] * S[None, :k].to(U.dtype)
        self.V = Vh[:k, :]

    def mult(self, x):
        x = _as_tensor(x, self.U.device, self.U.dtype)
        return self.U @ (self.V @ x)

    def rank(self):
        return self.U.shape[1]

    def memory(self):
        return int(self.U.numel() + self.V.numel())


class _LossyMatrix(StructuredMatrix):
    """Lossy dense storage: int8 tiles of 32 x 32 with a float32 scale
    each, rounded half to even (the on-device analog of the reference's
    ZFP-compressed factors, FrontLossy.cpp:46-90); decompressed for mult
    and for its dense LU."""

    TILE = 32

    def __init__(self, A, opts):
        A = A.to(torch.float32)
        self.rows, self.cols = A.shape
        T = self.TILE
        mp = ((self.rows + T - 1) // T) * T
        npd = ((self.cols + T - 1) // T) * T
        Ap = A.new_zeros((mp, npd))
        Ap[:self.rows, :self.cols] = A
        tiles = Ap.reshape(mp // T, T, npd // T, T).permute(0, 2, 1, 3)
        scale = torch.amax(torch.abs(tiles), dim=(-2, -1),
                           keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-30)
        self.q = torch.round(tiles / scale).to(torch.int8)
        self.scale = scale
        self.mp, self.np_ = mp, npd
        self._lu = None

    def _dense(self):
        tiles = self.q.to(torch.float32) * self.scale
        return tiles.permute(0, 2, 1, 3).reshape(self.mp, self.np_)

    def mult(self, x):
        x = _as_tensor(x, self.q.device, torch.float32)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[:, None]
        xp = x.new_zeros((self.np_, x.shape[1]))
        xp[:self.cols] = x
        y = (self._dense() @ xp)[:self.rows]
        return y[:, 0] if squeeze else y

    def factor(self):
        from .hss import _lu
        self._lu = _lu(self._dense()[:self.rows, :self.cols].contiguous())

    def solve(self, b):
        from .hss import _lu_solve
        if self._lu is None:
            self.factor()
        b = _as_tensor(b, self.q.device, torch.float32)
        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        x = _lu_solve(*self._lu, b)
        return x[:, 0] if squeeze else x

    def rank(self):
        return min(self.rows, self.cols)

    def memory(self):
        return int(self.q.numel() + self.scale.numel() * 4)


def _pad_to(x, m):
    return ((x + m - 1) // m) * m
