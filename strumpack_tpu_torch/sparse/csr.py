"""Host-side CSR sparse matrix container.

Role of the reference's ``sparse/CSRMatrix.{hpp,cpp}`` and parts of
``sparse/CompressedSparseMatrix.hpp`` (spmv, equilibration, symmetrize,
matrix-market IO, scaled residual).  This lives on host (NumPy): in the
level-batched design the sparse matrix is *planning input*; the device only
ever sees gathered value vectors and dense padded fronts.  Device spmv for
the refinement loop is built from this container by ``ops.spmv``.
"""
from __future__ import annotations

import numpy as np


class CSRMatrix:
    """Compressed sparse row matrix with solver-support operations.

    Reference parity: CSRMatrix.hpp:74-192 (spmv, equilibration/equilibrate,
    symmetrize_sparsity, permutation, max_scaled_residual, matrix-market IO).
    """

    def __init__(self, n, rowptr, colind, data, symm_sparse=False):
        self.n = int(n)
        self.rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
        self.colind = np.ascontiguousarray(colind, dtype=np.int64)
        self.data = np.ascontiguousarray(data)
        self.symm_sparse = symm_sparse
        assert self.rowptr.shape == (self.n + 1,)
        assert self.colind.shape == self.data.shape

    # -- basics ------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.colind.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def copy(self) -> "CSRMatrix":
        return CSRMatrix(self.n, self.rowptr.copy(), self.colind.copy(),
                         self.data.copy(), self.symm_sparse)

    def to_scipy(self):
        from scipy.sparse import csr_matrix
        return csr_matrix((self.data, self.colind, self.rowptr),
                          shape=(self.n, self.n))

    @classmethod
    def from_scipy(cls, A) -> "CSRMatrix":
        A = A.tocsr()
        A.sum_duplicates()
        A.sort_indices()
        return cls(A.shape[0], A.indptr, A.indices, A.data)

    @classmethod
    def from_coo(cls, n, rows, cols, vals) -> "CSRMatrix":
        from scipy.sparse import coo_matrix
        return cls.from_scipy(coo_matrix((vals, (rows, cols)), shape=(n, n)))

    # -- operations --------------------------------------------------------
    def spmv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x (host). Reference: CompressedSparseMatrix.hpp:309."""
        return self.to_scipy() @ x

    def transpose(self) -> "CSRMatrix":
        return CSRMatrix.from_scipy(self.to_scipy().T.tocsr())

    def symmetrize_sparsity(self) -> "CSRMatrix":
        """Make the sparsity pattern structurally symmetric (union with A^T),
        keeping values (zeros inserted). Reference:
        CompressedSparseMatrix.hpp:347."""
        S = self.to_scipy()
        # pattern union: add explicit zeros where only A^T has entries
        P = (S + S.T * 0.0).tocsr()
        P.sort_indices()
        out = CSRMatrix(self.n, P.indptr, P.indices, P.data)
        out.symm_sparse = True
        return out

    def permute(self, perm: np.ndarray, iperm: np.ndarray) -> "CSRMatrix":
        """Symmetric permutation PAP^T: row/col i of the result is row/col
        perm[i] of A, i.e. new[i,j] = old[perm[i], perm[j]].
        Reference: CompressedSparseMatrix permute (iperm,perm) pair."""
        S = self.to_scipy()
        out = S[perm, :][:, perm].tocsr()
        out.sort_indices()
        return CSRMatrix(self.n, out.indptr, out.indices, out.data,
                         self.symm_sparse)

    def scale_rows_cols(self, dr: np.ndarray, dc: np.ndarray) -> "CSRMatrix":
        """Return diag(dr) @ A @ diag(dc) (equilibrate / matching scaling)."""
        out = self.copy()
        rows = np.repeat(np.arange(self.n), np.diff(self.rowptr))
        out.data = self.data * dr[rows] * dc[self.colind]
        return out

    def equilibration(self):
        """LAPACK-geequ-style row/column inf-norm scaling factors.

        Returns (dr, dc, rowcnd, colcnd, amax); reference
        CSRMatrix equilibration -> EquilibrationType. dr/dc are the scaling
        vectors such that diag(dr) A diag(dc) has rows/cols with max |.| 1.
        """
        absA = np.abs(self.data)
        rows = np.repeat(np.arange(self.n), np.diff(self.rowptr))
        rmax = np.zeros(self.n, dtype=np.float64)
        np.maximum.at(rmax, rows, absA.astype(np.float64))
        rmax[rmax == 0.0] = 1.0
        dr = 1.0 / rmax
        scaled = absA * dr[rows]
        cmax = np.zeros(self.n, dtype=np.float64)
        np.maximum.at(cmax, self.colind, scaled)
        cmax[cmax == 0.0] = 1.0
        dc = 1.0 / cmax
        amax = absA.max() if absA.size else 0.0
        rowcnd = (rmax.min() / rmax.max()) if self.n else 1.0
        colcnd = (cmax.min() / cmax.max()) if self.n else 1.0
        return dr, dc, rowcnd, colcnd, amax

    def to_real_interleaved(self) -> "CSRMatrix":
        """The real-equivalent expansion of a complex matrix
        (``strumpack_tpu/sparse/csr.py:121-163``): each entry a + bi
        becomes the 2x2 block [[a, -b], [b, a]] at rows and columns
        (2i, 2i+1) x (2j, 2j+1), the unknowns interleaved as
        [Re x_0, Im x_0, Re x_1, ...]; geometric ND treats a grid point's
        two dofs as ``components``."""
        assert np.iscomplexobj(self.data)
        n2 = 2 * self.n
        counts = np.diff(self.rowptr)
        rowptr = np.zeros(n2 + 1, np.int64)
        np.cumsum(np.repeat(counts * 2, 2), out=rowptr[1:])
        a = np.real(self.data).astype(np.float64)
        b = np.imag(self.data).astype(np.float64)
        c0 = 2 * self.colind
        rows = np.repeat(np.arange(self.n), counts)
        k = 2 * (np.arange(self.nnz) - self.rowptr[rows])
        colind = np.empty(rowptr[-1], np.int64)
        data = np.empty(rowptr[-1], np.float64)
        # row 2i: (2j, a), (2j+1, -b); row 2i+1: (2j, b), (2j+1, a)
        for e, re, im in ((rowptr[2 * rows] + k, a, -b),
                          (rowptr[2 * rows + 1] + k, b, a)):
            colind[e], colind[e + 1] = c0, c0 + 1
            data[e], data[e + 1] = re, im
        return CSRMatrix(n2, rowptr, colind, data,
                         symm_sparse=self.symm_sparse)

    @staticmethod
    def complex_to_real_vec(x: np.ndarray) -> np.ndarray:
        """[n] complex (or [n, k]) -> [2n(, k)] interleaved real."""
        x = np.asarray(x)
        out = np.empty((2 * x.shape[0],) + x.shape[1:], np.float64)
        out[0::2] = np.real(x)
        out[1::2] = np.imag(x)
        return out

    @staticmethod
    def real_to_complex_vec(y: np.ndarray, dtype=np.complex128):
        """The inverse of ``complex_to_real_vec``."""
        return (y[0::2] + 1j * y[1::2]).astype(dtype)

    def max_scaled_residual(self, x: np.ndarray, b: np.ndarray) -> float:
        """Componentwise scaled residual max_i |Ax-b|_i / (|A||x|+|b|)_i.

        Reference: CSRMatrix::max_scaled_residual, the test pass criterion
        of test/test_sparse_seq.cpp:39.
        """
        S = self.to_scipy()
        absS = S.copy()
        absS.data = np.abs(absS.data)
        x = np.asarray(x)
        b = np.asarray(b)
        r = np.abs(S @ x - b)
        d = absS @ np.abs(x) + np.abs(b)
        d[d == 0.0] = 1.0
        return float((r / d).max())

    def norm1(self) -> float:
        """1-norm (max column sum of |A|)."""
        colsum = np.zeros(self.n, dtype=np.float64)
        np.add.at(colsum, self.colind, np.abs(self.data).astype(np.float64))
        return float(colsum.max()) if self.n else 0.0

    def extract_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # -- IO ----------------------------------------------------------------
    @classmethod
    def from_matrix_market(cls, path: str) -> "CSRMatrix":
        """Read a MatrixMarket coordinate file (real/complex/pattern,
        general/symmetric/skew/hermitian). Reference: CSRMatrix
        read_matrix_market."""
        import scipy.io
        A = scipy.io.mmread(path)
        return cls.from_scipy(A.tocsr())

    def write_matrix_market(self, path: str) -> None:
        import scipy.io
        scipy.io.mmwrite(path, self.to_scipy())

    def save_binary(self, path: str) -> None:
        """Binary save (role of the reference CSRMatrix binary IO,
        CSRMatrix.hpp print_binary/read_binary): rowptr/colind/data in one
        compressed container."""
        np.savez_compressed(path, n=self.n, rowptr=self.rowptr,
                            colind=self.colind, data=self.data,
                            symm_sparse=self.symm_sparse)

    @classmethod
    def from_binary(cls, path: str) -> "CSRMatrix":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(int(z["n"]), z["rowptr"], z["colind"], z["data"],
                   symm_sparse=bool(z["symm_sparse"]))

    def __repr__(self):
        return (f"CSRMatrix(n={self.n}, nnz={self.nnz}, "
                f"dtype={self.data.dtype})")
