"""Device sparse matrix-vector product.

Role of the reference's ``CompressedSparseMatrix::spmv`` (CSR spmv used by
the outer iterations), the counterpart of ``strumpack_tpu/ops/spmv.py``: the
matrix is converted on host to **padded ELL** (fixed nonzeros per row), so
spmv is one gather and one reduction along the padded-nnz axis.  It is plain
PyTorch (the JAX version is not a Pallas kernel either).
"""
from __future__ import annotations

import numpy as np
import torch


class DeviceELL:
    """Padded ELL-format device sparse matrix (gather-based spmv)."""

    def __init__(self, csr, dtype=None, device="cpu"):
        n = csr.n
        lens = np.diff(csr.rowptr)
        w = int(lens.max()) if n else 0
        self.n = n
        self.width = w
        cols = np.full((n, w), n, dtype=np.int64)        # n = zero pad row
        vals = np.zeros((n, w), dtype=dtype or csr.data.dtype)
        rows = np.repeat(np.arange(n), lens)
        pos = np.arange(csr.nnz) - np.repeat(csr.rowptr[:-1], lens)
        cols[rows, pos] = csr.colind
        vals[rows, pos] = csr.data
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, device=device)

    def __matmul__(self, x):
        return spmv_ell(self.vals, self.cols, x)


def spmv_ell(vals, cols, x):
    """y = A x for x [n] or [n, nrhs]."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    xext = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    y = torch.einsum("nw,nwr->nr", vals.to(x.dtype), xext[cols])
    return y[:, 0] if squeeze else y
