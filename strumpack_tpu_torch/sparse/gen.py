"""Analytic test-matrix generators.

Role of the stencil code inlined in the reference's examples
(``examples/sparse/testPoisson2d.cpp``, ``testPoisson3d.cpp:54-78``):
5/7-point Poisson stencils on regular grids, used both by tests and by
``chip_smoke.py`` so that no external matrix downloads are required.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRMatrix


def poisson2d(nx: int, ny: int | None = None, dtype=np.float64) -> CSRMatrix:
    """5-point 2D Laplacian on an nx x ny grid (natural ordering)."""
    if ny is None:
        ny = nx
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype=dtype))

    add(idx, idx, 4.0)
    add(idx[1:, :], idx[:-1, :], -1.0)
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -1.0)
    add(idx[:, :-1], idx[:, 1:], -1.0)
    return CSRMatrix.from_coo(n, np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals))


def poisson3d(nx: int, ny: int | None = None, nz: int | None = None,
              dtype=np.float64) -> CSRMatrix:
    """7-point 3D Laplacian on an nx x ny x nz grid."""
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype=dtype))

    add(idx, idx, 6.0)
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(1, None)
        hi[ax] = slice(None, -1)
        add(idx[tuple(lo)], idx[tuple(hi)], -1.0)
        add(idx[tuple(hi)], idx[tuple(lo)], -1.0)
    return CSRMatrix.from_coo(n, np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals))

