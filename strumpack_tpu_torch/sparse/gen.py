"""Analytic test-matrix generators.

Role of the stencil code inlined in the reference's examples
(``examples/sparse/testPoisson2d.cpp``, ``testPoisson3d.cpp:54-78``):
5/7-point Poisson stencils on regular grids, and the harder real test
matrices of the JAX package's generator (complex Helmholtz, random SPD,
anisotropic and high-contrast diffusion, shifted indefinite Helmholtz, a
saddle point),
used both by tests and by ``chip_smoke.py`` so that no external matrix
downloads are required.
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


def helmholtz3d(nx: int, k0: float = 10.0,
                dtype=np.complex128) -> CSRMatrix:
    """Complex 3D Helmholtz -lap - (k0^2 + 0.05i k0^2) h^2 on an nx^3 grid
    (``strumpack_tpu/sparse/gen.py:66``; the reference's
    examples/sparse/testHelmholtz.cpp, damped to stay invertible)."""
    import scipy.sparse as sp
    A = poisson3d(nx, dtype=np.float64)
    h = 1.0 / (nx + 1)
    shift = (k0 * h) ** 2 + 1j * 0.05 * (k0 * h) ** 2
    S = A.to_scipy().astype(dtype)
    S = S - shift * sp.eye(A.n, dtype=dtype, format="csr")
    return CSRMatrix.from_scipy(S)


def random_spd(n: int, density: float = 0.02, seed: int = 0,
               dtype=np.float64) -> CSRMatrix:
    """Random sparse SPD matrix: B + B^T + diag shift (for SPD test set)."""
    rng = np.random.default_rng(seed)
    from scipy.sparse import random as sprandom, eye
    B = sprandom(n, n, density=density, random_state=rng, format="csr",
                 dtype=dtype)
    S = (B + B.T) * 0.5
    S = S + eye(n, dtype=dtype, format="csr") * (np.abs(S).sum(axis=1).max() + 1.0)
    return CSRMatrix.from_scipy(S.tocsr())


def anisotropic3d(nx: int, eps: float = 1e-3,
                  dtype=np.float64) -> CSRMatrix:
    """Strongly anisotropic 3D diffusion -(u_xx + eps*u_yy + eps*u_zz):
    7-point stencil with direction-dependent coefficients.  The layered
    near-1D coupling defeats isotropic orderings and stresses
    compression rank growth (SuiteSparse t2dal/cz10228-class behavior,
    reference sweep test/CMakeLists.txt:189-318)."""
    n = nx ** 3
    idx = np.arange(n).reshape(nx, nx, nx)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype=dtype))

    diag = 2.0 * (1.0 + eps + eps)
    add(idx, idx, diag)
    for ax, w in ((0, 1.0), (1, eps), (2, eps)):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, nx - 1)
        hi[ax] = slice(1, nx)
        add(idx[tuple(lo)], idx[tuple(hi)], -w)
        add(idx[tuple(hi)], idx[tuple(lo)], -w)
    return CSRMatrix.from_coo(n, np.concatenate(rows),
                              np.concatenate(cols), np.concatenate(vals))


def jump3d(nx: int, contrast: float = 1e6,
           dtype=np.float64) -> CSRMatrix:
    """3D diffusion with a high-contrast coefficient jump: cells in the
    central cube have coefficient ``contrast``, outside 1.  Harmonic-
    mean face coefficients; stresses equilibration and the compression
    tolerances (bcsstk/cbuckle-class conditioning)."""
    n = nx ** 3
    coef = np.ones((nx, nx, nx), dtype=dtype)
    a, b = nx // 4, 3 * nx // 4
    coef[a:b, a:b, a:b] = contrast
    idx = np.arange(n).reshape(nx, nx, nx)
    rows, cols, vals = [], [], []
    diag = np.zeros((nx, nx, nx), dtype=dtype)
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, nx - 1)
        hi[ax] = slice(1, nx)
        clo, chi = coef[tuple(lo)], coef[tuple(hi)]
        w = 2.0 * clo * chi / (clo + chi)
        rows += [idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()]
        cols += [idx[tuple(hi)].ravel(), idx[tuple(lo)].ravel()]
        vals += [-w.ravel(), -w.ravel()]
        diag[tuple(lo)] += w
        diag[tuple(hi)] += w
    diag += 1e-8 * coef          # keep boundary rows nonsingular
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(diag.ravel())
    return CSRMatrix.from_coo(n, np.concatenate(rows),
                              np.concatenate(cols), np.concatenate(vals))


def helmholtz_shifted3d(nx: int, k0: float = 15.0,
                        dtype=np.float64) -> CSRMatrix:
    """REAL shifted indefinite Helmholtz -lap - k^2: negative eigenvalues
    force pivoting / iterative correction (sherman/rdb-class
    indefiniteness) without leaving the real f64 path."""
    A = poisson3d(nx, dtype=dtype)
    h = 1.0 / (nx + 1)
    shift = (k0 * h) ** 2
    from scipy.sparse import eye
    S = A.to_scipy() - shift * eye(A.n, dtype=dtype, format="csr")
    return CSRMatrix.from_scipy(S.tocsr())


def saddle_point2d(nx: int, dtype=np.float64) -> CSRMatrix:
    """Stokes-like saddle point [[K, B^T], [B, 0]]: K = 2D Poisson
    (velocities), B = discrete divergence onto a coarse pressure grid.
    Zero diagonal block defeats no-pivot factorizations (MatchingJob /
    threshold-pivot sweep target; utm300-class structure)."""
    K = poisson2d(nx, dtype=dtype).to_scipy()
    nv = nx * nx
    npr = (nx // 2) ** 2
    from scipy.sparse import lil_matrix, bmat
    B = lil_matrix((npr, nv), dtype=dtype)
    for pj in range(nx // 2):
        for pi in range(nx // 2):
            p = pj * (nx // 2) + pi
            for dj in range(2):
                for di in range(2):
                    v = (2 * pj + dj) * nx + (2 * pi + di)
                    B[p, v] = 1.0 if (di + dj) % 2 == 0 else -1.0
    S = bmat([[K, B.T], [B, None]], format="csr", dtype=dtype)
    # explicit zero diagonal entries so the pattern is square/symmetric
    from scipy.sparse import eye as _eye
    S = (S + 0.0 * _eye(nv + npr, dtype=dtype, format="csr")).tocsr()
    S.sort_indices()
    return CSRMatrix.from_scipy(S)
