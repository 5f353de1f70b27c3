"""The port's Krylov solvers against the JAX package's, with the same
numpy-backed operator and preconditioner: identical iteration counts and
solutions within 1e-10 (f64; the two differ only in the rounding of the
device dot products and norms)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_ref  # noqa: F401  (one torch thread a test worker)

from strumpack_tpu.krylov import solvers as KJ
from strumpack_tpu.sparse.gen import poisson2d

from strumpack_tpu_torch.krylov import solvers as KT


def _problem():
    """Poisson 2D 16^2 made nonsymmetric by a convection term, with a
    weak (Jacobi) preconditioner so that GMRES restarts."""
    A = poisson2d(16).to_scipy().tocsr()
    n = A.shape[0]
    rng = np.random.default_rng(0)
    C = (np.eye(n, k=1) - np.eye(n, k=-1)) * 0.3
    M = A.toarray() + C
    b = M @ rng.standard_normal(n)
    dinv = 1.0 / np.diag(M)
    return M, b, dinv


def _ops(M, dinv, wrap, unwrap):
    return (lambda v: wrap(M @ unwrap(v)),
            lambda v: wrap(dinv * unwrap(v)))


JAX = (jnp.asarray, np.asarray)
TORCH = (torch.from_numpy, lambda v: v.numpy())


def _compare(run_port, run_jax, b):
    x, its, rel = run_port(torch.from_numpy(b))
    xj, itsj, relj = run_jax(jnp.asarray(b))
    assert its == itsj and its > 0
    xj = np.asarray(xj)
    np.testing.assert_allclose(x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())
    assert abs(rel - relj) <= 1e-6 * max(relj, 1e-300)
    return its, rel


@pytest.mark.parametrize("gs", ["modified", "classical"])
def test_gmres_matches_jax(gs):
    M, b, dinv = _problem()
    kw = dict(rtol=1e-10, atol=1e-14, maxit=400, restart=12,
              gram_schmidt=gs)
    its, rel = _compare(
        lambda bb: KT.gmres(*_ops(M, dinv, *TORCH), bb, **kw),
        lambda bb: KJ.gmres(*_ops(M, dinv, *JAX), bb, **kw), b)
    assert its > 12 and rel <= 1e-10          # restarted, converged


def test_gmres_unpreconditioned_matches_jax():
    M, b, dinv = _problem()
    kw = dict(rtol=1e-8, atol=1e-14, maxit=400, restart=20)
    spmv = _ops(M, dinv, *TORCH)[0]
    spmvj = _ops(M, dinv, *JAX)[0]
    _compare(lambda bb: KT.gmres(spmv, None, bb, **kw),
             lambda bb: KJ.gmres(spmvj, None, bb, **kw), b)


def test_bicgstab_matches_jax():
    M, b, dinv = _problem()
    kw = dict(rtol=1e-10, atol=1e-14, maxit=400)
    its, rel = _compare(
        lambda bb: KT.bicgstab(*_ops(M, dinv, *TORCH), bb, **kw),
        lambda bb: KJ.bicgstab(*_ops(M, dinv, *JAX), bb, **kw), b)
    assert rel <= 1e-10


def test_iterative_refinement_matches_jax():
    M, b, dinv = _problem()
    # a close preconditioner: the exact inverse of M perturbed by 1e-3
    Minv = np.linalg.inv(M + 1e-3 * np.diag(np.diag(M)))
    kw = dict(rtol=1e-12, atol=1e-14, maxit=50)
    _compare(
        lambda bb: KT.iterative_refinement(
            lambda v: torch.from_numpy(M @ v.numpy()),
            lambda v: torch.from_numpy(Minv @ v.numpy()), bb, **kw),
        lambda bb: KJ.iterative_refinement(
            lambda v: jnp.asarray(M @ np.asarray(v)),
            lambda v: jnp.asarray(Minv @ np.asarray(v)), bb, **kw), b)
