"""The port's refinement paths against the JAX solver on the same inputs
(on the CPU, the port's kernels through their plain versions): an
initial guess, f32 factors refined in f64, and bench.py's double-float
(``float32x2``) refinement.  Solutions agree with equal iteration
counts."""
import numpy as np

import torch_ref  # noqa: F401  (one torch thread a test worker)
from torch_ref import jax_split_programs  # noqa: F401  (autouse)

from strumpack_tpu.sparse.gen import poisson2d

import strumpack_tpu_torch as st

from test_torch_general_solver import _pair, _port_matrix, _rhs, _solve_both


def test_initial_guess():
    """IR from x0 (equilibration off, where the JAX package maps x0 into
    the scaled system the same way); then, with equilibration on, x0 = the
    solution converges in no iteration (the port maps x0 by the inverse of
    the solution transform)."""
    A = poisson2d(15)
    rng = np.random.default_rng(3)
    xex = rng.standard_normal(A.n)
    b = A.spmv(xex)
    x0 = xex + 1e-3 * rng.standard_normal(A.n)
    ref, port = _pair(A, rel_tol=1e-10, equilibration=False)
    x = _solve_both(ref, port, b, x0=x0)
    assert A.max_scaled_residual(x, b) < 1e-8
    s = st.SparseSolver(st.SPOptions(rel_tol=1e-10), device="cpu")
    s.set_csr_matrix(_port_matrix(A))
    x, rc = s.solve(b, x0=xex)
    assert rc == st.ReturnCode.SUCCESS and s.Krylov_iterations() == 0
    np.testing.assert_array_equal(x, xex)
    for kr in (st.KrylovSolver.PREC_GMRES, st.KrylovSolver.PREC_BICGSTAB):
        s.opts.krylov_solver = kr
        x, rc = s.solve(b, x0=x0)
        assert rc == st.ReturnCode.SUCCESS
        assert A.max_scaled_residual(x, b) < 1e-8


def test_f32_factor_f64_refine():
    A = poisson2d(12)
    ref, port = _pair(A, factor_dtype="float32", refine_dtype="float64",
                      rel_tol=1e-10)
    b = _rhs(A)
    x = _solve_both(ref, port, b, tol=1e-9)
    assert A.max_scaled_residual(x, b) < 1e-10


def test_double_float_refinement():
    """bench.py's df32 options (f32 factors, residuals in double float)
    on Poisson 12^2, which takes the 2 refinement steps Poisson 8^3 took
    (a smaller plan: fewer JAX programs to compile); the same iteration
    count as the JAX package's and bench.py's 1e-10 gate."""
    A = poisson2d(12)
    ref, port = _pair(A, factor_dtype="float32", refine_dtype="float32x2",
                      rel_tol=1e-12, abs_tol=1e-13)
    b = _rhs(A)
    x = _solve_both(ref, port, b, tol=1e-9)
    assert A.max_scaled_residual(x, b) <= 1e-10
    assert port.ell_lo is not None and port.ell.vals.dtype.itemsize == 4
