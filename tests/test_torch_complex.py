"""Complex input in the port against the JAX package, on the CPU.

The interleaved real expansion and Helmholtz generator bit for bit; the
plan of a ``complex_via_real`` Helmholtz identical; native complex128
factors (the library route, the complex tiny-pivot rule) against the JAX
package's; complex GMRES, BiCGStab and refinement against the JAX
package's on a small complex system (the same iteration counts); the
whole native solver: the JAX test's residual gate, Krylov iterations
within 2 of the JAX package's, and the port's solve on the JAX
package's factors within 1e-10 of the JAX solve; and the interleaved
real form's plan and solve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ref import assert_flags_identical, solve_on_jax_factors, \
    solver_pair

from strumpack_tpu.frontal import numeric as NJ
from strumpack_tpu.krylov import solvers as KJ
from strumpack_tpu.sparse import gen as gen_j

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import numeric as NT
from strumpack_tpu_torch.krylov import solvers as KT
from strumpack_tpu_torch.sparse import gen as gen_t


def test_interleave_and_helmholtz_bit_exact():
    """helmholtz3d, to_real_interleaved and the vector maps equal the JAX
    package's array for array."""
    Aj, At = gen_j.helmholtz3d(6, k0=8.0), gen_t.helmholtz3d(6, k0=8.0)
    for a, b in ((At, Aj), (At.to_real_interleaved(),
                            Aj.to_real_interleaved())):
        for name in ("rowptr", "colind", "data"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((Aj.n, 2)) + 1j * rng.standard_normal((Aj.n, 2))
    zr = st.CSRMatrix.complex_to_real_vec(z)
    np.testing.assert_array_equal(zr, type(Aj).complex_to_real_vec(z))
    back = st.CSRMatrix.real_to_complex_vec(zr, np.complex64)
    assert back.dtype == np.complex64
    np.testing.assert_array_equal(
        back, type(Aj).real_to_complex_vec(zr, np.complex64))


def test_complex_library_route_and_tiny_pivots():
    """Complex fronts take the library route (K2 and K3 are real only):
    lu, perm, L21, U12 and the CB equal the JAX package's
    ``_factor_bucket`` to 1e-13, with tiny pivots replaced by
    sign(real(d)) * thresh (numeric.py:486-490)."""
    rng = np.random.default_rng(2)
    nf, p, s = 3, 40, 16
    F = rng.standard_normal((nf, p, p)) + 1j * rng.standard_normal((nf, p, p))
    F[0, :s, :s] = np.triu(F[0, :s, :s])
    F[0, 3, 3] = 1e-9 - 2e-9j          # a tiny pivot with a positive real part
    F[1, :s, :s] = np.triu(F[1, :s, :s])
    F[1, 5, 5] = -1e-9 + 0.5e-9j       # and a negative one
    assert not st.frontal.numeric.FL.use_cross(s, p, torch.complex128)
    want = jax.jit(lambda F: NJ._factor_bucket(F, 1e-6, s))(jnp.asarray(F))
    got = NT._factor_bucket(torch.from_numpy(F), 1e-6, s)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-13 * max(np.abs(b).max(), 1))
    d = np.diagonal(got[0].numpy(), axis1=1, axis2=2)
    assert d[0, 3] == 1e-6 and d[1, 5] == -1e-6


def _complex_problem():
    """A small nonsymmetric complex system (Helmholtz 5^3 with a complex
    convection term)."""
    rng = np.random.default_rng(0)
    A = gen_j.helmholtz3d(5, k0=8.0).to_scipy().toarray()
    C = (np.eye(A.shape[0], k=1) - np.eye(A.shape[0], k=-1)) * (0.3 + 0.2j)
    M = A + C
    b = M @ (rng.standard_normal(M.shape[0])
             + 1j * rng.standard_normal(M.shape[0]))
    return M, b


@pytest.mark.parametrize("solver", ["gmres", "bicgstab", "refine"])
def test_complex_krylov_matches_jax(solver):
    """Complex GMRES (restarted, Givens rotations with conjugates),
    BiCGStab and refinement, preconditioned by the inverse of a perturbed
    matrix: the JAX package's iteration count, and the solution within
    1e-8 (both stop at a residual of 1e-10; the two differ only in the
    rounding of the dot products and norms)."""
    M, b = _complex_problem()
    shift = 1e-3 if solver == "refine" else 0.1
    Minv = np.linalg.inv(M + shift * np.diag(np.diag(M)))

    def run(K, wrap, unwrap):
        ops = (lambda v: wrap(M @ unwrap(v)),
               lambda v: wrap(Minv @ unwrap(v)))
        if solver == "gmres":
            return K.gmres(*ops, wrap(b), rtol=1e-10, atol=1e-14, maxit=300,
                           restart=10)   # restarts: 26 iterations
        if solver == "bicgstab":
            return K.bicgstab(*ops, wrap(b), rtol=1e-10, atol=1e-14,
                              maxit=300)
        return K.iterative_refinement(*ops, wrap(b), rtol=1e-12, atol=1e-14,
                                      maxit=50)
    x, its, rel = run(KT, torch.from_numpy, lambda v: v.numpy())
    xj, itsj, relj = run(KJ, jnp.asarray, np.asarray)
    assert its == itsj and its > 0 and x.is_complex()
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(xj)).max())
    assert rel <= 1e-9


@pytest.fixture(scope="module")
def helmholtz_pair():
    """The JAX package's and the port's solvers on Helmholtz 8^3 in
    native complex128, solved once."""
    A = gen_j.helmholtz3d(8, k0=8.0)
    ref, port = solver_pair(A, (8, 8, 8), "NONE", factor_dtype="complex128",
                            refine_dtype="complex128")
    rng = np.random.default_rng(0)
    b = A.spmv(rng.standard_normal(A.n) + 1j * rng.standard_normal(A.n))
    out = {}
    for name, s in (("jax", ref), ("port", port)):
        x, rc = s.solve(b)
        out[name] = (np.asarray(x), rc.name, s.Krylov_iterations())
    return A, ref, port, b, out


def test_helmholtz_solves_like_jax(helmholtz_pair):
    """test_sparse_seq.py::test_helmholtz_complex's gate (max scaled
    residual below 1e-10) and iteration count, plans identical, complex
    output."""
    A, ref, port, b, out = helmholtz_pair
    assert_flags_identical(ref, port)
    x, rc, its = out["port"]
    assert rc == "SUCCESS" and x.dtype == np.complex128
    assert A.max_scaled_residual(x, b) < 1e-10
    assert abs(its - out["jax"][2]) <= 2


def test_helmholtz_solve_on_jax_factors(helmholtz_pair):
    """The port's multifrontal solve on the JAX package's complex factors
    within 1e-10 of the JAX solve."""
    A, ref, port, b, out = helmholtz_pair
    got, want = solve_on_jax_factors(ref, port, b, dtype=torch.complex128)
    assert np.linalg.norm(got - want) <= 1e-10 * np.linalg.norm(want)


def test_complex_via_real_plan_and_solve():
    """complex_via_real: the interleaved form's plan equals the JAX
    package's (``components`` doubled once, real factor dtypes), and the
    port solves the complex system to the native gate with a complex
    solution of the input's dtype, also after update_matrix_values."""
    A = gen_j.helmholtz3d(8, k0=8.0)
    ref, port = solver_pair(A, (8, 8, 8), "NONE", factor_dtype="complex128",
                            refine_dtype="complex128", complex_via_real=True)
    assert_flags_identical(ref, port)
    assert port.opts.components == ref.opts.components == 2
    assert port.opts.factor_dtype == ref.opts.factor_dtype == "float64"
    rng = np.random.default_rng(0)
    b = A.spmv(rng.standard_normal(A.n) + 1j * rng.standard_normal(A.n))
    At = st.CSRMatrix(A.n, A.rowptr, A.colind, A.data)
    for _ in range(2):
        x, rc = port.solve(b)
        assert rc == st.ReturnCode.SUCCESS and x.dtype == np.complex128
        assert A.max_scaled_residual(x, b) < 1e-10
        port.update_matrix_values(At)
    assert port.opts.components == 2
