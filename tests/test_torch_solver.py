"""End to end: the port's SparseSolver against the JAX package's on the
same problems (f64 on the CPU, where both are exact LU): the same IR
iteration count, the same solution and factors to rounding, a direct
residual at machine precision, and the port's solve on the JAX factors."""
import numpy as np
import pytest
import torch

import torch_ref  # noqa: F401  (one torch thread a test worker)

import strumpack_tpu as sj
from strumpack_tpu.frontal import numeric as sj_numeric
from strumpack_tpu.sparse.gen import poisson2d, poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import numeric as st_numeric
from strumpack_tpu_torch.interop import factors_from_numpy

# p3d12 has six buckets the two packages route differently (K3 in the
# port, the library route in the JAX package: the port's routing is
# derived on the H100, ops/front_lu.py use_cross)
PROBLEMS = {"p3d8": (lambda: poisson3d(8), (8, 8, 8)),
            "p2d16": (lambda: poisson2d(16), (16, 16)),
            "p3d12": (lambda: poisson3d(12), (12, 12, 12))}


def _port_matrix(A):
    return st.CSRMatrix(A.n, A.rowptr, A.colind, A.data)


def _port_solver(A, dims, **opts):
    s = st.SparseSolver(st.SPOptions(**opts), device="cpu")
    s.set_csr_matrix(_port_matrix(A))
    s.reorder(*dims)
    return s


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def pair(request):
    """Both packages' solvers on one problem, f64, refinement (AUTO)."""
    make, dims = PROBLEMS[request.param]
    A = make()
    rng = np.random.default_rng(0)
    b = A.spmv(rng.standard_normal(A.n))
    ref = sj.SparseSolver(sj.SPOptions())
    ref.set_csr_matrix(A)
    ref.reorder(*dims)
    x_ref, rc_ref = ref.solve(b)
    port = _port_solver(A, dims)
    x, rc = port.solve(b)
    assert rc_ref.name == rc.name == "SUCCESS"
    return dict(A=A, b=b, dims=dims, ref=ref, port=port, x_ref=x_ref, x=x)


def test_solution_and_iterations_match(pair):
    """Same IR iteration count; solutions equal to 1e-10 of their size
    (two exact f64 LUs of a well-conditioned matrix differ by rounding)."""
    assert pair["port"].Krylov_iterations() == \
        pair["ref"].Krylov_iterations()
    x, x_ref = pair["x"], np.asarray(pair["x_ref"])
    np.testing.assert_allclose(x, x_ref, rtol=0,
                               atol=1e-10 * np.abs(x_ref).max())


def test_factors_match(pair):
    """Per bucket: perm exact, lu/L21/U12 to 1e-10 of each array's
    largest entry (K3 and the library route against the XLA LU)."""
    ref_tree = pair["ref"].fac.tree
    port_tree = pair["port"].fac.tree
    assert set(port_tree["lu"]) == set(ref_tree["lu"])
    for key in ref_tree["lu"]:
        np.testing.assert_array_equal(port_tree["perm"][key].numpy(),
                                      np.asarray(ref_tree["perm"][key]))
        for name in ("lu", "L21", "U12"):
            want = np.asarray(ref_tree[name][key])
            np.testing.assert_allclose(
                port_tree[name][key].numpy(), want, rtol=0,
                atol=1e-10 * max(np.abs(want).max(initial=0), 1.0),
                err_msg=f"{name} {key}")


def test_direct_residual(pair):
    """DIRECT on the same factors: machine-precision scaled residual."""
    port = pair["port"]
    port.opts.krylov_solver = st.KrylovSolver.DIRECT
    x, rc = port.solve(pair["b"])
    port.opts.krylov_solver = st.KrylovSolver.AUTO
    assert rc == st.ReturnCode.SUCCESS and port.Krylov_iterations() == 1
    assert pair["A"].max_scaled_residual(x, pair["b"]) < 1e-13


def test_solve_on_jax_factors(pair):
    """The port's solve on the JAX factors (interop) against the JAX
    solve of the same permuted right-hand side: 1e-12 relative (only the
    solve's own rounding differs)."""
    ref, port = pair["ref"], pair["port"]
    bp = ref._transform_b(pair["b"])
    want = np.asarray(sj_numeric.solve(ref.fac, bp))
    tree = {name: {k: np.asarray(v) for k, v in ref.fac.tree[name].items()}
            for name in ("lu", "perm", "L21", "U12")}
    fac = factors_from_numpy(port.pdev, tree)
    got = st_numeric.solve(fac, bp).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_f32_exact32_options():
    """The exact32 options at 8^3: f32 factor and refinement to 1e-5."""
    A = poisson3d(8)
    s = _port_solver(A, (8, 8, 8), factor_dtype="float32",
                     refine_dtype="float32", rel_tol=1e-5,
                     krylov_solver=st.KrylovSolver.REFINE, nd_leaf=16)
    b = A.spmv(np.random.default_rng(1).standard_normal(A.n))
    for k in st_numeric.route_counts:
        st_numeric.route_counts[k] = 0
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert s.achieved_rtol <= 1e-5
    assert np.linalg.norm(b - A.spmv(x.astype(np.float64))) \
        <= 1e-4 * np.linalg.norm(b)
    assert st_numeric.route_counts["k3"] == s.pdev.k3_buckets(torch.float32) > 0
    assert sum(st_numeric.route_counts.values()) == \
        sum(len(lvl) for lvl in s.pdev.levels)


@pytest.mark.parametrize("solver", ["DIRECT", "REFINE"])
def test_multiple_rhs(solver):
    A = poisson2d(12)
    s = _port_solver(A, (12, 12), krylov_solver=st.KrylovSolver[solver])
    B = A.spmv(np.random.default_rng(2).standard_normal((A.n, 3)))
    X, rc = s.solve(B)
    assert rc == st.ReturnCode.SUCCESS and X.shape == (A.n, 3)
    assert s.Krylov_iterations() == 1   # exact factors: one solve each
    for j in range(3):
        assert A.max_scaled_residual(X[:, j], B[:, j]) < 1e-13


def test_update_matrix_values_reuses_plan():
    A = poisson2d(12)
    s = _port_solver(A, (12, 12), krylov_solver=st.KrylovSolver.DIRECT)
    rng = np.random.default_rng(4)
    xex = rng.standard_normal(A.n)
    x, _ = s.solve(A.spmv(xex))
    plan = s.plan
    A2 = _port_matrix(A)
    A2.data = A.data * (1.0 + 0.01 * rng.standard_normal(A.nnz))
    s.update_matrix_values(A2)
    b2 = A2.spmv(xex)
    x2, rc = s.solve(b2)
    assert rc == st.ReturnCode.SUCCESS and s.plan is plan
    assert A2.max_scaled_residual(x2, b2) < 1e-13
