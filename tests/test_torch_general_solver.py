"""The port's general-input paths against the JAX solver on the same inputs
(f64 on the CPU, the port's kernels through their plain versions): the
defaults on matrices given without a grid, MC64 matching with a value
update, the SPD (Cholesky) path, symmetric scaling, subnormals, draw and
delete_factors.  Solutions agree to 1e-10 of their size, with equal
iteration counts; residuals meet ``test_sparse_seq.py``'s gate
(ERROR_TOL x rel_tol)."""
import numpy as np
import pytest

import torch_ref  # noqa: F401  (one torch thread a test worker)

import strumpack_tpu as sj
from strumpack_tpu.sparse.gen import poisson2d, random_spd

import strumpack_tpu_torch as st

from test_torch_matching import badly_scaled120
from test_torch_ordering import _unsymmetric150

ERROR_TOL = 1e2             # test_sparse_seq.py's residual gate factor


def _port_matrix(A):
    return st.CSRMatrix(A.n, A.rowptr, A.colind, A.data)


def _pair(A, dims=(), **opts):
    """The JAX and the port solver on A with the same options (enum
    options by name), reordered (by the grid when ``dims``)."""
    def conv(pkg, v):
        return getattr(pkg, type(v).__name__)[v.name] if hasattr(
            v, "name") else v
    ref = sj.SparseSolver(sj.SPOptions(
        **{k: conv(sj, v) for k, v in opts.items()}))
    ref.set_csr_matrix(A)
    port = st.SparseSolver(st.SPOptions(
        **{k: conv(st, v) for k, v in opts.items()}), device="cpu")
    port.set_csr_matrix(_port_matrix(A))
    assert ref.reorder(*dims) == sj.ReturnCode.SUCCESS
    assert port.reorder(*dims) == st.ReturnCode.SUCCESS
    return ref, port


def _rhs(A, seed=0):
    return A.spmv(np.random.default_rng(seed).standard_normal(A.n))


def _solve_both(ref, port, b, x0=None, tol=1e-10):
    x_ref, rc_ref = ref.solve(b, x0=x0)
    x, rc = port.solve(b, x0=x0)
    assert rc_ref.name == rc.name == "SUCCESS"
    assert port.Krylov_iterations() == ref.Krylov_iterations()
    x_ref = np.asarray(x_ref)
    np.testing.assert_allclose(x, x_ref, rtol=0,
                               atol=tol * np.abs(x_ref).max())
    return x


@pytest.mark.parametrize("make", [lambda: random_spd(200), _unsymmetric150],
                         ids=["random_spd200", "unsym150"])
def test_defaults_without_grid(make):
    """``SparseSolver(SPOptions())``, ``set_csr_matrix``, ``solve``: ND by
    the native BFS splitter, then refinement."""
    A = make()
    ref = sj.SparseSolver(sj.SPOptions())
    ref.set_csr_matrix(A)
    port = st.SparseSolver(st.SPOptions(), device="cpu")
    port.set_csr_matrix(_port_matrix(A))
    b = _rhs(A)
    x = _solve_both(ref, port, b)
    assert A.max_scaled_residual(x, b) < ERROR_TOL * port.opts.rel_tol
    np.testing.assert_array_equal(port.perm, ref.perm)


def test_mc64_then_update_values():
    A = badly_scaled120()
    ref, port = _pair(A, matching=st.MatchingJob.MAX_DIAGONAL_PRODUCT_SCALING,
                      rel_tol=1e-10)
    b = _rhs(A, 2)
    x = _solve_both(ref, port, b)
    assert A.max_scaled_residual(x, b) < ERROR_TOL * 1e-10
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 1e-3 * np.random.default_rng(5)
                         .standard_normal(A2.nnz))
    ref.update_matrix_values(A2)
    port.update_matrix_values(_port_matrix(A2))
    np.testing.assert_allclose(port.mdr, ref.mdr, rtol=1e-12, atol=0)
    b2 = _rhs(A2, 3)
    x2 = _solve_both(ref, port, b2)
    assert A2.max_scaled_residual(x2, b2) < ERROR_TOL * 1e-10


@pytest.fixture(scope="module")
def spd25():
    A = poisson2d(25)
    ref, port = _pair(A, (25, 25), symmetric=True, positive_definite=True,
                      krylov_solver=st.KrylovSolver.DIRECT)
    b = _rhs(A)
    x = _solve_both(ref, port, b)
    return A, ref, port, b, x


def test_spd_direct_factors(spd25):
    """Cholesky factors per bucket (the port's from the no-pivot K3/K2
    plain versions, the JAX package's from XLA's Cholesky) and the solve
    at machine precision."""
    A, ref, port, b, x = spd25
    assert A.max_scaled_residual(x, b) < 1e-13
    rt, pt = ref.fac.tree, port.fac.tree
    assert set(pt["lu"]) == set(rt["lu"]) and not pt["perm"]
    for key in rt["lu"]:
        for name in ("lu", "L21"):
            want = np.asarray(rt[name][key])
            np.testing.assert_allclose(
                pt[name][key].numpy(), want, rtol=0,
                atol=1e-10 * max(np.abs(want).max(initial=0), 1.0),
                err_msg=f"{name} {key}")
    assert port.inertia()[:3] == ref.inertia()[:3] == (A.n, 0, 0)
    assert port.inertia()[3].name == ref.inertia()[3].name == "SUCCESS"


def test_positive_definite_scales_symmetrically():
    """``positive_definite`` alone scales D A D as ``symmetric`` does, as
    the JAX package does (``strumpack_tpu/solver.py:120``)."""
    A = poisson2d(10)
    ref, port = _pair(A, (10, 10), positive_definite=True)
    np.testing.assert_allclose(port.dr, ref.dr, rtol=1e-15, atol=0)
    np.testing.assert_allclose(port.dc, ref.dc, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(port.dr, port.dc)
    _solve_both(ref, port, _rhs(A))


def test_subnormals_equal():
    """No subnormal entries in Poisson's factors; one planted subnormal in
    a factor is counted."""
    A = poisson2d(12)
    ref, port = _pair(A)
    assert port.subnormals() == ref.subnormals() == 0
    lu = next(iter(port.fac.tree["lu"].values()))
    lu[0, 0, -1] = 1e-310
    assert port.subnormals() == 1


def test_draw_and_delete_factors(tmp_path):
    """``draw`` writes the JAX package's factor-layout file byte for byte;
    ``delete_factors`` keeps the analysis and the next solve factors
    again."""
    A = poisson2d(10)
    ref, port = _pair(A, (10, 10))
    ref.draw(str(tmp_path / "ref.gnuplot"))
    port.draw(str(tmp_path / "port.gnuplot"))
    want = (tmp_path / "ref.gnuplot").read_text().replace("ref.gnuplot", "")
    got = (tmp_path / "port.gnuplot").read_text().replace("port.gnuplot", "")
    assert got == want and got.count("\n") > A.n
    b = _rhs(A)
    x, _ = port.solve(b)
    port.delete_factors()
    assert port.fac is None and port.plan is not None
    x2, rc = port.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    np.testing.assert_array_equal(x2, x)
