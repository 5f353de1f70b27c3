"""The port's indefinite and no-pivot paths against the JAX solver on the
same inputs (f64 on the CPU, the port's kernels through their plain
versions): inertia and pivot growth of an indefinite matrix, the
no-pivot path, and the generators' saddle point (with MC64 matching) and
shifted Helmholtz operator (with its inertia)."""
import numpy as np
import pytest
import scipy.sparse as sp

import torch_ref  # noqa: F401  (one torch thread a test worker)

from strumpack_tpu.sparse.csr import CSRMatrix as SJ_CSR

import strumpack_tpu_torch as st

from test_torch_general_solver import ERROR_TOL, _pair, _rhs, _solve_both


def test_inertia_indefinite():
    """``test_sparse_seq.py::test_inertia_indefinite``'s matrix: the
    counts, the exact flag and the pivot growth agree."""
    n = 50
    d = np.concatenate([np.full(30, 5.0), np.full(20, -5.0)])
    rng = np.random.default_rng(1)
    B = sp.random(n, n, density=0.05, random_state=rng)
    A = SJ_CSR.from_scipy(sp.csr_matrix(sp.csr_matrix(sp.diags(d))
                                        + 0.1 * (B + B.T)))
    ref, port = _pair(A, equilibration=False)
    ref.factor()
    port.factor()
    npos, nneg, nzero, rc = port.inertia()
    want = ref.inertia()
    assert (npos, nneg, nzero, rc.name) == want[:3] + (want[3].name,)
    assert npos + nneg == n
    np.testing.assert_allclose(port.pivot_growth(), ref.pivot_growth(),
                               rtol=1e-10)


def test_nopivot():
    """``pivoting=False`` on a diagonally dominant anisotropic matrix:
    K3/K2 in no-pivot mode, every permutation the identity."""
    from strumpack_tpu.sparse.gen import anisotropic3d
    A = anisotropic3d(6)
    ref, port = _pair(A, pivoting=False)
    x = _solve_both(ref, port, _rhs(A))
    assert A.max_scaled_residual(x, _rhs(A)) < ERROR_TOL * 1e-6
    assert port.inertia()[3].name == "SUCCESS"


@pytest.mark.parametrize("case", ["saddle_point2d", "helmholtz_shifted3d"])
def test_indefinite_generators(case):
    """The generators' indefinite matrices through both solvers: the
    saddle point (zero diagonal block) with MC64 matching, the shifted
    Helmholtz operator with its inertia."""
    from strumpack_tpu.sparse import gen as sj_gen
    from strumpack_tpu_torch.sparse import gen as st_gen
    args = (8,) if case == "saddle_point2d" else (6,)
    A = getattr(sj_gen, case)(*args)
    Ap = getattr(st_gen, case)(*args)
    np.testing.assert_array_equal(Ap.rowptr, A.rowptr)
    np.testing.assert_array_equal(Ap.colind, A.colind)
    np.testing.assert_array_equal(Ap.data, A.data)
    opts = (dict(matching=st.MatchingJob.MAX_DIAGONAL_PRODUCT_SCALING)
            if case == "saddle_point2d" else dict(equilibration=False))
    ref, port = _pair(A, **opts)
    b = _rhs(A)
    x = _solve_both(ref, port, b)
    assert A.max_scaled_residual(x, b) < ERROR_TOL * port.opts.rel_tol
    want = ref.inertia()
    assert port.inertia() == want[:3] + (getattr(st.ReturnCode,
                                                 want[3].name),)
