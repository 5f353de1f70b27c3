"""The port's MC64-family matchings and scalings equal the JAX package's on
the badly scaled unsymmetric matrix of
``test_sparse_seq.py::test_mc64_matching_badly_scaled``: the column
permutation q identical, the row and column scalings to 1e-12 relative,
and the matched, scaled matrix the same."""
import numpy as np
import pytest

import torch_ref  # noqa: F401  (one torch thread a test worker)

from strumpack_tpu.sparse import matching as sj_matching
from strumpack_tpu.sparse.csr import CSRMatrix as SJ_CSR

import strumpack_tpu_torch as st
from strumpack_tpu_torch.sparse import matching as st_matching

JOBS = {
    "MAX_CARDINALITY": "max_cardinality_matching",
    "MAX_SMALLEST_DIAGONAL": "max_smallest_diagonal_matching",
    "MAX_DIAGONAL_SUM": "max_diagonal_sum_matching",
    "MAX_DIAGONAL_PRODUCT_SCALING": "max_product_matching",
    "COMBBLAS": "awpm_matching",
}


def badly_scaled120():
    """n = 120, 3% random entries, a permuted diagonal of 10^2..10^7."""
    from scipy.sparse import csr_matrix, random as sprandom
    rng = np.random.default_rng(11)
    n = 120
    B = sprandom(n, n, density=0.03, random_state=rng, format="lil")
    p = rng.permutation(n)
    for i in range(n):
        B[i, p[i]] = 10.0 ** rng.integers(2, 8)
    return SJ_CSR.from_scipy(csr_matrix(B))


@pytest.fixture(scope="module")
def matrices():
    A = badly_scaled120()
    return A, st.CSRMatrix(A.n, A.rowptr, A.colind, A.data)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_matching_identical(matrices, job):
    A, Ap = matrices
    q0, dr0, dc0 = getattr(sj_matching, JOBS[job])(A)
    q, dr, dc = getattr(st_matching, JOBS[job])(Ap)
    np.testing.assert_array_equal(q, q0)
    np.testing.assert_array_equal(np.sort(q), np.arange(A.n))
    np.testing.assert_allclose(dr, dr0, rtol=1e-12, atol=0)
    np.testing.assert_allclose(dc, dc0, rtol=1e-12, atol=0)
    M0 = sj_matching.apply_matching(A, q0, dr0, dc0)
    M = st_matching.apply_matching(Ap, q, dr, dc)
    np.testing.assert_array_equal(M.rowptr, M0.rowptr)
    np.testing.assert_array_equal(M.colind, M0.colind)
    np.testing.assert_allclose(M.data, M0.data, rtol=1e-12, atol=0)


@pytest.mark.parametrize(
    "job", sorted(m.name for m in st.MatchingJob if m.name != "NONE"))
def test_solver_matching_identical(matrices, job):
    """Through ``SparseSolver.reorder``: each MatchingJob takes the
    matching the JAX solver takes, and the matched, scaled, permuted
    matrix the factorization sees is the same."""
    import strumpack_tpu as sj
    A, Ap = matrices
    ref = sj.SparseSolver(sj.SPOptions(matching=sj.MatchingJob[job]))
    ref.set_csr_matrix(A)
    ref.reorder()
    port = st.SparseSolver(st.SPOptions(matching=st.MatchingJob[job]),
                           device="cpu")
    port.set_csr_matrix(Ap)
    port.reorder()
    np.testing.assert_array_equal(port.mq, ref.mq)
    np.testing.assert_allclose(port.mdr, ref.mdr, rtol=1e-12, atol=0)
    np.testing.assert_allclose(port.mdc, ref.mdc, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(port.perm, ref.perm)
    np.testing.assert_allclose(port.Ap.data, ref.Ap.data, rtol=1e-12, atol=0)
