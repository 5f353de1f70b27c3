"""Every fill-reducing ordering of the port but GEOMETRIC (nested
dissection with the BFS, multilevel and spectral splitters, natural, RCM,
AMD, MMD, MLF with etree amalgamation) gives the JAX package's
permutation, tree, symbolic factorization and level plan, array for array,
on a grid matrix given without its grid and on a pattern-unsymmetric
random matrix; and the native orderings agree call for call."""
import numpy as np
import pytest
import scipy.sparse.linalg

import torch_ref  # noqa: F401  (one torch thread a test worker)

import strumpack_tpu as sj
from strumpack_tpu import native as sj_native
from strumpack_tpu.sparse.csr import CSRMatrix as SJ_CSR
from strumpack_tpu.sparse.gen import poisson2d

import strumpack_tpu_torch as st
from strumpack_tpu_torch import native as st_native

from test_torch_plan import assert_plans_identical


def _unsymmetric150():
    """``test_sparse_seq.py::test_unsymmetric_pattern``'s matrix."""
    from scipy.sparse import eye, random as sprandom
    rng = np.random.default_rng(7)
    B = sprandom(150, 150, density=0.02, random_state=rng, format="csr")
    return SJ_CSR.from_scipy((B + eye(150, format="csr") * 10.0).tocsr())


MATRICES = {"p2d12": lambda: poisson2d(12), "unsym150": _unsymmetric150}
STRATEGIES = [m.name for m in st.ReorderingStrategy if m.name != "GEOMETRIC"]


def _seeded_eigsh(eigsh):
    """scipy's eigsh with a starting vector fixed by the problem size: with
    none, ARPACK starts from OS entropy, and the sign of the Fiedler vector
    (so the SPECTRAL split) may differ from call to call in either
    package."""
    def run(A, *args, **kw):
        kw.setdefault("v0", np.random.default_rng(A.shape[0]).uniform(
            -1.0, 1.0, A.shape[0]))
        return eigsh(A, *args, **kw)
    return run


@pytest.fixture(scope="module", params=sorted(MATRICES))
def matrix(request):
    return MATRICES[request.param]()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ordering_plan_identical(matrix, strategy):
    A = matrix
    ref = sj.SparseSolver(sj.SPOptions(
        reordering_method=sj.ReorderingStrategy[strategy]))
    port = st.SparseSolver(st.SPOptions(
        reordering_method=st.ReorderingStrategy[strategy]), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scipy.sparse.linalg, "eigsh",
                   _seeded_eigsh(scipy.sparse.linalg.eigsh))
        ref.set_csr_matrix(A)
        assert ref.reorder().name == "SUCCESS"
        port.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
        assert port.reorder().name == "SUCCESS"
    port.tree.check(A.n)
    assert_plans_identical(ref, port)


def test_native_orderings_identical(matrix):
    """The three native wrappers of each package, called directly on the
    symmetrized pattern: both packages' libraries load (the native path,
    not the Python fallback) and give the same arrays."""
    S = matrix.symmetrize_sparsity()
    args = (S.rowptr, S.colind, S.n)
    for method in ("bfs", "ml"):
        a = sj_native.nested_dissection_native(*args, leaf=16, method=method)
        b = st_native.nested_dissection_native(*args, leaf=16, method=method)
        assert a is not None and b is not None, method
        for x, y in zip(a[:2], b[:2]):
            np.testing.assert_array_equal(x, y)
        for name in ("sep_begin", "sep_end", "parent", "lch", "rch"):
            np.testing.assert_array_equal(getattr(a[2], name),
                                          getattr(b[2], name))
        b[2].check(S.n)
    for multiple in (False, True):
        a = sj_native.min_degree_native(*args, multiple=multiple)
        b = st_native.min_degree_native(*args, multiple=multiple)
        assert a is not None and b is not None
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.sort(b), np.arange(S.n))
    a = sj_native.min_fill_native(*args)
    b = st_native.min_fill_native(*args)
    assert a is not None and b is not None
    np.testing.assert_array_equal(a, b)


def test_nd_takes_the_native_path(matrix):
    """ND and METIS through the solver give exactly the native orderings'
    permutations (no fallback to the Python bisection)."""
    S = matrix.symmetrize_sparsity()
    for strategy, method in (("ND", "bfs"), ("METIS", "ml")):
        s = st.SparseSolver(st.SPOptions(
            reordering_method=st.ReorderingStrategy[strategy]), device="cpu")
        s.set_csr_matrix(st.CSRMatrix(S.n, matrix.rowptr, matrix.colind,
                                      matrix.data))
        s.reorder()
        perm = st_native.nested_dissection_native(
            S.rowptr, S.colind, S.n, leaf=s.opts.nd_leaf, method=method)[0]
        np.testing.assert_array_equal(s.perm, perm)
