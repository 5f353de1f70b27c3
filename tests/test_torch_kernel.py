"""The port's kernel-matrix machine learning (``strumpack_tpu_torch/
kernel``, ``structured/hss_sample.hss_from_neighbors``) against the JAX
package's, on the CPU.

The point sets are the JAX tests' (``tests/test_structured.py``,
``tests/test_kernel_ann.py``) at n <= 600.  Clustering and the
approximate kNN are the same numpy code with the same draws: identical
orders, neighbours and distances.  Kernel blocks and the dense-built HSS
and HODLR fits in f64 agree to rounding.  The neighbour-built and the
matrix-free HSS compress by greedy interpolative decompositions, whose
pivots follow near ties that rounding decides differently in XLA and in
PyTorch, so they agree to within their compression error, and to
rounding where both take the JAX package's ID.  The JAX package's
structured code is traced as one program per call
(``torch_ref.jit_jax_structured``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref

from strumpack_tpu.kernel import clustering as CJ
from strumpack_tpu.kernel import kernel as KJ
from strumpack_tpu.structured import hss_sample as SJ

from strumpack_tpu_torch import interop
from strumpack_tpu_torch.kernel import clustering as CT
from strumpack_tpu_torch.kernel import kernel as KT
from strumpack_tpu_torch.structured import draws
from strumpack_tpu_torch.structured import hss_sample as ST


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(autouse=True)
def replay(monkeypatch):
    monkeypatch.setattr(draws, "draw", torch_ref.jax_draw)
    torch_ref.jit_jax_structured(monkeypatch)


def _regression(n=600, seed=1):
    """``tests/test_structured.py::test_kernel_matrix_free_fit``'s data."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2))
    return X, np.sin(X[:, 0]) + 0.5 * np.cos(2 * X[:, 1])


@pytest.mark.parametrize("method", ["natural", "kd", "2means", "pca",
                                    "cobble"])
def test_clustering_orders_identical(method):
    X = np.random.default_rng(0).standard_normal((500, 3))
    np.testing.assert_array_equal(
        CT.binary_tree_clustering(method, X, leaf=32),
        CJ.binary_tree_clustering(method, X, leaf=32))


def test_approximate_knn_identical():
    X = np.random.default_rng(1).standard_normal((300, 2))
    nj, dj = CJ.approximate_knn(X, k=5, n_trees=6)
    nt, dt = CT.approximate_knn(X, k=5, n_trees=6)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(dt, dj)


KERNELS = {"gauss": ("GaussKernel", {}), "laplace": ("LaplaceKernel", {}),
           "anova": ("ANOVAKernel", {"p": 2})}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_eval_matches_jax(name):
    cls, kw = KERNELS[name]
    X = np.random.default_rng(2).standard_normal((90, 3))
    kj = getattr(KJ, cls)(h=0.8, lam=2.0, **kw)
    kt = getattr(KT, cls)(h=0.8, lam=2.0, device="cpu", **kw)
    assert _rel(kt.eval(X[:50], X[20:]), kj.eval(X[:50], X[20:])) < 1e-14
    Xi, Xj = X[:40, None, :], X[None, 50:, :]
    assert _rel(kt.eval_pairs(torch.from_numpy(Xi), torch.from_numpy(Xj)),
                kj.eval_pairs(jnp.asarray(Xi), jnp.asarray(Xj))) < 1e-14


def test_dense_kernel_matches_jax():
    """A DenseKernel's blocks and its HODLR fit on index points."""
    X, y = _regression(200)
    K = np.exp(-((X[:, None] - X[None]) ** 2).sum(-1) / 2.0)
    idx = np.arange(200.0)[:, None]
    kj, kt = KJ.DenseKernel(K, lam=2.0), KT.DenseKernel(K, lam=2.0,
                                                       device="cpu")
    assert _rel(kt.eval(idx[:30], idx[50:]), kj.eval(idx[:30], idx[50:])) \
        == 0.0
    wj = kj.fit_HODLR(idx, y, leaf_size=32, rel_tol=1e-10)
    wt = kt.fit_HODLR(idx, y, leaf_size=32, rel_tol=1e-10)
    assert _rel(wt, wj) < 1e-8


def _neighbor_setting(n=600, lam=2.0):
    """``tests/test_kernel_ann.py``'s setting in f64: 600 points in
    recursive-PCA order, their kNN graph, both packages' element
    closures and the dense K + lam I."""
    X = np.random.default_rng(0).standard_normal((n, 2))
    Xo = X[KT.recursive_pca_order(X, leaf=32)]
    np.testing.assert_array_equal(Xo, X[KJ.recursive_pca_order(X, leaf=32)])
    nbr, _ = CT.approximate_knn(Xo, k=12)
    kj = KJ.GaussKernel(h=1.0, lam=lam)
    kt = KT.GaussKernel(h=1.0, lam=lam, device="cpu")
    Xj, Xt = jnp.asarray(Xo), torch.from_numpy(Xo)

    def elem_j(I, J):
        I2, J2 = jnp.broadcast_arrays(jnp.asarray(I), jnp.asarray(J))
        return kj.eval_pairs(Xj[I2], Xj[J2]) + lam * (I2 == J2)

    def elem_t(I, J):
        I2, J2 = torch.broadcast_tensors(I, J)
        return kt.eval_pairs(Xt[I2], Xt[J2]) + lam * (I2 == J2)
    K = np.asarray(kj.eval(Xj, Xj)) + lam * np.eye(n)
    return nbr, elem_j, elem_t, K


_JAX_ID_ROWS = jax.jit(SJ._id_rows, static_argnums=(1, 2))


def _jax_id_rows(F, tol, r):
    """The JAX package's interpolative decomposition for the port, traced
    as one program a shape (op by op it compiled each step)."""
    X, J, rk = _JAX_ID_ROWS(jnp.asarray(F.numpy()), tol, r)
    return tuple(torch.from_numpy(np.array(a)) for a in (X, J, rk))


@pytest.mark.parametrize("ids", ["own", "shared"])
def test_hss_from_neighbors_matches_jax(ids, monkeypatch):
    """The neighbour-built HSS: the same ranks and memory, the leaf
    blocks to rounding.
    With the JAX package's ID in both, on entries read from one K
    ("shared"), the rest of the build (candidate columns, masks, the level
    recursion) gives products and ULV solves within 1e-10.  With each package's own ID the pivots
    follow near ties that rounding decides (the leaf bases differ by
    4e-2), so the products agree to within the compression error: within
    1e-5 of each other (measured 1.0e-6), each within 1e-4 of K V."""
    n = 600
    nbr, elem_j, elem_t, K = _neighbor_setting(n)
    if ids == "shared":
        # the same ID on the same entries: both read one K
        monkeypatch.setattr(ST, "_id_rows", _jax_id_rows)
        Kj, Kt = jnp.asarray(K), torch.from_numpy(K)

        def elem_j(I, J):
            return Kj[I, J]

        def elem_t(I, J):
            return Kt[I, J]
    kw = dict(leaf_size=64, max_rank=40, rel_tol=1e-7)
    Hj = SJ.hss_from_neighbors(elem_j, nbr, n, dtype=jnp.float64, **kw)
    Ht = ST.hss_from_neighbors(elem_t, nbr, n, dtype=torch.float64,
                               device="cpu", **kw)
    assert Ht.max_rank() == Hj.max_rank() and Ht.memory() == Hj.memory()
    for a, b in zip(Ht.ranks[0], Hj.ranks[0]):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    assert _rel(Ht.D[0], Hj.D) < 1e-14
    V = np.random.default_rng(1).standard_normal((n, 3))
    yt = Ht.matvec(torch.from_numpy(V)[None])[0]
    yj = Hj.matvec(jnp.asarray(V))
    Hj.factor()
    Ht.factor()
    xt = Ht.solve(torch.from_numpy(V)[None])[0]
    xj = Hj.solve(jnp.asarray(V))
    if ids == "shared":
        assert _rel(yt, yj) < 1e-10 and _rel(xt, xj) < 1e-10
    else:
        assert _rel(yt, yj) < 1e-5
        assert _rel(yt, K @ V) < 1e-4 and _rel(yj, K @ V) < 1e-4


def _jax_dense_fit():
    """The JAX package's dense-built f64 HSS fit of ``_regression(300)``
    (two levels of 128-point leaves, as 600 points have three: the same
    build at two thirds of its compile), as host data, computed once for
    the run (``torch_ref.shared``): the weights, 200 predictions, the
    HSS's rank and memory, the fitted state ``interop.kernel_from_numpy``
    takes, and the factored HSS's solve of y in the fit's order."""
    def fit():
        X, y = _regression(300)
        k = KJ.GaussKernel(h=1.0, lam=0.5)
        w = k.fit_HSS(X, y, leaf_size=128, rel_tol=1e-8, matrix_free=False)
        yo = y[np.asarray(k._order)]
        return dict(X=X, y=y, w=np.asarray(w), pred=np.asarray(
            k.predict(X[:200])), max_rank=np.asarray(k._M.max_rank()).item(),
            memory=np.asarray(k._M.memory()).item(),
            state=torch_ref.kernel_numpy(k), yo=yo,
            solve=np.asarray(k._M.solve(jnp.asarray(yo))))
    return torch_ref.shared("kernel-dense-fit", fit)


def test_fit_hss_dense_matches_jax():
    """The dense-built f64 HSS fit: weights within 1e-8, predictions."""
    ref = _jax_dense_fit()
    X, y = ref["X"], ref["y"]
    kt = KT.GaussKernel(h=1.0, lam=0.5, device="cpu")
    wt = kt.fit_HSS(X, y, leaf_size=128, rel_tol=1e-8, matrix_free=False)
    assert _rel(wt, ref["w"]) < 1e-8
    assert _rel(kt.predict(X[:200]), ref["pred"]) < 1e-8
    assert kt._M.max_rank() == ref["max_rank"]
    assert kt._M.memory() == ref["memory"]
    assert kt._Xtrain.device.type == "cpu" and kt._order.dtype == torch.int64


def test_fit_hodlr_matches_jax():
    """``test_gauss_kernel_fit_predict_regression``: a 1-D regression fit
    by HODLR, weights within 1e-8."""
    rng = np.random.default_rng(6)
    X = rng.uniform(-2, 2, (300, 1))
    y = np.sin(2 * X[:, 0]) + 0.01 * rng.standard_normal(300)
    kj = KJ.GaussKernel(h=0.5, lam=1e-3)
    kt = KT.GaussKernel(h=0.5, lam=1e-3, device="cpu")
    wj = kj.fit_HODLR(X, y, leaf_size=32, rel_tol=1e-8)
    wt = kt.fit_HODLR(X, y, leaf_size=32, rel_tol=1e-8)
    assert _rel(wt, wj) < 1e-8
    Xt = np.linspace(-1.5, 1.5, 50)[:, None]
    assert _rel(kt.predict(Xt), kj.predict(Xt)) < 1e-8


@functools.lru_cache(maxsize=None)
def _exact_fit():
    """``_regression()`` and the predictions of its exact dense f64 fit,
    (K + lam I) w = y solved by LAPACK (the dense-built HSS fit reaches
    them to 2e-10: it compresses at rel_tol 1e-8)."""
    X, y = _regression()
    k = KT.GaussKernel(h=1.0, lam=0.5, device="cpu")
    w = np.linalg.solve(np.asarray(k.eval(X, X)) + 0.5 * np.eye(len(X)), y)
    return X, y, np.asarray(k.eval(X[:200], X)) @ w


@pytest.mark.parametrize("compression", ["sketch", "ann"])
def test_fit_matrix_free_matches_jax(compression):
    """The matrix-free fits (sketch and ann) in float32 as the API runs
    them: both packages' predictions within the JAX test's 5e-3 of the
    dense f64 fit (its exact predictions, ``_exact_fit``) and within 2e-3
    of each other; in f64 (``_fit``'s dtype), where the ID pivots
    coincide, within 1e-6 of each other."""
    X, y, pd = _exact_fit()
    kw = dict(leaf_size=128, rel_tol=1e-8, matrix_free=True,
              compression=compression)
    kj = KJ.GaussKernel(h=1.0, lam=0.5)
    kt = KT.GaussKernel(h=1.0, lam=0.5, device="cpu")
    kj.fit_HSS(X, y, **kw)
    kt.fit_HSS(X, y, **kw)
    assert kt._weights.dtype == torch.float32
    pj, pt = kj.predict(X[:200]), kt.predict(X[:200])
    assert _rel(pj, pd) < 5e-3 and _rel(pt, pd) < 5e-3
    assert _rel(pt, pj) < 2e-3
    args = (X, y, "hss", 128, None, 1e-8, 64)
    kj._fit(*args, matrix_free=True, dtype=np.float64,
            compression=compression)
    kt._fit(*args, matrix_free=True, dtype=np.float64,
            compression=compression)
    assert _rel(kt.predict(X[:200]), kj.predict(X[:200])) < 1e-6


def test_classifier_same_labels():
    """``test_kernel_regression_classification``'s two moons: the same
    predicted labels and score."""
    rng = np.random.default_rng(5)
    n = 400
    theta = rng.uniform(0, np.pi, n)
    X1 = np.stack([np.cos(theta), np.sin(theta)], 1) \
        + 0.1 * rng.standard_normal((n, 2))
    X2 = np.stack([1 - np.cos(theta), 0.5 - np.sin(theta)], 1) \
        + 0.1 * rng.standard_normal((n, 2))
    X = np.concatenate([X1, X2])
    y = np.concatenate([np.zeros(n), np.ones(n)])
    idx = rng.permutation(2 * n)
    X, y = X[idx], y[idx]
    kw = dict(h=0.3, lam=1.0, fmt="hss", leaf_size=64, rel_tol=1e-6)
    cj = KJ.KernelRegressionClassifier(**kw).fit(X[:600], y[:600])
    ct = KT.KernelRegressionClassifier(device="cpu", **kw).fit(X[:600],
                                                               y[:600])
    np.testing.assert_array_equal(ct.predict(X[600:]), cj.predict(X[600:]))
    assert ct.score(X[600:], y[600:]) == cj.score(X[600:], y[600:]) > 0.92


def test_kernel_state_carried_across():
    """A fitted JAX kernel carried into the port (``interop``): its
    predictions, and the solve of its factored HSS, equal the JAX
    package's to 1e-12."""
    ref = _jax_dense_fit()
    kt = interop.kernel_from_numpy(ref["state"], "cpu")
    assert _rel(kt.predict(ref["X"][:200]), ref["pred"]) < 1e-12
    yo = ref["yo"]
    assert _rel(kt._M.solve(torch.from_numpy(yo)[None, :, None])[0, :, 0],
                ref["solve"]) < 1e-12


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KT.GaussKernel()
    assert KT.GaussKernel(device="cpu").device.type == "cpu"
