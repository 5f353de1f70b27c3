"""Butterfly and HODBF matrices in the port against the JAX package, on
the CPU in f64/complex128.

The JAX side of each case is traced as one jitted program; the port's
random draws replay the JAX package's (``torch_ref.jax_draw``), so the
sampled constructions compare number for number.  The cases are those of
``tests/test_structured.py:214-375``: butterflies of an exact low-rank
matrix and of the DFT (dense-built and from products), and the direct
HODBF factorization of an oscillatory matrix with butterfly G blocks and
a recursively factored Schur correction."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref

from strumpack_tpu.structured import butterfly as BJ
from strumpack_tpu.structured import hodbf as HJ

from strumpack_tpu_torch.interop import structured_from_numpy
from strumpack_tpu_torch.structured import butterfly as BT
from strumpack_tpu_torch.structured import draws
from strumpack_tpu_torch.structured import hodbf as HT


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(draws, "draw", torch_ref.jax_draw)


def _dft(m):
    j = np.arange(m)
    return np.exp(2j * np.pi * np.outer(j, j) / m) / np.sqrt(m)


# name: (matrix, depth, rank, tolerance, accuracy against the matrix)
BF_CASES = {
    "low_rank": (lambda rng: np.outer(rng.standard_normal(128),
                                      rng.standard_normal(128)),
                 4, 4, 1e-12, 1e-12),
    "dft": (lambda rng: _dft(256), 4, 40, 1e-9, 1e-7),
}


@pytest.mark.parametrize("case", sorted(BF_CASES))
def test_bf_compress_matches_jax(case):
    """ButterflyMatrix (bf_compress, bf_matvec, bf_rmatvec) on the JAX
    tests' matrices:
    within 1e-10 of the JAX package's products, and as accurate as the
    JAX tests ask against the matrix itself; a batch of two blocks
    compresses each as on its own."""
    make, D, r, tol, acc = BF_CASES[case]
    rng = np.random.default_rng(0)
    A = make(rng)
    X = rng.standard_normal((A.shape[1], 3)).astype(A.dtype)
    fn = jax.jit(lambda A, X: (BJ.bf_matvec(bf := BJ.bf_compress(
        A, D, r, jnp.asarray(tol)), X, D, r), BJ.bf_rmatvec(bf, X, D, r)))
    yj, zj = fn(jnp.asarray(A), jnp.asarray(X))
    B = BT.ButterflyMatrix(torch.from_numpy(A), levels=D, max_rank=r,
                           rel_tol=tol)
    yt, zt = B.matvec(torch.from_numpy(X)), B.rmatvec(torch.from_numpy(X))
    assert _rel(yt, yj) < 1e-10 and _rel(zt, zj) < 1e-10
    assert 0 < B.max_rank() <= r and B.memory() > 0
    assert _rel(yt, A @ X) < acc and _rel(zt, A.conj().T @ X) < acc
    both = BT.bf_compress(torch.from_numpy(np.stack([A, 2 * A])), D, r, tol)
    y2 = BT.bf_matvec(both, torch.from_numpy(np.stack([X, X])), D, r)
    assert _rel(y2[0], yt) < 1e-12 and _rel(y2[1], 2 * yt) < 1e-12


def test_bf_compress_rand_matches_jax(jax_draws):
    """The butterfly of the DFT from products only, on the JAX package's
    draws (PRNGKey(3)): products and adjoint products within 1e-9 of the
    JAX package's, and within 1e-7 of the DFT (test_structured.py)."""
    m, D, r = 256, 4, 32
    F = _dft(m)
    X = np.random.default_rng(0).standard_normal((m, 5)) + 0j

    def jax_side(A, X):
        bf = BJ.bf_compress_rand(lambda Y: A @ Y, lambda Y: A.conj().T @ Y,
                                 m, m, D, r, 1e-10,
                                 key=jax.random.PRNGKey(3))
        return BJ.bf_matvec(bf, X, D, r), BJ.bf_rmatvec(bf, X, D, r)
    yj, zj = jax.jit(jax_side)(jnp.asarray(F), jnp.asarray(X))
    Ft = torch.from_numpy(F)
    bt = BT.bf_compress_rand(lambda Y: Ft @ Y, lambda Y: Ft.mH @ Y, m, m, D,
                             r, 1e-10, key=(3,), dtype=torch.complex128)
    yt = BT.bf_matvec(bt, torch.from_numpy(X), D, r)
    zt = BT.bf_rmatvec(bt, torch.from_numpy(X), D, r)
    assert _rel(yt, yj) < 1e-9 and _rel(zt, zj) < 1e-9
    assert _rel(yt, F @ X) < 1e-7 and _rel(zt, F.conj().T @ X) < 1e-7


def _oscillatory(m, seed):
    """test_structured.py's oscillatory matrix: a cos kernel / 8 plus a
    dominant diagonal."""
    rng = np.random.default_rng(seed)
    j = np.arange(m)
    return (np.cos(2 * np.pi * np.outer(j, j) / m) / 8.0
            + np.eye(m) * (4.0 + 0.1 * rng.standard_normal(m)))


def _walk(f, kinds):
    kinds.append(f.kind)
    if f.kind != "leaf":
        _walk(f.f1, kinds)
        _walk(f.f2, kinds)
    return kinds


def test_hodbf_direct_factor_matches_jax(jax_draws):
    """The fixed-rank direct factorization (the sparse fronts' mode) of a
    HODBF matrix whose dense cutoff sends a node through butterfly G
    blocks and a recursively factored correction, on the JAX package's
    draws: products, solves and adjoint solves within 1e-9 of the JAX
    package's; the JAX factor chain carried into the port (``interop``)
    solves within 1e-10 of the JAX solve."""
    m, leaf, rank, cut = 128, 16, 24, 32
    A = _oscillatory(m, 11)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, 2))

    def jax_side(A, x):
        H = HJ.HODBFMatrix(A, leaf_size=leaf, max_rank=rank, rel_tol=1e-8)
        H.factor(dense_cutoff=cut, fixed=True)
        return H, H.matvec(x), H.solve_direct(x), H.rsolve(x)
    Hj, yj, sj, rj = jax.jit(jax_side)(jnp.asarray(A), jnp.asarray(x))
    Ht = HT.HODBFMatrix(torch.from_numpy(A)[None], leaf_size=leaf,
                        max_rank=rank, rel_tol=1e-8)
    Ht.factor(dense_cutoff=cut, fixed=True)
    assert "bf" in _walk(Ht._froot, [])
    xt = torch.from_numpy(x)[None]
    assert _rel(Ht.matvec(xt)[0], yj) < 1e-9
    assert _rel(Ht.solve_direct(xt)[0], sj) < 1e-9
    assert _rel(Ht.rsolve(xt)[0], rj) < 1e-9
    Hc = structured_from_numpy(torch_ref.structured_numpy(Hj), "cpu")
    assert _walk(Hc._froot, []) == _walk(Ht._froot, [])
    assert _rel(Hc.solve_direct(xt)[0], sj) < 1e-10
    assert _rel(Hc.rsolve(xt)[0], rj) < 1e-10


def test_hodbf_adaptive_factor_solves():
    """test_structured.py's direct factorization through the butterfly
    path with adaptive ranks (m = 512, dense cutoff 64), on the port's
    own draws: solve and adjoint solve to 1e-5 with at most two sweeps of
    refinement; the HODLR-preconditioned GMRES on the HODBF product to
    the same; memory and rank reported."""
    m = 512
    A = _oscillatory(m, 11)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(m)
    H = HT.HODBFMatrix(torch.from_numpy(A)[None], leaf_size=32, max_rank=48,
                       rel_tol=1e-8)
    H.factor(dense_cutoff=64)
    assert "bf" in _walk(H._froot, [])
    col = torch.from_numpy(x)[None, :, None]
    xs = H.solve(torch.from_numpy(A @ x)[None, :, None])
    assert _rel(xs[0, :, 0], x) < 1e-5 and H.iterations <= 2
    ys = H.rsolve(torch.from_numpy(A.T @ x)[None, :, None])
    assert _rel(ys[0, :, 0], x) < 1e-5
    assert _rel(H.matvec(col)[0, :, 0], A @ x) < 1e-6
    xi = H.solve_iterative(torch.from_numpy(A @ x)[None, :, None])
    assert _rel(xi[0, :, 0], x) < 1e-5
    assert 0 < H.max_rank() <= 48 and H.memory() > 0
