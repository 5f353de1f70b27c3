"""The port's structured matrices (``strumpack_tpu_torch/structured``)
against the JAX package's, f64 on the CPU, on the Schur complement of a 2D
Poisson grid onto its middle row (SPD, with the low-rank off-diagonal
blocks of a separator's front).  The JAX package's sketches are replayed
into the port's draw function, so both build the same compressions:
products (the reconstructed matrix), F11^-1 b and the fronts' Schur
pieces agree to 1e-9 relative, ranks and pivots exactly; SVD and QR signs
differ between LAPACK and XLA, so raw generators are not compared."""
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp
from torch_ref import jax_draw, shared

from strumpack_tpu.frontal import numeric as NJ
from strumpack_tpu.structured import hodlr as OJ
from strumpack_tpu.structured import hss as HJ
from strumpack_tpu.structured import hss_sample as SJ

from strumpack_tpu_torch.frontal import numeric as NT
from strumpack_tpu_torch.structured import draws
from strumpack_tpu_torch.structured import hodlr as OT
from strumpack_tpu_torch.structured import hss as HT
from strumpack_tpu_torch.structured import hss_sample as ST

TOL = 1e-9


def _schur(m, w):
    """Schur complement of the 5-point Laplacian on an m x (2w + 1) grid
    onto its middle row (m unknowns)."""
    def lap(k):
        return sps.diags([-np.ones(k - 1), 2 * np.ones(k), -np.ones(k - 1)],
                         [-1, 0, 1])
    rows = 2 * w + 1
    A = (sps.kron(sps.eye(rows), lap(m)) + sps.kron(lap(rows), sps.eye(m)))
    A = A.tocsc()
    sep = np.arange(w * m, (w + 1) * m)
    inner = np.setdiff1d(np.arange(rows * m), sep)
    Ais = A[inner][:, sep]
    X = spla.splu(A[inner][:, inner].tocsc()).solve(Ais.toarray())
    return A[sep][:, sep].toarray() - Ais.T @ X


@pytest.fixture
def S256():
    """``_schur(256, 8)``, built once for the run (``torch_ref.shared``):
    a module fixture was rebuilt by every worker each time it came back
    to the module."""
    return shared("schur-256-8", lambda: _schur(256, 8))


@pytest.fixture(autouse=True)
def replay(monkeypatch):
    monkeypatch.setattr(draws, "draw", jax_draw)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


def _jax_products(build, ranks, A, b):
    """The JAX structured matrix ``build(A)`` factored, its reconstructed
    matrix, its solve of b and ``ranks(H)``, traced as one program (op by
    op the JAX package's structured code costs seconds of compiles)."""
    def run(A, b):
        H = build(A)
        H.factor()
        return H.matvec(jnp.eye(A.shape[0], dtype=A.dtype)), H.solve(b), \
            ranks(H)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(run)(jnp.asarray(A),
                                               jnp.asarray(b)))


def _check(jax_out, Ht, A, b):
    """The port's structured matrix of one front against the JAX
    package's products: reconstructed matrix and F11^-1 b."""
    dense_j, xj, _ = jax_out
    m = A.shape[0]
    dense_t = Ht.matvec(torch.eye(m, dtype=torch.float64)[None])[0].numpy()
    assert _rel(dense_t, dense_j) < TOL
    xt = Ht.solve(torch.from_numpy(b)[None])[0].numpy()
    assert _rel(xt, xj) < TOL
    return dense_t


def _rhs(m, seed):
    return np.random.default_rng(seed).standard_normal((m, 3))


def _lowrank_plus_diag(m, k=3):
    """A diagonal plus a rank-k matrix: every off-diagonal block has rank
    at most k, so even a sparse sketch captures it exactly."""
    rng = np.random.default_rng(8)
    return (np.diag(4.0 + rng.random(m))
            + rng.standard_normal((m, k)) @ rng.standard_normal((k, m)) / m)


@pytest.mark.parametrize("m,leaf", [(1, 4), (16, 16), (17, 16), (256, 32),
                                    (300, 64), (4096, 128), (10000, 256)])
def test_pad_pow2(m, leaf):
    assert HT._pad_pow2(m, leaf) == HJ._pad_pow2(m, leaf)


def test_id_rows_matches_jax():
    """The same ranks and pivot rows within them (later pivots pick among
    rounding-level residuals, and the rank mask zeroes them); the
    interpolation matrices to 1e-12 of their size."""
    rng = np.random.default_rng(3)
    F = np.stack([rng.standard_normal((40, k)) @ rng.standard_normal((k, 24))
                  for k in (3, 7, 24)])
    F[1, 5] = 0.0
    Xj, Jj, rj = SJ._id_rows(jnp.asarray(F), 1e-10, 12)
    Xt, Jt, rt = ST._id_rows(torch.from_numpy(F), 1e-10, 12)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    for f, k in enumerate(np.asarray(rj)):
        np.testing.assert_array_equal(Jt[f, :k].numpy(),
                                      np.asarray(Jj)[f, :k])
    assert _rel(Xt.numpy(), np.asarray(Xj)) < 1e-12


@pytest.mark.parametrize("leaf,rank,tol", [(32, 32, 1e-10), (32, 8, 1e-6),
                                           (64, 16, 1e-8)])
def test_hss_matches_jax(S256, leaf, rank, tol):
    """HSSMatrix from the dense matrix: the leaf ranks, the reconstructed
    matrix and the ULV solve."""
    b = _rhs(256, 1)
    out = _jax_products(lambda A: HJ.HSSMatrix(A, leaf_size=leaf,
                                               max_rank=rank, rel_tol=tol),
                        lambda H: H.ranks[0], S256, b)
    Ht = HT.HSSMatrix(torch.from_numpy(S256)[None], leaf_size=leaf,
                      max_rank=rank, rel_tol=tol)
    for a, r in zip(Ht.ranks[0], out[2]):
        np.testing.assert_array_equal(a[0].numpy(), r)
    dense = _check(out, Ht, S256, b)
    if rank == leaf:
        assert _rel(dense, S256) < 1e-8


@pytest.mark.parametrize("m,leaf,rank", [(256, 32, 12), (1024, 128, 24)])
def test_hodlr_matches_jax(m, leaf, rank):
    """HODLRMatrix from the dense matrix: at 1024 the top level's 512-wide
    blocks take the randomized range finder, on the JAX package's
    sketches (keys folded with the level and the block's first entry)."""
    S = _schur(m, 4)
    b = _rhs(m, 2)
    out = _jax_products(lambda A: OJ.HODLRMatrix(A, leaf_size=leaf,
                                                 max_rank=rank, rel_tol=1e-8),
                        lambda H: H.rank_arrays, S, b)
    Ht = OT.HODLRMatrix(torch.from_numpy(S)[None], leaf_size=leaf,
                        max_rank=rank, rel_tol=1e-8)
    for a, r in zip(Ht.ranks, out[2]):
        assert int(a[0]) == int(r.max())
    _check(out, Ht, S, b)


@pytest.mark.parametrize("sketch", ["gaussian", "sjlt"])
def test_hss_from_sampling_matches_jax(S256, sketch):
    """Sampled HSS from a product closure and an element closure: the
    same interpolative rows a level, ranks, reconstruction and solve.  The
    sparse SJLT sketch runs on a matrix whose off-diagonal blocks it
    captures exactly (on the Schur complement its approximation error is
    1e-2, and the two packages' roundings move it at 1e-6)."""
    A = S256 if sketch == "gaussian" else _lowrank_plus_diag(256)
    b = _rhs(256, 4)
    St = torch.from_numpy(A)

    def build_j(Aj):
        return SJ.hss_from_sampling(
            lambda X, trans: (Aj.T if trans else Aj) @ X,
            lambda I, J: Aj[I, J], 256, leaf_size=32, max_rank=24,
            rel_tol=1e-8, dtype=jnp.float64, sketch=sketch, seed=5)

    out = _jax_products(build_j, lambda H: H.ranks[0], A, b)
    Ht = ST.hss_from_sampling(
        lambda X, trans: torch.matmul(St.T if trans else St, X),
        lambda I, J: St[I, J], 256, 1, leaf_size=32, max_rank=24,
        rel_tol=1e-8, dtype=torch.float64, sketch=sketch, seed=5,
        device="cpu")
    for a, r in zip(Ht.ranks[0], out[2]):
        np.testing.assert_array_equal(a[0].numpy(), r)
    dense = _check(out, Ht, A, b)
    assert _rel(dense, A) < 1e-6


@pytest.mark.parametrize("kind", ["hss", "hodlr"])
def test_front_bucket_matches_jax(S256, kind):
    """A bucket of two dense-built structured fronts against the JAX
    package's vmapped ``_hss_front_bucket``: S12 = F11^-1 F12 and the CB
    F22 - F21 S12, each front to 1e-9 of its size."""
    rng = np.random.default_rng(6)
    s, u = 256, 48
    F = np.zeros((2, s + u, s + u))
    for f in range(2):
        F[f, :s, :s] = S256 * (1 + f)
        F[f, :s, s:] = rng.standard_normal((s, u))
        F[f, s:, :s] = rng.standard_normal((u, s))
        F[f, s:, s:] = rng.standard_normal((u, u))
    from types import SimpleNamespace
    bp = SimpleNamespace(s_pad=s, u_pad=u, hss=kind == "hss",
                         hodlr=kind == "hodlr", hodbf=False, bf_D=0,
                         hss_leaf=32, hss_rank=16)
    _, S12j, F21j, CBj = jax.jit(lambda F: NJ._hss_front_bucket(
        F, bp, 1e-8, jnp.float64))(jnp.asarray(F))
    _, S12t, F21t, CBt = NT._hss_front_bucket(torch.from_numpy(F), bp, 1e-8)
    for f in range(2):
        assert _rel(S12t[f].numpy(), np.asarray(S12j)[f]) < TOL
        assert _rel(CBt[f].numpy(), np.asarray(CBj)[f]) < TOL
    np.testing.assert_array_equal(F21t.numpy(), np.asarray(F21j))


def test_batched_fronts_are_independent(S256):
    """A batch of fronts equals its fronts built one at a time (the front
    axis replaces the JAX package's vmap), and ``cat_fronts`` rebuilds the
    batch."""
    A = torch.from_numpy(np.stack([S256, 2 * S256 + np.eye(256)]))
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 256, 2)))
    for cls in (HT.HSSMatrix, OT.HODLRMatrix):
        Hb = cls(A, leaf_size=32, max_rank=16, rel_tol=1e-8)
        ones = [cls(A[f:f + 1], leaf_size=32, max_rank=16, rel_tol=1e-8)
                for f in range(2)]
        xb = Hb.solve(b)
        for f, H in enumerate(ones):
            assert _rel(H.solve(b[f:f + 1])[0].numpy(), xb[f].numpy()) < TOL
        Hc = HT.cat_fronts(ones)
        assert Hc.nf == 2
        assert _rel(Hc.solve(b).numpy(), xb.numpy()) < TOL
