"""K2 (small-front LU), K3 (cross-shape front LU) and the library route
against the JAX package: the plain K2 and K3 versions against
``pallas_factor_bucket`` and ``pallas_partial_factor`` in interpret mode,
the no-pivot elimination against ``nopivot_factor_bucket_xla``, the
library route against ``_factor_bucket``'s XLA path."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_ref  # noqa: F401  (one torch thread a test worker)

from strumpack_tpu.frontal.numeric import _factor_bucket
from strumpack_tpu.ops.pallas_lu import (nopivot_factor_bucket_xla,
                                         pallas_factor_bucket,
                                         pallas_partial_factor)

from strumpack_tpu_torch.ops import front_lu as FL

NAMES = ("lu", "perm", "L21", "U12", "CB")


def _fronts(rng, nf, p, s, dtype):
    F = rng.standard_normal((nf, p, p)).astype(dtype)
    F[0, :, 0] = 0.0                  # zero pivot: replaced by thresh
    F[1, :s, 1] *= 1e-7               # tiny column: pivot below thresh
    F[-1, 0, 0] = 1e-3                # a small diagonal entry: must pivot
    return F


@pytest.mark.parametrize("nf,p,s", [(5, 24, 8), (3, 48, 16), (2, 160, 32)])
def test_plain_matches_pallas_interpret(nf, p, s):
    rng = np.random.default_rng(nf * 100 + p)
    F = _fronts(rng, nf, p, s, np.float32)
    thresh = 1e-3
    want = pallas_partial_factor(jnp.asarray(F), thresh=thresh, s_pad=s,
                                 pivot=True, interpret=True)
    got = FL.partial_factor(torch.from_numpy(F), thresh, s)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1][-1, 0] != 0          # the small diagonal entry pivoted
    # f32 outputs of the same elimination: the two differ only in where
    # rounding falls (the Schur GEMM and JAX's masked-sum formulation), a
    # few ulps of the largest entry times the element growth of random
    # fronts, so 1e-5 of each output's largest entry
    for name, a, b in zip(NAMES, got, want):
        if name == "perm":
            continue
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    d = np.abs(np.diagonal(got[0].numpy(), axis1=1, axis2=2))
    assert d[0, 0] == np.float32(thresh) and d[1, 1] == np.float32(thresh)


def test_cross_ties_take_the_lowest_position():
    """Integer-valued fronts (equal magnitudes everywhere): among equal
    |.| candidates the row at the lowest current position wins, positions
    counted after the earlier swaps (the masked min over row indices of
    pallas_lu.py:190 after its arithmetic swaps).  f64; perm identical,
    values to 1e-12 of each output's largest entry."""
    rng = np.random.default_rng(17)
    nf, p, s = 4, 40, 16
    F = rng.integers(-2, 3, size=(nf, p, p)).astype(np.float64)
    want = pallas_partial_factor(jnp.asarray(F), thresh=1e-3, s_pad=s,
                                 pivot=True, interpret=True)
    got = FL.partial_factor(torch.from_numpy(F), 1e-3, s)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name, a, b in zip(NAMES, got, want):
        if name != "perm":
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-12 * np.abs(b).max(),
                                       err_msg=name)
    # a tie the lowest position decides: column 0 holds +-2 in rows 1 and
    # 3 of front 0 below a 1 in row 0; row 1 wins, then the displaced row 0
    # sits at position 1 and competes from there
    G = np.eye(6)
    G[:4, 0] = [1.0, 2.0, 1.0, -2.0]
    G[:4, 1] = [3.0, 0.0, 0.0, 1.5]
    got = FL.partial_factor(torch.from_numpy(G[None]), 0.0, 4)
    want = pallas_partial_factor(jnp.asarray(G[None]), s_pad=4, pivot=True,
                                 interpret=True)
    assert got[1][0].tolist() == np.asarray(want[1])[0].tolist()
    assert got[1][0, :2].tolist() == [1, 0]


def test_library_route_matches_xla_path():
    """The library route (LAPACK pivots converted to the applied perm,
    tiny diagonal entries of U replaced after the LU) against the JAX
    package's XLA path in f64.  Same LAPACK algorithm in both: agreement
    to 1e-12 of each output's largest entry (a few hundred ulps, room for
    the two builds' blocked-LU and GEMM summation orders)."""
    rng = np.random.default_rng(5)
    nf, p, s = 4, 40, 24
    F = _fronts(rng, nf, p, s, np.float64)
    thresh = 1e-4
    want = _factor_bucket(jnp.asarray(F), jnp.asarray(thresh), s)
    got = FL.library_factor(torch.from_numpy(F), thresh, s)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name, a, b in zip(NAMES, got, want):
        if name == "perm":
            continue
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)
    d = np.abs(np.diagonal(got[0].numpy(), axis1=1, axis2=2))
    assert d[0, 0] == thresh


def test_lapack_pivots_to_perm():
    """Exact against the sequential-swap definition of LAPACK pivots."""
    rng = np.random.default_rng(9)
    nf, s = 6, 13
    A = torch.from_numpy(rng.standard_normal((nf, s, s)))
    lu, piv, _ = torch.linalg.lu_factor_ex(A)
    perm = FL.lapack_pivots_to_perm(lu, piv).numpy()
    for f in range(nf):
        want = np.arange(s)
        for i, j in enumerate(piv[f].numpy() - 1):
            want[[i, j]] = want[[j, i]]
        np.testing.assert_array_equal(perm[f], want)
        # and it is the applied form: P A = L U
        L = np.tril(lu[f].numpy(), -1) + np.eye(s)
        U = np.triu(lu[f].numpy())
        np.testing.assert_allclose(L @ U, A[f].numpy()[want], atol=1e-12)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("nf,p,s", [(9, 16, 12), (3, 32, 24), (1, 8, 8)])
def test_small_lu_plain_matches_pallas_interpret(pivot, nf, p, s):
    """The shapes tests/test_pallas_lu.py runs: perm identical, the packed
    front within 1e-12 of its largest entry.  f64 elimination, same pivot
    rule and operation order; the two differ only where rounding falls
    (JAX's masked-sum formulation), a few ulps times the element growth."""
    rng = np.random.default_rng(nf * p + pivot)
    F = rng.standard_normal((nf, p, p))
    if not pivot:   # diagonally dominant so no-pivot elimination is stable
        F += np.eye(p) * 8
    thresh = 1e-3
    want, wperm = pallas_factor_bucket(jnp.asarray(F), thresh=thresh,
                                       s_pad=s, pivot=pivot, interpret=True)
    got, perm = FL.factor_bucket(torch.from_numpy(F), thresh, s, pivot)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_small_lu_pivot_order():
    """A block that needs row pivoting (tests/test_pallas_lu.py:50)."""
    A = np.array([[1e-7, 1.0], [1.0, 1.0]])
    packed, perm = FL.factor_bucket(torch.from_numpy(A[None]), 0.0, 2)
    assert perm[0].tolist() == [1, 0]
    assert abs(np.triu(packed[0].numpy())[0, 0]) == 1.0


def test_small_lu_ties_take_the_lowest_row():
    """Among equal |.| candidates the lowest unpivoted row wins, as in the
    TPU kernel (pallas_lu.py:74-77); pivoted rows never return."""
    A = np.array([[1.0, 2.0, 0.0],
                  [-1.0, 0.0, 1.0],
                  [1.0, 1.0, 3.0]])
    want, wperm = pallas_factor_bucket(jnp.asarray(A[None]), s_pad=3,
                                       pivot=True, interpret=True)
    got, perm = FL.factor_bucket(torch.from_numpy(A[None]), 0.0, 3)
    assert perm[0].tolist() == np.asarray(wperm)[0].tolist()
    assert perm[0, 0] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)


def test_small_lu_tiny_pivot_replacement():
    """An exactly singular leading block (tests/test_pallas_lu.py:75): the
    tiny pivots are replaced during the elimination, as in the kernel."""
    A = np.zeros((4, 4))
    A[2, 2] = A[3, 3] = 1.0
    want, wperm = pallas_factor_bucket(jnp.asarray(A[None]), thresh=1e-3,
                                       s_pad=4, pivot=True, interpret=True)
    got, perm = FL.factor_bucket(torch.from_numpy(A[None]), 1e-3, 4)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d = np.abs(np.diag(got[0].numpy()))
    assert (d >= 1e-3).all() and np.isfinite(got.numpy()).all()


def test_nopivot_factor_bucket_matches_xla():
    """f64, 1e-12 of the largest entry: the same elimination order."""
    rng = np.random.default_rng(3)
    nf, p, s = 5, 24, 16
    F = rng.standard_normal((nf, p, p)) + np.eye(p) * 10
    F[1, 0, 0] = 0.0                  # a zero pivot, replaced by thresh
    want = np.asarray(nopivot_factor_bucket_xla(jnp.asarray(F), 1e-3, s))
    got = FL.nopivot_factor_bucket(torch.from_numpy(F), 1e-3, s).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert got[1, 0, 0] == 1e-3


def test_cross_plain_without_pivoting():
    """K3's no-pivot mode (pallas_partial_factor(pivot=False)), f32 as in
    test_plain_matches_pallas_interpret."""
    rng = np.random.default_rng(4)
    nf, p, s = 3, 40, 16
    F = (rng.standard_normal((nf, p, p)) + np.eye(p) * 8).astype(np.float32)
    want = pallas_partial_factor(jnp.asarray(F), thresh=1e-3, s_pad=s,
                                 pivot=False, interpret=True)
    got = FL.partial_factor(torch.from_numpy(F), 1e-3, s, pivot=False)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name, a, b in zip(NAMES, got, want):
        if name != "perm":
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("p,nf,want", [
    (28, 1, (32, 1)), (32, 256, (32, 2)), (32, 5000, (32, 8)),
    (33, 16, (64, 1)), (64, 16, (64, 1)), (52, 2048, (64, 4)),
    (64, 264, (64, 2)), (64, 265, (64, 3))])
def test_k2_layout_by_p_and_nf(p, nf, want):
    """K2 holds one row a thread: one warp a front up to 32 rows, two up
    to 64; a CTA packs up to 8 or 4 fronts, as many as it takes to give
    each of the H100's 132 SMs a CTA."""
    assert FL.k2_layout(p, nf) == want


@pytest.mark.parametrize("p,s,nf,itemsize,want", [
    (48, 16, 8192, 4, (16, 2, 4)), (80, 16, 4096, 4, (16, 3, 2)),
    (216, 24, 1024, 4, (24, 7, 1)), (32, 8, 2048, 4, (8, 1, 8)),
    (32, 8, 4, 4, (8, 1, 1)), (24, 8, 300, 8, (8, 1, 3)),
    (68, 4, 32, 4, (8, 3, 1)), (160, 32, 8, 8, (32, 5, 1)),
    (384, 64, 512, 4, (64, 12, 1)), (256, 64, 64, 8, (64, 8, 1)),
    (432, 48, 32, 4, (48, 14, 1)), (640, 8, 32, 8, (8, 20, 1))])
def test_k3_layout_by_shape(p, s, nf, itemsize, want):
    """K3 holds one row of [F11; F21] a thread: the width bucket (the pad
    sizes 8, 16, 24, 32, 48, 64) >= s, a
    front of ceil(p / 32) warps, up to 256 threads of fronts a CTA but only
    as many as it takes to give each of the H100's 132 SMs a CTA."""
    assert FL.k3_layout(p, s, nf, itemsize) == want


@pytest.mark.parametrize("p,s,itemsize", [
    (128, 96, 4), (448, 64, 4), (320, 64, 8), (1024, 32, 4), (16, 16, 4),
    (416, 48, 8)])
def test_k3_layout_rejects_what_it_cannot_hold(p, s, itemsize):
    """s > 64, more rows than the registers of a CTA hold at that width
    (``K3_MAX_THREADS``: 384 f32 or 256 f64 rows at s = 64), or s = p."""
    with pytest.raises(ValueError):
        FL.k3_layout(p, s, 8, itemsize)


def test_k2_layout_rejects_wide_fronts():
    with pytest.raises(ValueError):
        FL.k2_layout(65, 1)
