"""K3 (cross-shape front LU) and the library route against the JAX
package: the plain K3 version against ``pallas_partial_factor`` in
interpret mode, the library route against ``_factor_bucket``'s XLA path."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strumpack_tpu.frontal.numeric import _factor_bucket
from strumpack_tpu.ops.pallas_lu import pallas_partial_factor

from strumpack_tpu_torch.ops import front_lu as FL

NAMES = ("lu", "perm", "L21", "U12", "CB")


def _fronts(rng, nf, p, s, dtype):
    F = rng.standard_normal((nf, p, p)).astype(dtype)
    F[0, :, 0] = 0.0                  # zero pivot: replaced by thresh
    F[1, :s, 1] *= 1e-7               # tiny column: pivot below thresh
    F[-1, 0, 0] = 1e-3                # a small diagonal entry: must pivot
    return F


@pytest.mark.parametrize("nf,p,s", [(5, 24, 8), (3, 48, 16)])
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
