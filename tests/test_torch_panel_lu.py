"""K4 (panel LU), its blocked LU and ``batched_lu`` against the JAX
package: the plain K4 version against ``pallas_panel_lu`` in interpret
mode, ``panel_perm`` exactly, the blocked LU against the JAX one over
the interpreted kernel, and the routing of ``batched_lu`` by size."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_ref  # noqa: F401  (one torch thread a test worker)

from strumpack_tpu.ops import pallas_panel_lu as PPJ

from strumpack_tpu_torch.ops import front_lu as FL
from strumpack_tpu_torch.ops import panel_lu as PP


def test_panel_plain_matches_pallas_interpret():
    """A panel with finished rows above it (row0 > 0) and pivots limited
    to rows < slim < p: pivot rows identical, values within 1e-12 of the
    largest entry (f64, same elimination order), rows < row0 untouched."""
    rng = np.random.default_rng(2)
    nf, p, w, row0, slim = 3, 40, 8, 12, 32
    panel = rng.standard_normal((nf, p, w))
    panel[0, :, 0] = 0.0                      # a zero pivot: replaced
    want, wpr = PPJ.pallas_panel_lu(jnp.asarray(panel), 1e-3, row0=row0,
                                    w=w, slim=slim, interpret=True)
    got, pr = PP.panel_lu(torch.from_numpy(panel), 1e-3, row0, w, slim)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(wpr))
    assert ((pr.numpy() >= row0) & (pr.numpy() < slim)).all()
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy()[:, :row0], panel[:, :row0])
    assert got[0, pr[0, 0], 0] == 1e-3


def test_panel_plain_without_pivoting():
    rng = np.random.default_rng(6)
    nf, p, w = 2, 24, 8
    panel = rng.standard_normal((nf, p, w))
    panel[:, 4:4 + w] += 8 * np.eye(w)
    want, wpr = PPJ.pallas_panel_lu(jnp.asarray(panel), 0.0, row0=4, w=w,
                                    slim=p, pivot=False, interpret=True)
    got, pr = PP.panel_lu(torch.from_numpy(panel), 0.0, 4, w, p, pivot=False)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(wpr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("row0", [0, 5])
def test_panel_perm_exact(row0):
    rng = np.random.default_rng(row0)
    nf, p, w = 4, 30, 7
    pr = np.stack([row0 + rng.choice(p - row0, size=w, replace=False)
                   for _ in range(nf)]).astype(np.int32)
    want = np.asarray(PPJ.panel_perm(jnp.asarray(pr), p, row0, w))
    got = PP.panel_perm(torch.from_numpy(pr.astype(np.int64)), p, row0, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_blocked_factor_bucket_matches_jax():
    """The blocked LU with 32-wide panels (two panels of a partial
    factorization with a CB) against the JAX blocked LU over the interpreted
    kernel: perm identical, every output within 1e-11 of its largest entry
    (f64; the two triangular solves differ: LAPACK here, a
    Neumann-series inverse in the JAX package)."""
    p, s = 80, 64
    rng = np.random.default_rng(p + s)
    F = rng.standard_normal((2, p, p))
    want = PPJ.blocked_factor_bucket(jnp.asarray(F), 1e-3, s, panel_w=32,
                                     interpret=True)
    got = PP.blocked_factor_bucket(torch.from_numpy(F), 1e-3, s, panel_w=32)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name, a, b in zip(("lu", "perm", "L21", "U12", "CB"), got, want):
        b = np.asarray(b)
        if name != "perm" and b.size:
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-11 * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("m,route", [(1, "k2"), (64, "k2"), (65, "k4"),
                                     (256, "k4"), (8192, "k4"),
                                     (8193, "library")])
def test_batched_lu_routes_by_size(monkeypatch, m, route):
    """batched_lu sends m <= 64 to K2, m <= 8192 to the blocked LU over
    K4 and larger blocks to the library LU, the JAX package's routing
    (pallas_panel_lu.py:212-222, with MAX_PALLAS_P and MAX_PANEL_P the same
    in both packages)."""
    assert (FL.MAX_PALLAS_P, PP.MAX_PANEL_P) == (64, PPJ.MAX_PANEL_P)
    taken = []
    monkeypatch.setattr(FL, "factor_bucket",
                        lambda F, *a, **k: taken.append("k2") or (F, None))
    monkeypatch.setattr(PP, "blocked_factor_bucket",
                        lambda F, *a, **k: taken.append("k4") or (F,) * 5)
    monkeypatch.setattr(torch.linalg, "lu_factor_ex",
                        lambda F: taken.append("library") or (F, None, None))
    monkeypatch.setattr(FL, "lapack_pivots_to_perm", lambda lu, piv: None)
    monkeypatch.setattr(FL, "replace_tiny_diagonal", lambda lu, th: None)
    F = torch.zeros(()).expand(1, m, m)       # no m x m allocation
    PP.batched_lu(F, 0.0)
    assert taken == [route]


def test_batched_lu_tiles_against_lapack():
    """Full LU of 64- and 96-row tiles (K2 and K4 routes): P A = L U to
    1e-13 and the same permutation as LAPACK's partial pivoting on
    well-separated random tiles."""
    rng = np.random.default_rng(12)
    for m in (64, 96):
        A = rng.standard_normal((3, m, m))
        lu, perm = PP.batched_lu(torch.from_numpy(A), 0.0)
        lu, perm = lu.numpy(), perm.numpy()
        wlu, piv, _ = torch.linalg.lu_factor_ex(torch.from_numpy(A))
        np.testing.assert_array_equal(
            perm, FL.lapack_pivots_to_perm(wlu, piv).numpy())
        for f in range(3):
            L = np.tril(lu[f], -1) + np.eye(m)
            np.testing.assert_allclose(L @ np.triu(lu[f]), A[f][perm[f]],
                                       rtol=0, atol=1e-13 * m)


# Every panel of the blr50 tile LUs (tiles t = 96, 128, 192, 256, cut into
# 128-wide panels as blocked_factor_bucket cuts them): f32, one CTA each.
BLR50_PANELS = [(96, 96, 0), (128, 128, 0), (192, 128, 0), (192, 64, 128),
                (256, 128, 0), (256, 128, 128)]


@pytest.mark.parametrize("p,w,row0", BLR50_PANELS)
def test_k4_design_of_blr_panels(p, w, row0):
    assert PP.design(p, w, 4, row0) == ("cta", 1)


@pytest.mark.parametrize("p,w,row0,itemsize,want", [
    (256, 128, 0, 8, ("cluster", 2)),      # f64: 128 rows a CTA
    (256, 128, 128, 8, ("cta", 1)),
    (300, 96, 30, 8, ("cluster", 3)),
    (257, 128, 0, 4, ("cluster", 2)),
    (2048, 128, 0, 4, ("cluster", 8)),
    (4096, 128, 0, 4, ("cluster", 16)),    # the largest (non-portable) cluster
    (4097, 128, 0, 4, ("global", 0)),
    (8192, 128, 0, 4, ("global", 0)),
    (2048, 64, 0, 8, ("cluster", 16)),
    (4096, 64, 0, 8, ("global", 0))])
def test_k4_design_by_shape(p, w, row0, itemsize, want):
    """One CTA holds 256 rows in f32 (one thread a row) or 128 in f64 (two
    threads a row); a cluster of up to 16 CTAs holds more; the rest is
    eliminated in global memory."""
    assert PP.design(p, w, itemsize, row0) == want


def test_k4_design_rejects_what_no_design_takes():
    with pytest.raises(ValueError):
        PP.design(256, 129, 4)
    with pytest.raises(ValueError):
        PP.design(256, 64, 2)
