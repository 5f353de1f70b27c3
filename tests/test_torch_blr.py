"""The port's BLR pieces against the JAX package's on the CPU: RRQR tile
compression, the BLR bucket factorization and its forward/backward solve,
and the BLR plan (separator reordering, tile sizes, rank caps)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_ref  # noqa: F401  (one torch thread a test worker)

import strumpack_tpu as sj
from strumpack_tpu.frontal import blr as BJ
from strumpack_tpu.ops.rrqr import rrqr as rrqr_jax
from strumpack_tpu.sparse.gen import poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import blr as BT
from strumpack_tpu_torch.frontal import numeric as st_numeric
from strumpack_tpu_torch.ops.rrqr import rrqr


def _lowrank(m, n, k, rng):
    return rng.standard_normal((m, k)) @ rng.standard_normal((k, n))


def _geometric(m, rng):
    Q1, _ = np.linalg.qr(rng.standard_normal((m, m)))
    Q2, _ = np.linalg.qr(rng.standard_normal((m, m)))
    return (Q1 * 10.0 ** -np.arange(m, dtype=np.float64)) @ Q2


# the tiles of tests/test_rrqr.py: (tiles, tol, rank cap)
RRQR_CASES = {
    "exact_rank": (lambda rng: _lowrank(48, 48, 7, rng), 1e-10, 24),
    "truncation_1e-2": (lambda rng: _geometric(64, rng), 1e-2, 48),
    "truncation_1e-4": (lambda rng: _geometric(64, rng), 1e-4, 48),
    "truncation_1e-6": (lambda rng: _geometric(64, rng), 1e-6, 48),
    "batched_mixed": (lambda rng: np.stack(
        [_lowrank(32, 32, k, rng) for k in (1, 3, 9, 16)]), 1e-9, 20),
    "zero_tiles": (lambda rng: np.zeros((2, 16, 16)), 1e-8, 8),
    "complex": (lambda rng: _lowrank(40, 24, 5, rng)
                + 1j * _lowrank(40, 24, 5, rng), 1e-10, 12),
}


@pytest.mark.parametrize("case", sorted(RRQR_CASES))
def test_rrqr_matches_jax(case):
    """Ranks identical; U V within 1e-10 of the JAX product relative to
    the tile's largest entry (f64; the same pivot rule and deflation,
    rounding apart)."""
    make, tol, r = RRQR_CASES[case]
    T = make(np.random.default_rng(len(case)))
    U, V, ranks = rrqr(torch.from_numpy(T), tol, r)
    Uj, Vj, rj = rrqr_jax(jnp.asarray(T), tol, r)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(rj))
    want = np.asarray(Uj) @ np.asarray(Vj)
    np.testing.assert_allclose((U @ V).numpy(), want, rtol=0,
                               atol=1e-10 * max(np.abs(T).max(), 1e-300))
    assert np.isfinite(U.numpy()).all() and np.isfinite(V.numpy()).all()


def _bucket():
    """test_blr_kernel_exact_at_full_rank's fronts: 2 fronts of 6 x 6
    tiles of 16, 4 of them separator tiles; diagonally dominant."""
    rng = np.random.default_rng(0)
    nf, t, nts, nt = 2, 16, 4, 6
    F = rng.standard_normal((nf, nt * t, nt * t)) * 0.01
    F += np.eye(nt * t)[None] * 10.0
    return F, t, nts, nt, rng


@pytest.mark.parametrize("adm,variant", [(0, "rl"), (0, "ll"), (1, "rl")])
def test_blr_bucket_matches_jax(adm, variant):
    """Factors, Schur complement and solves of one BLR bucket at full rank
    (tol 1e-14, r = t) against the JAX package: tile perms and ranks
    identical, every dense piece and every compressed tile product U V
    within 1e-11 of its largest entry, the forward and backward solves
    within 1e-11 (f64; the tile LU runs K2's elimination here and LAPACK's
    there, the rest differs in summation order)."""
    F, t, nts, nt, rng = _bucket()
    kw = dict(t=t, r=t, nts=nts, nt=nt, adm_band=adm, variant=variant)
    got = BT.blr_factor_bucket(torch.from_numpy(F), 0.0, 1e-14, **kw)
    want = [np.asarray(x) for x in BJ.blr_factor_bucket(
        jnp.asarray(F), jnp.asarray(0.0), jnp.asarray(1e-14), **kw)]
    names = ("lud", "perms", "Uu", "Vu", "Ul", "Vl", "Du", "Dl", "CB", "rk")
    g = dict(zip(names, (x.numpy() for x in got)))
    w = dict(zip(names, want))
    np.testing.assert_array_equal(g["perms"], w["perms"])
    np.testing.assert_array_equal(g["rk"], w["rk"])
    assert g["rk"].max() == t          # full rank at tol 1e-14

    def close(a, b, what):
        scale = max(np.abs(b).max(initial=0), 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-11 * scale,
                                   err_msg=what)

    for name in ("lud", "Du", "Dl", "CB"):
        close(g[name], w[name], name)
    close(g["Uu"] @ g["Vu"], w["Uu"] @ w["Vu"], "Uu Vu")
    close(g["Ul"] @ g["Vl"], w["Ul"] @ w["Vl"], "Ul Vl")

    b = rng.standard_normal((2, nt * t, 1))
    y, cbv = BT.blr_fwd_bucket(*got[:2], got[4], got[5], got[7],
                               torch.from_numpy(b), t=t, nts=nts, nt=nt,
                               adm_band=adm)
    yj, cbvj = BJ.blr_fwd_bucket(*(jnp.asarray(w[k]) for k in
                                   ("lud", "perms", "Ul", "Vl", "Dl")),
                                 jnp.asarray(b), t=t, nts=nts, nt=nt,
                                 adm_band=adm)
    close(y.numpy(), np.asarray(yj), "y")
    close(cbv.numpy(), np.asarray(cbvj), "cbv")
    xupd = rng.standard_normal((2, (nt - nts) * t, 1))
    x = BT.blr_bwd_bucket(got[0], got[2], got[3], got[6], y,
                          torch.from_numpy(xupd), t=t, nts=nts, nt=nt,
                          adm_band=adm)
    xj = BJ.blr_bwd_bucket(*(jnp.asarray(w[k]) for k in
                             ("lud", "Uu", "Vu", "Du")), yj,
                           jnp.asarray(xupd), t=t, nts=nts, nt=nt,
                           adm_band=adm)
    close(x.numpy(), np.asarray(xj), "x")
    # and the front is solved: F [x; xupd] = b with xupd the CB solve
    xu = np.linalg.solve(g["CB"], cbv.numpy())
    xs = BT.blr_bwd_bucket(got[0], got[2], got[3], got[6], y,
                           torch.from_numpy(xu), t=t, nts=nts, nt=nt,
                           adm_band=adm).numpy()
    assert np.abs(F @ np.concatenate([xs, xu], axis=1) - b).max() < 1e-9


def test_compress_tiles_svd_matches_jax():
    rng = np.random.default_rng(5)
    T = np.stack([_lowrank(16, 16, k, rng) for k in (2, 5)])
    U, V, ranks = BT._compress_tiles(torch.from_numpy(T), 1e-10, 8, "svd")
    Uj, Vj, rj = BJ._compress_tiles(jnp.asarray(T), 1e-10, 8, algo="svd")
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(rj))
    np.testing.assert_allclose((U @ V).numpy(),
                               np.asarray(Uj) @ np.asarray(Vj), rtol=0,
                               atol=1e-10 * np.abs(T).max())
    # the element-based compressors are ported too (ops/aca.py)
    for algo in ("aca", "baca"):
        U, V, ranks = BT._compress_tiles(torch.from_numpy(T), 1e-10, 8, algo)
        Uj, Vj, rj = BJ._compress_tiles(jnp.asarray(T), 1e-10, 8, algo=algo)
        np.testing.assert_array_equal(ranks.numpy(), np.asarray(rj))
        np.testing.assert_allclose((U @ V).numpy(),
                                   np.asarray(Uj) @ np.asarray(Vj), rtol=0,
                                   atol=1e-10 * np.abs(T).max())


@pytest.mark.parametrize("s_pad,u_pad,leaf", [
    (128, 384, 256), (192, 768, 256), (384, 1536, 256), (3072, 0, 256),
    (256, 0, 128), (64, 192, 256), (48, 100, 16), (7, 0, 4)])
def test_choose_tile_alike(s_pad, u_pad, leaf):
    assert BT.choose_tile(s_pad, u_pad, leaf) == \
        BJ.choose_tile(s_pad, u_pad, leaf)


@pytest.mark.parametrize("adm,leaf", [("weak", 256), ("strong", 128)])
def test_blr_plan_identical(adm, leaf):
    """Poisson 16^3 with BLR fronts for separators >= 128: the
    separator-reordered permutation and every BucketPlan field, the BLR
    tile size, rank cap and admissibility included.  On the CPU the
    port's planner assumes the JAX package's 16 GB fallback, so the
    generous rank caps agree."""
    A = poisson3d(16)

    def opts(mod):
        o = mod.SPOptions(compression=mod.CompressionType.BLR,
                          compression_min_sep_size=128)
        o.blr.admissibility, o.blr.leaf_size = adm, leaf
        return o

    ref = sj.SparseSolver(opts(sj))
    ref.set_csr_matrix(A)
    ref.reorder(16, 16, 16)
    port = st.SparseSolver(opts(st), device="cpu")
    port.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
    port.reorder(16, 16, 16)
    assert st_numeric.hbm_budget_bytes(port.device) == 16 * 10**9
    np.testing.assert_array_equal(port.perm, ref.perm)
    nblr = 0
    for lp, lr in zip(port.plan.levels, ref.plan.levels, strict=True):
        for bp, br in zip(lp, lr, strict=True):
            for f in dataclasses.fields(bp):
                a, b = getattr(bp, f.name), getattr(br, f.name)
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype, f.name
                    np.testing.assert_array_equal(a, b, f.name)
                else:
                    assert a == b, f.name
            nblr += bp.blr
    assert nblr >= 2
    assert any(bp.max_rank == bp.tile for lvl in port.plan.levels
               for bp in lvl if bp.blr)
    assert port.plan.factor_flops == ref.plan.factor_flops


def test_adaptive_rank_restart():
    """A rank cap the tiles saturate: the saturated buckets' caps double
    and the factorization runs again until no bucket saturates (the JAX
    package's solver.py:315-353), and the solve still converges."""
    A = poisson3d(12)
    o = st.SPOptions(compression=st.CompressionType.BLR,
                     compression_min_sep_size=64, rel_tol=1e-8)
    o.blr.leaf_size, o.blr.max_rank, o.blr.rel_tol = 32, 2, 1e-8
    s = st.SparseSolver(o, device="cpu")
    s.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
    s.reorder(12, 12, 12)
    caps = {(li, bi): bp.max_rank for li, lvl in enumerate(s.plan.levels)
            for bi, bp in enumerate(lvl) if bp.blr}
    assert caps and set(caps.values()) == {2}
    b = A.spmv(np.random.default_rng(1).standard_normal(A.n))
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS and s.factor_passes > 1
    assert not s.fac.saturated_buckets()
    for (li, bi), cap in caps.items():
        bp = s.plan.levels[li][bi]
        assert bp.max_rank > cap and bp.max_rank <= bp.tile
    assert A.max_scaled_residual(x, b) < 1e-6
