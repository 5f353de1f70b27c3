"""HODBF (butterfly) fronts in the port against the JAX package, on the
CPU.

Plans identical bucket for bucket and flag for flag (the HODBF flags,
butterfly depths and ranks, the direct factorization and its cutoff) on
the configurations of ``tests/test_sparse_seq.py::test_hodbf_fronts`` and
``tests/test_hard_matrices.py::test_helmholtz_complex_hodbf_fronts`` and
with butterfly levels under HODLR and the composites; a bucket of HODBF
fronts against the JAX package's vmapped ``_hss_front_bucket`` on its
draws; and a complex HODBF Helmholtz solved end to end against the JAX
package's solver (a smaller grid than the JAX test that still holds
butterfly-stored S12 and F21)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref
from torch_ref import jax_split_programs  # noqa: F401  (autouse)
from torch_ref import assert_flags_identical, solve_on_jax_factors, \
    solver_pair

from strumpack_tpu.frontal import numeric as NJ
from strumpack_tpu.sparse.gen import helmholtz3d, poisson3d
from strumpack_tpu.structured import butterfly as BJ

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import numeric as NT
from strumpack_tpu_torch.structured import butterfly as BT
from strumpack_tpu_torch.structured import draws


def _hss(leaf, rank, tol, levels=0):
    def tweak(o):
        o.hss.leaf_size, o.hss.max_rank, o.hss.rel_tol = leaf, rank, tol
        o.hodlr_butterfly_levels = levels
        o.hodlr_min_sep_size = 64
    return tweak


# name: (matrix, grid (empty: the default ordering), compression, tweak,
# SPOptions fields)
PLAN_CASES = {
    "poisson_hodbf": (lambda: poisson3d(16), (16, 16, 16), "HODBF",
                      _hss(32, 32, 1e-8),
                      dict(compression_min_sep_size=64, rel_tol=1e-6)),
    "helmholtz_hodbf": (lambda: helmholtz3d(14, k0=8.0), (), "HODBF",
                        _hss(32, 64, 1e-6),
                        dict(compression_min_sep_size=64, rel_tol=1e-8,
                             factor_dtype="complex128",
                             refine_dtype="complex128")),
    "hodlr_butterfly_levels": (lambda: poisson3d(16), (16, 16, 16),
                               "HODLR", _hss(32, 32, 1e-8, levels=2),
                               dict(compression_min_sep_size=64)),
    "zfp_blr_hodlr_butterfly": (lambda: poisson3d(16), (16, 16, 16),
                                "ZFP_BLR_HODLR", _hss(32, 32, 1e-8, 1),
                                dict(compression_min_sep_size=32)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_hodbf_plans_identical(case):
    """The port's plan equals the JAX package's, HODBF flags included,
    and holds HODBF fronts whose S12 and F21 are butterflies; the
    Poisson case then solves within test_hodbf_fronts' gate."""
    make, dims, comp, tweak, kw = PLAN_CASES[case]
    A = make()
    ref, port = solver_pair(A, dims, comp, tweak=tweak, **kw)
    assert_flags_identical(ref, port)
    bps = [bp for lvl in port.plan.levels for bp in lvl if bp.hodbf]
    assert bps and any(bp.bf_D >= 2 and bp.u_pad > 0 and bp.bf_direct
                       for bp in bps)
    if case == "poisson_hodbf":
        b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
        x, rc = port.solve(b)
        assert rc == st.ReturnCode.SUCCESS
        assert A.max_scaled_residual(x, b) < 1e2 * 1e-6


def test_hodbf_front_bucket_matches_jax(monkeypatch):
    """Two HODBF fronts (s = 128, u = 64) through the port's
    ``_hss_front_bucket`` and the JAX package's (vmapped), on the JAX
    package's draws: the direct butterfly factorization of F11 (a node
    above the dense cutoff takes butterfly G blocks), S12 = F11^-1 F12
    and F21 as butterflies, and the CB, all within 1e-9."""
    monkeypatch.setattr(draws, "draw", torch_ref.jax_draw)
    rng = np.random.default_rng(4)
    s, u, nf = 128, 64, 2
    j = np.arange(s)
    F = rng.standard_normal((nf, s + u, s + u)) * 0.1
    for f in range(nf):
        F[f, :s, :s] = (np.cos(2 * np.pi * np.outer(j, j) / s) / 8.0
                        + np.eye(s) * (4.0 + f))
    bp = SimpleNamespace(s_pad=s, u_pad=u, hss=False, hodlr=False,
                         hodbf=True, bf_D=2, bf_r=16, bf_direct=True,
                         bf_cutoff=32, hss_leaf=32, hss_rank=16)
    Hj, S12j, F21j, CBj = jax.jit(lambda F: NJ._hss_front_bucket(
        F, bp, 1e-8, jnp.float64))(jnp.asarray(F))
    H, S12, F21, CB = NT._hss_front_bucket(torch.from_numpy(F), bp, 1e-8)
    assert H._froot.kind == "bf"
    X = rng.standard_normal((nf, u, 3))
    Y = rng.standard_normal((nf, s, 3))
    for bt, bj, x in ((S12, S12j, X), (F21, F21j, Y)):
        got = BT.bf_matvec(bt, torch.from_numpy(x), 2, 16).numpy()
        want = np.asarray(jax.vmap(lambda b, x: BJ.bf_matvec(b, x, 2, 16))(
            bj, jnp.asarray(x)))
        assert np.linalg.norm(got - want) < 1e-9 * np.linalg.norm(want)
    np.testing.assert_allclose(CB.numpy(), np.asarray(CBj), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(CBj)).max())
    got = NT._f11_solve(H, torch.from_numpy(Y)).numpy()
    want = np.asarray(jax.vmap(lambda h, y: h.solve_direct(y))(
        Hj, jnp.asarray(Y)))
    assert np.linalg.norm(got - want) < 1e-9 * np.linalg.norm(want)


@pytest.fixture(scope="module")
def helmholtz_hodbf():
    """test_helmholtz_complex_hodbf_fronts' options on Helmholtz 10^3
    (geometric ND): the JAX package's and the port's solvers, solved
    once."""
    A = helmholtz3d(10, k0=8.0)
    ref, port = solver_pair(
        A, (10, 10, 10), "HODBF", tweak=_hss(32, 64, 1e-6),
        factor_dtype="complex128", refine_dtype="complex128",
        krylov_solver=st.KrylovSolver.PREC_GMRES, rel_tol=1e-8,
        compression_min_sep_size=64)
    rng = np.random.default_rng(0)
    b = A.spmv(rng.standard_normal(A.n) + 1j * rng.standard_normal(A.n))
    out = {}
    for name, s in (("jax", ref), ("port", port)):
        x, rc = s.solve(b)
        out[name] = (np.asarray(x), rc.name, s.Krylov_iterations())
    return A, ref, port, b, out


def test_complex_hodbf_solves_like_jax(helmholtz_hodbf):
    """Plans identical, butterfly-stored S12/F21 at complex fronts; the
    JAX test's gate (1e2 x rel_tol) and Krylov iterations within 2 of the
    JAX package's; the port's solve on the JAX package's factors (the
    HODBF factor chains and butterflies carried by ``interop``) within
    1e-10 of the JAX solve."""
    A, ref, port, b, out = helmholtz_hodbf
    assert_flags_identical(ref, port)
    assert any(bp.hodbf and bp.bf_D >= 2 and bp.u_pad > 0
               for lvl in port.plan.levels for bp in lvl)
    x, rc, its = out["port"]
    assert rc == "SUCCESS" and x.dtype == np.complex128
    assert A.max_scaled_residual(x, b) <= 1e2 * 1e-8
    assert abs(its - out["jax"][2]) <= 2
    got, want = solve_on_jax_factors(ref, port, b, dtype=torch.complex128)
    assert np.linalg.norm(got - want) <= 1e-10 * np.linalg.norm(want)
    assert port.fac.structured_max_rank() > 0
    assert port.fac.factor_memory() > 0
