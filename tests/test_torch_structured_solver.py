"""End to end with rank-structured fronts: the port's SparseSolver against
the JAX package's, f64 on the CPU, on the configurations of
``tests/test_sparse_seq.py``'s HSS, sampled-HSS, HODLR and composite
tests.  Plans identical bucket for bucket and flag for flag; the port's
multifrontal solve on the JAX package's factors within 1e-10 of the JAX
solve; and each solver on its own sketches (the port's from its
generators): rc SUCCESS, the JAX test's residual gate, Krylov iterations
within 2 of the JAX package's.  Then the repairs: the multi-rhs iteration
count, STRUMPACK_TPU_HBM_GB, and double-float with two right-hand
sides."""
import numpy as np
import pytest
import torch

from torch_ref import assert_flags_identical, solve_on_jax_factors, \
    solver_pair

import strumpack_tpu as sj
from strumpack_tpu.frontal import numeric as sj_numeric
from strumpack_tpu.sparse.gen import poisson2d, poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch import solver as st_solver
from strumpack_tpu_torch.frontal import numeric as st_numeric

ERROR_TOL = 1e2   # tests/test_sparse_seq.py:16


def _hss(leaf, rank, tol, sampling=False):
    def tweak(o):
        o.hss.leaf_size, o.hss.rel_tol = leaf, tol
        if rank:
            o.hss.max_rank = rank
        o.hss.sampling = sampling
    return tweak


def _composite(o):
    o.hodlr_min_sep_size = 256
    o.lossy_min_sep_size = 8
    o.hss.rel_tol, o.hss.leaf_size = 1e-8, 32
    o.blr.rel_tol, o.blr.leaf_size = 1e-8, 32


# name: (matrix, grid, compression, tweak, SPOptions fields, the kinds of
# buckets the plan must hold): the options of test_sparse_seq.py's
# test_hss_fronts, test_hss_sampling_root_front,
# test_hss_sampling_interior_fronts, test_hodlr_fronts and
# test_blr_hodlr_composite
CASES = {
    "hss": (lambda: poisson2d(40), (40, 40), "HSS", _hss(16, 16, 1e-6),
            dict(compression_min_sep_size=32, rel_tol=1e-6), ("hss",)),
    "hss_sample_root": (lambda: poisson2d(40), (40, 40), "HSS",
                        _hss(16, 16, 1e-8, True),
                        dict(compression_min_sep_size=32, rel_tol=1e-6),
                        ("hss_sample",)),
    "hss_sample_interior": (lambda: poisson2d(64), (64, 64), "HSS",
                            _hss(16, 24, 1e-8, True),
                            dict(compression_min_sep_size=30, rel_tol=1e-6),
                            ("hss_sample",)),
    "hodlr": (lambda: poisson2d(40), (40, 40), "HODLR", _hss(16, 0, 1e-6),
              dict(compression_min_sep_size=32, rel_tol=1e-6), ("hodlr",)),
    "zfp_blr_hodlr": (lambda: poisson3d(16), (16, 16, 16), "ZFP_BLR_HODLR",
                      _composite, dict(compression_min_sep_size=64,
                                       rel_tol=1e-4),
                      ("hodlr", "blr", "lossy")),
}


def _composite8(o):
    _composite(o)
    o.hodlr_min_sep_size = 64


# The whole-solver comparison runs at the smallest grid whose plan still
# holds the case's bucket kinds (the JAX reference's compile grows with
# the plan's buckets), with the separator thresholds scaled to the grid
# where the plan's own grid is too small: (grid, dims, tweak, SPOptions
# fields).  poisson2d(32): hss, hss_sample_root and hodlr have the root
# front (s = 32) as their one compressed bucket; hss_sample_interior at
# compression_min_sep_size 16 samples five fronts, the level-1 ones
# (s = 16) with an update set; zfp_blr_hodlr at Poisson 8^3 with
# compression_min_sep_size 32 and hodlr_min_sep_size 64 has the HODLR
# root (s = 64), a BLR bucket (s = 32) and 15 lossy ones.
SOLVE_CASES = {
    "hss": (lambda: poisson2d(32), (32, 32), None, {}),
    "hss_sample_root": (lambda: poisson2d(32), (32, 32), None, {}),
    "hodlr": (lambda: poisson2d(32), (32, 32), None, {}),
    "hss_sample_interior": (lambda: poisson2d(32), (32, 32), None,
                            dict(compression_min_sep_size=16)),
    "zfp_blr_hodlr": (lambda: poisson3d(8), (8, 8, 8), _composite8,
                      dict(compression_min_sep_size=32)),
}


def _pair(name, solve=False):
    make, dims, comp, tweak, kw, kinds = CASES[name]
    if solve:
        make, dims, tw, over = SOLVE_CASES[name]
        tweak = tw or tweak
        kw = dict(kw, **over)
    A = make()
    ref, port = solver_pair(A, dims, comp, tweak, **kw)
    return A, ref, port, kinds


@pytest.mark.parametrize("name", sorted(CASES))
def test_plans_identical(name):
    """The same plan as the JAX package's, array for array and flag for
    flag, with the bucket kinds the JAX test asks for."""
    _, ref, port, kinds = _pair(name)
    assert_flags_identical(ref, port)
    have = port.pdev.kinds()
    for k in kinds:
        assert have[k] > 0, (k, have)
    if name == "hss_sample_interior":
        samp = [bp for lvl in port.plan.levels for bp in lvl
                if bp.hss_sample]
        assert any(bp.u_pad > 0 for bp in samp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solver_matches_jax(name, monkeypatch):
    """The port's solve on the JAX package's factors within 1e-10 of the
    JAX solve (no randomness between them); then both solvers on their
    own: rc SUCCESS, the JAX test's residual gate, and Krylov iterations
    within 2 of the JAX package's.  At ``SOLVE_CASES``' grid, whose plan
    holds buckets of the case's kinds.  The JAX solver runs its
    split-program mode (one right-hand side here; see
    ``torch_ref.jax_split_programs``)."""
    monkeypatch.setattr(sj_numeric, "SPLIT_SOLVE_BUCKETS", 0)
    A, ref, port, kinds = _pair(name, solve=True)
    have = port.pdev.kinds()
    assert all(have[k] > 0 for k in kinds), (kinds, have)
    if name == "hss_sample_interior":
        assert any(bp.hss_sample and bp.u_pad > 0
                   for lvl in port.plan.levels for bp in lvl)
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    x_ref, rc_ref = ref.solve(b)
    assert rc_ref.name == "SUCCESS"
    got, want = solve_on_jax_factors(ref, port, b)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    x, rc = port.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert A.max_scaled_residual(x, b) < ERROR_TOL * port.opts.rel_tol
    assert abs(port.Krylov_iterations() - ref.Krylov_iterations()) <= 2
    assert port.fac.structured_max_rank() > 0


def test_lossless_is_exact():
    """LOSSLESS stores exact factors (the ZFP reversible role): the plan
    has no lossy or compressed bucket and the residual is exact."""
    A = poisson2d(16)
    ref, port = solver_pair(A, (16, 16), "LOSSLESS")
    assert_flags_identical(ref, port)
    b = A.spmv(np.ones(A.n))
    x, rc = port.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert A.max_scaled_residual(x, b) < 1e-12


def test_hodbf_raises_naming_the_next_slice():
    """HODBF, butterfly levels and complex input were refused until the
    slice that ports them: each now plans HODBF fronts, and a complex
    matrix is taken."""
    A = st.CSRMatrix(*(lambda a: (a.n, a.rowptr, a.colind, a.data))(
        poisson2d(8)))
    for comp, levels in ((st.CompressionType.HODBF, 0),
                         (st.CompressionType.HODLR, 2),
                         (st.CompressionType.ZFP_BLR_HODLR, 1)):
        s = st.SparseSolver(st.SPOptions(compression=comp,
                                         hodlr_butterfly_levels=levels,
                                         compression_min_sep_size=8,
                                         hodlr_min_sep_size=8),
                            device="cpu")
        s.set_csr_matrix(A)
        assert s.reorder(8, 8) == st.ReturnCode.SUCCESS
        assert s.pdev.kinds()["hodbf"] > 0
    Ac = st.CSRMatrix(A.n, A.rowptr, A.colind, A.data.astype(complex))
    s = st.SparseSolver(device="cpu")
    s.set_csr_matrix(Ac)
    assert s.A.data.dtype == np.complex128


# ---------------------------------------------------------------------------
# repairs
# ---------------------------------------------------------------------------

def test_multi_rhs_iterations_match_jax():
    """Three right-hand sides under PREC_GMRES on an 8-bucket plan: one
    Krylov stream in the JAX package, so the largest count, not the sum
    of the columns' (the port's fault before)."""
    A = poisson2d(12)
    ref, port = solver_pair(A, (12, 12),
                            krylov_solver=sj.KrylovSolver.PREC_GMRES)
    B = A.spmv(np.random.default_rng(3).standard_normal((A.n, 3)))
    X_ref, _ = ref.solve(B)
    X, rc = port.solve(B)
    assert rc == st.ReturnCode.SUCCESS
    assert sum(len(lvl) for lvl in port.plan.levels) <= \
        st_solver.SPLIT_SOLVE_BUCKETS
    assert port.Krylov_iterations() == ref.Krylov_iterations() == 1
    np.testing.assert_allclose(X, np.asarray(X_ref), rtol=0,
                               atol=1e-10 * np.abs(X_ref).max())


def test_multi_rhs_large_plan_sums(monkeypatch):
    """Above SPLIT_SOLVE_BUCKETS buckets both packages solve column by
    column and report the sum of the columns' iterations (the limit is
    lowered in both so a small plan crosses it)."""
    A = poisson2d(12)
    monkeypatch.setattr(sj_numeric, "SPLIT_SOLVE_BUCKETS", 4)
    monkeypatch.setattr(st_solver, "SPLIT_SOLVE_BUCKETS", 4)
    ref, port = solver_pair(A, (12, 12),
                            krylov_solver=sj.KrylovSolver.PREC_GMRES)
    B = A.spmv(np.random.default_rng(4).standard_normal((A.n, 3)))
    ref.solve(B)
    _, rc = port.solve(B)
    assert rc == st.ReturnCode.SUCCESS
    assert port.Krylov_iterations() == ref.Krylov_iterations() == 3


def test_hbm_budget_env(monkeypatch):
    """STRUMPACK_TPU_HBM_GB sets the planner's device memory in both
    packages, on the CPU and for a CUDA device alike."""
    monkeypatch.setenv("STRUMPACK_TPU_HBM_GB", "2.5")
    assert st_numeric.hbm_budget_bytes(None) == \
        sj_numeric.hbm_budget_bytes() == 2_500_000_000
    assert st_numeric.hbm_budget_bytes(torch.device("cuda")) == 2_500_000_000
    monkeypatch.delenv("STRUMPACK_TPU_HBM_GB")
    assert st_numeric.hbm_budget_bytes(None) == \
        st_numeric.HBM_FALLBACK_BYTES


def test_double_float_two_rhs_equals_columns():
    """float32x2 with two right-hand sides equals the port's own 1-rhs
    solves column by column (the JAX package raises there, so it cannot
    be the oracle)."""
    A = poisson3d(6)
    s = st.SparseSolver(st.SPOptions(factor_dtype="float32",
                                     refine_dtype="float32x2",
                                     rel_tol=1e-12, abs_tol=1e-13),
                        device="cpu")
    s.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
    s.reorder(6, 6, 6)
    B = A.spmv(np.random.default_rng(5).standard_normal((A.n, 2)))
    X, rc = s.solve(B)
    assert rc == st.ReturnCode.SUCCESS and X.shape == B.shape
    its = s.Krylov_iterations()
    cols = []
    for j in range(2):
        x, rc = s.solve(B[:, j])
        assert rc == st.ReturnCode.SUCCESS
        cols.append(x)
        assert s.Krylov_iterations() <= its
    np.testing.assert_array_equal(X, np.stack(cols, axis=1))
    assert A.max_scaled_residual(X[:, 0], B[:, 0]) <= 1e-10
