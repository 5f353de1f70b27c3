"""End to end with BLR fronts: the port's SparseSolver against the JAX
package's on Poisson 16^3 with test_poisson3d_blr_gmres's options (BLR for
separators >= 128, tiles at rel_tol 1e-5, preconditioned GMRES to 1e-6,
f64 on the CPU)."""
import numpy as np
import pytest
import torch

import torch_ref  # noqa: F401  (one torch thread a test worker)
from torch_ref import jax_split_programs  # noqa: F401  (autouse)

import strumpack_tpu as sj
from strumpack_tpu.frontal import numeric as sj_numeric
from strumpack_tpu.sparse.gen import poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import numeric as st_numeric
from strumpack_tpu_torch.interop import factors_from_numpy
from strumpack_tpu_torch.krylov import solvers as K


def _opts(mod, **kw):
    o = mod.SPOptions(compression=mod.CompressionType.BLR,
                      compression_min_sep_size=128, rel_tol=1e-6, **kw)
    o.blr.rel_tol = 1e-5
    return o


@pytest.fixture(scope="module")
def pair():
    A = poisson3d(16)
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    ref = sj.SparseSolver(_opts(sj))
    ref.set_csr_matrix(A)
    ref.reorder(16, 16, 16)
    x_ref, rc_ref = ref.solve(b)
    port = st.SparseSolver(_opts(st), device="cpu")
    port.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
    port.reorder(16, 16, 16)
    for k in st_numeric.route_counts:
        st_numeric.route_counts[k] = 0
    x, rc = port.solve(b)
    assert rc_ref.name == rc.name == "SUCCESS"
    return dict(A=A, b=b, ref=ref, port=port, x_ref=np.asarray(x_ref), x=x)


def test_gmres_iterations_and_residual(pair):
    """The same GMRES iteration count within one (the JAX side runs its
    on-device GMRES on this small plan, the port the host-loop one), and
    the residual test_poisson3d_blr_gmres asks for."""
    port, ref, A, b = pair["port"], pair["ref"], pair["A"], pair["b"]
    assert abs(port.Krylov_iterations() - ref.Krylov_iterations()) <= 1
    assert A.max_scaled_residual(pair["x"], b) < 1e2 * port.opts.rel_tol
    assert port.fac.max_rank() > 0
    nb = sum(len(lvl) for lvl in port.pdev.levels)
    assert st_numeric.route_counts["blr"] == len(port.fac.tree["blr"]) >= 2
    assert sum(st_numeric.route_counts.values()) == nb


def test_tile_ranks_within_one(pair):
    """Per tile, the port's rank is the JAX package's within one (the
    tiles compressed differ by rounding only)."""
    ranks = pair["port"].fac.tree["blr_ranks"]
    ref_ranks = pair["ref"].fac.tree["blr_ranks"]
    assert set(ranks) == set(ref_ranks)
    for key, rk in ranks.items():
        d = np.abs(rk.numpy() - np.asarray(ref_ranks[key]))
        assert d.max() <= 1, key
    assert pair["port"].fac.saturated_buckets() == set()


def test_solve_on_jax_blr_factors(pair):
    """The port's solve on the JAX package's BLR and dense factors
    (interop) against the JAX solve of the same permuted right-hand side:
    1e-12 relative, only the solve's own rounding differs."""
    ref, port = pair["ref"], pair["port"]
    bp = ref._transform_b(pair["b"])
    want = np.asarray(sj_numeric.solve(ref.fac, bp))
    tree = {}
    for name, d in ref.fac.tree.items():
        if name in ("lu", "perm", "L21", "U12", "blr_ranks"):
            tree[name] = {k: np.asarray(v) for k, v in d.items()}
        elif name == "blr":
            tree[name] = {k: tuple(np.asarray(a) for a in v)
                          for k, v in d.items()}
    fac = factors_from_numpy(port.pdev, tree)
    assert fac.max_rank() == int(max(np.asarray(r).max()
                                     for r in tree["blr_ranks"].values()))
    got = st_numeric.solve(fac, bp).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_statistics_match(pair):
    """Effective flops and effective factor memory follow the JAX
    formulas on the tile ranks (equal when the ranks are)."""
    port, ref = pair["port"], pair["ref"]
    same = all(np.array_equal(port.fac.tree["blr_ranks"][k].numpy(),
                              np.asarray(v))
               for k, v in ref.fac.tree["blr_ranks"].items())
    if same:
        assert port.fac.effective_factor_flops() == \
            ref.fac.effective_factor_flops()
    assert 0 < port.fac.factor_memory() < port.fac.factor_memory(False)


def test_auto_is_prec_gmres_under_compression(pair, monkeypatch):
    """AUTO resolves to PREC_GMRES when compression is on, as in the JAX
    package (solver.py:489-492); multiple right-hand sides solve column by
    column."""
    calls = []
    gmres = K.gmres

    def spy(spmv, prec, b, **kw):
        calls.append(prec is not None)
        return gmres(spmv, prec, b, **kw)

    monkeypatch.setattr(K, "gmres", spy)
    port, A = pair["port"], pair["A"]
    assert port.opts.krylov_solver == st.KrylovSolver.AUTO
    B = np.stack([pair["b"], 2 * pair["b"]], axis=1)
    X, rc = port.solve(B)
    assert rc == st.ReturnCode.SUCCESS and calls == [True, True]
    np.testing.assert_allclose(X[:, 1], 2 * X[:, 0], rtol=1e-6,
                               atol=1e-8 * np.abs(X).max())


def test_bicgstab_solves(pair):
    port, A, b = pair["port"], pair["A"], pair["b"]
    port.opts.krylov_solver = st.KrylovSolver.PREC_BICGSTAB
    try:
        x, rc = port.solve(b)
    finally:
        port.opts.krylov_solver = st.KrylovSolver.AUTO
    assert rc == st.ReturnCode.SUCCESS
    assert A.max_scaled_residual(x, b) < 1e2 * port.opts.rel_tol


def test_batched_lu_shapes_are_the_calls(pair, monkeypatch):
    """PlanDev.batched_lu_shapes lists the (nf, t) of every batched_lu call
    of one factorization, in order, and the K2/K4 launch counts follow
    from it."""
    from strumpack_tpu_torch.frontal import blr as st_blr
    from strumpack_tpu_torch.ops import front_lu as FL
    port = pair["port"]
    calls = []
    real = st_blr.batched_lu

    def recording(F, *a, **k):
        calls.append(tuple(F.shape[:2]))
        return real(F, *a, **k)

    monkeypatch.setattr(st_blr, "batched_lu", recording)
    port._factored = False
    port.factor()
    shapes = port.pdev.batched_lu_shapes()
    assert calls == shapes * port.factor_passes and shapes
    dtype = getattr(torch, port.opts.factor_dtype)
    dense = port.pdev.k2_dense_shapes(dtype)
    assert port.pdev.k2_launches(dtype) == len(dense) + sum(
        t <= FL.MAX_PALLAS_P for _, t in shapes)
    assert all(p <= FL.MAX_PALLAS_P and not FL.use_cross(s, p, dtype)
               for nf, p, s in dense)
