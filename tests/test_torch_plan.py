"""The port's host pipeline (geometric ND, symbolic factorization, level
plan, extend-add pairs) is identical to the JAX package's, array for array,
and K3 routes the same buckets in both packages."""
import numpy as np
import pytest

import torch_ref  # noqa: F401  (one torch thread a test worker)

import strumpack_tpu as sj
from strumpack_tpu.ops import pallas_lu as PL
from strumpack_tpu.sparse.gen import poisson2d, poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch.ops import front_lu as FL

PROBLEMS = {"p2d12": (lambda: poisson2d(12), (12, 12)),
            "p3d8": (lambda: poisson3d(8), (8, 8, 8))}
BUCKET_ARRAYS = ("ds", "du", "fronts", "asm_bidx", "asm_r", "asm_c",
                 "asm_vidx", "posL", "posR", "offL", "offR", "strideL",
                 "strideR", "voffL", "voffR", "sep_glob", "upd_glob",
                 "hasL", "hasR")


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def solvers(request):
    make, dims = PROBLEMS[request.param]
    A = make()
    sj_s = sj.SparseSolver(sj.SPOptions())
    sj_s.set_csr_matrix(A)
    sj_s.reorder(*dims)
    st_s = st.SparseSolver(st.SPOptions(), device="cpu")
    st_s.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
    st_s.reorder(*dims)
    return sj_s, st_s


def assert_plans_identical(ref, port):
    """The port's ordering, tree, permuted matrix, symbolic factorization,
    level plan and extend-add pairs equal the JAX solver's, array for
    array (``tests/test_torch_ordering.py`` holds every ordering to it)."""
    np.testing.assert_array_equal(port.perm, ref.perm)
    np.testing.assert_array_equal(port.iperm, ref.iperm)
    for name in ("sep_begin", "sep_end", "parent", "lch", "rch"):
        np.testing.assert_array_equal(getattr(port.tree, name),
                                      getattr(ref.tree, name))
    np.testing.assert_array_equal(port.Ap.data, ref.Ap.data)
    assert len(port.plan.upd) == len(ref.plan.upd)
    for a, b in zip(port.plan.upd, ref.plan.upd):
        np.testing.assert_array_equal(a, b)
    for name in ("n", "nnz", "factor_nnz", "factor_flops", "max_front",
                 "cb_sizes", "cbv_sizes"):
        assert getattr(port.plan, name) == getattr(ref.plan, name), name
    assert len(port.plan.levels) == len(ref.plan.levels)
    for lp, lr in zip(port.plan.levels, ref.plan.levels):
        assert len(lp) == len(lr)
        for bp, br in zip(lp, lr):
            assert (bp.level, bp.nf, bp.p, bp.s_pad, bp.u_pad,
                    bp.chunks) == (br.level, br.nf, br.p, br.s_pad,
                                   br.u_pad, br.chunks)
            for name in BUCKET_ARRAYS:
                a, b = getattr(bp, name), getattr(br, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    # extend-add pairs: (child bucket, u, child block index per front)
    for lp, lr in zip(port.pdev.levels, ref.pdev.levels):
        for bp, br in zip(lp, lr):
            for side in ("L", "R"):
                pp, pr = getattr(bp, "pairs" + side), getattr(br, "pairs" + side)
                assert [(x.bk, x.u) for x in pp] == [(x[0], x[1]) for x in pr]
                for x, y in zip(pp, pr):
                    np.testing.assert_array_equal(
                        x.idx.numpy(), br.host_arrays[y[2]])


def test_plan_identical(solvers):
    assert_plans_identical(*solvers)


def test_assembly_indices_unique(solvers):
    """Every (front, row, col) is assembled from one value at most, so the
    port's scatter-add gives each element exactly one addend (no order
    dependence from atomics)."""
    _, port = solvers
    for lvl in port.plan.levels:
        for bp in lvl:
            key = (bp.asm_bidx.astype(np.int64) * bp.p + bp.asm_r) * bp.p \
                + bp.asm_c
            assert len(np.unique(key)) == len(key)


def test_use_cross_routes_alike():
    """Every bucket the JAX package sends to its cross kernel goes to K3 in
    the port too, in f32 and f64, but for s > 64, which K3 does not hold
    (no path of the port has such a bucket: PERF.md).  The port adds
    exactly the fronts its predicate's docstring names: those K3 holds
    (``k3_layout``) beyond the JAX package's, at any batch size, except
    p <= 64 with s < 8, which stay with K2."""
    import torch
    for s in (0, 4, 7, 8, 16, 24, 48, 64, 96, 128, 256, 512):
        for u in (0, 8, 16, 64, 96, 128, 192, 384, 512, 1024):
            for nf in (1, 16, 31, 32, 64, 128, 1024):
                p = s + u
                for dtype in (torch.float32, torch.float64):
                    port = FL.use_cross(s, p, dtype)
                    try:
                        FL.k3_layout(p, s, nf, dtype.itemsize)
                        holds = True
                    except ValueError:
                        holds = False
                    if PL.use_cross(s, p, nf) and s <= 64:
                        assert port, (s, p, nf, dtype)
                    assert port == (holds and not (p <= 64 and s < 8)), \
                        (s, p, nf, dtype)


def test_k3_and_library_shapes(solvers):
    """PlanDev lists the dense buckets by route: K3's shapes (its
    launches) and the library route's, which with K2's cover every dense
    bucket once."""
    import torch
    _, port = solvers
    for dtype in (torch.float32, torch.float64):
        k3 = port.pdev.k3_shapes(dtype)
        lib = port.pdev.library_shapes(dtype)
        assert port.pdev.k3_buckets(dtype) == len(k3) > 0
        assert all(FL.use_cross(s, p, dtype) for _, p, s in k3)
        assert not any(FL.use_cross(s, p, dtype) or p <= FL.MAX_PALLAS_P
                       for _, p, s in lib)
        dense = sorted((bp.nf, bp.p, bp.s_pad) for lvl in port.plan.levels
                       for bp in lvl)
        assert sorted(k3 + lib + port.pdev.k2_dense_shapes(dtype)) == dense
