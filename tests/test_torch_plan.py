"""The port's host pipeline (geometric ND, symbolic factorization, level
plan, extend-add pairs) is identical to the JAX package's, array for array,
and K3 routes the same buckets in both packages."""
import numpy as np
import pytest

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


def test_plan_identical(solvers):
    ref, port = solvers
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
            assert (bp.level, bp.nf, bp.p, bp.s_pad, bp.u_pad) == (
                br.level, br.nf, br.p, br.s_pad, br.u_pad)
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
    for s in (0, 4, 7, 8, 16, 24, 48, 64, 96, 128, 256, 512):
        for u in (0, 8, 16, 64, 96, 128, 192, 384, 512, 1024):
            for nf in (1, 16, 31, 32, 64, 128, 1024):
                p = s + u
                assert FL.use_cross(s, p, nf) == PL.use_cross(s, p, nf), \
                    (s, p, nf)
