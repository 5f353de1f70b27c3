"""nf-chunked buckets and the HODLR restart in the port, on the CPU.

Under ``STRUMPACK_TPU_CHUNK_GB=0.001`` (``tests/test_split_mode.py:97-177``)
the plans equal the JAX package's, ``chunks`` included; a chunked dense
plan factors and solves bit for bit as the unchunked one (the JAX
package's ``test_chunked_bucket_execution_exact``), with one factor call
and one extend-add a chunk as ``PlanDev`` counts them and a peak model no
higher than the unchunked one; BLR buckets with compressed CBs run
chunked to the JAX test's gate.  Then the repair of the adaptive-rank
restart: HODLR fronts never report saturation, as in the JAX package."""
import numpy as np
import pytest
import torch

from torch_ref import assert_flags_identical, solver_pair

from strumpack_tpu.sparse.gen import poisson2d, poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import numeric as NT


def _blr(o):
    o.blr.rel_tol = 1e-8
    o.blr.cb_compression = True


def _hodbf(o):
    o.hss.leaf_size, o.hss.rel_tol = 8, 1e-10


# name: (compression, tweak, SPOptions fields), Poisson 12^3 on its grid
# with leaves of 8 as in test_split_mode.py
CASES = {
    "dense": ("NONE", None, dict(krylov_solver=st.KrylovSolver.DIRECT)),
    "blr_cb": ("BLR", _blr, dict(compression_min_sep_size=32,
                                 krylov_solver=st.KrylovSolver.DIRECT)),
    "hodbf": ("HODBF", _hodbf, dict(compression_min_sep_size=16,
                                    krylov_solver=st.KrylovSolver.DIRECT)),
}


def _solvers(case, cap, monkeypatch):
    comp, tweak, kw = CASES[case]
    monkeypatch.setenv("STRUMPACK_TPU_CHUNK_GB", cap)
    return solver_pair(poisson3d(12), (12, 12, 12), comp, tweak=tweak,
                       nd_leaf=8, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_plan_and_solve(case, monkeypatch):
    """Plans identical to the JAX package's with chunked buckets; the
    chunked factorization against the unchunked one: dense bit for bit
    (factors and solution, residual < 1e-12), BLR with compressed CBs
    (to the JAX test's gate) and HODBF fronts (their factor chains
    concatenated chunk by chunk) to 1e-12; factor calls and K1 pairs one
    a chunk; the peak model not above the unchunked one."""
    A = poisson3d(12)
    b = A.spmv(np.ones(A.n))
    runs = {}
    for cap in ("0.001", "100"):
        ref, port = _solvers(case, cap, monkeypatch)
        assert_flags_identical(ref, port)
        nchunked = port.pdev.chunked_buckets()
        assert (nchunked > 0) == (cap == "0.001")
        if case != "dense" and cap == "0.001":
            assert any(bp.chunks > 1 and bp.compressed
                       and (bp.cb_comp or not bp.blr)
                       for lvl in port.plan.levels for bp in lvl)
        before = dict(NT.route_counts)
        x, rc = port.solve(b)
        assert rc == st.ReturnCode.SUCCESS
        calls = sum(NT.route_counts.values()) - sum(before.values())
        assert calls == port.pdev.factor_calls()[0]
        runs[cap] = (x, port)
    (x, port), (x1, port1) = runs["0.001"], runs["100"]
    assert port.pdev.ea_pairs() > port1.pdev.ea_pairs()
    assert (NT.factor_peak_bytes(port.pdev, 8)
            <= NT.factor_peak_bytes(port1.pdev, 8))
    res = np.linalg.norm(A.spmv(x) - b) / np.linalg.norm(b)
    if case == "dense":
        np.testing.assert_array_equal(x, x1)
        for name in ("lu", "perm", "L21", "U12"):
            for key, v in port1.fac.tree[name].items():
                assert torch.equal(port.fac.tree[name][key], v), (name, key)
        assert res < 1e-12
    else:
        np.testing.assert_allclose(x, x1, rtol=0, atol=1e-12)
    if case == "blr_cb":
        assert res < 1e-1


def test_hodlr_fronts_never_restart():
    """A HODLR plan whose rank cap (4) lies below its leaf (16): the
    ranks reach the cap, yet no bucket reports saturation and the factor
    runs once, as in the JAX package, whose factors report none either."""
    def tweak(o):
        o.hss.leaf_size, o.hss.max_rank, o.hss.rel_tol = 16, 4, 1e-8
    ref, port = solver_pair(poisson2d(40), (40, 40), "HODLR", tweak=tweak,
                            compression_min_sep_size=32)
    assert_flags_identical(ref, port)
    ref.factor()
    port.factor()
    assert any(bp.hodlr and bp.hss_rank < bp.hss_leaf
               for lvl in port.plan.levels for bp in lvl)
    assert port.fac.structured_max_rank() == 4
    assert port.fac.saturated_buckets() == ref.fac.saturated_buckets() == set()
    assert port.factor_passes == 1
