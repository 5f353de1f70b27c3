"""BLR-compressed contribution blocks, lossy factors and the ACA/BACA tile
compressors of the port against the JAX package's, f64 on the CPU:
quantization bit for bit (the same bf16 bits, int8 codes and packed
nibbles), compressed CBs densified to 1e-12, ACA/BACA products to 1e-10,
the plans of test_sparse_seq.py's compressed-CB and lossy tests flag for
flag, and both solvers end to end on them."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_ref import assert_flags_identical, solve_on_jax_factors, \
    solver_pair

from strumpack_tpu.frontal import numeric as NJ
from strumpack_tpu.ops import aca as AJ
from strumpack_tpu.sparse.gen import poisson2d, poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import numeric as NT
from strumpack_tpu_torch.interop import blrcb_from_numpy
from strumpack_tpu_torch.ops import aca as AT

ERROR_TOL = 1e2   # tests/test_sparse_seq.py:16


def _smooth(nf, u, seed):
    """CB-like blocks: a smooth kernel (low-rank off-diagonal tiles) plus
    noise at 1e-9."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random((nf, u)), axis=1)
    K = 1.0 / (1.0 + 50.0 * np.abs(x[:, :, None] - x[:, None, :]))
    return K + 1e-9 * rng.standard_normal((nf, u, u))


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quantize_bit_exact(bits, dtype):
    """_quantize gives the JAX package's stored bits; _dequantize its
    values."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 10, 12))
         * 10.0 ** rng.integers(-3, 3, (3, 10, 1))).astype(dtype)
    x[1, 4] = 0.0                       # a zero row: the tiny scale
    qj = NJ._quantize(jnp.asarray(x), bits)
    qt = NT._quantize(torch.from_numpy(x), bits)
    if bits >= 16:
        np.testing.assert_array_equal(qt.view(torch.int16).numpy(),
                                      np.asarray(qj).view(np.int16))
    else:
        assert qt[0].dtype == (torch.int8 if bits == 8 else torch.uint8)
        np.testing.assert_array_equal(qt[0].numpy(), np.asarray(qj[0]))
        np.testing.assert_array_equal(qt[1].numpy(), np.asarray(qj[1]))
    dj = np.asarray(NJ._dequantize(qj, jnp.dtype(dtype)))
    dt = NT._dequantize(qt, getattr(torch, dtype)).numpy()
    np.testing.assert_array_equal(dt, dj)
    assert np.abs(dt - x).max() <= np.abs(x).max() * (
        0.01 if bits >= 8 else 0.1)


def test_compressed_cb_matches_jax():
    """_compress_cb then _cb_dense: the port's densified CB and the JAX
    package's to 1e-12 of its size, and the JAX package's BLRCB carried
    into the port (interop) densifies to the same values."""
    CB = _smooth(2, 256, 1)
    cj = NJ._compress_cb(jnp.asarray(CB), 64, 1e-6, 16)
    ct = NT._compress_cb(torch.from_numpy(CB), 64, 1e-6, 16)
    dj = np.asarray(NJ._cb_dense(cj))
    dt = NT._cb_dense(ct).numpy()
    scale = np.abs(dj).max()
    assert np.abs(dt - dj).max() <= 1e-12 * scale
    assert np.abs(dt - CB).max() <= 1e-5 * scale
    carried = blrcb_from_numpy(np.asarray(cj.diag), np.asarray(cj.U),
                               np.asarray(cj.V), cj.u, cj.t, "cpu")
    assert np.abs(NT._cb_dense(carried).numpy() - dj).max() <= 1e-14 * scale
    sel = torch.tensor([1, 0, 1])
    np.testing.assert_array_equal(NT._cb_dense(ct.select(sel)).numpy(),
                                  dt[[1, 0, 1]])


def test_extend_add_of_compressed_child():
    """Extend-add from a BLR-compressed child bucket densifies the blocks
    its parent reads and extend-adds them with the pair's own map: the
    same front as from the densified child bucket, bit for bit."""
    A = poisson3d(16)
    o = st.SPOptions(compression=st.CompressionType.BLR,
                     compression_min_sep_size=64)
    o.blr.cb_compression = True
    s = st.SparseSolver(o, device="cpu")
    s.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
    s.reorder(16, 16, 16)
    rng = np.random.default_rng(2)
    done = 0
    for li, lvl in enumerate(s.pdev.levels):
        for bd in lvl:
            for pr, pos in ([(p, bd.posL) for p in bd.pairsL]
                            + [(p, bd.posR) for p in bd.pairsR]):
                child = s.pdev.levels[li - 1][pr.bk].bp
                if not child.cb_comp:
                    continue
                CB = torch.from_numpy(_smooth(child.nf, child.u_pad, 3))
                comp = NT._compress_cb(CB, child.cb_comp, 1e-8, 16)
                F = torch.from_numpy(rng.standard_normal(
                    (bd.bp.nf, bd.bp.p, bd.bp.p)))
                got = NT._extend_add_blocks(F.clone(), [None] * pr.bk
                                            + [comp], pos, [pr])
                want = NT._extend_add_blocks(F.clone(), [None] * pr.bk
                                             + [NT._cb_dense(comp)], pos,
                                             [pr])
                assert torch.equal(got, want)
                done += 1
    assert done > 0


@pytest.mark.parametrize("algo", ["aca", "baca"])
def test_aca_matches_jax(algo):
    """ACA and BACA tiles: the JAX package's ranks and U V products to
    1e-10 of the tiles' size."""
    rng = np.random.default_rng(9)
    T = np.stack([rng.standard_normal((24, k)) @ rng.standard_normal((k, 20))
                  for k in (1, 4, 9)] + [_smooth(1, 24, 4)[0, :, :20]])
    fj = jax.jit(lambda T: (AJ.aca if algo == "aca" else AJ.baca)(
        T, 1e-9, 12))
    Uj, Vj, rj = (np.asarray(a) for a in fj(jnp.asarray(T)))
    fn = AT.aca if algo == "aca" else AT.baca
    Ut, Vt, rt = fn(torch.from_numpy(T), 1e-9, 12)
    np.testing.assert_array_equal(rt.numpy(), rj)
    assert np.abs((Ut @ Vt).numpy() - Uj @ Vj).max() <= \
        1e-10 * np.abs(T).max()


def _blr_cb(cbc):
    def tweak(o):
        o.blr.rel_tol = 1e-5
        o.blr.cb_compression = cbc
    return tweak


# test_sparse_seq.py's test_blr_compressed_cb_and_hbm_budget (first half)
# and test_lossy_factor_compression
CASES = {
    "blr_cb": (lambda: poisson3d(16), (16, 16, 16), "BLR", _blr_cb(True),
               dict(compression_min_sep_size=64,
                    krylov_solver="PREC_GMRES", rel_tol=1e-6)),
    "blr_dense_cb": (lambda: poisson3d(16), (16, 16, 16), "BLR",
                     _blr_cb(False),
                     dict(compression_min_sep_size=64,
                          krylov_solver="PREC_GMRES", rel_tol=1e-6)),
    "lossy16": (lambda: poisson2d(30), (30, 30), "LOSSY", None,
                dict(compression_min_sep_size=16, lossy_precision=16,
                     rel_tol=1e-8)),
    "lossy8": (lambda: poisson2d(30), (30, 30), "LOSSY", None,
               dict(compression_min_sep_size=16, lossy_precision=8,
                    rel_tol=1e-8)),
    "lossy4": (lambda: poisson2d(30), (30, 30), "LOSSY", None,
               dict(compression_min_sep_size=16, lossy_precision=4,
                    rel_tol=1e-8)),
}


# The whole-solver comparison runs at the smallest grid whose plan still
# holds a bucket of the kind under test, the separator threshold scaled to
# the grid: (grid, dims, SPOptions fields).  poisson2d(16) for the lossy
# cases (three lossy buckets, the root's separator of 16 among them);
# Poisson 12^3 for the compressed CBs (two BLR buckets of s = 72 with
# compressed CBs below the BLR root of s = 144; at 10^3 with the
# threshold at 32 the compressed CBs no longer lower the peak model).
SOLVE_CASES = {k: (lambda: poisson2d(16), (16, 16), {})
               for k in ("lossy16", "lossy8", "lossy4")}
SOLVE_CASES.update({k: (lambda: poisson3d(12), (12, 12, 12), {})
                    for k in ("blr_cb", "blr_dense_cb")})


def _pair(name, solve=False):
    import strumpack_tpu as sj
    make, dims, comp, tweak, kw = CASES[name]
    if solve:
        make, dims, over = SOLVE_CASES[name]
        kw = dict(kw, **over)
    kw = {k: (sj.KrylovSolver[v] if k == "krylov_solver" else v)
          for k, v in kw.items()}
    A = make()
    return (A,) + solver_pair(A, dims, comp, tweak, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plans_identical(name):
    """The same plan as the JAX package's, array for array and flag for
    flag (compressed CB tiles and ranks, lossy bits)."""
    _, ref, port = _pair(name)
    assert_flags_identical(ref, port)
    kinds = port.pdev.kinds()
    assert kinds["blr_cb" if name == "blr_cb" else "lossy"
                 if name.startswith("lossy") else "blr"] > 0


@pytest.mark.parametrize("name", ["blr_cb", "lossy16", "lossy8", "lossy4"])
def test_solver_matches_jax(name):
    """The port's solve on the JAX package's (quantized) factors within
    1e-10 of the JAX solve; both solvers on their own under the JAX
    test's gate, Krylov iterations within 2; compressed CBs lower the
    peak model, lossy buckets store their bits.  At ``SOLVE_CASES``'
    grid."""
    A, ref, port = _pair(name, solve=True)
    assert port.pdev.kinds()["blr_cb" if name == "blr_cb" else "lossy"] > 0
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    _, rc_ref = ref.solve(b)
    assert rc_ref.name == "SUCCESS"
    got, want = solve_on_jax_factors(ref, port, b)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    x, rc = port.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert A.max_scaled_residual(x, b) < ERROR_TOL * port.opts.rel_tol
    assert abs(port.Krylov_iterations() - ref.Krylov_iterations()) <= 2
    if name == "blr_cb":
        _, _, dense = _pair("blr_dense_cb", solve=True)
        assert NT.factor_peak_bytes(port.pdev, 8) <= \
            NT.factor_peak_bytes(dense.pdev, 8)
    else:
        bits = port.opts.lossy_precision
        stored = {torch.bfloat16: 16, torch.int8: 8, torch.uint8: 4}
        lossy = 0
        for key, lu in port.fac.tree["lu"].items():
            li, bi = map(int, key.split(","))
            if port.plan.levels[li][bi].lossy:
                q = lu if bits >= 16 else lu[0]
                assert stored[q.dtype] == bits
                lossy += 1
        assert lossy > 0
