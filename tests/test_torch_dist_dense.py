"""The port's distributed dense pieces against the JAX package's, on a
2 x 2 grid: one gloo world of 4 CPU ranks (``torch_dist_worker``), the
JAX side on 4 of the 8 virtual CPU devices with the same mesh shape,
computed while the ranks run.

* ``parallel.dist2d``: the blocked LUs (contiguous and cyclic tiles,
  diagonal-tile pivoting) and the pivoted grid LU at 128 against the JAX
  package's, their solves against numpy's;
  the grid and cyclic partial factorizations of two 128-wide fronts (64
  columns eliminated), with and without pivoting: within 1e-12 of the
  JAX package's, and the grid ones of the port's single-process
  factorization;
* ``DistributedMatrix``: every operation within 1e-12 of numpy's;
* ``DistCSR``: the halo spmv within 1e-15 of A @ x, built from the
  global matrix and from 4 uneven row blocks, and after new values."""
import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps
import torch
from jax.sharding import Mesh

import torch_dist_worker as W
import torch_ref  # noqa: F401  (one torch and one BLAS thread a worker)

from strumpack_tpu.parallel import dist2d as GJ
from strumpack_tpu.sparse.gen import poisson3d

from strumpack_tpu_torch.frontal import numeric as NT

M_, BLK, NF, P_, S_ = 128, 32, 2, 128, 64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _inputs():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((M_, M_))
    F = rng.standard_normal((NF, P_, P_)) + 24.0 * np.eye(P_)
    Acsr = poisson3d(6)
    Acsr.data = Acsr.data * rng.uniform(0.5, 1.5, Acsr.nnz)
    n = Acsr.n
    return dict(
        A=A, b=rng.standard_normal(M_), blk=BLK, fronts=F, s=S_,
        M=rng.standard_normal((64, 40)), N=rng.standard_normal((64, 40)),
        S=rng.standard_normal((64, 64)) + 8.0 * np.eye(64),
        perm=rng.permutation(64),
        csr=(n, np.asarray(Acsr.rowptr), np.asarray(Acsr.colind),
             np.asarray(Acsr.data)),
        x=rng.standard_normal(n), cuts=[0, 17, 100, 130, n])


def _jax_dense(inp):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("r", "c"))
    A = jnp.asarray(inp["A"])
    out = {}
    with mesh:
        for name, fn in (("blocked", GJ.sharded_blocked_lu),
                         ("cyclic", GJ.cyclic_blocked_lu),
                         ("pivoted", GJ.sharded_blocked_lu_pivoted)):
            out[name] = jax.jit(lambda A, fn=fn: fn(A, mesh, BLK, 0.0))(A)
        F = jnp.asarray(inp["fronts"])
        for piv in (True, False):
            out[f"grid_{piv}"] = jax.jit(
                lambda F, piv=piv: GJ.grid_partial_factor(
                    F, mesh, ("r",), ("c",), 0.0, S_, pivot=piv))(F)
        out["cyclic_front"] = jax.jit(lambda F: GJ.cyclic_partial_factor(
            F, mesh, ("r",), ("c",), 0.0, S_))(F)
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def test_dist_dense_matches_jax_and_numpy():
    """One world of 4 ranks on the 2 x 2 grid for dist2d,
    DistributedMatrix and DistCSR."""
    inp = _inputs()
    with W.World(["dense", "dist_matrix", "dist_csr"], (2, 2), ("r", "c"),
                 inp) as world:
        want = _jax_dense(inp)
        ranks = world.results()
    for got in ranks:
        got = got["dense"]
        for name in ("blocked", "cyclic", "pivoted"):
            LU, perm, x = got[name]
            LUj, permj = want[name]
            np.testing.assert_array_equal(perm, permj)
            assert _rel(LU, LUj) < 1e-12
            assert _rel(x, np.linalg.solve(inp["A"], inp["b"])) < 1e-12
        for name in ("grid_True", "grid_False", "cyclic_front"):
            for a, aj in zip(got[name], want[name]):
                if a.dtype.kind == "i":
                    np.testing.assert_array_equal(a, aj)
                else:
                    assert _rel(a, aj) < 1e-12, name
    # the grid factorizations against the single-process one
    F = torch.from_numpy(inp["fronts"])
    for piv in (True, False):
        one = NT._factor_bucket(F.clone(), 0.0, S_, pivoting=piv)
        for a, b in zip(ranks[0]["dense"][f"grid_{piv}"], one):
            b = b.numpy()
            if b.dtype.kind == "i":
                np.testing.assert_array_equal(a, b)
            else:
                assert _rel(a, b) < 1e-12
    # every DistributedMatrix operation within 1e-12 of numpy's
    M, N, S, perm = inp["M"], inp["N"], inp["S"], inp["perm"]
    L = np.tril(S)
    wantm = {"to_host": M, "redistribute": M, "scale": 2.5 * M,
            "add": M - 0.5 * N, "axpby": 2.0 * M + 3.0 * N,
            "transpose": M.T, "gemm": 2.0 * M @ N.T + 0.5 * S,
            "trsm": np.linalg.solve(L, M), "laswp": M[perm],
            "laswp_inv": M[np.argsort(perm)], "extract": M[3:40, 5:29]}
    asg = M.copy()
    asg[7:27, 9:22] = N[:20, :13]
    wantm["assign"] = asg
    spd = S @ S.T + 64 * np.eye(64)
    for got in ranks:
        got = got["dist_matrix"]
        for k, v in wantm.items():
            assert _rel(got[k], v) < 1e-12, k
        nF, n1, nI = got["norms"]
        assert abs(nF - np.linalg.norm(M)) < 1e-12 * nF
        assert abs(n1 - np.abs(M).sum(0).max()) < 1e-12 * n1
        assert abs(nI - np.abs(M).sum(1).max()) < 1e-12 * nI
        LU, p = got["getrf"]
        Lf, Uf = np.tril(LU, -1) + np.eye(64), np.triu(LU)
        assert _rel(Lf @ Uf, S[p]) < 1e-12
        assert _rel(got["solve"], np.linalg.solve(S, inp["b"][:64])) < 1e-12
        assert _rel(got["potrf"], np.linalg.cholesky(spd)) < 1e-12
    # the halo spmv within 1e-15 of A @ x
    n, rp, ci, v = inp["csr"]
    A = sps.csr_matrix((v, ci, rp), shape=(n, n))
    y = A @ inp["x"]
    for got in ranks:
        got = got["dist_csr"]
        assert _rel(got["global"], y) <= 1e-15
        assert _rel(got["blocks"], y) <= 1e-15
        assert _rel(got["blocks_x2"], 2 * y) <= 1e-15
        assert got["halo"] > 0
