"""The port's DistributedSparseSolver against the JAX package's, f64 on
the CPU: poisson2d(16) on meshes of 4 ('b') and 1 x 2 x 2 ('b', 'r',
'c'), one gloo world of 4 ranks (``torch_dist_worker``) for both, the
JAX solver on a mesh of 4 of the 8 virtual CPU devices ('b'), computed
while the ranks run (the plan has no grid bucket, so the JAX solution
does not depend on the split of its 4 devices into 'r' and 'c').

* DIRECT f64: every rank's solution on both meshes within 1e-10 of the
  JAX package's,
  max scaled residual <= 1e-12; also on Poisson 10^3 with nd_leaf 128
  on the 4-rank mesh, whose plan has 4 grid buckets (fronts of p >= 128
  factored across the ranks), in the cyclic layout (3 of them tile, one
  has no tile size and stays contiguous) and in the contiguous one
  (``STRUMPACK_TPU_CYCLIC`` 1 and 0), both against the JAX package's
  solution in its default, cyclic layout;
* ``set_distributed_csr_matrix`` (4 uneven row blocks) and
  ``set_MPIAIJ_matrix`` give set_csr_matrix's x bit for bit;
* ``update_matrix_values``, then one factorization serving two solves;
* IR (f32 factor, f64 refinement), preconditioned GMRES and BiCGStab:
  the JAX package's iteration counts;
* every shard bucket's factors on each rank bit-equal to the same fronts
  of the port's single-process factorization;
* the distributed solve on the JAX package's factors (carried by
  ``interop.shard_factors``) within 1e-12 of the single-process solve;
* a rank with another plan: every rank raises; a collective a rank
  leaves raises on the others after the group's timeout."""
import functools

import jax
import numpy as np
from jax.sharding import Mesh

import torch_dist_worker as W
from torch_ref import jax_tree_numpy

import strumpack_tpu as sj
from strumpack_tpu.parallel.driver import DistributedSparseSolver as DJ
from strumpack_tpu.sparse.gen import poisson2d, poisson3d

NX = 16
# a small plan with grid buckets on 4 ranks, cyclic tiles 8, 16 and 32
# and a contiguous fall-back among them (9 buckets: shard 2, grid 4,
# repl 3)
GRID_NX, GRID_LEAF = 10, 128
# f32 factors, f64 refinement
KRYLOV = {"ir": dict(solver="REFINE", rtol=1e-10),
          "gmres": dict(solver="PREC_GMRES", rtol=1e-6),
          "bicgstab": dict(solver="PREC_BICGSTAB", rtol=1e-10)}
B4 = ((4,), ("b",))     # the world's mesh; its ranks also build 1 x 2 x 2


def _jm():
    return Mesh(np.array(jax.devices()[:4]).reshape(B4[0]), B4[1])


def _problem():
    A = poisson2d(NX)
    return A, np.random.default_rng(0).standard_normal(A.n)


def _inputs():
    """The problem and the worlds' inputs."""
    A, b = _problem()
    bg = np.random.default_rng(1).standard_normal(GRID_NX ** 3)
    return A, b, dict(nx=NX, b=b, scale=1.25, cuts=[0, 37, 100, 190, A.n],
                      krylov=KRYLOV, timeout_s=1,
                      grid=(GRID_NX, GRID_LEAF, bg))


@functools.lru_cache(maxsize=None)
def _jax_tree():
    """The JAX package's single-device f64 factors of the plan (numpy)."""
    A, _ = _problem()
    one = sj.SparseSolver(sj.SPOptions(nd_leaf=4, factor_dtype="float64"))
    one.set_csr_matrix(A)
    one.reorder(NX, NX)
    one.factor()
    return jax_tree_numpy(one.fac.tree)


def _jax_refs(A, b, grid):
    """The JAX package's DIRECT solution on the 4-rank mesh, its Krylov
    iteration counts and return codes, and its DIRECT solution of the
    grid problem (default, cyclic layout)."""
    s = DJ(_jm(), sj.SPOptions(
        nd_leaf=4, krylov_solver=sj.KrylovSolver.DIRECT,
        factor_dtype="float64"))
    s.set_csr_matrix(A)
    s.reorder(NX, NX)
    want = {"direct": s.solve(b)[0]}
    sk = DJ(_jm(), sj.SPOptions(nd_leaf=4, factor_dtype="float32",
                                    refine_dtype="float64"))
    sk.set_csr_matrix(A)
    sk.reorder(NX, NX)
    for name, kw in KRYLOV.items():
        sk.opts.krylov_solver = sj.KrylovSolver[kw["solver"]]
        sk.opts.rel_tol = kw["rtol"]
        _, rc = sk.solve(b)
        want[name] = (sk.Krylov_iterations(), rc.name)
    nx, leaf, bg = grid
    Ag = poisson3d(nx)
    s = DJ(_jm(), sj.SPOptions(
        nd_leaf=leaf, krylov_solver=sj.KrylovSolver.DIRECT,
        factor_dtype="float64"))
    s.set_csr_matrix(Ag)
    s.reorder(nx, nx, nx)
    want["grid"] = s.solve(bg)[0]
    return want


def test_solver_matches_jax():
    """On both meshes (one world: its 4 ranks build the second mesh too):
    DIRECT, the input forms, refactoring, the shard factors, the solve on
    carried JAX factors and the digest check; on the 4-rank mesh also IR,
    preconditioned GMRES and BiCGStab (one f32 factorization each side):
    the JAX package's iteration counts and return codes, max scaled
    residuals within 1e2 rel_tol (``tests/test_sparse_seq.py``'s
    ERROR_TOL), DIRECT on the plan with a grid bucket in both layouts,
    and a collective that a rank leaves, which raises on the ranks that
    wait once the group's timeout passes."""
    A, b, inp = _inputs()
    with W.World(["solver", "solver_1x2x2", "krylov", "solver_grid",
                  "timeout"], *B4, inp) as world:
        world.send("jax_tree", _jax_tree())
        want = _jax_refs(A, b, inp["grid"])
        ranks = world.results()
    A2 = A.copy()
    A2.data = A2.data * 1.25
    Ag = poisson3d(GRID_NX)
    for got in ranks:
        for sv in (got["solver"], got["solver_1x2x2"]):
            x, rc, res = sv["direct"]
            assert rc == "SUCCESS" and res <= 1e-12
            assert np.abs(x - want["direct"]).max() <= 1e-10
            assert sv["modes"]["shard"] > 0 and sv["modes"]["repl"] > 0
            np.testing.assert_array_equal(sv["blocks"], x)
            np.testing.assert_array_equal(sv["mpiaij"], x)
            x1, x2, same_tree = sv["update"]
            assert same_tree
            assert A2.max_scaled_residual(x1, b) <= 1e-12
            assert A2.max_scaled_residual(x2, 2 * b) <= 1e-12
            nshard, equal = sv["shard_equal"]
            assert nshard > 0 and equal
            xd, xs = sv["carried"]
            assert np.abs(xd - xs).max() <= 1e-12 * np.abs(xs).max()
            assert "different plans" in sv["digest"]
        for name in KRYLOV:
            its, rck, resk = got["krylov"][name]
            assert (its, rck) == want[name], name
            assert resk <= 1e2 * KRYLOV[name]["rtol"]
        for cyc, (x, rc, res, modes, tiles) in got["solver_grid"].items():
            assert rc == "SUCCESS" and res <= 1e-12
            assert np.abs(x - want["grid"]).max() <= 1e-10
            assert modes["grid"] > 0 and len(tiles) == modes["grid"]
            # cyclic where a tile fits (not all), else contiguous
            assert 0 < sum(t > 0 for t in tiles) < len(tiles) \
                if cyc == "1" else not any(tiles)
            assert Ag.max_scaled_residual(x, inp["grid"][2]) == res
    assert ranks[0]["timeout"] == "left"
    assert all(r["timeout"] == "RuntimeError" for r in ranks[1:])
