"""Gloo worlds of the port's distributed tests (``tests/test_torch_dist_*``).

``World(scenarios, shape, names, inputs)`` spawns one world of
``prod(shape)`` CPU ranks (one torch and one BLAS thread each) on a free
localhost port and returns at once, so that the parent computes the JAX
package's references while the ranks run; every rank builds the
``DeviceMesh`` of ``shape`` and runs the scenarios of this module named in
``scenarios`` in order, each with the rank's mesh and ``inputs``;
``World.results()`` waits and gives back, per rank, a dict of each
scenario's picklable result.  The inputs go through a file, not the
spawn arguments: arguments past a pipe's buffer make the parent wait for
each rank to import torch before it starts the next.  An input the
parent computes after the spawn goes through ``World.send`` and a rank
reads it with ``late``.  This module imports
torch and the port only: the spawned ranks never import JAX.
"""
from __future__ import annotations

import math
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, shape, names, scenarios, out):
    import threadpoolctl
    torch.set_num_threads(1)
    threadpoolctl.threadpool_limits(1, user_api="blas")
    from torch.distributed.device_mesh import init_device_mesh
    from strumpack_tpu_torch.parallel import dist as D
    with open(os.path.join(out, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    inputs["_dir"] = out
    D.init_process_group("gloo", rank, world, port, timeout_s=TIMEOUT_S)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        res = {}
        for name in scenarios:
            res[name] = globals()[name](mesh, inputs)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


class World:
    """One gloo world running ``scenarios``; a context manager that stops
    the ranks if the parent leaves before ``results``."""

    def __init__(self, scenarios, shape, names, inputs=None):
        self.world = math.prod(shape)
        self._dir = tempfile.TemporaryDirectory()
        with open(os.path.join(self._dir.name, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs or {}, f)
        self._ctx = mp.spawn(
            _rank_main, args=(self.world, _free_port(), tuple(shape),
                              tuple(names), list(scenarios),
                              self._dir.name),
            nprocs=self.world, join=False)

    def send(self, name, obj):
        """An input the ranks read with ``late(inp, name)``."""
        tmp = os.path.join(self._dir.name, name + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, os.path.join(self._dir.name, name + ".pkl"))

    def results(self):
        """Per rank (in rank order), {scenario: result}."""
        while not self._ctx.join():
            pass
        res = []
        for r in range(self.world):
            with open(os.path.join(self._dir.name, f"rank{r}.pkl"),
                      "rb") as f:
                res.append(pickle.load(f))
        return res

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self._ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
        self._dir.cleanup()


def late(inp, name):
    """The input ``name`` that the parent sends after the spawn, once it
    is there."""
    path = os.path.join(inp["_dir"], name + ".pkl")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > TIMEOUT_S:
            raise TimeoutError(f"input {name!r} never came")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# scenarios: dense (dist2d, DistributedMatrix) and DistCSR
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def dense(mesh, inp):
    """dist2d's factorizations and solves, its grid and cyclic partial
    factorizations of ``inp["fronts"]``, with and without pivoting."""
    from strumpack_tpu_torch.parallel import dist as D
    from strumpack_tpu_torch.parallel import dist2d as G
    grid = D.Grid(mesh)
    A, b, blk = _t(inp["A"]), _t(inp["b"]), inp["blk"]
    out = {}
    LU, perms = G.sharded_blocked_lu(A, grid, blk)
    out["blocked"] = (_np(LU), _np(perms),
                      _np(G.sharded_lu_solve(LU, perms, b, blk)))
    LU, perms = G.cyclic_blocked_lu(A, grid, blk)
    out["cyclic"] = (_np(LU), _np(perms),
                     _np(G.sharded_lu_solve(LU, perms, b, blk)))
    LU, perm = G.sharded_blocked_lu_pivoted(A, grid, blk)
    out["pivoted"] = (_np(LU), _np(perm),
                      _np(G.sharded_lu_solve_pivoted(LU, perm, b, blk)))
    F, s = _t(inp["fronts"]), inp["s"]
    for piv in (True, False):
        out[f"grid_{piv}"] = [_np(x) for x in G.grid_partial_factor(
            F, grid, 0.0, s, pivot=piv)]
    out["cyclic_front"] = [_np(x) for x in G.cyclic_partial_factor(
        F, grid, 0.0, s)]
    return out


def dist_matrix(mesh, inp):
    """Each DistributedMatrix operation, gathered to numpy."""
    from strumpack_tpu_torch.parallel import dist as D
    from strumpack_tpu_torch.parallel.dist_matrix import DistributedMatrix
    grid = D.Grid(mesh)
    A, B, S = (_t(inp[k]) for k in ("M", "N", "S"))
    dA = DistributedMatrix(A, grid, "cpu")
    dB = DistributedMatrix(B, grid, "cpu")
    dS = DistributedMatrix(S, grid, "cpu")
    out = {"to_host": dA.to_host(),
           "redistribute": dA.redistribute().to_host(),
           "scale": dA.scale(2.5).to_host(),
           "add": dA.add(dB, -0.5).to_host(),
           "axpby": dA.axpby(2.0, dB, 3.0).to_host(),
           "transpose": dA.transpose().to_host(),
           "norms": (dA.normF(), dA.norm1(), dA.normI()),
           "gemm": dA.gemm(dB, tb=True, alpha=2.0, beta=0.5,
                           C=dS).to_host(),
           "trsm": DistributedMatrix(torch.tril(S), grid, "cpu").trsm(
               dA, lower=True).to_host(),
           "laswp": dA.laswp(inp["perm"]).to_host(),
           "laswp_inv": dA.laswp(inp["perm"], fwd=False).to_host(),
           "extract": dA.extract(3, 40, 5, 29).to_host(),
           "assign": dA.assign(7, 9, B[:20, :13]).to_host()}
    LU, perm = dS.getrf(blk=16)
    out["getrf"] = (LU.to_host(), _np(perm))
    out["solve"] = _np(dS.solve(_t(inp["b"][:S.shape[0]])))
    spd = S @ S.T + S.shape[0] * torch.eye(S.shape[0], dtype=S.dtype)
    out["potrf"] = DistributedMatrix(spd, grid, "cpu").potrf().to_host()
    return out


def dist_csr(mesh, inp):
    """The halo spmv from the global matrix and from uneven row blocks,
    and after new values."""
    from strumpack_tpu_torch.parallel import dist as D
    from strumpack_tpu_torch.parallel.dist_spmv import DistCSR
    from strumpack_tpu_torch.sparse.csr import CSRMatrix
    grid = D.Grid(mesh)
    n, rp, ci, v = inp["csr"]
    A = CSRMatrix(n, rp, ci, v)
    x = _t(inp["x"])
    out = {"global": _np(DistCSR(A, grid, device="cpu").spmv(x))}
    cuts = inp["cuts"]
    a, b = cuts[grid.me], cuts[grid.me + 1]
    lrp = rp[a:b + 1] - rp[a]
    blk = DistCSR.from_local_block(a, lrp, ci[rp[a]:rp[b]], v[rp[a]:rp[b]],
                                   n, grid, device="cpu")
    out["blocks"] = _np(blk.spmv(x))
    blk.set_local_values(2.0 * v[rp[a]:rp[b]])
    out["blocks_x2"] = _np(blk.spmv(x))
    out["halo"] = int(len(blk.halo))
    return out


# ---------------------------------------------------------------------------
# scenarios: the solver
# ---------------------------------------------------------------------------

def _solver(mesh, nd_leaf=4, **kw):
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.parallel import DistributedSparseSolver
    opts = st.SPOptions(nd_leaf=nd_leaf, **kw)
    return DistributedSparseSolver(mesh, opts, device="cpu")


def krylov(mesh, inp):
    """IR / GMRES / BiCGStab on one f32 factorization: iteration counts,
    return codes, residuals."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson2d
    nx, b = inp["nx"], inp["b"]
    A = poisson2d(nx)
    sk = _solver(mesh, factor_dtype="float32", refine_dtype="float64")
    sk.set_csr_matrix(A)
    sk.reorder(nx, nx)
    out = {}
    for name, kw in inp["krylov"].items():
        sk.opts.krylov_solver = st.KrylovSolver[kw["solver"]]
        sk.opts.rel_tol = kw["rtol"]
        xk, rck = sk.solve(b)
        out[name] = (sk.Krylov_iterations(), rck.name,
                     A.max_scaled_residual(xk, b))
    return out


def timeout(mesh, inp):
    """A collective that rank 0 leaves, on a group with a short timeout:
    the ranks that wait raise ("left" on rank 0, the exception's type
    elsewhere); a world barrier then joins all again."""
    import datetime
    from strumpack_tpu_torch.parallel import dist as D
    g = dist.new_group(timeout=datetime.timedelta(seconds=inp["timeout_s"]))
    out = "left"
    if dist.get_rank() != 0:
        try:
            D.all_gather(torch.ones(2), g)
            out = "no error"
        except RuntimeError as err:
            out = type(err).__name__
    dist.barrier()
    return out


def solver_grid(mesh, inp):
    """DIRECT f64 on a plan with grid buckets (``inp["grid"]``: Poisson
    nx^3, nd_leaf, b), in the cyclic layout and in the contiguous one
    (``STRUMPACK_TPU_CYCLIC`` 1 and 0): x, return code, max scaled
    residual, the mode counts and the grid buckets' tile sizes."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.parallel import spmd
    from strumpack_tpu_torch.sparse.gen import poisson3d
    nx, leaf, b = inp["grid"]
    A = poisson3d(nx)
    out = {}
    for cyc in ("1", "0"):
        os.environ["STRUMPACK_TPU_CYCLIC"] = cyc
        s = _solver(mesh, leaf, krylov_solver=st.KrylovSolver.DIRECT,
                    factor_dtype="float64")
        s.set_csr_matrix(A)
        s.reorder(nx, nx, nx)
        x, rc = s.solve(b)
        tiles = [spmd.use_cyclic(s.pdev.levels[li][bi].bp, s.grid)
                 for (li, bi), m in s.sp.modes.items() if m == "grid"]
        out[cyc] = (x, rc.name, A.max_scaled_residual(x, b),
                    s.sp.counts(), tiles)
    del os.environ["STRUMPACK_TPU_CYCLIC"]
    return out


def solver_1x2x2(mesh, inp):
    """``solver`` on a second mesh of the same 4 ranks: ('b', 'r', 'c') of
    1 x 2 x 2."""
    from torch.distributed.device_mesh import init_device_mesh
    return solver(init_device_mesh("cpu", (1, 2, 2),
                                   mesh_dim_names=("b", "r", "c")), inp)


def solver(mesh, inp):
    """DIRECT f64 through the three input forms, update_matrix_values with
    one factorization and two solves, the shard buckets' factors against
    the single-process ones, the solve on carried JAX factors, and a plan
    digest mismatch."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch import interop
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.parallel import spmd
    from strumpack_tpu_torch.sparse.gen import poisson2d
    nx = inp["nx"]
    A = poisson2d(nx)
    b = inp["b"]
    K = st.KrylovSolver
    out = {}
    s = _solver(mesh, krylov_solver=K.DIRECT, factor_dtype="float64")
    s.set_csr_matrix(A)
    s.reorder(nx, nx)
    x, rc = s.solve(b)
    out["direct"] = (x, rc.name, A.max_scaled_residual(x, b))
    out["modes"] = s.sp.counts()
    # this rank's shard factors against the single-process factorization
    fac = numeric.factorize(s.pdev, s.Ap.data, dtype=torch.float64)
    same = []
    for (li, bi), (f0, f1) in s.sp.bounds.items():
        key = f"{li},{bi}"
        for name in ("lu", "perm", "L21", "U12"):
            same.append(torch.equal(s._tree[name][key],
                                    fac.tree[name][key][f0:f1]))
    out["shard_equal"] = (len(same), all(same))
    # two solves of one factorization after new values
    A2 = A.copy()
    A2.data = A2.data * inp["scale"]
    s.update_matrix_values(A2)
    x1, _ = s.solve(b)
    t1 = s._tree
    x2, _ = s.solve(2 * b)
    out["update"] = (x1, x2, t1 is s._tree)
    # the block-row inputs
    cuts = inp["cuts"]
    a, e = cuts[s.grid.me], cuts[s.grid.me + 1]
    rp, ci, v = A.rowptr, A.colind, A.data
    sb = _solver(mesh, krylov_solver=K.DIRECT, factor_dtype="float64")
    sb.set_distributed_csr_matrix(rp[a:e + 1] - rp[a], ci[rp[a]:rp[e]],
                                  v[rp[a]:rp[e]], a, A.n)
    sb.reorder(nx, nx)
    out["blocks"] = sb.solve(b)[0]
    d_rp, d_ci, d_v, o_rp, o_ci, o_v = [0], [], [], [0], [], []
    garray = np.unique(np.concatenate(
        [c[(c < a) | (c >= e)] for c in
         (ci[rp[i]:rp[i + 1]] for i in range(a, e))]))
    for i in range(a, e):
        c, vv = ci[rp[i]:rp[i + 1]], v[rp[i]:rp[i + 1]]
        dm = (c >= a) & (c < e)
        d_ci.append(c[dm] - a)
        d_v.append(vv[dm])
        o_ci.append(np.searchsorted(garray, c[~dm]))
        o_v.append(vv[~dm])
        d_rp.append(d_rp[-1] + int(dm.sum()))
        o_rp.append(o_rp[-1] + int((~dm).sum()))
    sm = _solver(mesh, krylov_solver=K.DIRECT, factor_dtype="float64")
    sm.set_MPIAIJ_matrix(e - a, d_rp, np.concatenate(d_ci),
                         np.concatenate(d_v), o_rp, np.concatenate(o_ci),
                         np.concatenate(o_v), garray, a, A.n)
    sm.reorder(nx, nx)
    out["mpiaij"] = sm.solve(b)[0]
    # the distributed solve on carried JAX factors
    fj = interop.factors_from_numpy(s.pdev, late(inp, "jax_tree"),
                                    dtype=torch.float64)
    tree = interop.shard_factors(fj, s.sp)
    bp = torch.from_numpy(s._transform_b(b))[:, None]
    xd = spmd.solve(s.sp, tree, bp)[:, 0]
    xs = numeric.solve(fj, bp[:, 0])
    out["carried"] = (_np(xd), _np(xs))
    # a rank with another plan: every rank raises
    sd = _solver(mesh, krylov_solver=K.DIRECT, factor_dtype="float64")
    sd.opts.nd_leaf = 8 if s.grid.me == 1 else 4
    sd.set_csr_matrix(A)
    try:
        sd.reorder(nx, nx)
        out["digest"] = "no error"
    except RuntimeError as err:
        out["digest"] = str(err)
    return out
