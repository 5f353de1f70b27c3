"""Distributed sparse solver over torch.distributed.

The counterpart of ``strumpack_tpu/parallel/driver.py``
(``DistributedSparseSolver``, :48-429), the role of the reference's
``SparseSolverMPIDist`` (StrumpackSparseSolverMPIDist.hpp:71) with a
replicated symbolic phase: every rank holds the matrix, reorders it and
builds the plan itself, as the JAX package does; the numeric phases run
over the mesh (``parallel/spmd.py``: shard, grid and repl buckets), the
outer Krylov iterations over block-row vectors (``krylov_dist.py`` with
the halo spmv of ``dist_spmv.py``).  One factorization serves every
solve.

Inputs: the global CSR (``set_csr_matrix``), each rank's block of rows
(``set_distributed_csr_matrix``, gathered as ``_allgather_blocks`` :25
does) or PETSc's MPIAIJ split (``set_MPIAIJ_matrix``, :114).

After reordering, one all-gather of a digest (the permutation and the
bucket shapes) checks that every rank built the same plan: an ordering
that draws from OS entropy (SPECTRAL starts ARPACK so) would otherwise
take different branches and deadlock a collective.  A mismatch raises on
every rank.

``fully_distributed=True`` (the distributed symbolic phase, ``dist_plan``,
``dist_symbolic``) raises ``NotImplementedError``: it is slice 8 of the
port.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from . import dist as D
from .spmd import ShardedPlan, make_sharded_factor_solve
from ..options import KrylovSolver
from ..solver import SparseSolver
from ..sparse.csr import CSRMatrix
from ..utils.params import ReturnCode


class DistributedSparseSolver(SparseSolver):
    """SparseSolver whose numeric phases run over ``mesh`` (a
    ``DeviceMesh``; axis 'b' front batches, optional 'r', 'c' for the
    grid fronts), one rank per device."""

    def __init__(self, mesh, opts=None, device=None, verbose=None,
                 fully_distributed=False):
        if fully_distributed:
            raise NotImplementedError(
                "fully_distributed=True (distributed symbolic phase, "
                "dist_plan / dist_symbolic / nd_dist) is slice 8 of the "
                "port")
        device = D.resolve_rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        super().__init__(opts, device=device, verbose=verbose)
        self.mesh = mesh
        self.grid = D.Grid(mesh)
        self.sp = None          # ShardedPlan
        self._step = None
        self._tree = None       # this rank's factors
        self._dA = None         # DistCSR of Ap (Krylov)

    # -- distributed input (CSRMatrixMPI role) ----------------------------
    def set_distributed_csr_matrix(self, local_rowptr, local_colind,
                                   local_vals, begin_row, n):
        """Block-row input (``set_distributed_csr_matrix``,
        StrumpackSparseSolverMPIDist.hpp:185): each rank passes its
        contiguous rows (``local_rowptr`` its [nrows + 1] pointer, global
        column indices); the blocks are all-gathered into the global CSR
        for the replicated symbolic phase."""
        lrp = np.asarray(local_rowptr, np.int64)
        blk = (int(begin_row), np.diff(lrp),
               np.asarray(local_colind, np.int64), np.asarray(local_vals))
        rows = sorted(D.all_gather_object(blk, self.grid.group),
                      key=lambda t: t[0])
        counts = np.concatenate([r[1] for r in rows])
        if len(counts) != n:
            raise ValueError(f"the row blocks hold {len(counts)} rows, "
                             f"not n = {n}")
        rowptr = np.concatenate([[0], np.cumsum(counts)])
        self.set_csr_matrix(CSRMatrix(
            n, rowptr, np.concatenate([r[2] for r in rows]),
            np.concatenate([r[3] for r in rows])))

    def set_MPIAIJ_matrix(self, n_local, d_rowptr, d_colind, d_vals,
                          o_rowptr, o_colind, o_vals, garray, begin_row,
                          n):
        """PETSc MPIAIJ split input (``set_MPIAIJ_matrix``,
        StrumpackSparseSolverMPIDist.hpp:195): the diagonal block with
        LOCAL column indices, the off-diagonal block with compressed
        global columns through ``garray``."""
        d_rowptr = np.asarray(d_rowptr, np.int64)
        o_rowptr = np.asarray(o_rowptr, np.int64)
        garray = np.asarray(garray, np.int64)
        rp, ci, vv = [0], [], []
        for i in range(n_local):
            dc = np.asarray(d_colind[d_rowptr[i]:d_rowptr[i + 1]],
                            np.int64) + begin_row
            oc = garray[np.asarray(o_colind[o_rowptr[i]:o_rowptr[i + 1]],
                                   np.int64)]
            c = np.concatenate([dc, oc])
            v = np.concatenate([
                np.asarray(d_vals[d_rowptr[i]:d_rowptr[i + 1]]),
                np.asarray(o_vals[o_rowptr[i]:o_rowptr[i + 1]])])
            srt = np.argsort(c, kind="stable")
            ci.append(c[srt])
            vv.append(v[srt])
            rp.append(rp[-1] + len(c))
        self.set_distributed_csr_matrix(
            np.asarray(rp, np.int64), np.concatenate(ci),
            np.concatenate(vv), begin_row, n)

    # -- phases ------------------------------------------------------------
    def plan_digest(self) -> str:
        """sha256 of the permutation and every bucket's shape and kind."""
        h = hashlib.sha256(np.asarray(self.perm, np.int64).tobytes())
        for li, lvl in enumerate(self.plan.levels):
            for bi, bp in enumerate(lvl):
                h.update(repr((li, bi, bp.nf, bp.s_pad, bp.u_pad, bp.blr,
                               bp.hss, bp.hodlr, bp.hodbf, bp.hss_sample,
                               bp.lossy, bp.chunks)).encode())
        return h.hexdigest()

    def reorder(self, nx=None, ny=None, nz=None) -> ReturnCode:
        rc = super().reorder(nx, ny, nz)
        if rc != ReturnCode.SUCCESS:
            return rc
        digests = D.all_gather_object(self.plan_digest(), self.grid.group)
        if len(set(digests)) > 1:
            raise RuntimeError(
                "the ranks built different plans (digests "
                f"{sorted(set(d[:12] for d in digests))}): the ordering is "
                "not deterministic across ranks")
        self.sp = ShardedPlan(self.pdev, self.grid)
        self._step = self._tree = self._dA = None
        return rc

    def update_matrix_values(self, A) -> None:
        super().update_matrix_values(A)
        self._tree = self._dA = None

    def factor(self) -> ReturnCode:
        if self.A is None:
            return ReturnCode.MATRIX_NOT_SET
        if not self._reordered:
            rc = self.reorder()
            if rc != ReturnCode.SUCCESS:
                return rc
        if self._factored:
            return ReturnCode.SUCCESS
        t0 = time.perf_counter()
        opts = self.opts
        thresh = 0.0
        if opts.replace_tiny_pivots:
            eps = np.finfo(np.dtype(opts.factor_dtype)).eps
            thresh = np.sqrt(eps) * self.Ap.norm1()
        fdt = getattr(torch, np.dtype(opts.factor_dtype).name)
        self._step = make_sharded_factor_solve(
            self.pdev, self.grid, dtype=fdt, thresh=thresh,
            hss_tol=opts.hss.rel_tol, blr_tol=opts.blr.rel_tol, sp=self.sp)
        self._tree = None
        self._tree = self._step.factor_fn(self.Ap.data)
        self._sync()
        self._factored = True
        self.factor_passes = 1
        self.times["factor"] = time.perf_counter() - t0
        return ReturnCode.SUCCESS

    def delete_factors(self) -> None:
        self._tree = None
        self._factored = False

    # -- solve -------------------------------------------------------------
    def _prec(self, fdt):
        """M^-1 on this rank's rows: the residual block all-gathered, the
        distributed multifrontal solve, this rank's rows kept."""
        lo, hi = self._dA.lo, self._dA.hi

        def prec(rl):
            r = torch.cat(D.all_gather(rl, self.grid.group))
            x = self._step.solve_fn(self._tree, r.to(fdt))
            return x[lo:hi].to(rl.dtype)
        return prec

    def _krylov_dist(self, solver, bcol, fdt):
        from . import krylov_dist as KD
        opts = self.opts
        A = self._dA
        bl = bcol[A.lo:A.hi].contiguous()
        prec = self._prec(fdt)
        g = self.grid.group
        if solver == KrylovSolver.REFINE:
            xl, its, rel = KD.iterative_refinement(
                A.spmv_local, prec, bl, opts.rel_tol, opts.abs_tol,
                opts.maxit, g)
        elif solver in (KrylovSolver.PREC_GMRES, KrylovSolver.GMRES):
            xl, its, rel = KD.gmres(
                A.spmv_local,
                prec if solver == KrylovSolver.PREC_GMRES else None, bl,
                opts.rel_tol, opts.abs_tol, opts.maxit, opts.gmres_restart,
                g, gram_schmidt=opts.gram_schmidt.value)
        elif solver in (KrylovSolver.PREC_BICGSTAB, KrylovSolver.BICGSTAB):
            xl, its, rel = KD.bicgstab(
                A.spmv_local,
                prec if solver == KrylovSolver.PREC_BICGSTAB else None, bl,
                opts.rel_tol, opts.abs_tol, opts.maxit, g)
        else:
            raise ValueError(solver)
        return torch.cat(D.all_gather(xl, g)), its, rel

    def _solve(self, b, x0=None):
        if x0 is not None:
            raise NotImplementedError("the distributed driver starts from "
                                      "zero (no initial guess)")
        if self.A is None:
            return None, ReturnCode.MATRIX_NOT_SET
        rc = self.factor()
        if rc != ReturnCode.SUCCESS:
            return None, rc
        from .dist_spmv import DistCSR
        opts = self.opts
        t0 = time.perf_counter()
        fdt = getattr(torch, np.dtype(opts.factor_dtype).name)
        rdt = getattr(torch, np.dtype(opts.refine_dtype).name)
        bp = self._transform_b(b)
        solver = opts.krylov_solver
        if solver == KrylovSolver.AUTO:
            solver = KrylovSolver.REFINE
        bdev = D.to_global(bp, self.device)
        if solver == KrylovSolver.DIRECT:
            x = self._step.solve_fn(self._tree, bdev.to(fdt))
            self.its = 1
            self.achieved_rtol = 0.0
        else:
            if self._dA is None:
                self._dA = DistCSR(self.Ap, self.grid,
                                   dtype=np.dtype(opts.refine_dtype),
                                   device=self.device)
            B = bdev.to(rdt)
            cols = [B] if B.ndim == 1 else list(B.T)
            out = [self._krylov_dist(solver, c.contiguous(), fdt)
                   for c in cols]
            x = out[0][0] if B.ndim == 1 else torch.stack(
                [o[0] for o in out], dim=1)
            self.its = max(o[1] for o in out)
            self.achieved_rtol = max(o[2] for o in out)
        xh = self._transform_x(D.from_global(x))
        self.times["solve"] = time.perf_counter() - t0
        rc = ReturnCode.SUCCESS
        if (solver != KrylovSolver.DIRECT and self.its >= opts.maxit
                and self.achieved_rtol > opts.rel_tol):
            rc = ReturnCode.NO_CONVERGENCE
        return xh, rc
