"""Top-level sparse solver (PyTorch).

Role of the reference's ``SparseSolverBase`` + ``SparseSolver``
(SparseSolverBase.cpp:304-721: reorder -> factor -> solve, equilibration,
rhs transforms, statistics), the counterpart of ``strumpack_tpu/solver.py``
for the exact multifrontal path:

  reorder():  host — equilibration, pattern symmetrization, geometric nested
              dissection, symbolic factorization, level/bucket plan
  factor():   device — level-batched numeric factorization
  solve():    device — multifrontal solve, directly or inside iterative
              refinement (``KrylovSolver.REFINE``, also what AUTO means here)

The device is CUDA unless the caller asks for another (``device="cpu"``);
without CUDA and without an explicit device the constructor raises.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .options import (CompressionType, KrylovSolver, MatchingJob,
                      ReorderingStrategy, SPOptions)
from .sparse.csr import CSRMatrix
from .utils.params import ReturnCode, counters


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


class SparseSolver:
    def __init__(self, opts: SPOptions | None = None, device=None,
                 verbose=None):
        self.opts = opts or SPOptions()
        if verbose is not None:
            self.opts.verbose = verbose
        self.device = resolve_device(device)
        self.A = None          # user matrix (host CSR)
        self.Ascaled = None    # scaled matrix
        self.Ap = None         # scaled + permuted matrix (factored one)
        self.perm = None
        self.iperm = None
        self.tree = None
        self.plan = None
        self.pdev = None
        self.fac = None
        self.ell = None        # device spmv operator on Ap
        self.dr = None
        self.dc = None
        self.times = {}
        self.its = 0
        self.achieved_rtol = 0.0
        self._reordered = False
        self._factored = False

    # -- input -------------------------------------------------------------
    def _check_supported(self):
        opts = self.opts
        unsupported = [
            (opts.compression != CompressionType.NONE,
             f"compression {opts.compression.name}"),
            (opts.matching != MatchingJob.NONE,
             f"matching {opts.matching.name}"),
            (opts.positive_definite, "the SPD (Cholesky) path"),
            (not opts.pivoting, "factorization without pivoting"),
            (opts.krylov_solver not in (KrylovSolver.AUTO,
                                        KrylovSolver.REFINE,
                                        KrylovSolver.DIRECT),
             f"Krylov solver {opts.krylov_solver.name}"),
            (opts.refine_dtype in ("float32x2", "df32"),
             "double-float refinement")]
        for bad, what in unsupported:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet")

    def set_csr_matrix(self, A) -> None:
        if not isinstance(A, CSRMatrix):
            A = CSRMatrix.from_scipy(A)
        if np.iscomplexobj(A.data):
            raise NotImplementedError("complex matrices are not ported yet")
        self.A = A
        self._reordered = False
        self._factored = False

    def update_matrix_values(self, A) -> None:
        """New values, same pattern: reuse symbolic analysis and plan.
        Reference: StrumpackSparseSolver.hpp:196 + structure-reuse test."""
        if not isinstance(A, CSRMatrix):
            A = CSRMatrix.from_scipy(A)
        if self.A is None or A.nnz != self.A.nnz:
            raise ValueError("update_matrix_values needs a matrix with the "
                             "same pattern as the one set before")
        self.A = A
        self._factored = False
        if self._reordered:
            self._rescale_and_permute()

    # -- phases ------------------------------------------------------------
    def _rescale_and_permute(self):
        """Scale, symmetrize the pattern, and permute.  The factored/spmv'd
        matrix Ap always carries the symmetrized pattern (explicit zeros
        where only A^T has entries) so the assembly plan's value indices
        stay valid under update_matrix_values."""
        A = self.A
        if self.opts.equilibration:
            from .options import EquilibrationType
            dr, dc, *_ = A.equilibration()
            et = self.opts.equilibration_type
            if et == EquilibrationType.ROW:
                dc = np.ones_like(dc)
            elif et == EquilibrationType.COLUMN:
                dr = np.ones_like(dr)
            if self.opts.symmetric:
                # symmetry-preserving scaling: D A D with D = sqrt(dr)
                dr = dc = np.sqrt(dr * dc) if not np.allclose(dr, dc) else dr
            self.dr, self.dc = dr, dc
            self.Ascaled = A.scale_rows_cols(dr, dc)
        else:
            self.dr = self.dc = None
            self.Ascaled = A
        Asym = (self.Ascaled if A.symm_sparse
                else self.Ascaled.symmetrize_sparsity())
        self.Ap = Asym.permute(self.perm, self.iperm)
        from .ops.spmv import DeviceELL
        self.ell = DeviceELL(self.Ap, dtype=np.dtype(self.opts.refine_dtype),
                             device=self.device)

    def reorder(self, nx=None, ny=None, nz=None) -> ReturnCode:
        if self.A is None:
            return ReturnCode.MATRIX_NOT_SET
        self._check_supported()
        t0 = time.perf_counter()
        opts = self.opts
        if nx is not None:
            opts.nx, opts.ny, opts.nz = nx, ny or 1, nz or 1
            opts.reordering_method = ReorderingStrategy.GEOMETRIC
        if opts.reordering_method != ReorderingStrategy.GEOMETRIC:
            raise NotImplementedError(
                f"reordering {opts.reordering_method.name}: only GEOMETRIC "
                "(reorder(nx, ny, nz)) is ported yet")
        from .sparse.ordering.geometric import geometric_nd
        perm, iperm, tree = geometric_nd(
            opts.nx, opts.ny, opts.nz, components=opts.components,
            width=opts.separator_width, leaf=opts.nd_leaf)
        self.perm, self.iperm, self.tree = perm, iperm, tree
        self._rescale_and_permute()

        # symbolic factorization on the symmetrized permuted pattern
        from .sparse.symbolic import symbolic_factorization
        from .frontal.plan import build_plan
        from .frontal.numeric import PlanDev
        upd = symbolic_factorization(self.Ap, tree)
        self.plan = build_plan(self.Ap, tree, upd, compression=opts)
        self.pdev = PlanDev(self.plan, self.device)
        self._reordered = True
        self.times["reorder"] = time.perf_counter() - t0
        if opts.verbose:
            print(f"# reordering time = {self.times['reorder']:.3f} s, "
                  f"{tree.nseps} fronts, {self.plan.n_levels} levels, "
                  f"max front {self.plan.max_front}")
        return ReturnCode.SUCCESS

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def factor(self) -> ReturnCode:
        if self.A is None:
            return ReturnCode.MATRIX_NOT_SET
        if not self._reordered:
            rc = self.reorder()
            if rc != ReturnCode.SUCCESS:
                return rc
        if self._factored:
            return ReturnCode.SUCCESS
        from .frontal import numeric
        t0 = time.perf_counter()
        opts = self.opts
        thresh = 0.0
        if opts.replace_tiny_pivots:
            eps = np.finfo(np.dtype(opts.factor_dtype)).eps
            thresh = np.sqrt(eps) * self.Ap.norm1()
        fdt = getattr(torch, np.dtype(opts.factor_dtype).name)
        self.fac = numeric.factorize(self.pdev, self.Ap.data, thresh=thresh,
                                     dtype=fdt)
        self._sync()
        self._factored = True
        self.times["factor"] = time.perf_counter() - t0
        itemsize = np.dtype(opts.factor_dtype).itemsize
        counters.flops += self.plan.factor_flops
        counters.factor_nonzeros = self.plan.factor_nnz
        counters.factor_memory = self.fac.factor_memory()
        counters.peak_device_bytes = max(
            counters.peak_device_bytes,
            numeric.factor_peak_bytes(self.pdev, itemsize))
        if opts.verbose:
            gfs = (self.plan.factor_flops
                   / max(self.times["factor"], 1e-12) / 1e9)
            print(f"#   - factor time = {self.times['factor']:.4f}")
            print(f"#   - factor nonzeros = {self.plan.factor_nnz}")
            print(f"#   - factor memory = "
                  f"{self.fac.factor_memory() / 1e6:.3f} MB")
            print(f"#   - factor flops = {self.plan.factor_flops:.4g}, "
                  f"rate = {gfs:.2f} GFlop/s")
        return ReturnCode.SUCCESS

    # -- rhs / solution transforms (SparseSolver.cpp:175-256) -------------
    def _transform_b(self, b):
        b = np.asarray(b)
        if self.dr is not None:
            b = b * (self.dr if b.ndim == 1 else self.dr[:, None])
        return b[self.perm]

    def _transform_x(self, xp):
        x = np.asarray(xp)[self.iperm]
        if self.dc is not None:
            x = x * (self.dc if x.ndim == 1 else self.dc[:, None])
        return x

    def solve(self, b, x0=None):
        """Solve A x = b for b [n] or [n, nrhs]; returns (x, ReturnCode)."""
        if x0 is not None:
            raise NotImplementedError("an initial guess is not ported yet")
        if self.A is None:
            return None, ReturnCode.MATRIX_NOT_SET
        if not self._factored:
            rc = self.factor()
            if rc != ReturnCode.SUCCESS:
                return None, rc
        from .frontal import numeric
        opts = self.opts
        t0 = time.perf_counter()
        bp = self._transform_b(b)
        rdt = getattr(torch, np.dtype(opts.refine_dtype).name)
        bdev = torch.as_tensor(bp, device=self.device).to(rdt)
        solver = opts.krylov_solver
        if solver == KrylovSolver.AUTO:
            solver = KrylovSolver.REFINE
        if solver == KrylovSolver.DIRECT:
            xdev = numeric.solve(self.fac, bdev)
            self.its = 1
            # achieved_rtol reflects THIS solve: one spmv on the
            # permuted/scaled system
            rv = (self.ell @ xdev.to(rdt)) - bdev
            self.achieved_rtol = float(
                torch.linalg.vector_norm(rv)
                / max(float(torch.linalg.vector_norm(bdev)), 1e-300))
        else:
            from .krylov.refine import iterative_refinement
            xdev, self.its, self.achieved_rtol = iterative_refinement(
                self.fac, self.ell, bdev, opts.rel_tol, opts.abs_tol,
                opts.maxit)
        x = self._transform_x(xdev.cpu().numpy())
        self.times["solve"] = time.perf_counter() - t0
        # solve-phase flop counter: per iteration one spmv (2 nnz) + one
        # preconditioner application (2 factor_nnz) per rhs
        nrhs = 1 if np.ndim(b) == 1 else np.shape(b)[1]
        counters.flops += self.its * nrhs * 2 * (
            self.A.nnz + self.plan.factor_nnz)
        if opts.verbose:
            print(f"#   - solve time = {self.times['solve']:.4f}, "
                  f"iterations = {self.its}")
        rc = ReturnCode.SUCCESS
        if (solver != KrylovSolver.DIRECT and self.its >= opts.maxit
                and self.achieved_rtol > opts.rel_tol):
            rc = ReturnCode.NO_CONVERGENCE
        return x, rc

    # -- stats -------------------------------------------------------------
    def Krylov_iterations(self) -> int:
        return self.its

    def factor_nonzeros(self) -> int:
        return self.plan.factor_nnz if self.plan else 0

    def factor_flops(self) -> int:
        return self.plan.factor_flops if self.plan else 0
