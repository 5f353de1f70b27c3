"""Top-level sparse solver (PyTorch).

Role of the reference's ``SparseSolverBase`` + ``SparseSolver``
(SparseSolverBase.cpp:304-721: reorder -> factor -> solve, equilibration,
rhs transforms, statistics), the counterpart of ``strumpack_tpu/solver.py``
for the exact (LU with or without pivoting, or Cholesky) and the compressed
multifrontal paths, in real or complex arithmetic:

  reorder():  host — MC64-family matching and scaling, equilibration,
              pattern symmetrization, a fill-reducing ordering (geometric,
              BFS or multilevel nested dissection, spectral, natural, RCM,
              AMD, MMD, MLF; separator reordering under compression),
              symbolic factorization, level/bucket plan
  factor():   device — level-batched numeric factorization (dense, lossy,
              BLR, HSS, sampled HSS, HODLR or HODBF fronts, BLR-compressed
              contribution blocks), with the adaptive-rank restart under
              compression
  solve():    device — multifrontal solve, directly, inside iterative
              refinement (in the refine dtype, or double-float for
              ``float32x2``) or as the preconditioner of GMRES/BiCGStab
              (AUTO: refinement for exact factors, PREC_GMRES under
              compression), from zero or an initial guess

and the factor diagnostics (inertia, pivot growth, subnormals).  A
complex matrix factors natively (complex64/complex128 factor and refine
dtypes) or, with ``complex_via_real``, as its real-equivalent interleaved
expansion.

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

# Plans of at most this many buckets solve several right-hand sides in one
# Krylov stream and report the largest iteration count; larger plans solve
# column by column and report the sum, as the JAX package does
# (strumpack_tpu/solver.py:584-645, SPLIT_SOLVE_BUCKETS at
# strumpack_tpu/frontal/numeric.py:1812)
SPLIT_SOLVE_BUCKETS = 40


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


def _double_float(opts) -> bool:
    """Whether refinement runs in double-float (``float32x2``)."""
    return opts.refine_dtype in ("float32x2", "df32")


def _order(opts, Asym):
    """(perm, iperm, tree) of the fill-reducing ordering ``opts`` names on
    the symmetrized pattern ``Asym`` (``strumpack_tpu/solver.py:183-248``).
    The METIS-family names take the native multilevel bisection (HEM
    coarsening + FM + vertex-cover separators), ND/AND the native BFS
    level-set bisection (ANDSparspak role); the parallel names
    (PARMETIS, PTSCOTCH) run the distributed-work nested dissection with
    the multilevel splitter across the ranks of ``torch.distributed``
    when it is initialized with more than one rank
    (``sparse/ordering/nd_dist.py``; every rank must reorder), and the
    single-process one otherwise.  RCM, AMD, MMD and MLF orderings get
    their tree from the etree, with relaxed amalgamation composed into
    the permutation."""
    R = ReorderingStrategy
    m = opts.reordering_method
    n = Asym.n
    if m == R.GEOMETRIC:
        from .sparse.ordering.geometric import geometric_nd
        return geometric_nd(opts.nx, opts.ny, opts.nz,
                            components=opts.components,
                            width=opts.separator_width, leaf=opts.nd_leaf)
    if m in (R.PARMETIS, R.PTSCOTCH):
        from .sparse.ordering.nd_dist import nested_dissection_distributed
        return nested_dissection_distributed(Asym.rowptr, Asym.colind, n,
                                             leaf=opts.nd_leaf)
    if m in (R.ND, R.AND, R.METIS, R.SCOTCH, R.SPECTRAL):
        from .sparse.ordering.nd import nested_dissection
        splitter = {R.ND: "bfs", R.AND: "bfs",
                    R.SPECTRAL: "spectral"}.get(m, "ml")
        return nested_dissection(Asym.rowptr, Asym.colind, n,
                                 leaf=opts.nd_leaf, splitter=splitter)
    from .sparse.separator_tree import from_etree_perm
    if m == R.NATURAL:
        perm = np.arange(n, dtype=np.int64)
        return perm, perm, from_etree_perm(Asym.rowptr, Asym.colind, n,
                                           perm, perm, leaf=opts.nd_leaf)
    if m == R.RCM:
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        perm = np.asarray(reverse_cuthill_mckee(Asym.to_scipy(),
                                                symmetric_mode=True),
                          dtype=np.int64)
    elif m in (R.AMD, R.MMD, R.MLF):
        from .sparse.ordering import amd
        order = {R.AMD: amd.amd_order, R.MMD: amd.mmd_order,
                 R.MLF: amd.mlf_order}[m]
        perm = order(Asym.rowptr, Asym.colind, n)
    else:
        raise ValueError(f"reordering method {m}")
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n)
    # relaxed amalgamation (SYMQAMD role) composes an extra permutation
    # that pulls small child supernodes into their parents
    return from_etree_perm(Asym.rowptr, Asym.colind, n, perm, iperm,
                           leaf=opts.nd_leaf, return_perm=True)


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
        self.mq = None         # matching column permutation
        self.mdr = None        # matching row / column scalings
        self.mdc = None
        self.ell_lo = None     # lo halves of Ap's values (float32x2)
        self.times = {}
        self.its = 0
        self.achieved_rtol = 0.0
        self.factor_passes = 0   # factorizations of the last factor()
        self._cvr = None       # complex dtype of a complex_via_real input
        self._reordered = False
        self._factored = False

    # -- input -------------------------------------------------------------
    def _maybe_expand_complex(self, A):
        """With ``complex_via_real``, a complex A as its real-equivalent
        interleaved expansion (``strumpack_tpu/solver.py:59-80``): complex
        factor and refine dtypes become their real ones, and each grid
        point carries two dofs (``components`` doubled once)."""
        opts = self.opts
        if not (opts.complex_via_real and np.iscomplexobj(A.data)):
            return A
        first = self._cvr is None
        self._cvr = np.dtype(A.data.dtype)
        A = A.to_real_interleaved()
        for attr in ("factor_dtype", "refine_dtype"):
            v = getattr(opts, attr)
            if v == "complex64":
                setattr(opts, attr, "float32")
            elif v == "complex128":
                setattr(opts, attr, "float64")
        if first:
            opts.components *= 2
        return A

    def set_csr_matrix(self, A) -> None:
        if not isinstance(A, CSRMatrix):
            A = CSRMatrix.from_scipy(A)
        self.A = self._maybe_expand_complex(A)
        self._reordered = False
        self._factored = False

    def update_matrix_values(self, A) -> None:
        """New values, same pattern: reuse symbolic analysis and plan.
        Reference: StrumpackSparseSolver.hpp:196 + structure-reuse test."""
        if not isinstance(A, CSRMatrix):
            A = CSRMatrix.from_scipy(A)
        A = self._maybe_expand_complex(A)
        if self.A is None or A.nnz != self.A.nnz:
            raise ValueError("update_matrix_values needs a matrix with the "
                             "same pattern as the one set before")
        self.A = A
        self._factored = False
        if self._reordered:
            self._rescale_and_permute()

    # -- phases ------------------------------------------------------------
    def _rescale_and_permute(self):
        """Match, scale, symmetrize the pattern, and permute.  The
        factored/spmv'd matrix Ap always carries the symmetrized pattern
        (explicit zeros where only A^T has entries) so the assembly plan's
        value indices stay valid under update_matrix_values.  The matching
        q stays fixed; its scalings follow the values."""
        A = self.A
        if self.mq is not None:
            from .sparse.matching import apply_matching, matching_scaling
            self.mdr, self.mdc = matching_scaling(A, self.mq)
            A = apply_matching(A, self.mq, self.mdr, self.mdc)
        if self.opts.equilibration:
            from .options import EquilibrationType
            dr, dc, *_ = A.equilibration()
            et = self.opts.equilibration_type
            if et == EquilibrationType.ROW:
                dc = np.ones_like(dc)
            elif et == EquilibrationType.COLUMN:
                dr = np.ones_like(dr)
            if self.opts.symmetric or self.opts.positive_definite:
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
        self.ell_lo = None
        if _double_float(self.opts):
            # A itself in hi + lo f32 pairs: with hi-only values the
            # componentwise residual floor is eps_f32 * |A| ~ 1e-8, not
            # the 1e-10 contract (StrumpackOptions.hpp:186-197)
            self.ell = DeviceELL(self.Ap, dtype=np.float32,
                                 device=self.device)
            Alo = self.Ap.copy()
            d64 = np.asarray(self.Ap.data, np.float64)
            Alo.data = d64 - d64.astype(np.float32).astype(np.float64)
            self.ell_lo = DeviceELL(Alo, dtype=np.float32, device=self.device)
        else:
            self.ell = DeviceELL(self.Ap,
                                 dtype=np.dtype(self.opts.refine_dtype),
                                 device=self.device)

    def reorder(self, nx=None, ny=None, nz=None) -> ReturnCode:
        if self.A is None:
            return ReturnCode.MATRIX_NOT_SET
        t0 = time.perf_counter()
        opts = self.opts
        A = self.A
        if nx is not None:
            opts.nx, opts.ny, opts.nz = nx, ny or 1, nz or 1
            opts.reordering_method = ReorderingStrategy.GEOMETRIC

        # column matching for stability (SparseSolverBase.cpp:327-334)
        self.mq = self.mdr = self.mdc = None
        if opts.matching != MatchingJob.NONE:
            from .sparse import matching as M
            match_fn = {
                MatchingJob.MAX_CARDINALITY: M.max_cardinality_matching,
                MatchingJob.MAX_SMALLEST_DIAGONAL:
                    M.max_smallest_diagonal_matching,
                MatchingJob.MAX_SMALLEST_DIAGONAL_2:
                    M.max_smallest_diagonal_matching,
                MatchingJob.MAX_DIAGONAL_SUM: M.max_diagonal_sum_matching,
                MatchingJob.MAX_DIAGONAL_PRODUCT_SCALING:
                    M.max_product_matching,
                MatchingJob.COMBBLAS: M.awpm_matching,
            }[opts.matching]
            t1 = time.perf_counter()
            self.mq, self.mdr, self.mdc = match_fn(A)
            self.times["matching"] = time.perf_counter() - t1
            A = M.apply_matching(A, self.mq, self.mdr, self.mdc)

        # pattern symmetrization for the ordering and symbolic analysis
        # (SparseSolverBase.cpp:353)
        Asym = A if A.symm_sparse else A.symmetrize_sparsity()
        perm, iperm, tree = _order(opts, Asym)

        if opts.compression != CompressionType.NONE:
            # separator reordering (MatrixReordering.cpp:159): re-partition
            # each big separator's graph so BLR tiles are graph clusters;
            # composed into perm before symbolic factorization
            from .sparse.ordering.separator_reorder import \
                separator_reordering
            q = separator_reordering(Asym.permute(perm, iperm), tree, opts)
            if q is not None:
                perm = perm[q]
                iperm = np.empty_like(perm)
                iperm[perm] = np.arange(A.n)
        self.perm, self.iperm, self.tree = perm, iperm, tree
        self._rescale_and_permute()

        # symbolic factorization on the symmetrized permuted pattern
        from .sparse.symbolic import symbolic_factorization
        from .frontal.plan import build_plan
        from .frontal.numeric import PlanDev, hbm_budget_bytes
        upd = symbolic_factorization(self.Ap, tree)
        self.plan = build_plan(self.Ap, tree, upd, compression=opts,
                               hbm_bytes=hbm_budget_bytes(self.device))
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
        itemsize = np.dtype(opts.factor_dtype).itemsize
        compressed = opts.compression != CompressionType.NONE

        def run_factor():
            self.factor_passes += 1
            return numeric.factorize(self.pdev, self.Ap.data, thresh=thresh,
                                     dtype=fdt, blr_tol=opts.blr.rel_tol,
                                     pivoting=opts.pivoting,
                                     spd=opts.positive_definite,
                                     hss_tol=opts.hss.rel_tol,
                                     verbose=opts.verbose)

        self.factor_passes = 0
        # the old factors go before the new ones are built: a refactor
        # (update_matrix_values, the restart below) holds one set at a time
        self.fac = None
        self.fac = run_factor()
        # adaptive rank control (solver.py:315-353 of the JAX package, the
        # role of HSSMatrix.compress.hpp:37-100): buckets whose masked
        # ranks hit their cap get doubled caps and the factorization runs
        # again, unless doubled storage would pass half the device memory
        if opts.adaptive_rank and compressed:
            for _ in range(4):
                sat = self.fac.saturated_buckets()
                if not sat:
                    break
                proj = 2 * numeric.static_factor_bytes(self.plan, itemsize)
                if proj > 0.5 * numeric.hbm_budget_bytes(self.device):
                    if opts.verbose:
                        print("# adaptive rank restart SKIPPED: doubled "
                              f"caps would need ~{proj / 1e9:.1f} GB of "
                              "factor storage")
                    break
                grew = False
                for li, bi in sat:
                    bp = self.plan.levels[li][bi]
                    if bp.blr and bp.max_rank < bp.tile:
                        bp.max_rank = min(bp.tile, bp.max_rank * 2)
                        grew = True
                    if (bp.structured
                            and 0 < bp.hss_rank < bp.hss_leaf):
                        bp.hss_rank = min(bp.hss_leaf, bp.hss_rank * 2)
                        grew = True
                if not grew:
                    break
                if opts.verbose:
                    print("# adaptive rank restart: saturated caps doubled, "
                          "re-factoring")
                self.fac = None
                self.fac = run_factor()
        self._sync()
        self._factored = True
        self.times["factor"] = time.perf_counter() - t0
        flops = (self.fac.effective_factor_flops() if compressed
                 else self.plan.factor_flops)
        counters.flops += flops
        counters.factor_nonzeros = self.plan.factor_nnz
        counters.factor_memory = self.fac.factor_memory()
        counters.peak_device_bytes = max(
            counters.peak_device_bytes,
            numeric.factor_peak_bytes(self.pdev, itemsize))
        if opts.verbose:
            gfs = flops / max(self.times["factor"], 1e-12) / 1e9
            fmem = self.fac.factor_memory()
            print(f"#   - factor time = {self.times['factor']:.4f}")
            print(f"#   - factor nonzeros = {self.plan.factor_nnz}")
            print(f"#   - factor memory = {fmem / 1e6:.3f} MB")
            if compressed:
                dense = self.plan.factor_nnz * itemsize
                print(f"#   - factor memory/nonzeros = "
                      f"{100.0 * fmem / max(dense, 1):.1f} %")
                print(f"#   - maximum rank = {self.fac.max_rank()}"
                      f" (BLR), {self.fac.structured_max_rank()} (HSS, "
                      "HODLR)")
                print(f"#   - factor flops = {flops:.4g} (effective-rank "
                      f"model; dense-equivalent "
                      f"{self.plan.factor_flops:.4g}), rate >= "
                      f"{gfs:.2f} GFlop/s")
            else:
                print(f"#   - factor flops = {flops:.4g}, "
                      f"rate = {gfs:.2f} GFlop/s")
        return ReturnCode.SUCCESS

    # -- rhs / solution transforms (SparseSolver.cpp:175-256) -------------
    def _transform_b(self, b):
        b = np.asarray(b)
        if self.mdr is not None:
            b = b * (self.mdr if b.ndim == 1 else self.mdr[:, None])
        if self.dr is not None:
            b = b * (self.dr if b.ndim == 1 else self.dr[:, None])
        return b[self.perm]

    def _transform_x(self, xp):
        x = np.asarray(xp)[self.iperm]
        if self.dc is not None:
            x = x * (self.dc if x.ndim == 1 else self.dc[:, None])
        if self.mq is not None:
            # undo the column permutation: x_scaled[q[j]] = z[j]
            y = np.empty_like(x)
            y[self.mq] = x
            x = y * (self.mdc if x.ndim == 1 else self.mdc[:, None])
        return x

    def _untransform_x0(self, x0):
        """An initial guess of A x = b in the permuted, scaled system (the
        inverse of ``_transform_x``)."""
        x = np.asarray(x0)
        if self.mq is not None:
            x = (x / (self.mdc if x.ndim == 1 else self.mdc[:, None]))[
                self.mq]
        if self.dc is not None:
            x = x / (self.dc if x.ndim == 1 else self.dc[:, None])
        return x[self.perm]

    def solve(self, b, x0=None):
        """Solve A x = b for b [n] or [n, nrhs], from the initial guess
        ``x0`` (b's shape) or from zero; returns (x, ReturnCode).  With
        ``complex_via_real`` active, b, x0 and x are complex vectors of
        the original system, solved as the interleaved real one
        (``strumpack_tpu/solver.py:431-444``)."""
        if self._cvr is not None:
            br = CSRMatrix.complex_to_real_vec(np.asarray(b))
            x0r = (None if x0 is None
                   else CSRMatrix.complex_to_real_vec(np.asarray(x0)))
            x, rc = self._solve(br, x0r)
            if x is not None:
                x = CSRMatrix.real_to_complex_vec(np.asarray(x), self._cvr)
            return x, rc
        return self._solve(b, x0)

    def _solve(self, b, x0=None):
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
        x0p = None if x0 is None else self._untransform_x0(x0)
        if _double_float(opts):
            return self._solve_double_float(bp, x0p, t0)
        rdt = getattr(torch, np.dtype(opts.refine_dtype).name)
        bdev = torch.as_tensor(bp, device=self.device).to(rdt)
        x0dev = (None if x0p is None
                 else torch.as_tensor(x0p, device=self.device).to(rdt))
        solver = opts.krylov_solver
        if solver == KrylovSolver.AUTO:
            solver = (KrylovSolver.REFINE
                      if opts.compression == CompressionType.NONE
                      else KrylovSolver.PREC_GMRES)
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
            xdev = self._krylov(solver, bdev, x0dev)
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

    def _solve_double_float(self, bp, x0p, t0):
        """Double-float refinement (``float32x2``, ``strumpack_tpu/
        solver.py:460-484``): f32 corrections from the factors, residuals
        of the hi + lo split of A in compensated f32 pairs
        (``ops/twofloat.py``); several right-hand sides column by column.
        Returns (x, ReturnCode)."""
        from .ops.twofloat import df_from_f64, df_iterative_refinement, \
            df_to_f64
        opts = self.opts

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        B = bp[:, None] if bp.ndim == 1 else bp
        X0 = None if x0p is None else (
            x0p[:, None] if x0p.ndim == 1 else x0p)
        cols, self.its, self.achieved_rtol = [], 0, 0.0
        for j in range(B.shape[1]):
            bh, bl = df_from_f64(B[:, j])
            start = None if X0 is None else tuple(
                dev(a) for a in df_from_f64(X0[:, j]))
            xh, xl, its, rel = df_iterative_refinement(
                self.fac, self.ell, self.ell_lo, dev(bh), dev(bl),
                opts.rel_tol, opts.abs_tol, opts.maxit, x0=start)
            cols.append(df_to_f64(xh.cpu().numpy(), xl.cpu().numpy()))
            self.its = max(self.its, its)
            self.achieved_rtol = max(self.achieved_rtol, rel)
        xp = cols[0] if bp.ndim == 1 else np.stack(cols, axis=1)
        x = self._transform_x(xp)
        self.times["solve"] = time.perf_counter() - t0
        rc = (ReturnCode.SUCCESS if self.its < opts.maxit
              or self.achieved_rtol <= opts.rel_tol
              else ReturnCode.NO_CONVERGENCE)
        return x, rc

    def _blocked(self, solver, x0dev) -> bool:
        """Whether several right-hand sides take one iteration stream
        (the largest count reported) rather than column by column (the
        sum): refinement or preconditioned GMRES from zero, not verbose,
        on a plan of at most ``SPLIT_SOLVE_BUCKETS`` buckets, as in the
        JAX package (strumpack_tpu/solver.py:584-645)."""
        nb = sum(len(lvl) for lvl in self.plan.levels)
        return (x0dev is None and not self.opts.verbose
                and nb <= SPLIT_SOLVE_BUCKETS
                and solver in (KrylovSolver.REFINE, KrylovSolver.PREC_GMRES))

    def _krylov(self, solver, bdev, x0dev=None):
        """Iterative refinement, GMRES or BiCGStab (``krylov/``) on the
        permuted system, preconditioned by the multifrontal solve for
        PREC_* and REFINE, from ``x0dev`` or zero.  Several right-hand
        sides: refinement runs one stream for all columns where
        ``_blocked``; otherwise each column solves on its own, and the
        iteration count is the largest over the columns with the largest
        residual where ``_blocked``, else the sum with the last column's
        residual."""
        from .frontal import numeric
        from .krylov import solvers as K
        from .krylov.refine import iterative_refinement
        opts = self.opts
        blocked = self._blocked(solver, x0dev)
        if solver == KrylovSolver.REFINE and (bdev.ndim == 1 or blocked):
            x, self.its, self.achieved_rtol = iterative_refinement(
                self.fac, self.ell, bdev, opts.rel_tol, opts.abs_tol,
                opts.maxit, x0=x0dev)
            return x

        def spmv(v):
            return self.ell @ v

        def prec(r):
            return numeric.solve(self.fac, r).to(r.dtype)

        def one(bcol, x0col):
            if solver == KrylovSolver.REFINE:
                return iterative_refinement(
                    self.fac, self.ell, bcol, opts.rel_tol, opts.abs_tol,
                    opts.maxit, x0=x0col)
            if solver in (KrylovSolver.PREC_GMRES, KrylovSolver.GMRES):
                return K.gmres(
                    spmv, prec if solver == KrylovSolver.PREC_GMRES else None,
                    bcol, x0=x0col, rtol=opts.rel_tol, atol=opts.abs_tol,
                    maxit=opts.maxit, restart=opts.gmres_restart,
                    gram_schmidt=opts.gram_schmidt.value,
                    verbose=opts.verbose)
            if solver in (KrylovSolver.PREC_BICGSTAB, KrylovSolver.BICGSTAB):
                return K.bicgstab(
                    spmv,
                    prec if solver == KrylovSolver.PREC_BICGSTAB else None,
                    bcol, x0=x0col, rtol=opts.rel_tol, atol=opts.abs_tol,
                    maxit=opts.maxit, verbose=opts.verbose)
            raise ValueError(solver)

        if bdev.ndim == 1:
            x, self.its, self.achieved_rtol = one(bdev, x0dev)
            return x
        cols, its, rels = [], [], []
        for j in range(bdev.shape[1]):
            x, it, rel = one(
                bdev[:, j].contiguous(),
                None if x0dev is None else x0dev[:, j].contiguous())
            cols.append(x)
            its.append(it)
            rels.append(rel)
        self.its = max(its) if blocked else sum(its)
        self.achieved_rtol = max(rels) if blocked else rels[-1]
        return torch.stack(cols, dim=1)

    # -- stats -------------------------------------------------------------
    def Krylov_iterations(self) -> int:
        return self.its

    def factor_nonzeros(self) -> int:
        return self.plan.factor_nnz if self.plan else 0

    def factor_flops(self) -> int:
        return self.plan.factor_flops if self.plan else 0

    def inertia(self):
        """(n_pos, n_neg, n_zero, ReturnCode) of the factored matrix
        (SparseSolverBase::inertia); INACCURATE_INERTIA when pivoting moved
        a row."""
        if not self._factored:
            self.factor()
        npos, nneg, nzero, exact = self.fac.inertia()
        rc = (ReturnCode.SUCCESS if exact
              else ReturnCode.INACCURATE_INERTIA)
        return npos, nneg, nzero, rc

    def pivot_growth(self) -> float:
        """max |factor entry| / max |A entry| of the factored matrix."""
        if not self._factored:
            self.factor()
        return self.fac.pivot_growth(float(np.abs(self.Ap.data).max()))

    def subnormals(self) -> int:
        """Count of subnormal entries in the factors
        (SparseSolverBase.hpp:368-372 subnormals diagnostic)."""
        if not self._factored:
            self.factor()
        return self.fac.subnormals()

    def draw(self, path: str) -> None:
        """Write a gnuplot-compatible picture of the factor layout
        (EliminationTree::draw, EliminationTree.cpp:213): one rectangle
        per front's F11/F12/F21 blocks in matrix coordinates."""
        if not self._reordered:
            self.reorder()
        tree, upd = self.tree, self.plan.upd
        with open(path, "w") as f:
            f.write("# gnuplot: plot '%s' with boxxy\n" % path)
            f.write("# x y xlow xhigh ylow yhigh (front blocks)\n")
            for i in range(tree.nseps):
                sb, se = int(tree.sep_begin[i]), int(tree.sep_end[i])
                if se <= sb:
                    continue
                c = (sb + se) / 2.0
                f.write(f"{c} {c} {sb} {se} {sb} {se}\n")
                for u in upd[i]:
                    f.write(f"{c} {u} {sb} {se} {u} {u+1}\n")
                    f.write(f"{u} {c} {u} {u+1} {sb} {se}\n")

    def delete_factors(self) -> None:
        """Free the numeric factors, keep the symbolic analysis
        (SparseSolverBase.cpp:723)."""
        self.fac = None
        self._factored = False
