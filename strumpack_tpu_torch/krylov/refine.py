"""Iterative refinement with the multifrontal solve as preconditioner.

The counterpart of ``strumpack_tpu/krylov/device_loop.py`` (the reference's
IterativeRefinement.cpp:48 with the mixed-precision split of
SparseSolverMixedPrecision.cpp:64-130): the residual and the update run in
the refine dtype, the preconditioner in the factor dtype.  The loop is a
Python loop over device tensors; the convergence test reads one small
vector of residual norms back per iteration.
"""
from __future__ import annotations

import torch

from ..frontal import numeric
from ..ops.spmv import spmv_ell


def iterative_refinement(fac, ell, b, rtol, atol, maxit, x0=None):
    """Returns (x, iterations, max relative residual) for b [n] or
    [n, nrhs] on the factors' device, starting from ``x0`` (b's shape) or
    from zero.  Several right-hand sides share one iteration stream, which
    runs until every column has converged."""
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    bnorm = torch.linalg.vector_norm(B, dim=0)                 # [nrhs]
    tol = torch.clamp(rtol * bnorm, min=atol)
    if x0 is None:
        x, r, rn = torch.zeros_like(B), B, bnorm
    else:
        x = (x0[:, None] if squeeze else x0).to(B.dtype)
        r = B - spmv_ell(ell.vals, ell.cols, x)
        rn = torch.linalg.vector_norm(r, dim=0)
    it = 0
    while it < maxit and bool((rn > tol).any()):
        x = x + numeric.solve(fac, r.to(fac.dtype)).to(B.dtype)
        r = B - spmv_ell(ell.vals, ell.cols, x)
        rn = torch.linalg.vector_norm(r, dim=0)
        it += 1
    rel = float(torch.max(rn / torch.clamp(bnorm,
                                           min=torch.finfo(B.dtype).tiny)))
    return (x[:, 0] if squeeze else x), it, rel
