"""Outer Krylov iterations over block-row distributed vectors.

The counterpart of ``strumpack_tpu/parallel/krylov_dist.py`` (IR :30,
BiCGStab :82, GMRES :149), the role of the reference's
``IterativeRefinementMPI``, ``BiCGStabMPI`` and ``GMResMPI``: every
Krylov vector is this rank's block of rows (``DistCSR``'s layout), the
spmv is the halo-exchange product, dot products and norms are local sums
all-reduced over the ranks, and the preconditioner is the distributed
multifrontal solve (the residual all-gathered, solved by the sweep of
``parallel/spmd.py`` on every rank, this rank's rows kept).

The loops are the host loops of ``krylov/solvers.py`` with the
all-reduced inner product, so the iteration counts are those of the
single-device solver.
Each returns (x block, iterations, achieved relative residual).
"""
from __future__ import annotations

import torch

from . import dist as D
from ..krylov import solvers as K


def make_dot(group):
    """The inner product of block-distributed vectors: local vdot, then
    one all-reduce over ``group``."""
    def dot(a, b):
        return D.all_reduce(torch.vdot(a, b).reshape(1), group=group)[0]
    return dot


def iterative_refinement(spmv, prec, b, rtol, atol, maxit, group):
    """Iterative refinement on blocks (``krylov/solvers.py``
    ``iterative_refinement`` with the all-reduced inner product)."""
    return K.iterative_refinement(spmv, prec, b, rtol=rtol, atol=atol,
                                  maxit=maxit, dot=make_dot(group))


def gmres(spmv, prec, b, rtol, atol, maxit, restart, group,
          gram_schmidt="modified"):
    """Restarted left-preconditioned GMRES on blocks (``krylov/solvers.py``
    ``gmres`` with the all-reduced inner product)."""
    return K.gmres(spmv, prec, b, rtol=rtol, atol=atol, maxit=maxit,
                   restart=restart, gram_schmidt=gram_schmidt,
                   dot=make_dot(group))


def bicgstab(spmv, prec, b, rtol, atol, maxit, group):
    """Preconditioned BiCGStab on blocks (``krylov/solvers.py``
    ``bicgstab`` with the all-reduced inner product)."""
    return K.bicgstab(spmv, prec, b, rtol=rtol, atol=atol, maxit=maxit,
                      dot=make_dot(group))
