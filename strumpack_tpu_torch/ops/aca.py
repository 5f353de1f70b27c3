"""Adaptive cross approximation of BLR tiles (element-based low rank).

The counterpart of ``strumpack_tpu/ops/aca.py`` (the reference's
``dense/ACA`` and ``dense/BACA``, BLROptions LowRankAlgorithm::{ACA,BACA}):
a fixed maximum rank r with masked actual ranks, the pivot search a loop
of r steps over the batched residual (one rank-1 update a step for ACA,
a rank-b block update for BACA).
"""
from __future__ import annotations

import torch


def _tiny(dt):
    return torch.finfo(torch.empty((), dtype=dt).real.dtype).tiny


def aca(T, tol, r):
    """Batched fully pivoted ACA of tiles T [..., m, n].

    Returns (U [..., m, r], V [..., r, n], ranks [...]): each step takes
    the residual's largest entry (the first in row-major order among
    equal magnitudes) as pivot; the rank counts the pivots above ``tol``
    times the first one, and U/V columns beyond it are zero."""
    m, n = T.shape[-2], T.shape[-1]
    batch = T.shape[:-2]
    R = T.reshape(-1, m, n).clone()
    N = R.shape[0]
    U = T.new_zeros((N, m, r))
    V = T.new_zeros((N, r, n))
    pv = torch.zeros((N, r), dtype=T.real.dtype if T.is_complex() else
                     T.dtype, device=T.device)
    for k in range(r):
        i = torch.argmax(R.abs().reshape(N, m * n), dim=-1)
        pi, pj = i // n, i % n
        piv = torch.gather(R.reshape(N, m * n), 1, i[:, None])[:, 0]
        safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
        col = torch.gather(R, 2, pj[:, None, None].expand(N, m, 1))[..., 0]
        row = torch.gather(R, 1, pi[:, None, None].expand(N, 1, n))[:, 0]
        u = col / safe[:, None]
        R = R - u[:, :, None] * row[:, None, :]
        U[:, :, k] = u
        V[:, k, :] = row
        pv[:, k] = piv.abs()
    ranks = (pv > tol * torch.clamp(pv[:, :1], min=_tiny(T.dtype))).sum(-1)
    mask = torch.arange(r, device=T.device)[None] < ranks[:, None]
    U = torch.where(mask[:, None, :], U, 0)
    V = torch.where(mask[:, :, None], V, 0)
    return (U.reshape(batch + (m, r)), V.reshape(batch + (r, n)),
            ranks.reshape(batch))


def baca(T, tol, r, b=4):
    """Blocked ACA (BACA.cpp role): b pivot rows and columns a step, the
    rows of largest residual norm and then the columns of largest norm
    within them; the core's pseudo-inverse spans the block.  Same masked
    rank contract as ``aca``."""
    m, n = T.shape[-2], T.shape[-1]
    batch = T.shape[:-2]
    R = T
    U = T.new_zeros(batch + (m, r))
    V = T.new_zeros(batch + (r, n))
    nsteps = (r + b - 1) // b
    norms0 = torch.linalg.matrix_norm(T)
    step_norms = []
    for s in range(nsteps):
        k0 = s * b
        bb = min(b, r - k0)
        _, rows = torch.topk(torch.linalg.vector_norm(R, dim=-1), bb)
        Rrows = torch.gather(R, -2, rows[..., :, None].expand(
            batch + (bb, n)))
        _, cols = torch.topk(torch.linalg.vector_norm(Rrows, dim=-2), bb)
        core = torch.gather(Rrows, -1, cols[..., None, :].expand(
            batch + (bb, bb)))
        Rcols = torch.gather(R, -1, cols[..., None, :].expand(
            batch + (m, bb)))
        # the core can lose rank once the residual rank drops below b
        Ub = torch.matmul(Rcols, torch.linalg.pinv(core, rtol=1e-10))
        R = R - torch.matmul(Ub, Rrows)
        step_norms.append(torch.linalg.matrix_norm(R))
        U[..., k0:k0 + bb] = Ub
        V[..., k0:k0 + bb, :] = Rrows
    sn = torch.stack(step_norms, dim=-1)                  # [..., nsteps]
    done = sn <= tol * torch.clamp(norms0, min=_tiny(T.dtype))[..., None]
    nused = nsteps - done.sum(dim=-1) + 1
    ranks = torch.clamp(nused * b, max=r)
    mask = torch.arange(r, device=T.device) < ranks[..., None]
    U = torch.where(mask[..., None, :], U, 0)
    V = torch.where(mask[..., :, None], V, 0)
    return U, V, ranks
