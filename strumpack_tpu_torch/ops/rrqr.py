"""Batched rank-revealing QR with tolerance early-stop (geqp3tol role).

The counterpart of ``strumpack_tpu/ops/rrqr.py``: the RRQR core of BLR
tile compression (BLROptions LowRankAlgorithm::RRQR, the reference
default; the reference's ``xgeqp3tol``).  Each step picks the residual
column of largest norm (the first one among equal norms, geqp3's rule),
normalises it and deflates the residual by one rank-1 update.  Ranks are
the geqp3tol stopping rule with the JAX package's running-product mask;
U/V columns beyond a tile's rank are zero.

Plain PyTorch (the JAX version is not a Pallas kernel either).  The step
loop stops early once every tile of the batch has passed its rank: the
later steps would only fill columns the mask zeroes, so the result is the
same as running all ``r`` steps.
"""
from __future__ import annotations

import torch

# steps between the host checks of the early stop (one sync each)
_CHECK_EVERY = 8


@torch.profiler.record_function("rrqr")
def rrqr(T, tol, r):
    """Batched truncated column-pivoted QR of tiles T [..., m, n].

    Returns ``(U [..., m, r], V [..., r, n], ranks [...])`` with
    ``T ~= U @ V``: U holds the orthonormal Q columns, V the rows of
    ``R P^T``.  The rank counts the leading pivots whose column norm
    (= |R[k,k]|) exceeds ``tol`` times the first pivot's."""
    m, n = T.shape[-2], T.shape[-1]
    batch = T.shape[:-2]
    dt = T.dtype
    rdt = T.real.dtype if T.is_complex() else dt
    R = T.reshape(-1, m, n).clone()
    N = R.shape[0]
    tiny = torch.finfo(rdt).tiny
    qs, vs, pvs = [], [], []
    for k in range(r):
        cn = torch.linalg.vector_norm(R, dim=-2)                   # [N, n]
        # torch.max returns the first index among equal maxima
        nrm, j = torch.max(cn, dim=-1)                             # [N]
        q = torch.gather(R, 2, j[:, None, None].expand(N, m, 1))   # [N, m, 1]
        q = q / nrm.masked_fill(nrm == 0, 1.0).to(dt)[:, None, None]
        # v = q^H R picks up v[j] = nrm, so U V reconstructs the pivot
        # column exactly; the rank-1 deflation zeroes it in the residual
        v = torch.bmm(q.conj().transpose(1, 2), R)                 # [N, 1, n]
        R.baddbmm_(q, v, alpha=-1)
        qs.append(q)
        vs.append(v)
        pvs.append(nrm)
        if (k + 1) % _CHECK_EVERY == 0 and k + 1 < r:
            pv = torch.stack(pvs, dim=1)
            keep = pv > tol * torch.clamp(pv[:, :1], min=tiny)
            if not bool(keep.all(dim=1).any()):
                break
    done = len(pvs)
    U = torch.zeros((N, m, r), dtype=dt, device=T.device)
    V = torch.zeros((N, r, n), dtype=dt, device=T.device)
    pv = torch.zeros((N, r), dtype=rdt, device=T.device)
    if done:
        U[:, :, :done] = torch.cat(qs, dim=2)
        V[:, :done] = torch.cat(vs, dim=1)
        pv[:, :done] = torch.stack(pvs, dim=1)
    keep = pv > tol * torch.clamp(pv[:, :1], min=tiny)
    ranks = torch.cumprod(keep.to(torch.int64), dim=-1).sum(dim=-1)
    mask = torch.arange(r, device=T.device)[None] < ranks[:, None]
    U = torch.where(mask[:, None, :], U, 0)
    V = torch.where(mask[:, :, None], V, 0)
    return (U.reshape(batch + (m, r)), V.reshape(batch + (r, n)),
            ranks.reshape(batch))
