"""Outer Krylov solvers: iterative refinement, restarted GMRES, BiCGStab.

The counterpart of ``strumpack_tpu/krylov/solvers.py`` (the reference's
``iterative/`` layer, IterativeSolvers.hpp:56-141): callback-based solvers
taking an ``spmv`` and a preconditioner ``prec`` closure on device
tensors, with classical or modified Gram-Schmidt for GMRES (GMRes.cpp:
43-160, restart + Givens rotations) and the iterative refinement of
IterativeRefinement.cpp:48.

Vectors stay on the device; the scalar recurrences run on the host, with
one transfer of the iteration's scalars per iteration.  Each solver
returns (x, iterations, achieved relative residual).
"""
from __future__ import annotations

import numpy as np
import torch


def _reductions(dot):
    """(inner product, 2-norm as a tensor) of the loops below: the local
    ones, or ``dot`` and the norm it gives."""
    if dot is None:
        return torch.vdot, torch.linalg.vector_norm
    return dot, lambda v: torch.sqrt(dot(v, v).real)


def iterative_refinement(spmv, prec, b, x0=None, rtol=1e-6, atol=1e-10,
                         maxit=50, verbose=False, dot=None):
    """x_{k+1} = x_k + M^{-1}(b - A x_k).  IterativeRefinement.cpp:48.
    ``dot`` as in ``gmres``."""
    _, vnorm = _reductions(dot)
    _fnorm = lambda v: float(vnorm(v))
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = _fnorm(b)
    if bnorm == 0.0:
        return x, 0, 0.0
    it, rnorm = 0, np.inf
    for it in range(1, maxit + 1):
        r = b - spmv(x)
        rnorm = _fnorm(r)
        if verbose:
            print(f"# IR it {it-1} res {rnorm:.6e} rel {rnorm/bnorm:.6e}")
        if rnorm <= max(rtol * bnorm, atol):
            return x, it - 1, rnorm / bnorm
        x = x + prec(r)
    r = b - spmv(x)
    return x, it, _fnorm(r) / bnorm


def gmres(spmv, prec, b, x0=None, rtol=1e-6, atol=1e-10, maxit=500,
          restart=30, gram_schmidt="modified", verbose=False, dot=None):
    """Left-preconditioned restarted GMRES with Givens rotations.

    Solves M^{-1} A x = M^{-1} b with the preconditioned residual driving
    the inner Givens recurrence (GMRes.cpp:43-160); the restart-boundary
    convergence gate uses the TRUE residual ||b - A x||, as the JAX
    package does.  Classical ("classical") or modified ("modified")
    Gram-Schmidt.  ``dot``: the inner product of vectors held in
    blocks over ranks (``parallel/krylov_dist.py``), else local."""
    vdot, vnorm = _reductions(dot)
    _fnorm = lambda v: float(vnorm(v))
    if prec is None:
        prec = lambda v: v
    x = torch.zeros_like(b) if x0 is None else x0
    totit = 0
    rho0 = None
    rho = None
    bnorm = _fnorm(b)
    if bnorm == 0.0:
        return x, 0, 0.0
    tol_true = max(rtol * bnorm, atol)
    r_true = b - spmv(x) if x0 is not None else b
    rho_true = _fnorm(r_true)
    hdt = np.complex128 if b.is_complex() else np.float64
    while totit < maxit and rho_true > tol_true:
        r = prec(r_true)
        rho = _fnorm(r)
        if rho0 is None:
            rho0 = rho if rho > 0 else 1.0
            if rho <= atol and rho_true <= tol_true:
                return x, 0, rho_true / bnorm
        V = [r / rho]
        m = restart
        H = np.zeros((m + 1, m), dtype=hdt)
        givens = []
        g = np.zeros(m + 1, dtype=hdt)
        g[0] = rho
        k = -1
        for k in range(m):
            w = prec(spmv(V[k]))
            if gram_schmidt == "classical":
                hs = torch.stack([vdot(V[j], w) for j in range(k + 1)])
                w = w - sum(hs[j] * V[j] for j in range(k + 1))
            else:  # modified
                hs = []
                for j in range(k + 1):
                    h = vdot(V[j], w)
                    hs.append(h)
                    w = w - h * V[j]
                hs = torch.stack(hs)
            # one transfer: the k+1 projections and the new norm
            vals = torch.cat([hs, vnorm(w)[None]
                              .to(hs.dtype)]).cpu().numpy()
            H[:k + 1, k] = vals[:k + 1]
            hnext = float(abs(vals[k + 1]))
            H[k + 1, k] = hnext
            # apply existing Givens rotations to column k
            for j, (c, s) in enumerate(givens):
                t = c * H[j, k] + s * H[j + 1, k]
                H[j + 1, k] = -np.conj(s) * H[j, k] + c * H[j + 1, k]
                H[j, k] = t
            # new rotation annihilating H[k+1, k]
            denom = np.sqrt(abs(H[k, k]) ** 2 + abs(H[k + 1, k]) ** 2)
            if denom == 0.0:
                c, s = 1.0, 0.0
            elif H[k, k] == 0:
                c, s = 0.0, 1.0
            else:
                c = abs(H[k, k]) / denom
                s = (H[k, k] / abs(H[k, k])) * np.conj(H[k + 1, k]) / denom
            givens.append((c, s))
            t = c * g[k] + s * g[k + 1]
            g[k + 1] = -np.conj(s) * g[k] + c * g[k + 1]
            g[k] = t
            H[k, k] = c * H[k, k] + s * H[k + 1, k]
            H[k + 1, k] = 0.0
            totit += 1
            rho = abs(g[k + 1])
            if verbose:
                print(f"# GMRES it {totit} res {rho:.6e} rel {rho/rho0:.6e}")
            if rho <= max(rtol * rho0, atol) or totit >= maxit:
                break
            if hnext == 0.0:
                break  # happy breakdown: exact solution in current space
            V.append(w / hnext)
        # solve the triangular system and update x
        kk = k + 1
        ysol = np.zeros(kk, dtype=hdt)
        for i in range(kk - 1, -1, -1):
            ysol[i] = (g[i] - H[i, i + 1:kk] @ ysol[i + 1:kk]) / H[i, i]
        dx = sum(torch.as_tensor(ysol[i], device=b.device).to(V[0].dtype)
                 * V[i] for i in range(kk))
        x = x + dx
        r_true = b - spmv(x)
        rho_true = _fnorm(r_true)
        if kk == 0 or rho <= atol:
            # preconditioned residual at the inner floor: further cycles
            # cannot improve x -- stop (unconverged runs report
            # totit = maxit so callers flag NO_CONVERGENCE)
            if rho_true > tol_true:
                totit = maxit
            break
    return x, totit, rho_true / bnorm


def bicgstab(spmv, prec, b, x0=None, rtol=1e-6, atol=1e-10, maxit=500,
             verbose=False, dot=None):
    """Preconditioned BiCGStab.  BiCGStab.cpp:41.  ``dot`` as in
    ``gmres``."""
    vdot, vnorm = _reductions(dot)
    _fnorm = lambda v: float(vnorm(v))
    if prec is None:
        prec = lambda v: v
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - spmv(x)
    rt = r
    bnorm = _fnorm(b)
    if bnorm == 0:
        return x, 0, 0.0
    rho_old = alpha = omega = 1.0
    v = p = torch.zeros_like(b)
    it = 0
    rnorm = _fnorm(r)
    for it in range(1, maxit + 1):
        if rnorm <= max(rtol * bnorm, atol):
            return x, it - 1, rnorm / bnorm
        rho = vdot(rt, r).item()
        if rho == 0:
            break
        if it == 1:
            p = r
        else:
            beta = (rho / rho_old) * (alpha / omega)
            p = r + beta * (p - omega * v)
        phat = prec(p)
        v = spmv(phat)
        denom = vdot(rt, v).item()
        if denom == 0:
            break
        alpha = rho / denom
        s = r - alpha * v
        if _fnorm(s) <= atol:
            x = x + alpha * phat
            r = s
            rnorm = _fnorm(r)
            continue
        shat = prec(s)
        t = spmv(shat)
        ts = torch.stack([vdot(t, t), vdot(t, s)]).tolist()
        omega = ts[1] / ts[0] if ts[0] != 0 else 0.0
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_old = rho
        rnorm = _fnorm(r)
        if verbose:
            print(f"# BiCGStab it {it} res {rnorm:.6e} rel {rnorm/bnorm:.6e}")
        if omega == 0:
            break
    return x, it, rnorm / bnorm
