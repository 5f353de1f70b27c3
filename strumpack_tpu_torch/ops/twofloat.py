"""Double-float (two-f32) compensated arithmetic for f64-quality residuals.

The counterpart of ``strumpack_tpu/ops/twofloat.py``: the refine dtype
``float32x2`` evaluates the *residual path* of iterative refinement in
double-float arithmetic, each value an unevaluated sum hi + lo of two f32
(~48-bit effective mantissa, unit roundoff ~1e-14), while the factor and
its solves stay f32 (the reference's mixed-precision refinement,
SparseSolverMixedPrecision.cpp:64-130, with the high precision emulated).
The H100 has native f64; the option keeps its name and numerics.

Dekker/Knuth error-free transformations without FMA (the Dekker split
multiplication), in eager PyTorch: each operation is its own kernel, so
no ``a * b - c`` is ever contracted into an FMA, which would break the
transformations.  Never run these through ``torch.compile``.
"""
from __future__ import annotations

import numpy as np
import torch


def two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free a + b = s + e, requires |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split of f32 into high/low 12-bit halves."""
    c = a * 4097.0              # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_from_f64(x):
    """f64 array -> (hi, lo) f32 pair, on the host."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


def df_to_f64(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def df_add(xh, xl, yh, yl):
    """(xh,xl) + (yh,yl), double-float."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_scale_add(xh, xl, a, yh, yl):
    """(x) + a*(y) with f32 scalar a (compensated product)."""
    ph, pe = two_prod(a, yh)
    pe = pe + a * yl
    sh, se = two_sum(xh, ph)
    se = se + (xl + pe)
    return fast_two_sum(sh, se)


def df_spmv_ell(vals, vals_lo, cols, xh, xl):
    """Compensated padded-ELL spmv: y = A x with A and x double-float.

    vals/vals_lo [n, w] f32 (A's values split hi + lo: without the lo
    part the componentwise residual floor is eps_f32 * |A| ~ 1e-8); cols
    [n, w] with n for padding; x pair [n].  The row accumulation keeps a
    running compensation term, ~1e-14 effective."""
    n, w = vals.shape
    z1 = xh.new_zeros(1)
    gxh = torch.cat([xh, z1])[cols]                      # [n, w]
    gxl = torch.cat([xl, z1])[cols]
    sh = xh.new_zeros(n)
    sl = xh.new_zeros(n)
    for j in range(w):
        ph, pe = two_prod(vals[:, j], gxh[:, j])
        pe = pe + vals[:, j] * gxl[:, j] + vals_lo[:, j] * gxh[:, j]
        th, te = two_sum(sh, ph)
        te = te + (sl + pe)
        sh, sl = fast_two_sum(th, te)
    return sh, sl


def df_iterative_refinement(fac, ell, ell_lo, bh, bl, rtol, atol, maxit,
                            x0=None):
    """Double-float iterative refinement (``make_df_ir`` of the JAX
    package): f32 corrections from the factors, compensated residuals.
    bh, bl [n] f32 on the factors' device; ``x0`` an optional (hi, lo)
    starting pair.  Returns (xh, xl, iterations, relative residual of the
    hi part).  The convergence test reads one norm back per iteration."""
    from ..frontal import numeric
    bnorm = torch.linalg.vector_norm(bh)
    tol = float(torch.clamp(np.float32(rtol) * bnorm, min=np.float32(atol)))
    if x0 is None:
        xh, xl = torch.zeros_like(bh), torch.zeros_like(bh)
        rh, rl = bh, bl
    else:
        xh, xl = x0
        ah, al = df_spmv_ell(ell.vals, ell_lo.vals, ell.cols, xh, xl)
        rh, rl = df_add(bh, bl, -ah, -al)
    rn, it = float(torch.linalg.vector_norm(rh)), 0
    one = torch.ones((), dtype=torch.float32, device=bh.device)
    while it < maxit and rn > tol:
        d = numeric.solve(fac, rh).to(torch.float32)
        xh, xl = df_scale_add(xh, xl, one, d, torch.zeros_like(d))
        ah, al = df_spmv_ell(ell.vals, ell_lo.vals, ell.cols, xh, xl)
        rh, rl = df_add(bh, bl, -ah, -al)
        rn = float(torch.linalg.vector_norm(rh))
        it += 1
    rel = np.float32(rn) / max(np.float32(bnorm.item()), np.float32(1e-30))
    return xh, xl, it, float(rel)
