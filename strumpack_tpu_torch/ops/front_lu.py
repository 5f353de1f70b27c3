"""Batched partial LU of identity-padded fronts.

Two routes, chosen by shape alone (``frontal/numeric.py::_factor_bucket``):

* **K3**, the cross-shape kernel (``partial_factor``), replacing
  ``strumpack_tpu/ops/pallas_lu.py`` (``pallas_partial_factor`` ->
  ``_lu_cross_kernel``).  The CUDA kernel is ``csrc/front_lu.cu``; its note
  says what bounds it on an H100 and how its design answers that.
  ``partial_factor_plain`` is its plain version: the CPU path and the
  kernel's reference in the tests and in ``chip_smoke.py``.
* the **library** route (``library_factor``): ``torch.linalg.lu_factor``,
  ``solve_triangular`` and ``matmul``, the counterpart of the XLA path of
  ``strumpack_tpu/frontal/numeric.py:481-496``.

Both return ``(lu [nf,s,s], perm [nf,s], L21 [nf,u,s], U12 [nf,s,u],
CB [nf,u,u])`` with ``perm`` in applied form (``perm[i]`` = source row of
row i, int64) — the ``_factor_bucket`` contract.  The two routes keep the
JAX package's two tiny-pivot rules: K3 replaces a tiny pivot *during* the
elimination, the library route replaces tiny diagonal entries of U *after*
the LU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Routing thresholds, kept identical to strumpack_tpu/ops/pallas_lu.py so
# that the same buckets take the same route in both packages.  They were
# derived for the TPU's VMEM and lanes; re-deriving them for Hopper's
# 227 KB of shared memory is queued.
_LANES = 128
MAX_PALLAS_P = 64           # K2's limit (K2 is not ported yet)
MAX_CROSS_P = 128
MAX_CROSS_WIDE_P = 640
MIN_CROSS_WIDE_NF = 32
_CROSS_VMEM_BUDGET = 80 * 1024 * 1024
SMEM_LIMIT = 232448         # H100 dynamic shared memory per block (227 KB)

_FN = {torch.float32: "lu_cross_f32", torch.float64: "lu_cross_f64"}
_SIG = (ctypes.c_int, [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ctypes.c_void_p])


def _cross_bb(p, s, u, nf):
    """The TPU kernel's fronts-per-block choice; here it only decides the
    route (``use_cross``), exactly as in the JAX package."""
    bb = _LANES if p * s > 2048 else 4 * _LANES
    nfp2 = 32
    while nfp2 < nf:
        nfp2 *= 2
    bb = min(bb, nfp2)
    while bb > 32 and (p * s + s * u) * bb * 64 > _CROSS_VMEM_BUDGET:
        bb //= 2
    if (p * s + s * u) * bb * 64 > _CROSS_VMEM_BUDGET:
        return None
    return bb


def use_cross(s, p, nf):
    """Routing predicate for K3 (``pallas_lu.py:268``): fronts with
    p <= 128, or p <= 640 with nf >= 32 when a full-lane TPU block fits."""
    if not (0 < s < p and s >= 8):
        return False
    if p <= MAX_CROSS_P:
        return True
    bb = _cross_bb(p, s, p - s, nf)
    return (p <= MAX_CROSS_WIDE_P and nf >= MIN_CROSS_WIDE_NF
            and bb is not None and bb >= _LANES)


def smem_bytes(p, s, itemsize):
    """Dynamic shared memory of one K3 block: A [p,s], B [s,u], perm [s]."""
    return itemsize * (p * s + s * (p - s)) + 4 * s


def _schur(F, L21, U12, s):
    """CB = F22 - L21 U12 as one batched GEMM (outside the kernel, as
    ``pallas_lu.py:346-347`` does)."""
    return torch.baddbmm(F[:, s:, s:], L21, U12, alpha=-1)


def partial_factor_plain(F, thresh, s):
    """Plain PyTorch version of K3: the same elimination, column by column,
    batched over fronts, with the same operation order and rounding
    (separate multiply and subtract)."""
    nf, p, _ = F.shape
    A = F[:, :, :s].clone()                                  # [nf, p, s]
    B = F[:, :s, s:].clone()                                 # [nf, s, u]
    P = torch.arange(s, device=F.device).expand(nf, s).clone()
    th = torch.tensor(thresh, dtype=F.dtype, device=F.device)
    ar = torch.arange(nf, device=F.device)
    for k in range(s):
        # lowest index among ties: torch.argmax returns the first maximum
        r = k + torch.argmax(A[:, k:s, k].abs(), dim=1)      # [nf]
        rows = torch.stack([torch.full_like(r, k), r], 1)    # [nf, 2]
        swapped = rows.flip(1)
        A[ar[:, None], rows] = A[ar[:, None], swapped]
        B[ar[:, None], rows] = B[ar[:, None], swapped]
        P[ar[:, None], rows] = P[ar[:, None], swapped]
        piv = A[:, k, k]
        piv = torch.where(piv.abs() < th,
                          torch.where(piv == 0, th, torch.sign(piv) * th),
                          piv)
        A[:, k, k] = piv
        A[:, k + 1:, k] = A[:, k + 1:, k] / piv[:, None]
        m = A[:, k + 1:, k]                                  # [nf, p-k-1]
        A[:, k + 1:, k + 1:] -= m[:, :, None] * A[:, k:k + 1, k + 1:]
        B[:, k + 1:, :] -= m[:, :s - k - 1, None] * B[:, k:k + 1, :]
    L21 = A[:, s:, :].contiguous()
    return A[:, :s, :].contiguous(), P, L21, B, _schur(F, L21, B, s)


def partial_factor(F, thresh, s):
    """K3: partial LU of the fronts F [nf, p, p] over their s leading
    columns.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (``partial_factor.launches`` counts launches)."""
    if F.device.type == "cpu":
        return partial_factor_plain(F, thresh, s)
    if F.device.type != "cuda":
        raise NotImplementedError(f"partial_factor on {F.device.type}")
    if F.dtype not in _FN:
        raise NotImplementedError(f"front LU kernel: dtype {F.dtype}")
    nf, p, p2 = F.shape
    if p != p2 or not 0 < s < p or not F.is_contiguous():
        raise ValueError(f"partial_factor: F{tuple(F.shape)}, s={s}")
    smem = smem_bytes(p, s, F.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"partial_factor: front p={p}, s={s} needs {smem} "
                         f"bytes of shared memory (> {SMEM_LIMIT})")
    u = p - s
    lu = torch.empty((nf, s, s), dtype=F.dtype, device=F.device)
    L21 = torch.empty((nf, u, s), dtype=F.dtype, device=F.device)
    U12 = torch.empty((nf, s, u), dtype=F.dtype, device=F.device)
    perm = torch.empty((nf, s), dtype=torch.int64, device=F.device)
    lib = _build.load("front_lu", {fn: _SIG for fn in _FN.values()})
    stream = torch.cuda.current_stream(F.device).cuda_stream
    err = getattr(lib, _FN[F.dtype])(
        F.data_ptr(), lu.data_ptr(), L21.data_ptr(), U12.data_ptr(),
        perm.data_ptr(), nf, p, s, float(thresh), stream)
    _build.check(lib, "front_lu", err)
    partial_factor.launches += 1
    return lu, perm, L21, U12, _schur(F, L21, U12, s)


partial_factor.launches = 0


def lapack_pivots_to_perm(lu, piv):
    """LAPACK pivots of ``torch.linalg.lu_factor`` (1-based sequential row
    swaps, [nf, s]) -> applied permutation (``perm[i]`` = source row of
    row i), the form ``jax.lax.linalg.lu`` returns."""
    P, _, _ = torch.lu_unpack(lu, piv, unpack_data=False)
    # A = P L U, so row i of P^T A = L U is row perm[i] of A
    return P.argmax(dim=-2)


def library_factor(F, thresh, s):
    """Library route: LU of F11 with partial pivoting, tiny diagonal
    entries of U replaced afterwards (``numeric.py:483-489``), then two
    triangular solves and the Schur GEMM."""
    # lu_factor_ex: a singular F11 is not an error (its zero pivots are
    # replaced below), and no host sync to check for one
    lu, piv, _ = torch.linalg.lu_factor_ex(F[:, :s, :s])
    perm = lapack_pivots_to_perm(lu, piv)
    d = torch.diagonal(lu, dim1=-2, dim2=-1)
    th = torch.tensor(thresh, dtype=d.real.dtype, device=F.device)
    sgn = torch.sign(d.real).to(d.dtype)
    d.copy_(torch.where(d.abs() < th,
                        torch.where(d == 0, th.to(d.dtype), sgn * th), d))
    F12 = torch.gather(F[:, :s, s:], 1,
                       perm[:, :, None].expand(-1, -1, F.shape[2] - s))
    U12 = torch.linalg.solve_triangular(lu, F12, upper=False, left=True,
                                        unitriangular=True)
    L21 = torch.linalg.solve_triangular(lu, F[:, s:, :s], upper=True,
                                        left=False)
    return lu, perm, L21, U12, _schur(F, L21, U12, s)
