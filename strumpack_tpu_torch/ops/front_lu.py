"""Batched partial LU of identity-padded fronts.

Three routes, chosen by shape alone (``frontal/numeric.py::_factor_bucket``):

* **K2**, the small-front kernel (``factor_bucket``), replacing
  ``strumpack_tpu/ops/pallas_lu.py`` (``pallas_factor_bucket`` ->
  ``_lu_kernel``) for fronts with p <= 64: the whole front, CB included,
  eliminated in one pass with logical partial pivoting.  The CUDA kernel
  is ``csrc/small_lu.cu``; ``factor_bucket_plain`` is its plain version.
  ``batched_lu`` (``ops/panel_lu.py``) also sends BLR tiles up to 64 here.
* **K3**, the cross-shape kernel (``partial_factor``), replacing
  ``strumpack_tpu/ops/pallas_lu.py`` (``pallas_partial_factor`` ->
  ``_lu_cross_kernel``) for the fronts ``use_cross`` names.  The CUDA
  kernel is ``csrc/front_lu.cu``.  It is bound by bytes (A = [F11; F21]
  and B = F12 in, lu, L21, U12 out, about s / 8 flops a byte) but a front
  waits on s dependent steps and the SM on their instructions, so the
  kernel holds one row of A a thread in registers with the step index a
  compile-time constant (one barrier a step, no per-element column
  test), moves B after the elimination as one forward substitution a
  column, and packs small fronts several to a CTA (``k3_layout``).  The
  Schur GEMM CB = F22 - L21 U12 stays one batched GEMM outside.  What it
  holds routes the fronts (``use_cross``) without a GPU, so this module
  keeps a copy of the kernel's capacity, which ``k3_capacity_drift``
  holds against the kernel's own.
  ``partial_factor_plain`` is its plain version: the CPU path and the
  kernel's reference in the tests and in ``chip_smoke.py``.
* the **library** route (``library_factor``): ``torch.linalg.lu_factor``,
  ``solve_triangular`` and ``matmul``, the counterpart of the XLA path of
  ``strumpack_tpu/frontal/numeric.py:481-496``.

K3 and the library route return ``(lu [nf,s,s], perm [nf,s], L21
[nf,u,s], U12 [nf,s,u], CB [nf,u,u])`` with ``perm`` in applied form
(``perm[i]`` = source row of row i, int64) — the ``_factor_bucket``
contract; K2 returns the same pieces packed in one ``[nf,p,p]`` tensor
(``unpack_factors``).  The routes keep the JAX package's two tiny-pivot
rules: K2 and K3 replace a tiny pivot *during* the elimination, the
library route replaces tiny diagonal entries of U *after* the LU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_PALLAS_P = 64           # K2's limit
SMEM_LIMIT = 232448         # H100 dynamic shared memory per block (227 KB)

_FN = {torch.float32: "lu_cross_f32", torch.float64: "lu_cross_f64"}
_SIG = (ctypes.c_int, [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_FN2 = {torch.float32: "small_lu_f32", torch.float64: "small_lu_f64"}
_SIG2 = (ctypes.c_int, [ctypes.c_void_p] * 3 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_SIGS = {fn: _SIG for fn in _FN.values()}
_SIGS["lu_cross_capacity"] = (ctypes.c_int, [ctypes.c_int] * 4
                              + [ctypes.c_void_p])
_SIGS2 = {fn: _SIG2 for fn in _FN2.values()}
K2_THREADS = 256            # threads of one K2 CTA, at most
H100_SMS = 132


def _replace_tiny(piv, th):
    """The tiny-pivot rule of both kernels: |piv| < thresh -> thresh
    (piv == 0) or sign(piv) * thresh (SparseSolverBase.cpp:346-350)."""
    return torch.where(piv.abs() < th,
                       torch.where(piv == 0, th, torch.sign(piv) * th), piv)


def _check_kernel_input(F, what):
    if F.device.type != "cuda":
        raise NotImplementedError(f"{what} on {F.device.type}")
    if F.dtype not in _FN:
        raise NotImplementedError(f"{what} kernel: dtype {F.dtype}")
    if not F.is_contiguous():
        raise ValueError(f"{what}: F must be contiguous")


# ---------------------------------------------------------------------------
# K2: small-front LU
# ---------------------------------------------------------------------------

def factor_bucket_plain(F, thresh, s_pad, pivot=True):
    """Plain PyTorch version of K2: the same elimination of the whole
    front, column by column, batched over fronts.  Pivot rows are marked
    (logical pivoting), never moved; one row gather triangularizes at the
    end.  Every row is updated with its multiplier (0 for rows already
    pivoted), as a separately rounded multiply and subtract."""
    nf, p, _ = F.shape
    G = F.clone()
    dev = F.device
    rows = torch.arange(p, device=dev)
    alive = rows < s_pad
    free = torch.ones((nf, p), dtype=torch.bool, device=dev)
    pr = torch.empty((nf, s_pad), dtype=torch.int64, device=dev)
    th = torch.tensor(thresh, dtype=F.dtype, device=dev)
    ar = torch.arange(nf, device=dev)
    for k in range(s_pad):
        colk = G[:, :, k].clone()                            # [nf, p]
        if pivot:
            # lowest index among ties: torch.argmax returns the first
            cand = torch.where(alive & free, colk.abs(), -1.0)
            r = torch.argmax(cand, dim=1)                     # [nf]
        else:
            r = torch.full((nf,), k, dtype=torch.int64, device=dev)
        piv = _replace_tiny(colk[ar, r], th)
        ispiv = rows[None, :] == r[:, None]                   # [nf, p]
        m = torch.where(free & ~ispiv, colk / piv[:, None], 0.0)
        urow = G[ar, r, k + 1:]                              # [nf, p-k-1]
        G[:, :, k + 1:] -= m[:, :, None] * urow[:, None, :]
        G[:, :, k] = torch.where(ispiv, piv[:, None],
                                 torch.where(free, m, colk))
        pr[:, k] = r
        free &= ~ispiv
    tail = torch.arange(s_pad, p, device=dev).expand(nf, p - s_pad)
    pj = torch.cat([pr, tail], dim=1)
    return torch.gather(G, 1, pj[:, :, None].expand(nf, p, p)), pr


def k2_layout(p, nf, sms=H100_SMS):
    """K2's launch choice for nf fronts of p <= 64 rows: (width bucket,
    fronts per CTA).  One thread per row holds the row in registers: a
    front of p <= 32 is one warp, of 32 < p <= 64 two warps.  A CTA packs
    up to 8 or 4 fronts (256 threads), but only as many as it takes to
    give each of the card's ``sms`` SMs a CTA: fronts that share a CTA
    share its SM's issue slots."""
    if not 0 < p <= MAX_PALLAS_P:
        raise ValueError(f"K2 takes 0 < p <= {MAX_PALLAS_P}, not {p}")
    wb = 32 if p <= 32 else 64
    return wb, max(1, min(K2_THREADS // wb, -(-nf // sms)))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def factor_bucket(F, thresh, s_pad, pivot=True):
    """K2: batched elimination of the ``s_pad`` leading columns of the
    fronts F [nf, p, p], p <= 64, CB included.  Returns (packed [nf,p,p],
    perm [nf,s_pad]): packed[:s,:s] = L\\U of P F11, [:s,s:] = U12,
    [s:,:s] = L21, [s:,s:] = CB (``unpack_factors``).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (``factor_bucket.launches``
    counts launches, ``factor_bucket.modes`` them by pivot mode)."""
    if F.device.type == "cpu":
        return factor_bucket_plain(F, thresh, s_pad, pivot)
    _check_kernel_input(F, "factor_bucket")
    nf, p, p2 = F.shape
    if p != p2 or not 0 < s_pad <= p or p > MAX_PALLAS_P:
        raise ValueError(f"factor_bucket: F{tuple(F.shape)}, s={s_pad} "
                         f"(the kernel takes 0 < s <= p <= {MAX_PALLAS_P})")
    wb, fpc = k2_layout(p, nf, _sm_count(F.device.index))
    packed = torch.empty_like(F)
    perm = torch.empty((nf, s_pad), dtype=torch.int64, device=F.device)
    lib = _build.load("small_lu", _SIGS2)
    stream = _build.stream(F.device)
    err = getattr(lib, _FN2[F.dtype])(
        F.data_ptr(), packed.data_ptr(), perm.data_ptr(), nf, p, s_pad,
        float(thresh), int(bool(pivot)), wb, fpc, stream)
    _build.check(lib, "small_lu", err)
    factor_bucket.launches += 1
    factor_bucket.modes["pivot" if pivot else "nopivot"] += 1
    return packed, perm


factor_bucket.launches = 0
factor_bucket.modes = {"pivot": 0, "nopivot": 0}


def unpack_factors(packed, s_pad):
    """Split a packed K2 output into (lu, L21, U12, CB)."""
    s = s_pad
    return (packed[:, :s, :s], packed[:, s:, :s], packed[:, :s, s:],
            packed[:, s:, s:])


def nopivot_factor_bucket(F, thresh, s_pad):
    """Elimination without pivoting in plain PyTorch, any device and
    dtype (the counterpart of ``nopivot_factor_bucket_xla``): the route of
    fronts too wide for K2 when pivoting is off.  Same packed output as
    K2."""
    G = F.clone()
    th = torch.as_tensor(thresh, dtype=F.real.dtype if F.is_complex()
                         else F.dtype, device=F.device)
    for k in range(s_pad):
        piv = G[:, k, k].clone()
        apiv = piv.abs()
        sgn = torch.where(piv == 0, torch.ones_like(piv),
                          piv / torch.where(apiv == 0, 1, apiv))
        piv = torch.where(apiv < th, sgn * th, piv)
        G[:, k + 1:, k] /= piv[:, None]
        G[:, k + 1:, k + 1:] -= G[:, k + 1:, k, None] * G[:, k, None, k + 1:]
        G[:, k, k] = piv
    return G


# ---------------------------------------------------------------------------
# K3: cross-shape partial LU
# ---------------------------------------------------------------------------


K3_WIDTHS = (8, 16, 24, 32, 48, 64)  # K3's width buckets: the s a row holds
K3_CTA_THREADS = 256            # threads of a CTA that packs several fronts
K3_MAX_FPC = 8                  # fronts per CTA, at most (barrier ids)


def _align16(x):
    return (x + 15) // 16 * 16


# Threads of one K3 CTA, at most, by value size and width bucket: its
# __launch_bounds__ (csrc/front_lu.cu Cfg::MAXT, k3_capacity_drift holds
# the two equal), which leave each thread the registers its row needs
# without spilling
K3_MAX_THREADS = {4: {8: 1024, 16: 1024, 24: 512, 32: 512, 48: 512, 64: 384},
                  8: {8: 768, 16: 512, 24: 512, 32: 384, 48: 256, 64: 256}}


def k3_smem(nw, s, wb, itemsize):
    """Dynamic shared memory of one K3 front (``csrc/front_lu.cu``
    ``layout``): each warp's staging tile, the L11 tile, the pivot row by
    step parity, the per-warp pivot candidates and the permutation."""
    ch = wb
    while ch * itemsize > 128:
        ch //= 2
    nwt = (wb + 31) // 32
    return (_align16(nw * 32 * (ch + 1) * itemsize)
            + _align16(s * (wb + 16 // itemsize) * itemsize)
            + _align16(2 * wb * itemsize)
            + _align16(2 * nwt * (4 if itemsize == 4 else 8))
            + _align16(2 * nwt * 4) + _align16(wb * 4))


def _k3_refusal(p, s, itemsize):
    """Why K3 cannot hold a front [p, p] eliminating s columns of
    ``itemsize``-byte values, or None when it can."""
    if not 0 < s < p:
        return f"K3 takes 0 < s < p, not s={s}, p={p}"
    wb = next((w for w in K3_WIDTHS if w >= s), None)
    if wb is None:
        return f"K3 takes s <= {K3_WIDTHS[-1]}, not {s}"
    nw = -(-p // 32)
    maxt = K3_MAX_THREADS[itemsize][wb]
    if 32 * nw > maxt:
        return (f"K3: a front of p={p} rows needs {32 * nw} threads "
                f"(> {maxt} at s={s}, {itemsize}-byte values)")
    smem = k3_smem(nw, s, wb, itemsize)
    if smem > SMEM_LIMIT:
        return (f"K3: a front p={p}, s={s} needs {smem} bytes of shared "
                f"memory (> {SMEM_LIMIT})")
    return None


def k3_layout(p, s, nf, itemsize, sms=H100_SMS):
    """K3's launch choice for nf fronts [p, p] eliminating s columns:
    (width bucket, warps per front, fronts per CTA).  One thread per row
    of [F11; F21] holds its s values in registers (a width bucket >= s);
    a front is ceil(p / 32) warps.  A CTA packs up to 256 threads of
    fronts, but only as many as it takes to give each of the card's
    ``sms`` SMs a CTA.  Raises ValueError on a front the kernel cannot
    hold (s > 64, more rows than a CTA's registers hold at that width,
    or shared memory)."""
    why = _k3_refusal(p, s, itemsize)
    if why:
        raise ValueError(why)
    wb = next(w for w in K3_WIDTHS if w >= s)
    nw = -(-p // 32)
    fpc = min(K3_CTA_THREADS // (32 * nw), K3_MAX_FPC, -(-nf // sms),
              SMEM_LIMIT // k3_smem(nw, s, wb, itemsize))
    return wb, nw, max(1, fpc)


def k3_capacity_drift():
    """Where this module's copy of K3's capacity (``K3_MAX_THREADS``,
    ``k3_smem``, ``SMEM_LIMIT``, ``K3_MAX_FPC``, which route fronts without
    a GPU) differs from the kernel's own (``csrc/front_lu.cu``
    ``lu_cross_capacity``), at every width bucket, value size, front
    height and s: a list of the differences, empty when the two agree.
    Builds the kernel library."""
    lib = _build.load("front_lu", _SIGS)
    out = (ctypes.c_int64 * 4)()
    drift = []
    for itemsize, caps in K3_MAX_THREADS.items():
        lo = 0
        for wb in K3_WIDTHS:
            for nw in range(1, caps[wb] // 32 + 1):
                for s in range(lo + 1, wb + 1):
                    _build.check(lib, "front_lu", lib.lu_cross_capacity(
                        itemsize, wb, nw, s, out))
                    want = (caps[wb], k3_smem(nw, s, wb, itemsize),
                            SMEM_LIMIT, K3_MAX_FPC)
                    if tuple(out) != want:
                        drift.append(f"{itemsize}-byte values, wb={wb}, "
                                     f"nw={nw}, s={s}: kernel {tuple(out)},"
                                     f" wrapper {want}")
            lo = wb
    return drift


def kernel_dtype(dtype) -> bool:
    """Whether K2 and K3 have an instantiation for ``dtype``: float32 and
    float64.  Complex fronts take the library route, as the JAX package's
    do (its kernels are f32 only, ``strumpack_tpu/ops/pallas_lu.py:47``)."""
    return dtype in _FN


def k2_holds(p, dtype) -> bool:
    """Whether K2 takes a dense front of width p in ``dtype``."""
    return p <= MAX_PALLAS_P and kernel_dtype(dtype)


def use_cross(s, p, dtype):
    """Routing predicate for K3, derived on the H100 (PERF.md, the routing
    table): K3 takes every front [p, p] with s eliminated columns that it
    can hold (``k3_layout``: s <= 64, and no more rows than
    ``K3_MAX_THREADS`` gives its width and dtype), except the fronts of
    p <= 64 with s < 8, which stay with K2 as in the JAX package.  On the
    card K3 beat the library route at every such shape of exact32,
    exact64, f64_32 and blr50, at every batch size from 1 to 8192, so the
    batch size does not enter.  Beyond the JAX package's cross fronts (p <= 128, or p <= 640
    with 32 fronts or more and a TPU block in VMEM) it takes the fronts
    of p > 128 that K3 holds at any batch size, and s < 8 at p > 64; of
    the JAX package's it leaves out s > 64, which K3 does not hold.
    Complex fronts never take K3."""
    if not kernel_dtype(dtype):
        return False
    if p <= MAX_PALLAS_P and s < 8:
        return False
    return _k3_refusal(p, s, torch.finfo(dtype).bits // 8) is None


def _schur(F, L21, U12, s):
    """CB = F22 - L21 U12 as one batched GEMM (outside the kernel, as
    ``pallas_lu.py:346-347`` does)."""
    return torch.baddbmm(F[:, s:, s:], L21, U12, alpha=-1)


def partial_factor_plain(F, thresh, s, pivot=True):
    """Plain PyTorch version of K3: the same elimination, column by column,
    batched over fronts, with the same operation order and rounding
    (separate multiply and subtract).  ``pivot=False`` eliminates on the
    diagonal."""
    nf, p, _ = F.shape
    A = F[:, :, :s].clone()                                  # [nf, p, s]
    B = F[:, :s, s:].clone()                                 # [nf, s, u]
    P = torch.arange(s, device=F.device).expand(nf, s).clone()
    th = torch.tensor(thresh, dtype=F.dtype, device=F.device)
    ar = torch.arange(nf, device=F.device)
    for k in range(s):
        if pivot:
            # lowest index among ties: torch.argmax returns the first
            r = k + torch.argmax(A[:, k:s, k].abs(), dim=1)  # [nf]
            rows = torch.stack([torch.full_like(r, k), r], 1)  # [nf, 2]
            swapped = rows.flip(1)
            A[ar[:, None], rows] = A[ar[:, None], swapped]
            B[ar[:, None], rows] = B[ar[:, None], swapped]
            P[ar[:, None], rows] = P[ar[:, None], swapped]
        piv = _replace_tiny(A[:, k, k], th)
        A[:, k, k] = piv
        A[:, k + 1:, k] = A[:, k + 1:, k] / piv[:, None]
        m = A[:, k + 1:, k]                                  # [nf, p-k-1]
        A[:, k + 1:, k + 1:] -= m[:, :, None] * A[:, k:k + 1, k + 1:]
        B[:, k + 1:, :] -= m[:, :s - k - 1, None] * B[:, k:k + 1, :]
    L21 = A[:, s:, :].contiguous()
    return A[:, :s, :].contiguous(), P, L21, B, _schur(F, L21, B, s)


@functools.lru_cache(maxsize=None)
def _k3_launch(nf, p, s, dtype, index):
    """What a K3 launch on nf fronts [p, p] of ``dtype`` on CUDA device
    ``index`` needs of its shape, worked out once per bucket shape (the
    wrapper's host time is the launch's cost at small nf): the library,
    its launcher, ``k3_layout``'s choice, and the size of the one
    allocation and the (size, stride, offset) of lu, L21 and U12 in it."""
    layout = k3_layout(p, s, nf, torch.finfo(dtype).bits // 8,
                       _sm_count(index))
    lib = _build.load("front_lu", _SIGS)
    u = p - s
    views = (((nf, s, s), (s * s, s, 1), 0),
             ((nf, u, s), (u * s, s, 1), nf * s * s),
             ((nf, s, u), (s * u, u, 1), nf * (s * s + u * s)))
    return lib, getattr(lib, _FN[dtype]), layout, nf * (s * s + 2 * u * s), \
        views


def partial_factor(F, thresh, s, pivot=True):
    """K3: partial LU of the fronts F [nf, p, p] over their s leading
    columns.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (``partial_factor.launches`` counts launches,
    ``partial_factor.modes`` them by pivot mode)."""
    if F.device.type == "cpu":
        return partial_factor_plain(F, thresh, s, pivot)
    _check_kernel_input(F, "partial_factor")
    nf, p, p2 = F.shape
    if p != p2 or not 0 < s < p:
        raise ValueError(f"partial_factor: F{tuple(F.shape)}, s={s}")
    lib, fn, (wb, nw, fpc), n, views = _k3_launch(nf, p, s, F.dtype,
                                                  F.device.index)
    # lu, L21 and U12 are views of one allocation (fewer calls a launch)
    out = torch.empty(n, dtype=F.dtype, device=F.device)
    lu, L21, U12 = (out.as_strided(*v) for v in views)
    perm = torch.empty((nf, s), dtype=torch.int64, device=F.device)
    err = fn(F.data_ptr(), lu.data_ptr(), L21.data_ptr(), U12.data_ptr(),
             perm.data_ptr(), nf, p, s, float(thresh), int(bool(pivot)), wb,
             nw, fpc, _build.stream(F.device))
    _build.check(lib, "front_lu", err)
    partial_factor.launches += 1
    partial_factor.modes["pivot" if pivot else "nopivot"] += 1
    return lu, perm, L21, U12, _schur(F, L21, U12, s)


partial_factor.launches = 0
partial_factor.modes = {"pivot": 0, "nopivot": 0}


def lapack_pivots_to_perm(lu, piv):
    """LAPACK pivots of ``torch.linalg.lu_factor`` (1-based sequential row
    swaps, [nf, s]) -> applied permutation (``perm[i]`` = source row of
    row i), the form ``jax.lax.linalg.lu`` returns."""
    P, _, _ = torch.lu_unpack(lu, piv, unpack_data=False)
    # A = P L U, so row i of P^T A = L U is row perm[i] of A
    return P.real.argmax(dim=-2)


def replace_tiny_diagonal(lu, thresh):
    """The library route's tiny-pivot rule, in place: diagonal entries of
    U below ``thresh`` become thresh (zero) or sign * thresh, after the
    LU (``strumpack_tpu/frontal/numeric.py:483-489``)."""
    d = torch.diagonal(lu, dim1=-2, dim2=-1)
    th = torch.tensor(thresh, dtype=d.real.dtype, device=lu.device)
    sgn = torch.sign(d.real).to(d.dtype)
    d.copy_(torch.where(d.abs() < th,
                        torch.where(d == 0, th.to(d.dtype), sgn * th), d))


def library_factor(F, thresh, s):
    """Library route: LU of F11 with partial pivoting, tiny diagonal
    entries of U replaced afterwards (``numeric.py:483-489``), then two
    triangular solves and the Schur GEMM."""
    # lu_factor_ex: a singular F11 is not an error (its zero pivots are
    # replaced below), and no host sync to check for one
    lu, piv, _ = torch.linalg.lu_factor_ex(F[:, :s, :s])
    perm = lapack_pivots_to_perm(lu, piv)
    replace_tiny_diagonal(lu, thresh)
    F12 = torch.gather(F[:, :s, s:], 1,
                       perm[:, :, None].expand(-1, -1, F.shape[2] - s))
    U12 = torch.linalg.solve_triangular(lu, F12, upper=False, left=True,
                                        unitriangular=True)
    L21 = torch.linalg.solve_triangular(lu, F[:, s:, :s], upper=True,
                                        left=False)
    return lu, perm, L21, U12, _schur(F, L21, U12, s)
