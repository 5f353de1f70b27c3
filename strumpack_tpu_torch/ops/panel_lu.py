"""Blocked panel LU of batched fronts and tiles, and ``batched_lu``.

* **K4**, the panel kernel (``panel_lu``), replacing
  ``strumpack_tpu/ops/pallas_panel_lu.py`` (``pallas_panel_lu`` ->
  ``_panel_kernel``): one full-height ``[p, w]`` panel per front, w <= 128,
  logical partial pivoting restricted to rows ``[row0, slim)``.  The CUDA
  kernel is ``csrc/panel_lu.cu`` (rows in registers on one CTA or on a
  cluster of CTAs, or a global-memory design for the tallest panels,
  chosen by ``design``); ``panel_lu_plain`` is its plain version.
* ``blocked_factor_bucket``: the JAX package's blocked LU over K4.
  Between panels it applies the panel's row permutation (one gather), the
  unit-lower triangular solve and the Schur GEMM as library calls.
* ``batched_lu``: full LU of a batch of square blocks, routed by size as
  the JAX package's TPU path routes it: K2 (``front_lu.factor_bucket``) up
  to 64, the blocked LU over K4 up to 8192, the library LU above.  The
  BLR tile LU (``frontal/blr.py``) goes through it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import front_lu as FL

PANEL_W = 128
MAX_PANEL_P = 8192

_FN = {torch.float32: "panel_lu_f32", torch.float64: "panel_lu_f64"}
_SIG = (ctypes.c_int, [ctypes.c_void_p] * 3 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_SIGS = {fn: _SIG for fn in _FN.values()}
K4_THREADS = 256            # threads of one K4 CTA
MAX_CLUSTER = 16            # CTAs of a non-portable Hopper cluster
DESIGNS = ("cta", "cluster", "global")


def design(p, w, itemsize, row0=0):
    """K4's launch choice for a panel [p, w] whose rows >= row0 are
    eliminated: (design, cluster size).  The register design holds one row
    per thread (f32) or per two threads (f64), so a CTA of 256 threads
    holds 256 or 128 rows: "cta" when one CTA holds the p - row0 rows,
    "cluster" of c <= 16 CTAs when c of them do, else "global" (the panel
    eliminated in device memory; cluster size 0)."""
    if not 0 < w <= PANEL_W or itemsize not in (4, 8):
        raise ValueError(f"K4 takes 0 < w <= {PANEL_W} in f32 or f64")
    rows = K4_THREADS // (itemsize // 4)
    c = -(-(p - row0) // rows)
    if c <= 1:
        return "cta", 1
    if c <= MAX_CLUSTER:
        return "cluster", c
    return "global", 0


def panel_lu_plain(panel, thresh, row0, w, slim, pivot=True):
    """Plain PyTorch version of K4: the same elimination of the w columns
    of ``panel`` [nf, p, w], batched over fronts, with the same operation
    order and rounding.  Returns (packed panel in ORIGINAL row order,
    pr [nf, w] = the pivot row of each column)."""
    nf, p, _ = panel.shape
    G = panel.clone()
    dev = panel.device
    rows = torch.arange(p, device=dev)
    upd0 = rows >= row0
    alive = upd0 & (rows < slim)
    free = torch.ones((nf, p), dtype=torch.bool, device=dev)
    pr = torch.empty((nf, w), dtype=torch.int64, device=dev)
    th = torch.tensor(thresh, dtype=panel.dtype, device=dev)
    ar = torch.arange(nf, device=dev)
    for k in range(w):
        col = G[:, :, k].clone()                              # [nf, p]
        if pivot:
            # lowest index among ties: torch.argmax returns the first
            cand = torch.where(alive & free, col.abs(), -1.0)
            r = torch.argmax(cand, dim=1)
        else:
            r = torch.full((nf,), row0 + k, dtype=torch.int64, device=dev)
        piv = FL._replace_tiny(col[ar, r], th)
        ispiv = rows[None, :] == r[:, None]
        upd = upd0 & free
        m = torch.where(upd & ~ispiv, col / piv[:, None], 0.0)
        urow = G[ar, r, k + 1:]
        G[:, :, k + 1:] -= m[:, :, None] * urow[:, None, :]
        G[:, :, k] = torch.where(ispiv, piv[:, None],
                                 torch.where(upd, m, col))
        pr[:, k] = r
        free &= ~ispiv
    return G, pr


def panel_lu(panel, thresh, row0, w, slim, pivot=True):
    """K4: factor one full-height panel [nf, p, w] per front (diagonal
    block at rows row0..row0+w, pivots from rows [row0, slim)).  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (``panel_lu.launches`` counts launches, ``panel_lu.variants`` them by
    design)."""
    if panel.device.type == "cpu":
        return panel_lu_plain(panel, thresh, row0, w, slim, pivot)
    FL._check_kernel_input(panel, "panel_lu")
    nf, p, w2 = panel.shape
    if (w2 != w or not 0 < w <= PANEL_W or p > MAX_PANEL_P or row0 < 0
            or row0 + w > slim or slim > p):
        raise ValueError(f"panel_lu: panel{tuple(panel.shape)}, w={w}, "
                         f"row0={row0}, slim={slim} (the kernel takes "
                         f"w <= {PANEL_W}, p <= {MAX_PANEL_P}, "
                         "row0 + w <= slim <= p)")
    kind, c = design(p, w, panel.element_size(), row0)
    out = torch.empty_like(panel)
    pr = torch.empty((nf, w), dtype=torch.int64, device=panel.device)
    lib = _build.load("panel_lu", _SIGS)
    stream = _build.stream(panel.device)
    err = getattr(lib, _FN[panel.dtype])(
        panel.data_ptr(), out.data_ptr(), pr.data_ptr(), nf, p, w, row0,
        slim, float(thresh), int(bool(pivot)), c, stream)
    _build.check(lib, "panel_lu", err)
    panel_lu.launches += 1
    panel_lu.variants[kind] += 1
    return out, pr


panel_lu.launches = 0
panel_lu.variants = dict.fromkeys(DESIGNS, 0)


def panel_perm(pr, p, row0, w):
    """Applied-form row permutation [nf, p] from per-column pivot rows:
    dest row row0+k takes source pr[:, k]; the remaining not-pivoted rows
    >= row0 follow in ascending source order; rows < row0 are fixed."""
    nf = pr.shape[0]
    dev = pr.device
    i = torch.arange(p, device=dev).expand(nf, p)
    pivmask = torch.zeros((nf, p), dtype=torch.bool, device=dev)
    pivmask.scatter_(1, pr, True)
    nonpiv = ~pivmask & (i >= row0)
    rank = torch.cumsum(nonpiv.to(torch.int64), dim=1) - 1
    dest = torch.where(i < row0, i, row0 + w + rank)
    dest = dest.scatter(1, pr, (row0 + torch.arange(w, device=dev))
                        .expand(nf, w).contiguous())
    return torch.empty_like(dest).scatter_(1, dest, i.contiguous())


def blocked_factor_bucket(F, thresh, s_pad, pivoting=True, panel_w=PANEL_W,
                          panel=None):
    """Blocked partial LU of a bucket of identity-padded fronts over K4
    (``panel``: the panel factorization, ``panel_lu`` by default; a check
    passes ``panel_lu_plain`` to run the same blocked LU over the plain
    version).

    Same contract as numeric._factor_bucket: returns
    (lu [nf,s,s], perm [nf,s], L21 [nf,u,s], U12 [nf,s,u], CB [nf,u,u])."""
    panel = panel_lu if panel is None else panel
    nf, p, _ = F.shape
    s = int(s_pad)
    G = F.clone()
    ptot = torch.arange(p, device=F.device).expand(nf, p)
    jb = 0
    while jb < s:
        w = min(panel_w, s - jb)
        pan, pr = panel(G[:, :, jb:jb + w].contiguous(), thresh, jb, w, s,
                        pivot=pivoting)
        # paste the factored panel (original row order), then apply the
        # panel's permutation to the whole matrix with one row gather
        G[:, :, jb:jb + w] = pan
        if pivoting:
            pj = panel_perm(pr, p, jb, w)
            G = torch.gather(G, 1, pj[:, :, None].expand(nf, p, p))
            ptot = torch.gather(ptot, 1, pj)
        if jb + w < p:
            L11 = G[:, jb:jb + w, jb:jb + w]
            U12 = torch.linalg.solve_triangular(
                L11, G[:, jb:jb + w, jb + w:], upper=False,
                unitriangular=True)
            G[:, jb:jb + w, jb + w:] = U12
            G[:, jb + w:, jb + w:] -= torch.matmul(G[:, jb + w:, jb:jb + w],
                                                   U12)
        jb += w
    return (G[:, :s, :s], ptot[:, :s], G[:, s:, :s], G[:, :s, s:],
            G[:, s:, s:])


def batched_lu(F, thresh=0.0, pivoting=True):
    """Full batched LU with partial pivoting and tiny-pivot replacement:
    [N, m, m] -> (packed L\\\\U, perm).  K2 for m <= 64, the blocked LU
    over K4 for m <= 8192 (real dtypes), the library LU otherwise."""
    N, m, _ = F.shape
    if N > 0 and not F.is_complex():
        if m <= FL.MAX_PALLAS_P:
            return FL.factor_bucket(F.contiguous(), thresh, m, pivot=pivoting)
        if m <= MAX_PANEL_P:
            lu, perm, _, _, _ = blocked_factor_bucket(F, thresh, m,
                                                      pivoting=pivoting)
            return lu, perm
    lu, piv, _ = torch.linalg.lu_factor_ex(F)
    FL.replace_tiny_diagonal(lu, thresh)
    return lu, FL.lapack_pivots_to_perm(lu, piv)
