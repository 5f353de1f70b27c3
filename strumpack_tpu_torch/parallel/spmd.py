"""The multifrontal level sweep over a process grid.

The counterpart of ``strumpack_tpu/parallel/spmd.py``: every bucket of the
elimination tree runs in one of the regimes the work model chooses
(``choose_modes``, copied from :78-300 so that it gives the JAX package's
mode map and report for any plan and mesh shape):

* **shard**: the bucket's fronts split into contiguous equal slices over
  the ranks in the mesh's axis-major order (the proportional-mapping
  role, ``EliminationTreeMPIDist.cpp:630-694``).  Each rank assembles,
  extend-adds and factors only its own fronts through the single-device
  bucket functions of ``frontal/numeric.py`` (kernels K1 and K3 or K2 run
  per rank); the level's contribution blocks are then all-gathered, so
  any rank's parent sees them (``ShardedPlan.gather``, :526, the
  alltoallv extend-add role of ``FrontMPI.cpp:60-119``).
* **grid**: few large dense fronts, assembled replicated (``_big_factor``,
  :636-700) and factored over the grid by ``dist2d.cyclic_partial_factor``
  (the default, ``STRUMPACK_TPU_CYCLIC=0`` opts out) or
  ``dist2d.grid_partial_factor`` (whose panels go to kernel K4); the
  factors and CB come back replicated.
* **repl**: the single-device code on every rank.

The two-phase solve follows the same ownership: shard buckets solve their
own fronts and all-gather the solve CBs (forward) and the separator values
(backward); grid and repl buckets solve on every rank.  One factorization
serves every solve (``make_sharded_factor_solve`` returns ``factor_fn`` and
``solve_fn``).

The sweep is eager: the JAX package's split-program mode (:1025-1124)
exists to bound the size of compiled programs and has no counterpart
here.  Buckets in the ``tile``, ``struct`` or ``samp`` modes raise
``NotImplementedError``: they are ported in slice 8 of the port.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from . import dist as D
from ..frontal import numeric
from ..frontal.numeric import BLRCB, BucketDev, CBPair
from ..ops import panel_lu as PP

BIG_P = 128     # min padded front size for intra-front distribution
BIG_NF = 4      # max batch count routed to the intra-front modes

SLICE8 = ("the {} mode of the distributed sweep is ported in slice 8 of "
          "the port (DistBLR/DistHSS, structured_dist)")


# ---------------------------------------------------------------------------
# work model (proportional-mapping role), as strumpack_tpu/parallel/spmd.py
# ---------------------------------------------------------------------------

def bucket_flops(bp) -> float:
    """Analytic dense partial-factorization flops of one bucket (the FLOPS
    work model of EliminationTreeMPIDist.cpp:512-574)."""
    s, u, nf = bp.s_pad, bp.u_pad, bp.nf
    return nf * (2.0 / 3.0 * s ** 3 + 2.0 * s * s * u + 2.0 * s * u * u)


def bucket_bytes(bp, itemsize=4) -> float:
    """FACTOR_MEMORY work model: bytes of factors + CB held per bucket."""
    s, u, nf = bp.s_pad, bp.u_pad, bp.nf
    return nf * (s * s + 2 * s * u + u * u) * itemsize


def _grid_panel_flops(bp) -> float:
    """Replicated portion of a grid-mode bucket: the panel
    factorizations."""
    from .dist2d import _grid_blk
    s, p = bp.s_pad, bp.p
    w = _grid_blk(s)
    fl = 0.0
    for o in range(0, s, w):
        fl += (p - o) * w * w
    return bp.nf * fl


def _tile_diag_flops(bp) -> float:
    """Replicated portion of a tile-mode BLR bucket: the sequential
    diagonal-tile LUs."""
    t = max(bp.tile, 1)
    nts = bp.s_pad // t if t else 0
    return bp.nf * nts * (2.0 / 3.0) * t ** 3


def _struct_repl_flops(bp, ndev) -> float:
    """Replicated portion of a struct-mode HODLR front: the level terms
    whose block-pair count the device count does not divide."""
    from ..structured.hss import _pad_pow2
    t = max(int(bp.hss_leaf), 1)
    mp, L = _pad_pow2(bp.s_pad, t)
    r = max(int(bp.hss_rank), 8)
    q = r + 8
    fl = 0.0
    for lev in range(L):
        half = 2 ** lev
        if half % ndev == 0:
            continue
        ml = mp // (2 * half)
        fl += 2 * half * (4.0 * ml * q * q + 10.0 * q * q * ml)
        fl += half * (2.0 / 3.0) * (2 * r) ** 3
    return bp.nf * fl


def _hodbf_repl_flops(bp, ndev) -> float:
    """Replicated portion of a struct-mode HODBF front: level compressions
    whose block-pair batch does not divide the devices, plus the factor
    chain's dense-cutoff LUs."""
    from ..structured.hss import _pad_pow2
    t = max(int(bp.hss_leaf), 1)
    mp, L = _pad_pow2(bp.s_pad, t)
    r = max(int(bp.hss_rank), 8)
    fl = 0.0
    for lev in range(L - 1, -1, -1):
        half = 2 ** lev
        ml = mp // (2 * half)
        lvl_fl = 2 * half * 8.0 * ml * ml * min(2 * r, ml)
        if not (half % ndev == 0 or ml * ml * half >= (1 << 20)):
            fl += lvl_fl
    cutoff = float(min(getattr(bp, "bf_cutoff", 256), mp))
    chain = max(mp / cutoff, 1.0) * (2.0 / 3.0) * cutoff ** 3 * 4
    if cutoff * cutoff < (1 << 20):
        fl += chain
    else:
        fl += chain / ndev
    return bp.nf * fl


def _samp_repl_flops(bp, ndev) -> float:
    """Replicated portion of a samp-mode sampling-HSS front: the per-level
    interpolative IDs whose node count the devices do not divide."""
    from ..structured.hss import _pad_pow2
    t = max(int(bp.hss_leaf), 1)
    mp, L = _pad_pow2(bp.s_pad, t)
    r = max(int(bp.hss_rank), 8)
    d = r + 16
    fl = 0.0
    for lev in range(L + 1):
        nl = max(mp // (t * 2 ** lev), 1)
        if nl % ndev == 0 and nl >= ndev:
            continue
        fl += nl * 4.0 * t * d * d * 2
    return bp.nf * fl


def mesh_size(mesh) -> int:
    """Device count of a mesh shape (a tuple of ints) or a Grid."""
    if isinstance(mesh, (tuple, list)):
        return int(math.prod(mesh))
    return mesh.ndev


def choose_modes(pdev, mesh):
    """Per-bucket execution mode over a mesh of ``mesh_size(mesh)``
    devices: 'shard', 'grid', 'tile', 'struct', 'samp' or 'repl', and the
    report (replicated-work fraction, modeled per-device load balance),
    as ``strumpack_tpu/parallel/spmd.py:choose_modes``."""
    ndev = mesh_size(mesh)
    modes = {}
    total, repl_fl, max_dev = 0.0, 0.0, 0.0
    for li, lvl in enumerate(pdev.levels):
        for bi, bd in enumerate(lvl):
            bp = bd.bp
            fl = bucket_flops(bp)
            total += fl
            dense = not (bp.blr or bp.hss or bp.hodlr or bp.hodbf
                         or bp.hss_sample)
            if ndev > 1 and bp.nf % ndev == 0:
                modes[(li, bi)] = "shard"
                max_dev += fl / ndev
            elif (ndev > 1 and bp.nf <= BIG_NF and bp.p >= BIG_P
                    and dense and bp.s_pad % 8 == 0):
                modes[(li, bi)] = "grid"
                pan = min(_grid_panel_flops(bp), fl)
                repl_fl += pan
                max_dev += pan + (fl - pan) / ndev
            elif (ndev > 1 and bp.blr and bp.nf <= BIG_NF
                    and bp.p >= BIG_P):
                modes[(li, bi)] = "tile"
                diag = min(_tile_diag_flops(bp), fl)
                repl_fl += diag
                max_dev += diag + (fl - diag) / ndev
            elif (ndev > 1 and bp.hss_sample and bp.nf == 1
                    and bp.s_pad >= 4 * BIG_P):
                modes[(li, bi)] = "samp"
                rp = min(_samp_repl_flops(bp, ndev), fl)
                repl_fl += rp
                max_dev += rp + (fl - rp) / ndev
            elif (ndev > 1 and (bp.hodlr or bp.hodbf or bp.hss)
                    and bp.nf == 1 and bp.s_pad >= 4 * BIG_P):
                modes[(li, bi)] = "struct"
                rp = min(_hodbf_repl_flops(bp, ndev) if bp.hodbf
                         else _struct_repl_flops(bp, ndev), fl)
                repl_fl += rp
                max_dev += rp + (fl - rp) / ndev
            else:
                modes[(li, bi)] = "repl"
                repl_fl += fl
                max_dev += fl
    ideal = total / max(ndev, 1)
    report = {"total_flops": total, "replicated_flops": repl_fl,
              "replicated_frac": repl_fl / max(total, 1.0),
              "ideal_device_flops": ideal,
              "max_device_flops": max_dev,
              "balance": max_dev / max(ideal, 1.0)}
    return modes, report


# ---------------------------------------------------------------------------
# sharded plan
# ---------------------------------------------------------------------------

def _slice_pair(pr, f0, f1):
    """A CBPair's rows of fronts f0..f1 (the child blocks stay indexed in
    the full child bucket: its CBs are all-gathered)."""
    out = object.__new__(CBPair)
    out.bk, out.u = pr.bk, pr.u
    out.idx = pr.idx[f0:f1].contiguous()
    ar = torch.arange(f1 - f0, device=out.idx.device, dtype=torch.int32)
    out.loc = torch.where(out.idx >= 0, ar, -1).to(torch.int32)
    out.posc = pr.posc[f0:f1]
    out.sel = pr.sel[f0:f1]
    return out


def slice_bucket(bd, f0, f1):
    """The BucketDev of fronts f0..f1 of a bucket, run whole (no chunks):
    the assembly entries of those fronts, their rows of the extend-add
    and solve maps, and the pairs whose child blocks they read."""
    bp = bd.bp
    p = bp.p
    sl = slice(f0, f1)
    lb = object.__new__(BucketDev)
    samp = None
    if bp.samp is not None:
        samp = {k: (v[sl] if np.ndim(v) and len(v) == bp.nf else v)
                for k, v in bp.samp.items()}
    lb.bp = dataclasses.replace(
        bp, fronts=bp.fronts[f0:min(f1, len(bp.fronts))], ds=bp.ds[sl],
        du=bp.du[sl], posL=bp.posL[sl], posR=bp.posR[sl],
        hasL=bp.hasL[sl], hasR=bp.hasR[sl], sep_glob=bp.sep_glob[sl],
        upd_glob=bp.upd_glob[sl], samp=samp, chunks=1)
    lb.has_L = bool(bp.hasL[sl].any())
    lb.has_R = bool(bp.hasR[sl].any())
    f = torch.div(bd.asm_lin, p * p, rounding_mode="floor")
    m = (f >= f0) & (f < f1)
    lb.asm_lin = bd.asm_lin[m] - f0 * p * p
    lb.asm_vidx = bd.asm_vidx[m]
    lb.posL, lb.posR = bd.posL[sl], bd.posR[sl]
    lb.sep_glob, lb.upd_glob = bd.sep_glob[sl], bd.upd_glob[sl]
    lb.chunk_asm = []
    if bp.hss_sample:
        lb.ell = tuple(t[sl] for t in bd.ell)
        lb.ellT = tuple(t[sl] for t in bd.ellT)
    lb.pairsL = [_slice_pair(q, f0, f1) for q in bd.pairsL
                 if bool((q.idx[sl] >= 0).any())] if lb.has_L else []
    lb.pairsR = [_slice_pair(q, f0, f1) for q in bd.pairsR
                 if bool((q.idx[sl] >= 0).any())] if lb.has_R else []
    lb._ea_map = (bd.ea_map().slice(f0, f1) if lb.pairsL or lb.pairsR
                  else None)
    return lb


def use_cyclic(bp, grid) -> int:
    """The cyclic tile size of a grid bucket, 0 for the contiguous layout
    (``STRUMPACK_TPU_CYCLIC=0``, or no tile size fits)."""
    from .dist2d import _cyclic_blk
    if os.environ.get("STRUMPACK_TPU_CYCLIC", "1") in ("", "0"):
        return 0
    return _cyclic_blk(bp.p, bp.s_pad, grid.pr, grid.pc)


class ShardedPlan:
    """A PlanDev over a Grid: the modes, and for each shard bucket this
    rank's slice of fronts (``local``), f0..f1 of the bucket's nf."""

    def __init__(self, pdev, grid):
        self.pdev = pdev
        self.grid = grid
        self.ndev = grid.ndev
        self.modes, self.report = choose_modes(pdev, grid)
        for key, mode in self.modes.items():
            if mode in ("tile", "struct", "samp"):
                raise NotImplementedError(
                    f"bucket {key}: " + SLICE8.format(mode))
        self.local = {}
        self.bounds = {}
        for li, lvl in enumerate(pdev.levels):
            for bi, bd in enumerate(lvl):
                if self.modes[(li, bi)] != "shard":
                    continue
                nfl = bd.bp.nf // self.ndev
                f0 = grid.me * nfl
                self.bounds[(li, bi)] = (f0, f0 + nfl)
                self.local[(li, bi)] = slice_bucket(bd, f0, f0 + nfl)
        self.level_bytes = [0] * len(pdev.levels)

    def bucket(self, li, bi):
        """The BucketDev this rank runs for bucket (li, bi)."""
        return self.local.get((li, bi), self.pdev.levels[li][bi])

    def gather(self, x):
        """All-gather the shard slices of a bucket output (a tensor or a
        BLRCB), in the mesh's order."""
        if self.ndev == 1:
            return x
        g = self.grid.group
        if isinstance(x, BLRCB):
            return BLRCB(*(torch.cat(D.all_gather(t, g))
                           for t in x.tensors()), x.u, x.t)
        return torch.cat(D.all_gather(x, g))

    def counts(self):
        """Buckets by mode."""
        out = dict.fromkeys(("shard", "grid", "repl"), 0)
        for m in self.modes.values():
            out[m] += 1
        return out

    def launch_share(self, dtype):
        """K1-K4 launches this rank makes in one factorization in
        ``dtype``, from the plan: the single-device counts
        (``PlanDev.ea_launches``, ``k3_buckets``, ``k2_launches``,
        ``k4_launches``) over its shard slices and the repl buckets, the
        grid buckets' replicated assembly (K1) and, in the contiguous
        layout, their K4 sub-panels."""
        view = object.__new__(numeric.PlanDev)
        view.levels = [[self.bucket(li, bi) for bi in range(len(lvl))
                        if self.modes[(li, bi)] != "grid"]
                       for li, lvl in enumerate(self.pdev.levels)]
        k1 = numeric.PlanDev.ea_launches(view)
        k4 = numeric.PlanDev.k4_launches(view, dtype)
        from .dist2d import _grid_blk, panel_route
        for (li, bi), mode in self.modes.items():
            if mode != "grid":
                continue
            bd = self.pdev.levels[li][bi]
            k1 += bd.ea_map().launches(0, bd.bp.nf, len(bd.pairsL)
                                       + len(bd.pairsR))
            bp = bd.bp
            if use_cyclic(bp, self.grid):
                continue
            w0 = _grid_blk(bp.s_pad)
            for o in range(0, bp.s_pad, w0):
                w = min(w0, bp.s_pad - o)
                if panel_route(bp.p - o, w, dtype) == "k4":
                    k4 += -(-w // PP.PANEL_W)
        return {"extend_add": k1,
                "front_lu_cross": numeric.PlanDev.k3_buckets(view, dtype),
                "small_lu": numeric.PlanDev.k2_launches(view, dtype),
                "panel_lu": k4}


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _grid_factor(sp, bd, F, thresh):
    """Factor an assembled grid bucket over the grid: cyclic tiles where
    ``use_cyclic``, else contiguous blocks."""
    from .dist2d import cyclic_partial_factor, grid_partial_factor
    bp = bd.bp
    blk = use_cyclic(bp, sp.grid)
    if blk:
        return cyclic_partial_factor(F, sp.grid, thresh, bp.s_pad, blk=blk)
    return grid_partial_factor(F, sp.grid, thresh, bp.s_pad)


def factor(sp, Avals, thresh=0.0, tol=1e-4, hss_tol=1e-4):
    """The distributed level sweep, deepest level first, with partial
    pivoting (the JAX package's mesh sweep factors with pivoting and
    without the SPD path).  Returns this rank's factor tree: its slices of
    the shard buckets, the grid and repl buckets whole.
    ``sp.level_bytes[li]`` counts the bytes all-gathered to this rank at
    each level."""
    pdev = sp.pdev
    vals_ext = torch.cat([Avals, torch.tensor([0.0, 1.0], dtype=Avals.dtype,
                                              device=Avals.device)])
    tree = {"lu": {}, "perm": {}, "L21": {}, "U12": {}, "blr": {},
            "blr_ranks": {}, "hss": {}}
    cb_list = []
    for li, lvl in enumerate(pdev.levels):
        b0 = D.all_gather.bytes
        new = []
        for bi, bd in enumerate(lvl):
            key = f"{li},{bi}"
            mode = sp.modes[(li, bi)]
            if mode == "grid":
                with torch.profiler.record_function("front:grid"):
                    F = numeric._assemble(bd, vals_ext, cb_list, bd.asm_lin,
                                          bd.asm_vidx, 0, bd.bp.nf)
                    lu, perm, L21, U12, CB = _grid_factor(sp, bd, F, thresh)
                if bd.bp.lossy:
                    lu, L21, U12 = (numeric._quantize(x, bd.bp.lossy)
                                    for x in (lu, L21, U12))
                numeric._record_factors(tree, key, "lu",
                                        (lu, perm, L21, U12))
            else:
                tag, fac, CB = numeric._bucket_factor_step(
                    sp.bucket(li, bi), vals_ext, cb_list, thresh, tol,
                    True, False, hss_tol, seed=li * 131 + bi)
                numeric._record_factors(tree, key, tag, fac)
                if mode == "shard":
                    CB = sp.gather(CB)
            new.append(CB)
        cb_list = new
        sp.level_bytes[li] += D.all_gather.bytes - b0
    return tree


def solve(sp, tree, b):
    """Two-phase solve of the permuted b [n, nrhs] (replicated) against
    this rank's factor tree; returns x [n, nrhs], replicated."""
    pdev = sp.pdev
    n = pdev.plan.n
    nrhs = b.shape[1]
    bext = torch.cat([b, b.new_zeros((1, nrhs))], dim=0)
    ys = {}
    cbv_list = []
    for li, lvl in enumerate(pdev.levels):
        parts = []
        for bi in range(len(lvl)):
            y, cbv = numeric._bucket_fwd_step(li, bi, sp.bucket(li, bi),
                                              tree, bext, cbv_list)
            ys[f"{li},{bi}"] = y
            if sp.modes[(li, bi)] == "shard":
                cbv = sp.gather(cbv)
            parts.append(cbv)
        cbv_list = parts
    xext = b.new_zeros((n + 1, nrhs))
    for li in range(len(pdev.levels) - 1, -1, -1):
        for bi, bd in enumerate(pdev.levels[li]):
            lb = sp.bucket(li, bi)
            xext = numeric._bucket_bwd_step(li, bi, lb, tree,
                                            ys[f"{li},{bi}"], xext)
            if sp.modes[(li, bi)] == "shard":
                # every rank takes the separator values of all fronts
                mine = xext[lb.sep_glob.reshape(-1)]
                xext[bd.sep_glob.reshape(-1)] = sp.gather(mine)
                xext[n] = 0
    return xext[:n]


def make_sharded_factor_solve(pdev, grid, dtype=torch.float32, thresh=0.0,
                              hss_tol=1e-4, blr_tol=1e-4, sp=None):
    """(Avals, b) -> x over the grid; ``run.factor_fn(Avals)`` factors once
    and returns the tree, ``run.solve_fn(tree, b)`` solves against it
    (b [n] or [n, nrhs], replicated), ``run.sharded_plan`` is the
    ShardedPlan (``spmd.py:847``; ``sp``: one built before)."""
    sp = sp or ShardedPlan(pdev, grid)
    dev = pdev.device

    def factor_fn(Avals):
        numeric.use_full_fp32_matmul()
        Avals = torch.as_tensor(Avals, device=dev).to(dtype)
        return factor(sp, Avals, thresh, blr_tol, hss_tol)

    def solve_fn(tree, b):
        b = torch.as_tensor(b, device=dev).to(dtype)
        squeeze = b.ndim == 1
        x = solve(sp, tree, b[:, None] if squeeze else b)
        return x[:, 0] if squeeze else x

    def run(Avals, b):
        return solve_fn(factor_fn(Avals), b)

    run.sharded_plan = sp
    run.factor_fn = factor_fn
    run.solve_fn = solve_fn
    return run
