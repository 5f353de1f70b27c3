#!/usr/bin/env python3
"""Smoke run of strumpack_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: CUDA present; card name and power limit, torch/CUDA versions;
2. build: the four CUDA kernels compiled from csrc/ with nvcc for sm_90a,
   one nvcc per source, all started together; K2's, K3's and K4's ptxas
   report checked for spills; K3's capacity as its wrapper states it (the
   routing's) held against the kernel's own;
3. each kernel against its plain PyTorch version on the card, at shapes of
   the main paths: K1 (extend-add, one launch a bucket chunk) bit-equal to
   its pair-by-pair plain version at every call one factorization of
   exact64 makes, and at exact64's three pairs earlier designs timed, each
   as a table of one, with one index_add_ as its yardstick; then at every
   call of the general-input phases' plans (8-12), in their factor dtype;
   K3 (cross-shape front LU) bit-exact
   at every shape exact64, exact32, blr50 (f32) and f64_32 (f64) launch,
   each timed as the kernel alone (profiler device time), the wrapper's
   host time, the wrapper with the Schur GEMM and the library route (the
   routing table); K2 (small-front LU) and K4 (panel LU) bit-exact
   at every shape one blr50 factorization launches and at the shapes of
   the other designs (K4 on one CTA, on clusters of 2, 8 and 16 CTAs, in
   global memory), and the blocked LU over K4; kernel, plain and library
   times by CUDA events (median of 15 after 3 warm-ups);
   then K3 and K2 at every shape of the general-input phases (8-12) not
   checked before, bit-exact: without pivoting at spd64's and
   aniso24_nopivot's, with pivoting at nd64's, metis64's, mc64's and the
   orderings' (events only, fewer repetitions); then K1 at every call of
   the rank-structured phases (13-14), on BLR-compressed children
   densified as the solver densifies them, and every K2, K3 and K4 shape
   of theirs not checked before: K3/K2 on their lossy and dense fronts,
   K2/K4 on hodlr100's BLR tiles;
4. exact32: Poisson 32^3, f32 factor + f32 iterative refinement to 1e-5;
5. exact64: Poisson 64^3, the same, plus peak device memory;
6. f64: Poisson 32^3 in float64 (the kernels' double instantiation);
7. blr50: Poisson 50^3 with BLR fronts, f32, preconditioned GMRES to 1e-4
   (bench.py's blr50 configuration), plus peak device memory;
8. nd64, metis64: Poisson 64^3 given without its grid, ordered by the
   defaults (native BFS nested dissection) and by METIS (native multilevel
   ND), exact64's numerics; a second solve from the first solution;
9. spd64: Poisson 64^3, the SPD path (Cholesky from the no-pivot K3),
   f32 factor + f64 refinement to 1e-10, inertia, peak device memory;
10. mc64: a high-contrast jump3d with scaled rows and permuted columns,
    MC64 matching + scaling, METIS, f64; again after new values;
11. orderings: Poisson 20^3 by NATURAL, RCM, AMD, MMD, MLF (12^3),
    SPECTRAL, AND and SCOTCH, and an anisotropic 24^3 without pivoting,
    f64;
12. df32: Poisson 32^3, f32 factor + double-float refinement (bench.py's
    df32 configuration);
13. hodlr100: bench.py's hodlr100 configuration (ZFP_BLR_HODLR on
    Poisson 100^3: sampled HSS fronts for separators >= 2048, BLR fronts
    with compressed CBs >= 256, bf16 fronts below; f32, preconditioned
    GMRES to 1e-6), the steady factor after update_matrix_values, peak
    device memory;
14. hss64, hodlr64: Poisson 64^3 with HSS and HODLR fronts built from the
    dense F11 for separators >= 1024, f32, preconditioned GMRES to 1e-6;
15. helmholtz32: bench.py's helmholtz32 configuration (complex Helmholtz
    32^3 in complex64 through its interleaved real form, HODBF fronts for
    separators >= 512, preconditioned GMRES to 1e-4), the steady factor
    after update_matrix_values, peak device memory, its SVDs' device time
    by events;
16. helm32_native: the same matrix factored exactly in native complex64
    (refinement to 1e-5) and complex128, K1's complex instantiations
    bit-equal at every K1 call of its plan;
17. chunked64: exact64's problem with buckets above a 0.5 GB working set
    run in chunks (STRUMPACK_TPU_CHUNK_GB): factors against exact64's,
    peak device memory against exact64's and the model;
18. dense16k: the structured dense facade on the Gauss kernel matrix
    K + 2I of 16,384 2-D points (float32, 1.07 GB): HSS, HODLR, BLR at
    leaf 128 (its tile LUs on K4) and 64 (on K2) and LOSSY, then HODBF,
    LR and BUTTERFLY on its leading 2048/4096 blocks; build, factor and solve
    seconds, rank and memory, mult and solve errors against the dense f64
    product and solve (gates 100 x rel_tol; LOSSY's its int8 bound), K2
    and K4 at the BLR runs' new shapes;
19. kernel100k: examples/kernel_regression_100k.py's configuration
    (100,000 points, matrix-free HSS), rel_err < 0.3 on 2000 points; the
    ann and HODLR fits and the two-moons classifier at 8,192 points
    (accuracy > 0.92);
20. dist64: the distributed solver (``parallel/``) on exact64's problem:
    (a) one NCCL rank, factors bit-equal to exact64's and its IR
    iterations; (b) two gloo ranks sharing the card (spawned), DIRECT and
    IR, in the cyclic and the contiguous grid layout: modes and report
    against ``choose_modes``, shard-front factors bit-equal to exact64's,
    grid fronts' backward errors, residuals, K1-K4 launches against each
    rank's share of the plan (K4: the contiguous layout's grid panels),
    reorder / factor / solve seconds and bytes all-gathered per level
    (ranks sharing one card: not a scaling measurement); K1 at every call
    of each rank's slices, K3 at the slices and K4 at the grid sub-panels
    against their plain versions, where phase 3 did not check those
    shapes;
21. one JSON line {"kernels": [...]}, then the last line
    {"ok": true, "device": {...}}.

The launch counters are set to 0 just before each solver phase factors
and read just after it solves; the launches the comparisons of phase 3 make
are not counted.  It imports neither JAX nor strumpack_tpu.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# f32 and f64 peaks without tensor cores and the memory rate of one H100
# SXM (NVIDIA's data sheet), the bounds' denominators
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, torch, warmup=3, reps=15):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_calls(pdev):
    """(level, bucket, chunk) of every K1 call one factorization of the
    plan makes: each chunk of each assembled bucket whose fronts take a
    child's CB (``BucketDev.ea_launches`` counts their launches)."""
    out = []
    for li, lvl in enumerate(pdev.levels):
        for bi, bd in enumerate(lvl):
            npairs = len(bd.pairsL) + len(bd.pairsR)
            if bd.bp.hss_sample or not npairs:
                continue
            emap, nfc = bd.ea_map(), bd.bp.nf // bd.bp.chunks
            out += [(li, bi, c) for c in range(bd.bp.chunks)
                    if emap.launches(c * nfc, (c + 1) * nfc, npairs)]
    return out


def k1_old_picks(pdev):
    """Three (level, bucket, side, pair) of the plan: the smallest, a
    middle and the largest parent front that has an extend-add pair (the
    pairs earlier designs launched one at a time and timed)."""
    cands = []
    for li, lvl in enumerate(pdev.levels):
        for bi, bd in enumerate(lvl):
            for side in ("L", "R"):
                for pr in getattr(bd, "pairs" + side):
                    cands.append((bd.bp.p, bd.bp.nf, li, bi, side, pr))
    cands.sort(key=lambda c: (c[0], c[1]))
    return [c[2:] for c in (cands[0], cands[len(cands) // 2], cands[-1])]


def k1_flat_index(torch, pairs, posL, posR, nf, p):
    """The index_add_ form of one K1 call, built on the device: every
    entry of the call's child blocks (the pairs' C, concatenated) with its
    flat index in F, and whether a front takes it.  An entry no front
    takes (padding, a block of another parent bucket) is sent to its own
    position modulo F's size, and the caller zeroes it, so it adds +0."""
    n_f = nf * p * p
    dev = posL.device
    flats, takens, base = [], [], 0
    for C, idx, side in pairs:
        nfc, u = C.shape[0], C.shape[1]
        pos = (posL, posR)[side].long()
        flat = (torch.arange(nfc * u * u, device=dev) + base) % n_f
        taken = torch.zeros(nfc * u * u, dtype=torch.bool, device=dev)
        f = torch.nonzero(idx >= 0).flatten()
        ok = pos[f] >= 0                                    # [nsel, p]
        hit = ok[:, :, None] & ok[:, None, :]               # [nsel, p, p]
        fi, i, j = torch.nonzero(hit, as_tuple=True)
        ff = f[fi]
        src = (idx.long()[ff] * u + pos[ff, i]) * u + pos[ff, j]
        flat[src] = (ff * p + i) * p + j
        taken[src] = True
        flats.append(flat)
        takens.append(taken)
        base += nfc * u * u
    return torch.cat(flats), torch.cat(takens)


# K1 yardstick flat indices are built up to this many child entries
K1_FLAT_MAX = 1 << 28
# K1 calls whose byte bound passes this many ms are summed apart too
K1_BIG_MS = 0.05


def k1_call(torch, pdev, li, bi, c, dtype, gen, child, kids=None):
    """The inputs of one K1 call as the solver makes it: F, the pair
    table, the maps and the map's front offset.  Random fronts and child
    CBs of ``dtype`` drawn by ``gen`` on the card (``child`` keeps a
    level's child buckets, {bucket: CBs}); a child bucket that hands on
    BLR-compressed CBs gives one dense block a parent front, indexed by
    the pair's ``loc`` (``numeric._ea_pairs``).  ``kids``: the plan the
    child buckets are read from (default ``pdev``; a rank's shard slices
    read the whole child buckets, all-gathered)."""
    bd = pdev.levels[li][bi]
    bp = bd.bp
    nfc = bp.nf // bp.chunks
    f0, f1 = c * nfc, (c + 1) * nfc
    pairs = []
    for side, prs in ((0, bd.pairsL), (1, bd.pairsR)):
        for pr in prs:
            cb = (kids or pdev).levels[li - 1][pr.bk].bp
            u = pr.u
            if cb.cb_comp:
                pairs.append((torch.randn((nfc, u, u), generator=gen,
                                          device="cuda", dtype=dtype),
                              pr.loc[f0:f1], side))
                continue
            if pr.bk not in child:
                child[pr.bk] = torch.randn((cb.nf, u, u), generator=gen,
                                           device="cuda", dtype=dtype)
            pairs.append((child[pr.bk], pr.idx[f0:f1], side))
    F = torch.randn((nfc, bp.p, bp.p), generator=gen, device="cuda",
                    dtype=dtype)
    return F, pairs, bd.posL[f0:f1], bd.posR[f0:f1], bd.ea_map(), f0


def k1_bytes(torch, pairs, posL, posR, itemsize):
    """K1's byte bound of one call, whatever implements it: each parent
    element with an addend read and written once, each child entry that
    lands read once.  Per front, with nL and nR the slots its left and
    right child fill and nLR those both fill, that is nL^2 + nR^2 - nLR^2
    elements and nL^2 + nR^2 child entries."""
    v = [torch.zeros_like(posL, dtype=torch.bool) for _ in range(2)]
    for _, idx, side in pairs:
        v[side] |= (idx >= 0)[:, None] & ((posL, posR)[side] >= 0)
    nL, nR = v[0].sum(1).double(), v[1].sum(1).double()
    nLR = (v[0] & v[1]).sum(1).double()
    sq = nL ** 2 + nR ** 2
    return itemsize * float((2 * (sq - nLR ** 2) + sq).sum())


def check_k1(torch, pdev, rng, calls=None, full=True, dtype=None,
             label="K1", one_pair=False, kids=None):
    """K1 against its plain version (``extend_add_bucket_plain``) at
    ``calls`` (default: ``k1_calls``, every call of one factorization), on
    random fronts and child blocks of ``dtype`` (default float32): bit-equal
    (``torch.equal``), timed by events, with the index_add_ yardstick where
    the call's child blocks have at most K1_FLAT_MAX entries.  With
    ``one_pair`` the calls are (level, bucket, side, pair) and each runs
    that pair alone (a table of one), as earlier designs launched it.
    Without ``full`` the times take fewer repetitions, and the yardstick
    runs on the calls whose bound passes K1_BIG_MS; ``kids`` as in
    ``k1_call``.  Returns one record a call; prints the records' sums
    under ``label``."""
    from strumpack_tpu_torch.ops.extend_add import (EAMap,
                                                    extend_add_bucket,
                                                    extend_add_bucket_plain)
    out = []
    # without ``full``: the kernel twice, the plain version once (the
    # check's calls warmed them), the yardstick on the calls whose bound
    # passes K1_BIG_MS only
    reps = {} if full else dict(warmup=0, reps=2)
    once = {} if full else dict(warmup=0, reps=1)
    dtype = dtype or torch.float32
    itemsize = torch.empty((), dtype=dtype).element_size()
    eps = torch.finfo(dtype).eps
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(2 ** 31)))
    if calls is None:
        calls = k1_calls(pdev)
    child, child_level = {}, None
    for call in calls:
        li, bi = call[:2]
        if li != child_level:
            child, child_level = {}, li
            torch.cuda.empty_cache()
        if one_pair:
            side, pr = call[2:]
            bd = pdev.levels[li][bi]
            pos = getattr(bd, "pos" + side)
            comp = bool(pdev.levels[li - 1][pr.bk].bp.cb_comp)
            nfc = bd.bp.nf if comp else pdev.levels[li - 1][pr.bk].bp.nf
            idx = pr.loc if comp else pr.idx
            C = torch.randn((nfc, pr.u, pr.u), generator=gen, device="cuda",
                            dtype=dtype)
            F = torch.randn((bd.bp.nf, bd.bp.p, bd.bp.p), generator=gen,
                            device="cuda", dtype=dtype)
            pairs, posL, posR, f0 = [(C, idx, 0)], pos, pos, 0
            emap = EAMap(pos, pos, (idx >= 0).cpu().numpy(),
                         np.zeros(len(idx), bool))
            nchunk = 1
        else:
            F, pairs, posL, posR, emap, f0 = k1_call(torch, pdev, li, bi,
                                                     call[2], dtype, gen,
                                                     child, kids)
            nchunk = pdev.levels[li][bi].bp.chunks
        nf, p = F.shape[0], F.shape[1]

        def kern(Fw):
            return extend_add_bucket(Fw, pairs, posL, posR, emap, f0)

        def plain(Fw):
            return extend_add_bucket_plain(Fw, pairs, posL, posR)

        n0 = extend_add_bucket.launches
        Fk = kern(F.clone())
        launches = extend_add_bucket.launches - n0
        Fp = plain(F.clone())
        torch.cuda.synchronize()
        err = float((Fk - Fp).abs().max())
        where = (f"level {li} bucket {bi} nf={nf} p={p} pairs={len(pairs)} "
                 f"u={[C.shape[1] for C, _, _ in pairs]} {dtype}")
        check(torch.equal(Fk, Fp), f"K1 bit-equal to the plain version at "
              f"{where}")
        check(launches == emap.launches(f0, f0 + nf, len(pairs)),
              f"K1 launches at {where}")
        del Fp
        nbytes = k1_bytes(torch, pairs, posL, posR, itemsize)
        Fw = F.clone()
        ms = cuda_ms(lambda: kern(Fw), torch, **reps)
        # the kernel alone (profiler device time) where the times are full
        kernel_ms = (device_ms(torch, lambda: kern(Fw), "extend_add_bucket",
                               reps=5) if full else None)
        Fw = F.clone()
        plain_ms = cuda_ms(lambda: plain(Fw), torch, **once)
        lib = None
        if (sum(C.numel() for C, _, _ in pairs) <= K1_FLAT_MAX
                and (full or nbytes / PEAK_BYTES * 1e3 >= K1_BIG_MS)):
            # yardstick: one index_add_ over a flat index built here,
            # outside the timed call; where both children feed an element
            # its atomics add the two in either order, so it equals K1 to
            # the rounding of one add
            flat, taken = k1_flat_index(torch, pairs, posL, posR, nf, p)
            Cz = torch.cat([C.reshape(-1) for C, _, _ in pairs])
            Cz[~taken] = 0
            Fl = F.clone()
            Fl.view(-1).index_add_(0, flat, Cz)
            scale = float(F.abs().max()) + 2 * float(Cz.abs().max())
            check(float((Fl - Fk).abs().max()) <= 4 * eps * scale,
                  f"K1 index_add_ yardstick equals K1 to rounding at {where}")
            Fw = F.clone()
            lib = cuda_ms(lambda: Fw.view(-1).index_add_(0, flat, Cz),
                          torch, **once)
            del flat, Cz, Fl
        rec = dict(level=li, bucket=bi, chunk=None if one_pair else call[2],
                   chunks=nchunk, nf=nf, p=p, pairs=len(pairs),
                   u=sorted({C.shape[1] for C, _, _ in pairs}),
                   tiles=int(emap.tile_ptr[f0 + nf] - emap.tile_ptr[f0]),
                   launches=launches, dtype=str(dtype).split(".")[-1],
                   max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, bound_ms=nbytes / PEAK_BYTES * 1e3,
                   bound_by="bytes", library_ms=lib)
        out.append(rec)
        del F, Fk, Fw, pairs
    sums = {k: sum(r[k] for r in out) for k in ("ms", "plain_ms",
                                                 "bound_ms")}
    # the calls whose bound passes K1_BIG_MS, apart
    big = [r for r in out if r["bound_ms"] >= K1_BIG_MS]
    print(label, json.dumps(dict(
        calls=len(out), launches=sum(r["launches"] for r in out),
        kernel_ms=(sum(r["kernel_ms"] for r in out) if full and all(
            r["kernel_ms"] is not None for r in out) else None),
        library_ms=sum(r["library_ms"] for r in out
                       if r["library_ms"] is not None),
        library_missing=sum(r["library_ms"] is None for r in out),
        big_calls=len(big), big_ms=sum(r["ms"] for r in big),
        big_bound_ms=sum(r["bound_ms"] for r in big), **sums)), flush=True)
    torch.cuda.empty_cache()
    return out


def backward_errors(torch, P1, P2, L11, L21, U, U12, skip=None):
    """Per front: |P F - L U| / (|L| |U|) over the factored columns and
    |P F12 - L11 U12| / (|L11| |U12|), in f64.  LU with partial pivoting
    meets both with gamma_s = s eps / (1 - s eps) (Higham, Thm 9.3).
    ``skip`` [nf, s]: diagonal entries left out of the first residual, the
    pivots the tiny-pivot rule replaced (each changes its one entry of
    P F by thresh - pivot and nothing else)."""
    L = L11 if L21 is None else torch.cat([L11, L21], dim=1)
    R1 = P1 - L @ U
    if skip is not None:
        d = R1.diagonal(dim1=1, dim2=2)
        d.copy_(torch.where(skip, torch.zeros_like(d), d))
    be = R1.abs().amax(dim=(1, 2)) / (L.abs() @ U.abs()).amax(dim=(1, 2))
    if U12 is not None and U12.shape[-1]:
        R2 = P2 - L11 @ U12
        be2 = R2.abs().amax(dim=(1, 2)) / (L11.abs() @ U12.abs()).amax(
            dim=(1, 2)).clamp(min=1e-300)
        be = be.maximum(be2)
    return be


def compare(what, got, want, same, tol):
    """Values of the fronts with equal perm, relative to each output's
    largest entry on the front; returns the largest absolute error."""
    err = 0.0
    for name, a, b in zip(what, got, want):
        if not a.numel():
            continue
        d = (a[same] - b[same]).abs().flatten(1).amax(dim=1)
        scale = b[same].abs().flatten(1).amax(dim=1).clamp(min=1e-300)
        check(bool((d <= tol * scale).all()), f"{name} values")
        err = max(err, float(d.max()))
    return err


def k2_flops(nf, p, s):
    """Divisions and rank-1 updates of the rows not yet pivoted."""
    k = np.arange(s)
    return nf * int(((p - k - 1) + 2 * (p - k - 1) ** 2).sum())


def check_k2(torch, rng, nf, p, s, dtype, pivot=True, launches=0,
             full=True):
    """K2 against its plain version: perm identical, the packed fronts bit
    for bit, the zero pivot of front 0 replaced, backward error.
    ``launches``: how often one blr50 factorization launches this shape;
    without ``full`` the times take fewer repetitions (the shapes of the
    general-input phases)."""
    from strumpack_tpu_torch.ops import front_lu as FL
    eps = float(np.finfo(dtype).eps)
    thresh = float(np.sqrt(eps))
    Fn = rng.standard_normal((nf, p, p)).astype(dtype)
    if not pivot:       # diagonally dominant: stable without pivoting
        Fn += np.eye(p, dtype=dtype) * 2 * p
    Fn[0, :, 0] = 0.0   # front 0: a zero pivot, replaced by thresh
    F = torch.from_numpy(Fn).cuda()
    k = FL.factor_bucket(F, thresh, s, pivot)
    q = FL.factor_bucket_plain(F, thresh, s, pivot)
    torch.cuda.synchronize()
    same = (k[1] == q[1]).all(dim=1)
    check(bool(same.all()), f"K2 perm identical ({int((~same).sum())} "
          f"fronts differ) at {(nf, p, s, dtype, pivot)}")
    check(torch.equal(k[0], q[0]), f"K2 bit-exact at {(nf, p, s, dtype)}")
    err = float((k[0] - q[0]).abs().max())
    tol = 1e-5 if dtype == "float32" else 1e-12
    lu, L21, U12, CB = (x.double() for x in FL.unpack_factors(k[0], s))
    perm = k[1]
    Fd = F.double()
    L11 = torch.tril(lu, -1) + torch.eye(s, dtype=torch.float64,
                                         device=F.device)
    U = torch.triu(lu)
    P1 = torch.cat([torch.gather(Fd[:, :s, :s], 1,
                                 perm[:, :, None].expand(-1, -1, s)),
                    Fd[:, s:, :s]], dim=1)
    P2 = torch.gather(Fd[:, :s, s:], 1, perm[:, :, None].expand(-1, -1, p - s))
    rep = (torch.diagonal(U, dim1=1, dim2=2).abs()
           == float(np.asarray(thresh, dtype)))
    replaced = rep.any(dim=1)
    check(bool(replaced[0]), "K2 front 0 has its zero pivot replaced")
    be = backward_errors(torch, P1, P2, L11, L21 if p > s else None, U, U12,
                         skip=rep)
    check(bool((be <= tol).all()), f"K2 backward error {float(be.max()):.3g}")
    if p > s:           # the Schur complement: CB = F22 - L21 U12
        rcb = (Fd[:, s:, s:] - L21 @ U12 - CB).abs().amax(dim=(1, 2))
        scb = (Fd[:, s:, s:].abs() + L21.abs() @ U12.abs()).amax(dim=(1, 2))
        check(bool((rcb <= tol * scb).all()), "K2 Schur complement")
    del lu, L21, U12, CB, Fd, L11, U, P1, P2

    reps = {} if full else dict(warmup=1, reps=5)
    ms = cuda_ms(lambda: FL.factor_bucket(F, thresh, s, pivot), torch,
                 **reps)
    plain = cuda_ms(lambda: FL.factor_bucket_plain(F, thresh, s, pivot),
                    torch, **({} if full else dict(warmup=0, reps=1)))
    # yardstick: the library route on the same batch (lu_factor_ex alone
    # for a full LU), timed only
    lib = cuda_ms((lambda: FL.library_factor(F, thresh, s)) if s < p else
                  (lambda: torch.linalg.lu_factor_ex(F)), torch, **reps)
    nbytes = nf * (np.dtype(dtype).itemsize * 2 * p * p + 8 * s)
    tb = nbytes / PEAK_BYTES * 1e3
    tf = k2_flops(nf, p, s) / PEAK_FLOPS[dtype] * 1e3
    rec = dict(nf=nf, p=p, s=s, dtype=dtype, pivot=pivot,
               fronts_per_cta=FL.k2_layout(
                   p, nf, torch.cuda.get_device_properties(0)
                   .multi_processor_count)[1], blr50_launches=launches,
               replaced_fronts=int(replaced.sum()), max_abs_err=err,
               backward_error=float(be.max()), ms=ms, plain_ms=plain,
               library_ms=lib, bound_ms=max(tb, tf),
               bound_by="bytes" if tb >= tf else "operations")
    print("K2" if full else "K2-general", json.dumps(rec), flush=True)
    return rec


def k4_flops(nf, p, w, row0):
    """Divisions and rank-1 updates of the updatable rows of a panel."""
    k = np.arange(w)
    nr = p - row0 - k - 1
    return nf * int((nr + 2 * nr * (w - k - 1)).sum())


def check_k4(torch, rng, nf, p, w, row0, dtype, want, launches=0):
    """K4 against its plain version on one panel per front (pivots from
    rows [row0, p)): ``want`` = (design, cluster size) chosen and launched,
    pivot rows identical, the panel bit for bit, the zero pivot of front 0
    replaced, backward error of the permuted panel.  ``launches``: how
    often one blr50 factorization launches this shape."""
    from strumpack_tpu_torch.ops import panel_lu as PP
    eps = float(np.finfo(dtype).eps)
    thresh = float(np.sqrt(eps))
    check(PP.design(p, w, np.dtype(dtype).itemsize, row0) == want,
          f"K4 design at {(p, w, row0, dtype)}")
    Pn = rng.standard_normal((nf, p, w)).astype(dtype)
    Pn[0, :, 0] = 0.0
    panel = torch.from_numpy(Pn).cuda()
    before = dict(PP.panel_lu.variants)
    k = PP.panel_lu(panel, thresh, row0, w, p)
    check(PP.panel_lu.variants[want[0]] == before[want[0]] + 1,
          f"K4 launched its {want[0]} design")
    q = PP.panel_lu_plain(panel, thresh, row0, w, p)
    torch.cuda.synchronize()
    same = (k[1] == q[1]).all(dim=1)
    check(bool(same.all()), f"K4 pivot rows identical at {(nf, p, w, row0)}")
    check(torch.equal(k[0], q[0]), f"K4 bit-exact at {(nf, p, w, row0, dtype)}")
    err = float((k[0] - q[0]).abs().max())
    tol = 1e-5 if dtype == "float32" else 1e-12
    # P panel[row0:] = [L11; L21] U11 on the rows it eliminates
    pj = PP.panel_perm(k[1], p, row0, w)
    G = torch.gather(k[0].double(), 1, pj[:, :, None].expand(-1, -1, w))
    Pin = torch.gather(panel.double(), 1, pj[:, :, None].expand(-1, -1, w))
    eye = torch.eye(w, dtype=torch.float64, device=panel.device)
    L11 = torch.tril(G[:, row0:row0 + w], -1) + eye
    U = torch.triu(G[:, row0:row0 + w])
    rep = (torch.diagonal(U, dim1=1, dim2=2).abs()
           == float(np.asarray(thresh, dtype)))
    check(bool(rep[0].any()), "K4 front 0 has its zero pivot replaced")
    be = backward_errors(torch, Pin[:, row0:], None, L11, G[:, row0 + w:], U,
                         None, skip=rep)
    check(bool((be <= tol).all()), f"K4 backward error {float(be.max()):.3g}")
    check(torch.equal(k[0][:, :row0], panel[:, :row0]), "K4 rows < row0 kept")
    del G, Pin, L11, U

    ms = cuda_ms(lambda: PP.panel_lu(panel, thresh, row0, w, p), torch)
    plain = cuda_ms(lambda: PP.panel_lu_plain(panel, thresh, row0, w, p),
                    torch)
    sub = panel[:, row0:].contiguous()
    lib = cuda_ms(lambda: torch.linalg.lu_factor_ex(sub), torch)
    nbytes = nf * (np.dtype(dtype).itemsize * 2 * p * w + 8 * w)
    tb = nbytes / PEAK_BYTES * 1e3
    tf = k4_flops(nf, p, w, row0) / PEAK_FLOPS[dtype] * 1e3
    rec = dict(nf=nf, p=p, w=w, row0=row0, dtype=dtype, design=want[0],
               cluster=want[1], blr50_launches=launches, max_abs_err=err,
               backward_error=float(be.max()),
               ms=ms, plain_ms=plain, library_ms=lib, bound_ms=max(tb, tf),
               bound_by="bytes" if tb >= tf else "operations")
    print("K4", json.dumps(rec), flush=True)
    return rec


def check_blocked(torch, rng, nf, m, dtype):
    """The blocked LU over K4 against the same blocked LU over the plain
    panel version: a full LU of [nf, m, m] tiles (two panels at m = 256),
    as batched_lu runs it for the BLR tiles."""
    from strumpack_tpu_torch.ops import panel_lu as PP
    thresh = float(np.sqrt(np.finfo(dtype).eps))
    F = torch.from_numpy(rng.standard_normal((nf, m, m)).astype(dtype)).cuda()
    k = PP.blocked_factor_bucket(F, thresh, m)
    q = PP.blocked_factor_bucket(F, thresh, m, panel=PP.panel_lu_plain)
    torch.cuda.synchronize()
    same = (k[1] == q[1]).all(dim=1)
    check(bool(same.all()), "blocked LU: perm identical")
    tol = 1e-5 if dtype == "float32" else 1e-12
    err = compare(("blocked lu",), (k[0],), (q[0],), same, tol)
    lu = k[0].double()
    L = torch.tril(lu, -1) + torch.eye(m, dtype=torch.float64, device=F.device)
    PF = torch.gather(F.double(), 1, k[1][:, :, None].expand(-1, -1, m))
    be = backward_errors(torch, PF, None, L, None, torch.triu(lu), None)
    check(bool((be <= 4 * tol).all()), f"blocked backward error {float(be.max()):.3g}")
    ms = cuda_ms(lambda: PP.blocked_factor_bucket(F, thresh, m), torch)
    plain = cuda_ms(lambda: PP.blocked_factor_bucket(
        F, thresh, m, panel=PP.panel_lu_plain), torch)
    lib = cuda_ms(lambda: torch.linalg.lu_factor_ex(F), torch)
    rec = dict(nf=nf, m=m, dtype=dtype, max_abs_err=err,
               backward_error=float(be.max()), ms=ms, plain_ms=plain,
               library_ms=lib)
    print("K4-blocked", json.dumps(rec), flush=True)
    return rec


def k3_flops(nf, p, s, schur=True):
    """Elimination (divisions + rank-1 updates of A and B) and, with
    ``schur``, the Schur GEMM."""
    u = p - s
    k = np.arange(s)
    elim = ((p - k - 1) + 2 * (p - k - 1) * (s - k - 1)
            + 2 * (s - k - 1) * u).sum()
    return nf * (int(elim) + (2 * u * u * s if schur else 0))


def k3_bounds(nf, p, s, dtype):
    """(bound ms, by) of K3 with the Schur GEMM (F read once, lu + L21 +
    U12 + CB + perm written once) and of the kernel alone
    (A and B read once, lu + L21 + U12 + perm written once)."""
    isz = np.dtype(dtype).itemsize
    out = []
    for nbytes, flops in (
            (nf * (isz * 2 * p * p + 8 * s), k3_flops(nf, p, s)),
            (nf * (isz * 2 * (p * s + s * (p - s)) + 8 * s),
             k3_flops(nf, p, s, schur=False))):
        tb = nbytes / PEAK_BYTES * 1e3
        tf = flops / PEAK_FLOPS[dtype] * 1e3
        out.append((max(tb, tf), "bytes" if tb >= tf else "operations"))
    return out


def device_ms(torch, fn, pattern, reps=10, tries=3):
    """Device milliseconds per call of the kernels whose name holds
    ``pattern``, over ``reps`` calls of ``fn`` after one warm-up
    (torch.profiler over CUPTI).  A trace now and then holds none of the
    kernels (seen on the card host once in ~100 traces): it is taken
    again, up to ``tries`` times; None when none had them (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
                 for ev in prof.key_averages() if pattern in ev.key)
        if us:
            return us / 1e3 / reps
    return None


def host_ms(torch, fn, reps=50):
    """Median host milliseconds of one call of ``fn`` over ``reps`` calls
    (perf_counter, the device idle before each call and nothing waited
    for after it): what the call costs the host to enqueue its work."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def time_k3(torch, FL, F, thresh, s):
    """K3's times on the fronts F through the module ``FL`` (this tree's
    ops/front_lu.py or another version's): the wrapper with the Schur GEMM
    (CUDA events, host time before the launch included), its host time
    alone, the kernel alone (device time), the Schur GEMM alone and the
    library route (events)."""
    k = FL.partial_factor(F, thresh, s)
    return dict(
        ms=cuda_ms(lambda: FL.partial_factor(F, thresh, s), torch),
        host_ms=host_ms(torch, lambda: FL.partial_factor(F, thresh, s)),
        kernel_ms=device_ms(torch, lambda: FL.partial_factor(F, thresh, s),
                            "lu_cross_kernel"),
        schur_ms=cuda_ms(lambda: torch.baddbmm(F[:, s:, s:], k[2], k[3],
                                               alpha=-1), torch),
        library_ms=cuda_ms(lambda: FL.library_factor(F, thresh, s), torch))


def k3_fronts(torch, rng, nf, p, dtype, pivot=True):
    """Random fronts, front 0 with a zero pivot (replaced by thresh); for
    the no-pivot mode symmetric positive definite ones, as the Cholesky
    path factors them."""
    Fn = rng.standard_normal((nf, p, p)).astype(dtype)
    if pivot:
        Fn[0, :, 0] = 0.0
    else:
        Fn = Fn + Fn.transpose(0, 2, 1) + np.eye(p, dtype=dtype) * 2 * p
    return torch.from_numpy(Fn).cuda()


def check_k3(torch, rng, nf, p, s, dtype, buckets=None, pivot=True,
             full=True):
    """K3 against its plain version: perm, lu, L21, U12 (and the CB, one
    GEMM on equal inputs) bit for bit, the zero pivot of front 0 replaced,
    backward error; then its times and the library route's.
    ``buckets``: {cell: buckets of this shape in one factorization}, each
    a K3 launch.  ``pivot=False``: the no-pivot mode on SPD fronts with
    the Cholesky path's thresh 0, the SPD library route the yardstick.
    Without ``full``, events only and fewer repetitions (the shapes of the
    general-input phases)."""
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.ops import front_lu as FL
    eps = float(np.finfo(dtype).eps)
    thresh = float(np.sqrt(eps)) if pivot else 0.0
    F = k3_fronts(torch, rng, nf, p, dtype, pivot)
    k = FL.partial_factor(F, thresh, s, pivot)
    q = FL.partial_factor_plain(F, thresh, s, pivot)
    torch.cuda.synchronize()
    names = ("lu", "perm", "L21", "U12", "CB")
    same = (k[1] == q[1]).all(dim=1)
    flips = int((~same).sum())
    check(flips == 0, f"K3 perm identical ({flips} fronts differ) at "
          f"{(nf, p, s, dtype, pivot)}")
    for n, a, b in zip(names, k, q):
        check(torch.equal(a, b),
              f"K3 {n} bit-exact at {(nf, p, s, dtype, pivot)}")
    err = max(float((a - b).abs().max()) for a, b in zip(k, q) if a.numel())
    tol = 1e-5 if dtype == "float32" else 1e-12
    # backward error, the replaced pivots' own entries left out
    lu, L21, U12 = (k[i].double() for i in (0, 2, 3))
    perm = k[1]
    L11 = torch.tril(lu, -1) + torch.eye(s, dtype=torch.float64,
                                         device=F.device)
    U = torch.triu(lu)
    Fd = F.double()
    P1 = torch.cat([torch.gather(Fd[:, :s, :s], 1,
                                 perm[:, :, None].expand(-1, -1, s)),
                    Fd[:, s:, :s]], dim=1)
    P2 = torch.gather(Fd[:, :s, s:], 1, perm[:, :, None].expand(-1, -1, p - s))
    rep = (torch.diagonal(U, dim1=1, dim2=2).abs()
           == float(np.asarray(thresh, dtype)))
    replaced = rep.any(dim=1)
    check(bool(replaced[0]) or not pivot,
          "K3 front 0 has its zero pivot replaced")
    be = backward_errors(torch, P1, P2, L11, L21, U, U12, skip=rep)
    check(bool((be <= tol).all()), f"K3 backward error {float(be.max()):.3g}")
    del k, q, lu, L21, U12, L11, U, Fd, P1, P2

    # ms: the wrapper with the Schur GEMM, as the solver calls it;
    # library: lu_factor + pivot conversion + 2 solve_triangular + GEMM,
    # the port's library route on the same fronts
    rec = dict(nf=nf, p=p, s=s, dtype=dtype, pivot=pivot,
               layout=FL.k3_layout(p, s, nf, F.element_size(),
                                   torch.cuda.get_device_properties(0)
                                   .multi_processor_count),
               buckets=buckets or {}, replaced_fronts=int(replaced.sum()),
               max_abs_err=err, backward_error=float(be.max()))
    if full:
        rec.update(time_k3(torch, FL, F, thresh, s))
    else:
        rec["ms"] = cuda_ms(lambda: FL.partial_factor(F, thresh, s, pivot),
                            torch, warmup=1, reps=5)
        rec["library_ms"] = cuda_ms(
            (lambda: FL.library_factor(F, thresh, s)) if pivot else
            (lambda: numeric.cholesky_factor(F, s)), torch, warmup=1,
            reps=5)
    rec["plain_ms"] = cuda_ms(
        lambda: FL.partial_factor_plain(F, thresh, s, pivot), torch,
        **(dict(warmup=1, reps=3) if full else dict(warmup=0, reps=1)))
    (rec["bound_ms"], rec["bound_by"]), (rec["kernel_bound_ms"],
                                         rec["kernel_bound_by"]) = \
        k3_bounds(nf, p, s, dtype)
    print("K3" if full else "K3-general", json.dumps(rec), flush=True)
    return rec


def k3_shapes(plans, dtype):
    """The K3 check list: the shape of every dense bucket of the plans
    ({cell: PlanDev}) that K3 factors in ``dtype`` (``PlanDev.k3_shapes``),
    with its buckets per factorization by cell; and the library route's
    shapes of s <= 128, which K3 does not hold, by cell."""
    import torch
    dtype = getattr(torch, dtype)
    shapes, refused = {}, {}
    for cell, pdev in plans.items():
        for key in pdev.k3_shapes(dtype):
            shapes.setdefault(key, {}).setdefault(cell, 0)
            shapes[key][cell] += 1
        for key in pdev.library_shapes(dtype):
            if key[2] <= 128:
                refused.setdefault(key, {}).setdefault(cell, 0)
                refused[key][cell] += 1
    return shapes, refused


def ptxas_report(log):
    """(kernel, registers, stack, spill stores, spill loads) of every
    K2, K3 and K4 instantiation in ptxas's -v output, by source."""
    import re
    rows = []
    for src in ("small_lu", "front_lu", "panel_lu"):
        name = None
        for line in log.get(src, "").splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and name:
                st = tuple(int(x) for x in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                short = re.sub(r"^.*?(small_lu_kernel|lu_cross_kernel|"
                               r"panel_lu_reg|panel_lu_global)", r"\1", name)
                rows.append((short, int(m.group(1))) + st)
                name = None
    return rows


def blr_shapes(pdev, dtype):
    """K2 and K4 shapes of one factorization of a BLR plan in ``dtype``,
    each with the number of launches: K2 (nf, p, s) of the dense buckets
    and of the tile LUs of t <= 64; K4 (nf, p, w, row0) of each panel of
    the tile LUs of t > 64, as blocked_factor_bucket cuts them."""
    from collections import Counter
    from strumpack_tpu_torch.ops import front_lu as FL
    from strumpack_tpu_torch.ops import panel_lu as PP
    k2, k4 = Counter(pdev.k2_dense_shapes(dtype)), Counter()
    for nf, t in pdev.batched_lu_shapes():
        if t <= FL.MAX_PALLAS_P:
            k2[(nf, t, t)] += 1
        elif t <= PP.MAX_PANEL_P:
            for jb in range(0, t, PP.PANEL_W):
                k4[(nf, t, min(PP.PANEL_W, t - jb), jb)] += 1
    check(sum(k2.values()) == pdev.k2_launches(dtype)
          and sum(k4.values()) == pdev.k4_launches(),
          "blr50 K2/K4 shapes add up to the plan's launches")
    return k2, k4


# ---------------------------------------------------------------------------
# phases 4-7: the solver
# ---------------------------------------------------------------------------

def _wrappers():
    from strumpack_tpu_torch.ops.extend_add import extend_add_bucket
    from strumpack_tpu_torch.ops.front_lu import factor_bucket, partial_factor
    from strumpack_tpu_torch.ops.panel_lu import panel_lu
    return dict(extend_add=extend_add_bucket, front_lu_cross=partial_factor,
                small_lu=factor_bucket, panel_lu=panel_lu)


def _tallies():
    """The per-kind launch tallies beside the counts: K4's by design, K3's
    and K2's by pivot mode, and the buckets by route."""
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.ops.front_lu import factor_bucket, partial_factor
    from strumpack_tpu_torch.ops.panel_lu import panel_lu
    return dict(routes=numeric.route_counts,
                panel_lu_designs=panel_lu.variants,
                front_lu_cross_modes=partial_factor.modes,
                small_lu_modes=factor_bucket.modes)


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    for tally in _tallies().values():
        for k in tally:
            tally[k] = 0


def read_counts():
    out = {name: fn.launches for name, fn in _wrappers().items()}
    out.update({name: dict(t) for name, t in _tallies().items()})
    return out


def make_solver(nx, dtype, rel_tol, blr=False):
    """bench.py's _build: exact LU + refinement, or with ``blr`` BLR fronts
    (separators >= 128, tiles at rel_tol 1e-4) + preconditioned GMRES."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson3d
    A = poisson3d(nx)
    opts = st.SPOptions(factor_dtype=dtype, refine_dtype=dtype,
                        krylov_solver=st.KrylovSolver.REFINE, nd_leaf=16)
    if blr:
        opts.krylov_solver = st.KrylovSolver.PREC_GMRES
        opts.compression = st.CompressionType.BLR
        opts.compression_min_sep_size = 128
        opts.blr.rel_tol = 1e-4
    if rel_tol is not None:
        opts.rel_tol = rel_tol
    s = st.SparseSolver(opts)
    s.set_csr_matrix(A)
    t0 = time.perf_counter()
    check(s.reorder(nx, nx, nx) == st.ReturnCode.SUCCESS, "reorder")
    return A, s, time.perf_counter() - t0


# the general-input phases, one cell each.  mc64 runs
# jump3d at MC64_NX^3, not 48^3: the matching (scipy's LAPJVsp, as the JAX
# package calls it) did not finish in 60 s on this matrix at 16^3 and
# 24^3 (2 s at 20^3); MLF runs at MLF_NX^3, not 20^3: its exact greedy
# minimum fill takes minutes at 20^3 (PERF.md, section 4)
MC64_NX = 20
MLF_NX = 12
ORDERINGS = ("NATURAL", "RCM", "AMD", "MMD", "MLF", "SPECTRAL", "AND",
             "SCOTCH")
ORD_PHASES = tuple("ord_" + m for m in ORDERINGS) + ("aniso24_nopivot",)
GENERAL_PHASES = ("nd64", "metis64", "spd64", "mc64", "df32") + ORD_PHASES


def jump3d_scrambled(nx, seed):
    """jump3d(nx) (coefficient contrast 1e6) with its rows scaled by
    10^U(-4, 4) and its columns permuted, both from a numpy seed: the
    large entries off the diagonal, on rows of very different scales."""
    from scipy.sparse import diags
    from strumpack_tpu_torch.sparse.csr import CSRMatrix
    from strumpack_tpu_torch.sparse.gen import jump3d
    A = jump3d(nx, contrast=1e6)
    rng = np.random.default_rng(seed)
    S = diags(10.0 ** rng.uniform(-4, 4, A.n)) @ A.to_scipy()
    return CSRMatrix.from_scipy(S[:, rng.permutation(A.n)].tocsr())


def make_general(name):
    """(A, reordered solver, reorder seconds) of a general-input phase: a
    matrix given without its grid unless the phase names one."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse import gen
    R = st.ReorderingStrategy
    f32 = dict(factor_dtype="float32", refine_dtype="float32", rel_tol=1e-5)
    f64 = dict(factor_dtype="float64", refine_dtype="float64")
    dims = ()
    if name == "nd64":
        A, opts = gen.poisson3d(64), f32
    elif name == "metis64":
        A, opts = gen.poisson3d(64), dict(f32, reordering_method=R.METIS)
    elif name == "spd64":
        A, dims = gen.poisson3d(64), (64, 64, 64)
        opts = dict(factor_dtype="float32", refine_dtype="float64",
                    rel_tol=1e-10, symmetric=True, positive_definite=True)
    elif name == "mc64":
        A = jump3d_scrambled(MC64_NX, seed=0)
        opts = dict(f64, rel_tol=1e-12, reordering_method=R.METIS,
                    matching=st.MatchingJob.MAX_DIAGONAL_PRODUCT_SCALING)
    elif name == "df32":
        A, dims = gen.poisson3d(32), (32, 32, 32)
        opts = dict(factor_dtype="float32", refine_dtype="float32x2",
                    rel_tol=1e-12, abs_tol=1e-13)
    elif name == "aniso24_nopivot":
        A, opts = gen.anisotropic3d(24), dict(f64, pivoting=False)
    else:
        strategy = name[len("ord_"):]
        A = gen.poisson3d(MLF_NX if strategy == "MLF" else 20)
        opts = dict(f64, reordering_method=R[strategy])
    s = st.SparseSolver(st.SPOptions(**opts))
    s.set_csr_matrix(A)
    t0 = time.perf_counter()
    check(s.reorder(*dims) == st.ReturnCode.SUCCESS, f"{name} reorder")
    return A, s, time.perf_counter() - t0


GENERAL_GROUPS = (("float32", True, ("nd64", "metis64")),
                  ("float64", True, ("mc64",) + ORD_PHASES[:-1]),
                  ("float32", False, ("spd64",)),
                  ("float64", False, ("aniso24_nopivot",)))


def general_checks(torch, rng, gen, k3_done, k2_done,
                   groups=GENERAL_GROUPS):
    """K3 and K2 at every shape of the phases ({name: PlanDev}) the checks
    before did not cover ((nf, p, s, dtype, pivot) sets, updated), by
    ``groups`` of (dtype, pivot, phase names): by default pivot mode at
    nd64's and metis64's f32 shapes and at mc64's and the orderings' f64
    shapes, no-pivot mode at spd64's f32 shapes and at aniso24_nopivot's
    f64 shapes."""
    k3_new, k2_new = [], []
    for dtype, pivot, names in groups:
        plans = {n: gen[n] for n in names}
        shapes, _ = k3_shapes(plans, dtype)
        for (nf, p, s), n in sorted(shapes.items()):
            if (nf, p, s, dtype, pivot) not in k3_done:
                k3_done.add((nf, p, s, dtype, pivot))
                k3_new.append(check_k3(torch, rng, nf, p, s, dtype,
                                       buckets=n, pivot=pivot, full=False))
        k2s = sorted({key for pdev in plans.values()
                      for key in pdev.k2_dense_shapes(getattr(torch,
                                                              dtype))})
        for nf, p, s in k2s:
            if (nf, p, s, dtype, pivot) not in k2_done:
                k2_done.add((nf, p, s, dtype, pivot))
                k2_new.append(check_k2(torch, rng, nf, p, s, dtype,
                                       pivot=pivot, full=False))
        torch.cuda.empty_cache()
    return k3_new, k2_new


STRUCT_PHASES = ("hodlr100", "hss64", "hodlr64")


def make_structured(name):
    """(A, reordered solver, reorder seconds) of a rank-structured phase.
    hodlr100 is bench.py's hodlr100 configuration exactly
    (bench.py:252-300); hss64 and hodlr64 build HSS and HODLR fronts from
    the dense F11 (with hss.sampling on, hodlr100's large fronts are
    sampled instead), GMRES bounded at hodlr100's 200 iterations."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson3d
    CT = st.CompressionType
    base = dict(factor_dtype="float32", refine_dtype="float32",
                rel_tol=1e-6, krylov_solver=st.KrylovSolver.PREC_GMRES)
    if name == "hodlr100":
        nx = 100
        opts = st.SPOptions(compression=CT.ZFP_BLR_HODLR,
                            compression_min_sep_size=256, maxit=200, **base)
        opts.hss.sampling = True
        opts.hodlr_min_sep_size = 2048
        opts.blr.max_rank = 24
        opts.blr.rel_tol = 1e-4
        opts.blr.cb_compression = True
        opts.blr.cb_rank_cap = 12
        opts.hss.leaf_size = 256
        opts.hss.max_rank = 256
        opts.hss.rel_tol = 1e-4
    else:
        nx = 64
        opts = st.SPOptions(
            compression=CT.HSS if name == "hss64" else CT.HODLR,
            compression_min_sep_size=1024, maxit=200, **base)
        opts.hss.leaf_size = 128
        opts.hss.max_rank = 128
        opts.hss.rel_tol = 1e-4
    A = poisson3d(nx)
    s = st.SparseSolver(opts)
    s.set_csr_matrix(A)
    t0 = time.perf_counter()
    check(s.reorder(nx, nx, nx) == st.ReturnCode.SUCCESS, f"{name} reorder")
    return A, s, time.perf_counter() - t0


def structured_checks(torch, rng, plans, k3_done, k2_done, k4_done):
    """K1 at every call of the rank-structured phases ({name: PlanDev}),
    on BLR-compressed children densified as the solver densifies them,
    and every K3, K2 and K4 shape of theirs not checked before: K3/K2 at
    their dense and lossy fronts (f32, pivoting), K2/K4 at hodlr100's BLR
    tile LUs."""
    from strumpack_tpu_torch.ops import panel_lu as PP
    k1 = []
    for name, pdev in plans.items():
        k1 += check_k1(torch, pdev, rng, full=False, label=f"K1-{name}")
    k3, k2 = general_checks(torch, rng, plans, k3_done, k2_done,
                            groups=(("float32", True, tuple(plans)),))
    k4 = []
    for name, pdev in plans.items():
        k2t, k4t = blr_shapes(pdev, torch.float32)
        for (nf, p, s), n in sorted(k2t.items()):
            if (nf, p, s, "float32", True) not in k2_done:
                k2_done.add((nf, p, s, "float32", True))
                k2.append(check_k2(torch, rng, nf, p, s, "float32",
                                   launches=n, full=False))
        for (nf, p, w, row0), n in sorted(k4t.items()):
            if (nf, p, w, row0) not in k4_done:
                k4_done.add((nf, p, w, row0))
                k4.append(check_k4(torch, rng, nf, p, w, row0, "float32",
                                   PP.design(p, w, 4, row0), launches=n))
        torch.cuda.empty_cache()
    return k1, k3, k2, k4


# the complex phases (bench.py:358-410): helmholtz32 exactly, and its
# matrix factored exactly in native complex64 and complex128
COMPLEX_PHASES = ("helmholtz32", "helm32_c64", "helm32_c128")
# chunked64's working-set cap: exact64's seven top levels chunk (16
# buckets), none of them on the K3 or K2 routes
CHUNK_GB = "0.5"


def make_complex(name, nx=32):
    """(A, reordered solver, reorder seconds, right-hand side) of a
    complex phase.  helmholtz32 is bench.py's configuration exactly
    (helmholtz3d(32, k0=10) in complex64 through complex_via_real, HODBF
    fronts for separators >= 512 with leaf 128, rank 64 and tolerance
    1e-4, preconditioned GMRES to 1e-4); helm32_c64 and helm32_c128 factor
    the same matrix exactly in native complex64 (refinement to 1e-5) and
    complex128.  The right-hand side is A x for x complex normal from
    default_rng(0), as bench.py's."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import helmholtz3d
    if name == "helmholtz32":
        dt = "complex64"
        opts = st.SPOptions(factor_dtype=dt, refine_dtype=dt,
                            krylov_solver=st.KrylovSolver.PREC_GMRES,
                            rel_tol=1e-4,
                            compression=st.CompressionType.HODBF,
                            compression_min_sep_size=512,
                            complex_via_real=True)
        opts.hss.leaf_size = 128
        opts.hss.max_rank = 64
        opts.hss.rel_tol = 1e-4
    else:
        dt = "complex64" if name == "helm32_c64" else "complex128"
        opts = st.SPOptions(factor_dtype=dt, refine_dtype=dt,
                            krylov_solver=st.KrylovSolver.REFINE, nd_leaf=16)
        if dt == "complex64":
            opts.rel_tol = 1e-5
    A = helmholtz3d(nx, k0=10.0, dtype=np.dtype(dt))
    s = st.SparseSolver(opts)
    s.set_csr_matrix(A)
    t0 = time.perf_counter()
    check(s.reorder(nx, nx, nx) == st.ReturnCode.SUCCESS, f"{name} reorder")
    t = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(A.n)
         + 1j * rng.standard_normal(A.n)).astype(np.dtype(dt))
    return A, s, t, A.spmv(x)


def compare_factors(torch, ref, fac, plan):
    """The dense factors (lu, perm, L21, U12) of ``fac`` against ``ref``'s
    (the same matrix and plan but for chunks): per bucket whether they are
    bit-exact, and the largest difference relative to the largest entry.
    Returns (record, the K3/K2-routed buckets all bit-exact)."""
    from strumpack_tpu_torch.ops import front_lu as FL
    exact = differ = 0
    worst = 0.0
    kernel_exact = True
    for key, lu in ref.tree["lu"].items():
        li, bi = map(int, key.split(","))
        bp = plan.levels[li][bi]
        same, rel = True, 0.0
        for name in ("lu", "perm", "L21", "U12"):
            a, b = ref.tree[name][key], fac.tree[name][key]
            if torch.equal(a, b):
                continue
            same = False
            d = float((a.double() - b.double()).abs().max())
            rel = max(rel, d / max(float(a.double().abs().max()), 1e-300))
        exact += same
        differ += not same
        worst = max(worst, rel)
        kernel = (FL.use_cross(bp.s_pad, bp.p, torch.float32)
                  or FL.k2_holds(bp.p, torch.float32))
        if kernel and bp.s_pad and not same:
            kernel_exact = False
    return dict(buckets_bit_exact=exact, buckets_differing=differ,
                max_rel_diff=worst), kernel_exact


def plan_launches(pdev, dtype):
    """Kernel wrapper -> the plan's launches of one factorization in
    ``dtype``."""
    return dict(extend_add=pdev.ea_launches(),
                front_lu_cross=pdev.k3_buckets(dtype),
                small_lu=pdev.k2_launches(dtype),
                panel_lu=pdev.k4_launches(dtype))


def run_solver(torch, name, A, s, t_reorder, seed, res_tol=None,
               scaled_tol=None, memory=False, profile=False,
               launched=("extend_add", "front_lu_cross"), peak_check=True,
               k4_design=None, steady=3, nopivot=False, x0_check=False,
               spd=False, refresh=False, b=None):
    """Factor and solve once with the launch counters zeroed, check the
    counts against the plan and the result against the limits, then time
    ``steady`` factor + solve pairs.  ``launched``: the kernels this path
    must have launched at least once; ``k4_design``: the K4 design every
    K4 launch must have taken; ``nopivot``: every K3 and K2 launch without
    pivoting; ``x0_check``: a second solve from the first solution takes
    no more iterations; ``spd``: the inertia is (n, 0, 0) and exact;
    ``refresh``: each steady factorization follows update_matrix_values
    (the same values), as a new matrix of the same pattern would;
    ``profile`` "factor" profiles the factorization alone
    (``device_groups``), "steady" the steady factorization itself (its
    profiled wall is the steady time), "svd" times the steady
    factorization's SVDs by events (``svd_events``); ``b``: the right-hand side
    (default: A times a normal vector from ``seed``)."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.frontal import numeric
    plan, pdev = s.plan, s.pdev
    nb = sum(len(lvl) for lvl in pdev.levels)
    calls, empty_calls = pdev.factor_calls()
    rng = np.random.default_rng(seed)
    if b is None:
        b = A.spmv(rng.standard_normal(A.n))
    if memory:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    check(s.factor() == st.ReturnCode.SUCCESS, f"{name} factor")
    t_first = time.perf_counter() - t0
    passes = s.factor_passes
    if memory:
        peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    x, rc = s.solve(b)
    t_solve = time.perf_counter() - t0
    counts = read_counts()
    want = plan_launches(pdev, getattr(torch, s.opts.factor_dtype))
    for k, n in want.items():
        check(counts[k] == n * passes,
              f"{name}: {k} launches {counts[k]} == plan {n} x {passes}")
    for k in launched:
        check(counts[k] > 0, f"{name}: {k} launched")
    if k4_design:
        check(counts["panel_lu_designs"][k4_design] == counts["panel_lu"],
              f"{name}: every K4 launch on the {k4_design} design")
    check(sum(counts["routes"].values()) == calls * passes,
          f"{name}: every bucket (every chunk) routed")
    check(counts["routes"]["empty"] == empty_calls * passes,
          f"{name}: every empty-separator bucket passed on unfactored")
    if nopivot:
        for k in ("front_lu_cross", "small_lu"):
            check(counts[k + "_modes"]["nopivot"] == counts[k],
                  f"{name}: every {k} launch without pivoting")
    check(rc == st.ReturnCode.SUCCESS, f"{name}: solve returned {rc}")
    check(bool(np.isfinite(x).all()) and x.shape == (A.n,),
          f"{name}: finite solution of shape ({A.n},)")
    x64 = np.asarray(x, np.complex128 if np.iscomplexobj(x) else np.float64)
    res = float(np.linalg.norm(b - A.spmv(x64)) / np.linalg.norm(b))
    scaled = A.max_scaled_residual(x64, b)
    if res_tol is not None:
        check(res <= res_tol, f"{name}: host relative residual {res:.3g}")
    if scaled_tol is not None:
        check(scaled <= scaled_tol, f"{name}: max scaled residual {scaled:.3g}")
    its = s.Krylov_iterations()
    extra = {}
    if x0_check:
        _, rc0 = s.solve(b, x0=x)
        extra["its_from_x0"] = s.Krylov_iterations()
        check(rc0 == st.ReturnCode.SUCCESS and extra["its_from_x0"] <= its,
              f"{name}: from x0 = x SUCCESS in {extra['its_from_x0']} <= "
              f"{its} iterations")
    if spd:
        inertia = s.inertia()
        extra["inertia"] = inertia[:3] + (inertia[3].name,)
        check(inertia == (A.n, 0, 0, st.ReturnCode.SUCCESS),
              f"{name}: inertia {inertia}")
    # steady state: the same plan factored and solved again
    steady_times, steady_solve = [], []
    profiled = None
    for _ in range(steady):
        if refresh:
            s.update_matrix_values(A)
        s._factored = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile == "steady":
            # the steady factorization itself under the profiler (its wall
            # includes the profiler's cost): a factorization of minutes is
            # not run twice
            profiled = device_groups(torch, s.factor)
        elif profile == "svd":
            profiled = svd_events(torch, s.factor)
        else:
            s.factor()
        steady_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        s.solve(b)
        steady_solve.append(time.perf_counter() - t0)
    t_steady = float(np.median(steady_times))
    rec = dict(phase=name, n=A.n, buckets=nb, levels=plan.n_levels,
               empty_buckets=pdev.empty_buckets(),
               chunked_buckets=pdev.chunked_buckets(),
               ordering=s.opts.reordering_method.name, plan_launches=want,
               factor_passes=passes, launches=counts,
               factor_nnz=plan.factor_nnz, factor_flops=plan.factor_flops,
               reorder_s=t_reorder, factor_first_s=t_first,
               factor_steady_s=t_steady, factor_steady_all_s=steady_times,
               factor_gflops=plan.factor_flops / t_steady / 1e9,
               solve_first_s=t_solve,
               solve_steady_s=float(np.median(steady_solve)),
               its=its, achieved_rtol=s.achieved_rtol,
               host_rel_residual=res, max_scaled_residual=scaled, **extra)
    if "matching" in s.times:
        rec["matching_s"] = s.times["matching"]
    if s.opts.compression != st.CompressionType.NONE:
        itemsize = np.dtype(s.opts.factor_dtype).itemsize
        rec.update(kinds=pdev.kinds(), max_rank=s.fac.max_rank(),
                   structured_max_rank=s.fac.structured_max_rank(),
                   effective_factor_flops=s.fac.effective_factor_flops(),
                   factor_bytes_effective=s.fac.factor_memory(),
                   factor_bytes_allocated=s.fac.factor_memory(False),
                   dense_factor_bytes=plan.factor_nnz * itemsize)
    if memory:
        itemsize = np.dtype(s.opts.factor_dtype).itemsize
        rec["peak_bytes"] = int(peak)
        rec["factor_peak_bytes_model"] = numeric.factor_peak_bytes(
            pdev, itemsize)
        rec["factor_bytes"] = s.fac.factor_memory()
        if peak_check:
            # the analytic model is the capacity planner's upper bound
            check(peak <= rec["factor_peak_bytes_model"],
                  f"{name}: peak {peak} bytes within the factor_peak_bytes "
                  f"model's {rec['factor_peak_bytes_model']}")
    if profile == "factor":
        # the rank-structured phases: the factorization alone, from the
        # profiler's raw events
        s._factored = False
        rec["profile"] = device_groups(torch, s.factor)
    elif profile == "steady" and profiled:
        rec["profile"] = profiled
        rec["factor_steady_profiled"] = True
        rec["factor_steady_s"] = profiled["wall_ms"] / 1e3
    elif profile == "svd":
        rec["svd"] = profiled
        rec["factor_steady_s"] = profiled["wall_s"]
    elif profile:
        rec["profile"] = profile_factor(torch, s, b)
    print(name, json.dumps(rec), flush=True)
    return rec


# profiler rows by kernel name, in this order (first match wins)
KERNEL_GROUPS = (
    ("K1 extend_add", ("extend_add_bucket_kernel",)),
    ("K3 lu_cross", ("lu_cross_kernel",)),
    ("K2 small_lu", ("small_lu_kernel",)),
    ("K4 panel_lu", ("panel_lu_reg", "panel_lu_global")),
    ("library LU (getrf, pivots)", ("getrf", "getf2", "laswp", "swap",
                                    "pivinfo", "computecolumn",
                                    "displace_pointers", "iamax")),
    ("library trsm", ("trsm",)),
    ("GEMM (Schur, solve)", ("gemm", "xmma", "cutlass")),
)
PROFILER_OVERHEAD = ("Activity Buffer Request", "Buffer Flush")
# profiler ranges of the port whose kernels are summed apart (a kernel
# counts in every range around it): RRQR tile compression, CB
# compression, the HSS ULV and HODLR SMW factorizations, and the bucket
# steps by front kind (numeric._kind)
RANGE_GROUPS = ("rrqr", "cb_compress", "hss_ulv", "hodlr_smw",
                "hodbf_factor", "front:hss_sample", "front:hss",
                "front:hodlr", "front:hodbf", "front:blr", "front:lossy",
                "front:dense", "front:empty")


def _inside(ev, name):
    """Whether a profiler event runs inside a range called ``name``."""
    p = ev.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def profile_factor(torch, s, b):
    """Device time by kernel group over one steady factor + solve
    (torch.profiler over CUPTI), and the device's busy share of the wall
    time (kernel time summed, so overlapping kernels count twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s._factored = False
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.factor()
        s.solve(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    rrqr_ms = span_ms = 0.0
    t0 = time.perf_counter()
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if ev.key == "rrqr":
            # the range around ops/rrqr.rrqr: its device row is the span
            # of the device timeline inside the range, idle gaps included
            span_ms = max(span_ms, dev / 1e3)
        elif ev.key in RANGE_GROUPS:
            # the other port ranges' rows are spans too, not kernels
            continue
        elif (dev > 0 and ev.device_type == DeviceType.CUDA
                and ev.key not in PROFILER_OVERHEAD):
            rows.append((dev / 1e3, ev.count, ev.key))
    # the RRQR group: kernels launched by ops inside the "rrqr" range
    for ev in prof.events():
        if ev.kernels and _inside(ev, "rrqr"):
            rrqr_ms += sum(k.duration for k in ev.kernels) / 1e3
    print(f"profile: trace read in {time.perf_counter() - t0:.1f} s")
    if not rows:
        print("profile: no device time in the trace (not measured)")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (assembly, gathers, copies, elementwise)"] = 0.0
    for ms, _, key in rows:
        name = next((g for g, pats in KERNEL_GROUPS
                     if any(pt in key for pt in pats)),
                    "other (assembly, gathers, copies, elementwise)")
        groups[name] += ms
    print(f"profile: factor+solve wall {wall * 1e3:.1f} ms, kernels "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall)")
    for name, ms in groups.items():
        print(f"profile: group {ms:9.2f} ms {100 * ms / busy:5.1f}%  {name}")
    if rrqr_ms:
        print(f"profile: group {rrqr_ms:9.2f} ms {100 * rrqr_ms / busy:5.1f}%"
              "  RRQR tile compression (its kernels, also counted above); "
              f"device timeline inside it {span_ms:.1f} ms")
    for ms, count, key in rows[:12]:
        print(f"profile: {ms:9.2f} ms {count:6d}x {key[:90]}")
    return dict(wall_ms=wall * 1e3, kernel_ms=busy, groups=groups,
                rrqr_ms=rrqr_ms, rrqr_span_ms=span_ms)


# the rank-structured phases add the dense factorizations of the
# structured fronts to the groups
STRUCT_KERNEL_GROUPS = KERNEL_GROUPS + (
    ("library SVD", ("gesvd", "svd_")),
    ("library QR", ("geqr", "larf", "orgqr", "ormqr")),
)


def svd_events(torch, fn):
    """Run ``fn`` with every truncated-basis SVD of the structured modules
    (``structured/hss._svd``: the QR reduction and cuSOLVER's SVD) timed
    by CUDA events: a light stand-in for ``device_groups`` where a
    factorization launches millions of kernels (helmholtz32's 7.46
    million took minutes to trace and read).  Returns the wall seconds
    and the SVDs' device ms, calls and matrices."""
    from strumpack_tpu_torch.structured import hss
    orig = hss._svd
    recs = []

    def timed(X):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(X)
        b.record()
        recs.append((a, b, int(np.prod(X.shape[:-2]))))
        return out
    hss._svd = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        hss._svd = orig
    ms = sum(a.elapsed_time(b) for a, b, _ in recs)
    out = dict(wall_s=wall, svd_ms=ms, svd_calls=len(recs),
               svd_matrices=sum(n for _, _, n in recs),
               svd_share=ms / max(wall * 1e3, 1e-9))
    print(f"svd: {ms:.1f} ms of SVD (events) in {len(recs)} calls, "
          f"{out['svd_matrices']} matrices, {100 * out['svd_share']:.1f}% "
          f"of the {wall:.2f} s wall", flush=True)
    return out


def device_groups(torch, fn):
    """Device time of one call of ``fn`` by kernel group and by port range
    (RANGE_GROUPS), read from the profiler's raw events: hodlr100's factor
    holds more than half a million kernels, and the profiler's event tree
    of its factor and solve took minutes to read on the card host.  A
    kernel counts in a range when the op that launched it ran inside the
    range; the ranges' own device rows are left out."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    names = set(RANGE_GROUPS) | {"rrqr"}
    spans = {n: [] for n in names}
    launched = {}
    kernels = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in names and name not in PROFILER_OVERHEAD:
                kernels.append((name, e.duration_ns(),
                                e.linked_correlation_id()))
        elif name in names:
            spans[name].append((e.start_ns(), e.end_ns()))
        elif e.linked_correlation_id() == 0 and e.correlation_id():
            launched[e.correlation_id()] = e.start_ns()
    starts = {}
    for n in names:
        spans[n].sort()
        starts[n] = [a for a, _ in spans[n]]
    groups = {g: 0.0 for g, _ in STRUCT_KERNEL_GROUPS}
    other = "other (assembly, gathers, copies, elementwise)"
    groups[other] = 0.0
    ranges = dict.fromkeys(sorted(names), 0.0)
    busy = 0.0
    for name, ns, corr in kernels:
        ms = ns / 1e6
        busy += ms
        g = next((g for g, pats in STRUCT_KERNEL_GROUPS
                  if any(pt in name for pt in pats)), other)
        groups[g] += ms
        ts = launched.get(corr)
        if ts is None:
            continue
        for n in names:
            i = bisect.bisect_right(starts[n], ts) - 1
            if i >= 0 and ts < spans[n][i][1]:
                ranges[n] += ms
    print(f"profile: raw events read in {time.perf_counter() - t0:.1f} s, "
          f"{len(kernels)} kernels")
    print(f"profile: wall {wall * 1e3:.1f} ms, kernels {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of wall)")
    for name, ms in list(groups.items()) + [("range " + k, v)
                                            for k, v in ranges.items()]:
        print(f"profile: {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f}%  "
              f"{name}")
    return dict(wall_ms=wall * 1e3, kernel_ms=busy, groups=groups,
                ranges=ranges, kernels=len(kernels))


def complex_phases(torch, rng, runs, main_run, s64, profile="svd"):
    """Phases 15-17: helmholtz32, helm32_native (with K1's complex
    instantiations at every K1 shape of its plan) and chunked64 against
    exact64's solver ``s64`` and record ``main_run``.  helmholtz32's
    steady factorization is timed with its SVDs by events (``profile``
    "svd") or profiled by kernel group ("steady", ``device_groups``:
    minutes more).  Adds their records to ``runs``; returns K1's complex
    checks."""
    phase("15 helmholtz32")
    A, s, t, b = make_complex("helmholtz32")
    print(f"reorder helmholtz32: {t:.2f} s, n {A.n} (real form {s.A.n}), "
          f"{s.plan.n_levels} levels, buckets {json.dumps(s.pdev.kinds())}, "
          f"factor nnz {s.plan.factor_nnz}", flush=True)
    rec = run_solver(torch, "helmholtz32", A, s, t, seed=0, memory=True,
                     scaled_tol=1e2 * s.opts.rel_tol, steady=1, refresh=True,
                     profile=profile, b=b,
                     launched=("extend_add", "front_lu_cross"))
    hodbf = [dict(level=bp.level, nf=bp.nf, s=bp.s_pad, u=bp.u_pad,
                  bf_D=bp.bf_D, bf_r=bp.bf_r, leaf=bp.hss_leaf,
                  rank=bp.hss_rank, cutoff=bp.bf_cutoff)
             for lvl in s.plan.levels for bp in lvl if bp.hodbf]
    rec["hodbf_buckets"] = hodbf
    print(f"helmholtz32: {len(hodbf)} HODBF buckets {json.dumps(hodbf)}; "
          f"largest butterfly rank {rec['structured_max_rank']}; peak "
          f"{rec['peak_bytes']} bytes against the model's "
          f"{rec['factor_peak_bytes_model']}; factor bytes "
          f"{rec['factor_bytes_effective']} against dense "
          f"{rec['dense_factor_bytes']}; launches {rec['launches']} against "
          f"the plan's {rec['plan_launches']}", flush=True)
    runs["helmholtz32"] = rec
    del A, s
    torch.cuda.empty_cache()

    phase("16 helm32_native")
    k1_cx = []
    for name in COMPLEX_PHASES[1:]:
        A, s, t, b = make_complex(name)
        dt = getattr(torch, s.opts.factor_dtype)
        # K1's complex instantiation at every K1 call of the plan
        k1_cx += check_k1(torch, s.pdev, rng, full=False, dtype=dt,
                          label=f"K1-{name}")
        c64 = name == "helm32_c64"
        runs[name] = run_solver(torch, name, A, s, t, seed=0, b=b,
                                res_tol=1e-4 if c64 else None,
                                scaled_tol=None if c64 else 1e-10,
                                launched=("extend_add",))
        del A, s
        torch.cuda.empty_cache()

    phase("17 chunked64")
    os.environ["STRUMPACK_TPU_CHUNK_GB"] = CHUNK_GB
    try:
        A, s, t = make_solver(64, "float32", 1e-5)
    finally:
        del os.environ["STRUMPACK_TPU_CHUNK_GB"]
    nch = s.pdev.chunked_buckets()
    chunks = [dict(level=bp.level, nf=bp.nf, p=bp.p, s=bp.s_pad,
                   chunks=bp.chunks)
              for lvl in s.plan.levels for bp in lvl if bp.chunks > 1]
    print(f"chunked64: {nch} chunked buckets at {CHUNK_GB} GB: "
          f"{json.dumps(chunks)}", flush=True)
    check(nch >= 1, "chunked64: at least one bucket runs in chunks")
    rec = run_solver(torch, "chunked64", A, s, t, seed=64, res_tol=1e-4,
                     memory=True)
    cmp, kernel_exact = compare_factors(torch, s64.fac, s.fac, s.plan)
    rec["against_exact64"] = cmp
    print(f"chunked64 against exact64: {json.dumps(cmp)}; peak "
          f"{rec['peak_bytes']} bytes against exact64's "
          f"{main_run['peak_bytes']} and the model's "
          f"{rec['factor_peak_bytes_model']}", flush=True)
    check(kernel_exact, "chunked64: the K3/K2-routed buckets' factors "
          "bit-exact against exact64's")
    check(cmp["max_rel_diff"] <= 1e-4, "chunked64: factors equal to "
          f"exact64's to f32 rounding ({cmp['max_rel_diff']:.3g})")
    check(rec["peak_bytes"] < main_run["peak_bytes"],
          "chunked64: peak below exact64's")
    runs["chunked64"] = rec
    del A, s
    torch.cuda.empty_cache()
    return k1_cx



# ---------------------------------------------------------------------------
# phases 18-19: the structured dense facade and kernel ridge regression
# ---------------------------------------------------------------------------

# dense16k: the facade's types at the size its users factor; HODBF, LR and
# BUTTERFLY, bound by cuSOLVER's SVD, on a leading block: HODBF at 2048,
# because at 4096 it took 429.6 s, 99.4% of it in SVDs (PERF.md, PR 8)
DENSE_N = 16384
DENSE_TYPES = (("HSS", 128), ("HODLR", 128), ("BLR", 128), ("BLR", 64),
               ("LOSSY", 128))
DENSE_SVD_TYPES = (("HODBF", 2048), ("LR", 4096), ("BUTTERFLY", 4096))
# kernel100k: examples/kernel_regression_100k.py's configuration
KERNEL_N = 100_000
KERNEL_SMALL = 8192


def gauss_matrix(torch, n, device, seed=0):
    """The Gauss kernel matrix K + 2 I (h = 1) of n 2-D standard-normal
    points from default_rng(seed), in recursive-PCA order (leaf 64),
    float32 on ``device``; the points too."""
    from strumpack_tpu_torch.kernel.kernel import (GaussKernel,
                                                   recursive_pca_order)
    P = np.random.default_rng(seed).standard_normal((n, 2))
    P = P[recursive_pca_order(P)]
    Pt = torch.tensor(P, dtype=torch.float32, device=device)
    A = GaussKernel(h=1.0, lam=2.0, device=device).eval(Pt, Pt)
    A.diagonal().add_(2.0)
    return A


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _norm2(torch, E, iters=30):
    """The spectral norm of a symmetric E by power iteration."""
    v = torch.ones(E.shape[0], dtype=E.dtype, device=E.device)
    for _ in range(iters):
        w = E @ v
        v = w / w.norm()
    return float((E @ v).norm())


def facade_case(torch, A, name, leaf, xv, Ax, b, x_ref, device, gate=True):
    """One StructuredMatrix type on A: build, factor and solve seconds
    (synchronised), rank, memory against the dense count, and the mult
    and solve relative errors against the dense f64 product and solve.
    Gates: both <= 100 x rel_tol; LOSSY's mult at the JAX test's 2e-2 and
    its solve at the perturbation bound of its int8 storage
    (||E||_2 / (2 - ||E||_2) with E = A - stored: K is positive
    semidefinite, so A = K + 2 I has no eigenvalue below 2), plus f32
    rounding, and the solve of its stored matrix within 1e-2."""
    import strumpack_tpu_torch as st
    opts = st.StructuredOptions(type=st.StructuredType[name], leaf_size=leaf)
    tol = 100 * opts.rel_tol
    label = f"{name}" + ("" if leaf == 128 else f"_leaf{leaf}")
    n = A.shape[0]
    _sync(torch, device)
    t0 = time.perf_counter()
    S = st.construct_from_dense(A, opts, device=device)
    _sync(torch, device)
    rec = dict(type=name, leaf=leaf, n=n, build_s=time.perf_counter() - t0,
               rank=S.rank(), memory=S.memory(), dense=n * n)
    rec["mult_err"] = float((S.mult(xv).double() - Ax).norm() / Ax.norm())
    if name not in ("BUTTERFLY", "LR"):
        t0 = time.perf_counter()
        S.factor()
        _sync(torch, device)
        rec["factor_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = S.solve(b)
        _sync(torch, device)
        rec["solve_s"] = time.perf_counter() - t0
        check(tuple(x.shape) == (n,) and bool(torch.isfinite(x).all()),
              f"dense16k {label}: finite solution of shape ({n},)")
        rec["solve_err"] = float((x.double() - x_ref).norm() / x_ref.norm())
    if name == "LOSSY":
        E = (A - S._dense()[:n, :n]).double()
        rec["stored_err_norm2"] = e2 = _norm2(torch, E)
        rec["solve_bound"] = e2 / (2.0 - e2) + 1e-3
        x_st = torch.linalg.solve(A.double() - E, b.double())
        rec["solve_err_stored"] = float((x.double() - x_st).norm()
                                        / x_st.norm())
        del E, x_st
        if gate:
            check(rec["mult_err"] <= 2e-2, f"dense16k {label}: mult error "
                  f"{rec['mult_err']:.3g} <= 2e-2")
            check(rec["solve_err"] <= rec["solve_bound"],
                  f"dense16k {label}: solve error {rec['solve_err']:.3g} "
                  f"within the int8 bound {rec['solve_bound']:.3g}")
            check(rec["solve_err_stored"] <= tol, f"dense16k {label}: "
                  f"solve of the stored matrix {rec['solve_err_stored']:.3g}")
    elif gate:
        check(rec["mult_err"] <= tol, f"dense16k {label}: mult error "
              f"{rec['mult_err']:.3g} <= {tol:.3g}")
        if "solve_err" in rec:
            check(rec["solve_err"] <= tol, f"dense16k {label}: solve error "
                  f"{rec['solve_err']:.3g} <= {tol:.3g}")
    print(f"dense16k {label}", json.dumps(rec), flush=True)
    return rec, S


def dense_phase(torch, rng, runs, k2_done, k4_done, device="cuda",
                n=DENSE_N, types=DENSE_TYPES, svd_types=DENSE_SVD_TYPES):
    """Phase 18, dense16k: the facade's types on the Gauss kernel matrix
    (``gauss_matrix``) at ``n`` (HSS, HODLR, BLR at leaf 128 and 64,
    LOSSY) and on its leading blocks (``svd_types``: HODBF, LR; BUTTERFLY
    mult only, gated on the block's off-diagonal quarter, the HODBF role:
    the 2 I of the diagonal blocks needs full rank in its leaves), the
    SVDs of HODBF and BUTTERFLY timed by events.  The counters are zeroed before
    the BLR runs and read after them; then K2 and K4 at every shape they
    launched that phase 3 did not check.  Adds the record to ``runs``;
    returns the new K2 and K4 checks."""
    from strumpack_tpu_torch.ops import panel_lu as PP
    t0 = time.perf_counter()
    A = gauss_matrix(torch, n, device)
    _sync(torch, device)
    g = np.random.default_rng(1)
    xv = torch.tensor(g.standard_normal(n), dtype=torch.float32,
                      device=device)
    b = torch.tensor(g.standard_normal(n), dtype=torch.float32,
                     device=device)
    A64 = A.double()
    Ax = A64 @ xv.double()
    x_ref = torch.linalg.solve(A64, b.double())
    del A64
    _sync(torch, device)
    print(f"dense16k: K + 2I of {n} points, {A.numel() * 4 / 1e9:.2f} GB; "
          f"the f64 references {time.perf_counter() - t0:.2f} s", flush=True)
    cases = []
    blr_tiles = set()
    reset_counts()
    for name, leaf in types:
        before = read_counts()
        rec, S = facade_case(torch, A, name, leaf, xv, Ax, b, x_ref, device)
        after = read_counts()
        rec["launches"] = {k: after[k] - before[k] for k in _wrappers()}
        if name == "BLR":
            blr_tiles.add(S.t)
            rec["tiles"] = S.t
            key = "small_lu" if S.t <= 64 else "panel_lu"
            # the wrappers count launches of the kernel, not of the plain
            # versions a CPU rehearsal runs
            check(device != "cuda" or rec["launches"][key] == S.mpad // S.t,
                  f"dense16k BLR at tile {S.t}: {key} launched once a "
                  f"diagonal tile ({rec['launches'][key]})")
        cases.append(rec)
        del S
        if device == "cuda":
            torch.cuda.empty_cache()
    counts = read_counts()
    del Ax, x_ref, xv, b
    # the SVD-bound types on leading blocks
    for name, m in svd_types:
        Am = A[:m, :m].contiguous()
        xv, b = (torch.tensor(g.standard_normal(m), dtype=torch.float32,
                              device=device) for _ in range(2))
        Ax = Am.double() @ xv.double()
        x_ref = torch.linalg.solve(Am.double(), b.double())
        timed = {}

        def run(name=name):
            timed["out"] = facade_case(torch, Am, name, 128, xv, Ax, b,
                                       x_ref, device,
                                       gate=name != "BUTTERFLY")
        if device == "cuda" and name != "LR":
            timed["svd"] = svd_events(torch, run)
        else:
            run()
        rec, S = timed["out"]
        if "svd" in timed:
            rec["svd"] = timed["svd"]
        if name == "BUTTERFLY":
            h = m // 2
            B = Am[:h, h:].contiguous()
            rec["offdiag_block"] = facade_case(
                torch, B, name, 128, xv[h:], B.double() @ xv[h:].double(),
                None, None, device)[0]
        cases.append(rec)
        del S, Am
    del A
    # K2 and K4 at the BLR runs' tile-LU shapes not checked in phase 3
    k2_new, k4_new = [], []
    if device == "cuda":
        for t in sorted(blr_tiles):
            if t <= 64 and (1, t, t, "float32", True) not in k2_done:
                k2_new.append(check_k2(torch, rng, 1, t, t, "float32"))
            for jb in range(0, t if t > 64 else 0, PP.PANEL_W):
                w = min(PP.PANEL_W, t - jb)
                if (1, t, w, jb) not in k4_done:
                    k4_new.append(check_k4(
                        torch, rng, 1, t, w, jb, "float32",
                        PP.design(t, w, 4, jb)))
    runs["dense16k"] = dict(phase="dense16k", launches=counts, cases=cases)
    return k2_new, k4_new


def two_moons(n, seed):
    """``tests/test_structured.py``'s two moons: n points a moon, noise
    0.1, shuffled; labels 0 and 1."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, n)
    X1 = np.stack([np.cos(theta), np.sin(theta)], 1) \
        + 0.1 * rng.standard_normal((n, 2))
    X2 = np.stack([1 - np.cos(theta), 0.5 - np.sin(theta)], 1) \
        + 0.1 * rng.standard_normal((n, 2))
    X = np.concatenate([X1, X2])
    y = np.concatenate([np.zeros(n), np.ones(n)])
    idx = rng.permutation(2 * n)
    return X[idx], y[idx]


def kernel_phase(torch, runs, device="cuda", n=KERNEL_N, small=KERNEL_SMALL):
    """Phase 19, kernel100k: examples/kernel_regression_100k.py through
    the port (n points, Gauss h = 1, lambda = 2, matrix-free HSS at leaf
    256, rank 128, tolerance 1e-5, cluster leaf 128; predict 2000), gate
    rel_err < 0.3; then at ``small`` points the ann fit, the HODLR fit
    and the classifier on two moons (``small`` training, 2048 test
    points), gate accuracy > 0.92.  The fit's host seconds (clustering,
    kNN) print apart from the device steps."""
    from strumpack_tpu_torch.kernel.kernel import (GaussKernel,
                                                   KernelRegressionClassifier)
    reset_counts()
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 2))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(2.0 * X[:, 1]) \
        + 0.05 * rng.standard_normal(n)
    recs = {}

    def fit(label, fn, Xf, yf):
        k = GaussKernel(h=1.0, lam=2.0, device=device)
        t0 = time.perf_counter()
        fn(k, Xf, yf)
        _sync(torch, device)
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = k.predict(X[:2000])
        t_pred = time.perf_counter() - t0
        rel = float(np.linalg.norm(p - y[:2000]) / np.linalg.norm(y[:2000]))
        rec = dict(n=len(Xf), fit_s=t_fit, fit_steps_s=dict(k.times),
                   predict_2000_s=t_pred, rel_err=rel,
                   memory_bytes=k._M.memory() * k._M.D.element_size(),
                   dense_bytes=len(Xf) ** 2 * k._M.D.element_size(),
                   max_rank=k._M.max_rank(), weights_device=str(
                       k._weights.device))
        print(f"kernel100k {label}", json.dumps(rec), flush=True)
        check(np.isfinite(p).all() and rel < 0.3,
              f"kernel100k {label}: rel_err {rel:.3g} < 0.3")
        recs[label] = rec
    fit("hss_matrix_free", lambda k, X_, y_: k._fit(
        X_, y_, "hss", leaf_size=256, max_rank=128, rel_tol=1e-5,
        cluster_leaf=128, matrix_free=True), X, y)
    fit("hss_ann", lambda k, X_, y_: k.fit_HSS(X_, y_, compression="ann"),
        X[:small], y[:small])
    fit("hodlr", lambda k, X_, y_: k.fit_HODLR(X_, y_), X[:small], y[:small])
    Xm, ym = two_moons((small + 2048) // 2, seed=5)
    clf = KernelRegressionClassifier(h=0.3, lam=1.0, fmt="hss", leaf_size=64,
                                     rel_tol=1e-6, device=device)
    t0 = time.perf_counter()
    clf.fit(Xm[:small], ym[:small])
    _sync(torch, device)
    t_fit = time.perf_counter() - t0
    acc = clf.score(Xm[small:], ym[small:])
    recs["classifier"] = dict(n=small, test=len(Xm) - small, fit_s=t_fit,
                              fit_steps_s=dict(clf._k.times), accuracy=acc)
    print("kernel100k classifier", json.dumps(recs["classifier"]),
          flush=True)
    check(acc > 0.92, f"kernel100k classifier: accuracy {acc:.3f} > 0.92")
    runs["kernel100k"] = dict(phase="kernel100k", launches=read_counts(),
                              fits=recs)


# ---------------------------------------------------------------------------
# phase 20: the distributed solver (dist64)
# ---------------------------------------------------------------------------

DIST_NX = 64            # exact64's problem
DIST_RANKS = 2          # gloo ranks sharing one card
DIST_TIMEOUT_S = 300    # a collective or a rank that waits longer raises


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def dist_opts():
    """exact64's options (``make_solver(64, "float32", 1e-5)``)."""
    import strumpack_tpu_torch as st
    return st.SPOptions(factor_dtype="float32", refine_dtype="float32",
                        krylov_solver=st.KrylovSolver.REFINE, nd_leaf=16,
                        rel_tol=1e-5)


def front_backward_error(torch, F, out):
    """max over the blocks of a partial factorization (lu, perm, L21, U12,
    CB) of the assembled fronts F: ||P F11 - L U||, ||P F12 - L U12||,
    ||F21 - L21 U||, ||F22 - L21 U12 - CB||, each relative to its block's
    norm (f64)."""
    lu, perm, L21, U12, CB = (x.double() if x.is_floating_point() else x
                              for x in out)
    F = F.double()
    s = lu.shape[1]
    Fp = torch.gather(F[:, :s], 1, perm[:, :, None].expand(-1, -1,
                                                           F.shape[2]))
    L = torch.tril(lu, -1) + torch.eye(s, dtype=lu.dtype, device=lu.device)
    U = torch.triu(lu)
    parts = [(Fp[:, :, :s], L @ U)]
    if F.shape[1] > s:
        parts += [(Fp[:, :, s:], L @ U12), (F[:, s:, :s], L21 @ U),
                  (F[:, s:, s:], L21 @ U12 + CB)]
    return max(float(torch.linalg.norm(a - b) / max(
        float(torch.linalg.norm(a)), 1e-300)) for a, b in parts)


def dist_rank(rank, world, port, q, done, nx, device):
    """One of the gloo ranks of dist64 (b), all on cuda:0: reorder
    exact64's problem, then for the cyclic and the contiguous grid layout
    factor with the launch counters zeroed (counts against this rank's
    share of the plan), solve DIRECT and (cyclic) IR; the grid fronts'
    backward errors against the single-device factorization of the same
    assembled fronts.  Puts (rank, record, this rank's shard factors as
    tensors on ``device``: CUDA tensors travel by IPC handle) on ``q`` and
    keeps them alive until ``done``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul
    from strumpack_tpu_torch.parallel import DistributedSparseSolver
    from strumpack_tpu_torch.parallel import dist as D
    from strumpack_tpu_torch.parallel import spmd
    from strumpack_tpu_torch.sparse.gen import poisson3d
    import strumpack_tpu_torch as st
    use_full_fp32_matmul()
    D.init_process_group("gloo", rank, world, port, timeout_s=DIST_TIMEOUT_S)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("b",))
        A = poisson3d(nx)
        b = A.spmv(np.random.default_rng(64).standard_normal(A.n))
        s = DistributedSparseSolver(mesh, dist_opts(), device=device)
        s.set_csr_matrix(A)
        t0 = time.perf_counter()
        check(s.reorder(nx, nx, nx) == st.ReturnCode.SUCCESS, "reorder")
        rec = dict(rank=rank, reorder_s=time.perf_counter() - t0,
                   modes=s.sp.counts(), report=s.sp.report,
                   bounds={f"{li},{bi}": fb
                           for (li, bi), fb in s.sp.bounds.items()})
        grid_fronts = []
        orig = spmd._grid_factor

        def capture(sp, bd, F, thresh):
            out = orig(sp, bd, F, thresh)
            grid_fronts.append((bd, F.clone(), thresh, out))
            return out
        spmd._grid_factor = capture
        runs = {}
        for layout in ("cyclic", "contiguous"):
            os.environ["STRUMPACK_TPU_CYCLIC"] = \
                "1" if layout == "cyclic" else "0"
            share = s.sp.launch_share(torch.float32)
            s._factored = False
            s.sp.level_bytes = [0] * len(s.sp.level_bytes)
            grid_fronts.clear()
            reset_counts()
            _sync(torch, device)
            g0 = D.all_gather.seconds
            t0 = time.perf_counter()
            s.factor()
            _sync(torch, device)
            t_factor = time.perf_counter() - t0
            counts = read_counts()
            r = dict(share=share, launches=counts, factor_s=t_factor,
                     gather_s=D.all_gather.seconds - g0,
                     level_bytes=list(s.sp.level_bytes),
                     gathered_bytes=sum(s.sp.level_bytes))
            for k, n in share.items():
                check(counts[k] == n, f"dist64 rank {rank} {layout}: {k} "
                      f"launches {counts[k]} == its share {n}")
            check(counts["panel_lu_designs"]["global"] == 0,
                  f"dist64 rank {rank} {layout}: no K4 grid panel on the "
                  "global design")
            solvers = ("DIRECT", "REFINE") if layout == "cyclic" \
                else ("DIRECT",)
            for kind in solvers:
                s.opts.krylov_solver = st.KrylovSolver[kind]
                t0 = time.perf_counter()
                x, rc = s.solve(b)
                t_solve = time.perf_counter() - t0
                x64 = np.asarray(x, np.float64)
                r[kind] = dict(
                    rc=rc.name, solve_s=t_solve,
                    its=s.Krylov_iterations(),
                    host_rel_residual=float(
                        np.linalg.norm(b - A.spmv(x64))
                        / np.linalg.norm(b)),
                    max_scaled_residual=A.max_scaled_residual(x64, b))
            be = []
            for bd, F, thresh, out in grid_fronts:
                ref = numeric._factor_bucket(F.clone(), thresh, bd.bp.s_pad)
                be.append(dict(
                    nf=bd.bp.nf, p=bd.bp.p, s=bd.bp.s_pad,
                    grid=front_backward_error(torch, F, out),
                    single=front_backward_error(torch, F, ref)))
            r["grid_backward_errors"] = be
            grid_fronts.clear()
            runs[layout] = r
        spmd._grid_factor = orig
        os.environ.pop("STRUMPACK_TPU_CYCLIC", None)
        rec["runs"] = runs
        # the last factorization (contiguous layout) holds the same shard
        # factors: exact64's one grid bucket is the root, so no shard
        # front reads a CB the grid layout computed
        shard = {key: [s._tree[name][key] for name in
                       ("lu", "perm", "L21", "U12")]
                 for key in rec["bounds"]}
        q.put((rank, rec, shard))
        if not done.wait(DIST_TIMEOUT_S):
            raise TimeoutError("dist64: the parent did not release the "
                               "shard factors")
        del shard
    finally:
        dist.destroy_process_group()


def shard_against(torch, s64, bounds, shard):
    """A rank's shard-bucket factors (lu, perm, L21, U12 of fronts f0..f1)
    against the same fronts of exact64's: per route (K3/K2 or the
    library), the buckets bit-equal, and the largest difference relative
    to the largest entry; the differing buckets listed."""
    from strumpack_tpu_torch.ops import front_lu as FL
    out = dict(kernel_buckets=0, kernel_bit_equal=0, library_buckets=0,
               library_bit_equal=0, max_rel_diff=0.0, differing=[])
    for key, (f0, f1) in bounds.items():
        li, bi = map(int, key.split(","))
        bp = s64.plan.levels[li][bi]
        route = ("kernel" if FL.use_cross(bp.s_pad, bp.p, torch.float32)
                 or FL.k2_holds(bp.p, torch.float32) else "library")
        same, rel = True, 0.0
        for name, t in zip(("lu", "perm", "L21", "U12"), shard[key]):
            ref = s64.fac.tree[name][key][f0:f1]
            if torch.equal(t, ref):
                continue
            same = False
            d = float((t.double() - ref.double()).abs().max())
            rel = max(rel, d / max(float(ref.double().abs().max()), 1e-300))
        out[route + "_buckets"] += 1
        out[route + "_bit_equal"] += same
        out["max_rel_diff"] = max(out["max_rel_diff"], rel)
        if not same:
            out["differing"].append(dict(key=key, route=route, nf=bp.nf,
                                         p=bp.p, s=bp.s_pad, rel=rel))
    return out


def dist_checks(torch, rng, s64, k3_done, k4_done):
    """K1 at every call of each rank's slices of the shard buckets in
    dist64 (b) (the child CBs whole: they are all-gathered), and K3 and K4
    at the shapes it launches that the checks before did not cover: K3 at
    the slices, K4 at the contiguous grid layout's sub-panels of the grid
    buckets.  Returns (K1, K3, K4 records)."""
    import types
    from strumpack_tpu_torch.ops import front_lu as FL
    from strumpack_tpu_torch.ops import panel_lu as PP
    from strumpack_tpu_torch.parallel import spmd
    from strumpack_tpu_torch.parallel.dist2d import _grid_blk, panel_route
    full = s64.pdev
    k1, k3, k4 = [], [], []
    for r in range(DIST_RANKS):
        sp = spmd.ShardedPlan(full, types.SimpleNamespace(ndev=DIST_RANKS,
                                                          me=r))
        # the plan with this rank's slices in the shard buckets' places
        view = object.__new__(type(full))
        view.levels = [[sp.bucket(li, bi) for bi in range(len(lvl))]
                       for li, lvl in enumerate(full.levels)]
        k1 += check_k1(torch, view, rng, full=False, label=f"K1-dist-rank{r}",
                       calls=[c for c in k1_calls(view)
                              if c[:2] in sp.local], kids=full)
        for (li, bi), lb in sorted(sp.local.items()):
            bp = lb.bp
            if (bp.s_pad and FL.use_cross(bp.s_pad, bp.p, torch.float32)
                    and (bp.nf, bp.p, bp.s_pad, "float32", True)
                    not in k3_done):
                k3_done.add((bp.nf, bp.p, bp.s_pad, "float32", True))
                k3.append(check_k3(torch, rng, bp.nf, bp.p, bp.s_pad,
                                   "float32", full=False))
        for (li, bi), mode in sp.modes.items():
            bp = full.levels[li][bi].bp
            if mode != "grid" or r:
                continue
            w0 = _grid_blk(bp.s_pad)
            for o in range(0, bp.s_pad, w0):
                w = min(w0, bp.s_pad - o)
                rows = bp.p - o
                if panel_route(rows, w, torch.float32) != "k4":
                    continue
                for jb in range(0, w, PP.PANEL_W):
                    ws = min(PP.PANEL_W, w - jb)
                    if (1, rows, ws, jb) in k4_done:
                        continue
                    k4_done.add((1, rows, ws, jb))
                    k4.append(check_k4(torch, rng, 1, rows, ws, jb,
                                       "float32",
                                       PP.design(rows, ws, 4, jb)))
        torch.cuda.empty_cache()
    return k1, k3, k4


def dist_phase(torch, runs, s64, main_run, nx=DIST_NX, device="cuda:0",
               backend="nccl"):
    """Phase 20, dist64: DistributedSparseSolver on exact64's problem.
    (a) one NCCL rank (mesh ('b',) of 1): every bucket repl, factors
    bit-equal to phase 5's, its IR iterations and residual level;
    (b) DIST_RANKS gloo ranks sharing cuda:0 (spawned), DIRECT and IR:
    modes and replicated fraction = choose_modes' report, shard-front
    factors bit-equal to phase 5's where K3 or K2 factors them (the
    library route's batched LU picks its algorithm by batch count: to f32
    rounding, as chunked64's chunks), grid fronts' backward errors within
    10x the single-device factorization's of the same fronts, residuals
    at exact64's level, K1-K4 launches = each rank's share of the plan.
    These times measure ranks sharing one card, not scaling.  (``device``
    and ``backend``: the CPU and gloo rehearse the phase.)"""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.parallel import DistributedSparseSolver
    from strumpack_tpu_torch.parallel import dist as D
    from strumpack_tpu_torch.parallel import spmd
    from strumpack_tpu_torch.sparse.gen import poisson3d
    t_phase = time.perf_counter()
    A = poisson3d(nx)
    b = A.spmv(np.random.default_rng(64).standard_normal(A.n))
    # (a) one NCCL rank
    D.init_process_group(backend, 0, 1, _free_port(),
                         timeout_s=DIST_TIMEOUT_S)
    try:
        mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (1,),
                                mesh_dim_names=("b",))
        s = DistributedSparseSolver(mesh, dist_opts(), device=device)
        s.set_csr_matrix(A)
        t0 = time.perf_counter()
        check(s.reorder(nx, nx, nx) == st.ReturnCode.SUCCESS, "reorder")
        t_reorder = time.perf_counter() - t0
        counts_modes = s.sp.counts()
        check(counts_modes["repl"] == sum(len(lv) for lv in s.plan.levels),
              f"dist64 (a): every bucket repl on one rank {counts_modes}")
        reset_counts()
        _sync(torch, device)
        t0 = time.perf_counter()
        s.factor()
        _sync(torch, device)
        t_factor = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, rc = s.solve(b)
        t_solve = time.perf_counter() - t0
        counts = read_counts()
        same = all(torch.equal(s._tree[name][key], s64.fac.tree[name][key])
                   for name in ("lu", "perm", "L21", "U12")
                   for key in s64.fac.tree[name])
        x64 = np.asarray(x, np.float64)
        rec_a = dict(ranks=1, backend=backend, reorder_s=t_reorder,
                     factor_s=t_factor, solve_s=t_solve, rc=rc.name,
                     its=s.Krylov_iterations(), factors_bit_equal=same,
                     host_rel_residual=float(np.linalg.norm(
                         b - A.spmv(x64)) / np.linalg.norm(b)),
                     max_scaled_residual=A.max_scaled_residual(x64, b),
                     launches=counts)
        print("dist64 (a)", json.dumps(rec_a), flush=True)
        check(same, "dist64 (a): factors bit-equal to exact64's")
        check(rc == st.ReturnCode.SUCCESS
              and rec_a["its"] == main_run["its"],
              f"dist64 (a): {rec_a['its']} IR iterations == exact64's "
              f"{main_run['its']}")
        check(rec_a["max_scaled_residual"]
              <= 10 * main_run["max_scaled_residual"],
              "dist64 (a): max scaled residual at exact64's level")
        for k, n in plan_launches(s.pdev, torch.float32).items():
            check(counts[k] == n, f"dist64 (a): {k} launches {counts[k]} "
                  f"== plan {n}")
        del s
    finally:
        dist.destroy_process_group()
    # (b) DIST_RANKS gloo ranks on this card
    ctx = mp.get_context("spawn")
    q, done = ctx.Queue(), ctx.Event()
    pc = mp.start_processes(dist_rank, args=(DIST_RANKS, _free_port(), q,
                                             done, nx, device),
                            nprocs=DIST_RANKS, join=False,
                            start_method="spawn")
    got = {}
    deadline = time.perf_counter() + 2 * DIST_TIMEOUT_S
    try:
        while len(got) < DIST_RANKS:
            check(time.perf_counter() < deadline, "dist64: ranks in time")
            try:
                rank, rec, shard = q.get(timeout=5)
                got[rank] = (rec, shard)
            except Exception:       # queue.Empty: see whether a rank died
                pc.join(timeout=0)
        modes, report = spmd.choose_modes(s64.pdev, (DIST_RANKS,))
        want_counts = dict.fromkeys(("shard", "grid", "repl"), 0)
        for m in modes.values():
            want_counts[m] += 1
        recs = []
        for rank in range(DIST_RANKS):
            rec, shard = got[rank]
            check(rec["modes"] == want_counts
                  and rec["report"]["replicated_frac"]
                  == report["replicated_frac"],
                  f"dist64 rank {rank}: modes {rec['modes']} and report "
                  "== choose_modes'")
            rec["shard"] = shard_against(torch, s64, rec.pop("bounds"),
                                         shard)
            for layout, r in rec["runs"].items():
                for kind in ("DIRECT", "REFINE"):
                    if kind not in r:
                        continue
                    v = r[kind]
                    check(v["rc"] == "SUCCESS"
                          and v["host_rel_residual"] <= 1e-4,
                          f"dist64 rank {rank} {layout} {kind}: rc "
                          f"{v['rc']}, host residual "
                          f"{v['host_rel_residual']:.3g}")
                    check(v["max_scaled_residual"]
                          <= 10 * main_run["max_scaled_residual"],
                          f"dist64 rank {rank} {layout} {kind}: max scaled "
                          f"residual {v['max_scaled_residual']:.3g} at "
                          "exact64's level")
                for e in r["grid_backward_errors"]:
                    check(e["grid"] <= 10 * e["single"] + 1e-7,
                          f"dist64 rank {rank} {layout}: grid front "
                          f"backward error {e}")
            recs.append(rec)
            print(f"dist64 (b) rank {rank}", json.dumps(rec), flush=True)
        del shard, got
        for rank in range(DIST_RANKS):
            sh = recs[rank]["shard"]
            check(sh["kernel_bit_equal"] == sh["kernel_buckets"],
                  f"dist64 rank {rank}: the K3/K2-routed shard fronts' "
                  f"factors bit-equal to exact64's ({sh})")
            check(sh["max_rel_diff"] <= 1e-4,
                  f"dist64 rank {rank}: the shard fronts' factors equal to "
                  f"exact64's to f32 rounding ({sh['max_rel_diff']:.3g})")
    finally:
        done.set()
    # join() waits for one rank at a time: True once all have ended
    end = time.perf_counter() + DIST_TIMEOUT_S
    while not pc.join(timeout=max(end - time.perf_counter(), 1)):
        if time.perf_counter() > end:
            for proc in pc.processes:
                proc.terminate()
            check(False, "dist64: the ranks ended")
    rec = dict(phase="dist64", a=rec_a, b=recs,
               seconds=time.perf_counter() - t_phase)
    runs["dist64_nccl1"] = dict(phase="dist64_nccl1",
                                launches=rec_a["launches"])
    for r in recs:
        runs[f"dist64_rank{r['rank']}"] = dict(
            phase=f"dist64_rank{r['rank']}",
            launches={k: sum(v["launches"][k] for v in r["runs"].values())
                      for k in ("extend_add", "front_lu_cross", "small_lu",
                                "panel_lu")})
    print(f"dist64: {rec['seconds']:.1f} s (ranks sharing one card: not a "
          "scaling measurement)", flush=True)
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from strumpack_tpu_torch.ops import _build
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    use_full_fp32_matmul()

    phase("2 build")
    t0 = time.perf_counter()
    log = {}
    secs = _build.build(verbose=True, log=log)
    print(f"build {time.perf_counter() - t0:.2f} s {json.dumps(secs)}",
          flush=True)
    # K2, K3 and K4 hold rows in registers: no instantiation may spill
    ptxas = ptxas_report(log)
    for kname, regs, stack, sst, sld in ptxas:
        print(f"ptxas {kname[:60]:60s} {regs:4d} registers, stack {stack}, "
              f"spill {sst}/{sld}")
        check(stack == sst == sld == 0, f"{kname}: no stack or spill")
    if not ptxas:
        print("ptxas: K2/K3/K4 not rebuilt in this run, spill check not made")
    # the routing (ops/front_lu.py) keeps a copy of what K3 holds
    from strumpack_tpu_torch.ops import front_lu as FL
    drift = FL.k3_capacity_drift()
    check(not drift, f"K3's capacity in front_lu.py matches front_lu.cu: "
          f"{len(drift)} differ, e.g. {drift[:3]}")
    print("K3 capacity: front_lu.py agrees with front_lu.cu", flush=True)

    phase("3 kernels against their plain versions")
    A64, s64, t_reorder64 = make_solver(64, "float32", 1e-5)
    A32, s32, t_reorder32 = make_solver(32, "float32", 1e-5)
    Ad, sd, t_reorderd = make_solver(32, "float64", None)
    A50, s50, t_reorder50 = make_solver(50, "float32", 1e-4, blr=True)
    print(f"reorder s: exact64 {t_reorder64:.2f}, exact32 {t_reorder32:.2f}, "
          f"f64_32 {t_reorderd:.2f}, blr50 {t_reorder50:.2f}", flush=True)
    general = {}
    for name in GENERAL_PHASES:
        general[name] = make_general(name)
        A_, s_, t_ = general[name]
        print(f"reorder {name}: {t_:.2f} s, n {A_.n}, "
              f"{s_.plan.n_levels} levels, "
              f"{sum(len(lvl) for lvl in s_.pdev.levels)} buckets "
              f"({s_.pdev.empty_buckets()} of empty separators), "
              f"factor nnz {s_.plan.factor_nnz}"
              + (f", matching {s_.times['matching']:.2f} s"
                 if "matching" in s_.times else ""), flush=True)
    rng = np.random.default_rng(20261016)
    # K1 at every call of exact64's factorization, and the three pairs
    # earlier designs timed one launch each, as tables of one
    k1 = check_k1(torch, s64.pdev, rng, label="K1-exact64")
    k1_pairs = check_k1(torch, s64.pdev, rng, calls=k1_old_picks(s64.pdev),
                        one_pair=True, label="K1-exact64-pairs")
    # and at every call of the general-input phases, in their factor dtype
    k1_gen = []
    for name, (_, s_, _) in general.items():
        k1_gen += check_k1(torch, s_.pdev, rng, full=False,
                           dtype=getattr(torch, s_.opts.factor_dtype),
                           label=f"K1-{name}")
    # K3 at every shape a path launches and at every dense library shape
    # of p > 64, s <= 128 it can hold (the routing table), f32 on the f32
    # paths, f64 on f64_32's
    k3, k3_refused = [], []
    for dtype, plans in (("float32", dict(exact64=s64.pdev, exact32=s32.pdev,
                                          blr50=s50.pdev)),
                         ("float64", dict(f64_32=sd.pdev))):
        shapes, refused = k3_shapes(plans, dtype)
        k3 += [check_k3(torch, rng, nf, p, s, dtype, buckets=n)
               for (nf, p, s), n in sorted(shapes.items())]
        k3_refused += [dict(nf=nf, p=p, s=s, dtype=dtype, buckets=n)
                       for (nf, p, s), n in sorted(refused.items())]
        torch.cuda.empty_cache()
    print("K3-refused", json.dumps(k3_refused), flush=True)
    # K2 and K4 at every shape one blr50 factorization launches, then the
    # shapes of the earlier checks and the other designs
    k2_blr, k4_blr = blr_shapes(s50.pdev, torch.float32)
    print(f"blr50 K2 shapes {sorted(k2_blr.items())}", flush=True)
    print(f"blr50 K4 shapes {sorted(k4_blr.items())}", flush=True)
    k2 = [check_k2(torch, rng, nf, p, s, "float32", launches=n)
          for (nf, p, s), n in sorted(k2_blr.items())]
    k2 += [check_k2(torch, rng, 16, 64, 64, "float32", pivot=False),
           check_k2(torch, rng, 1, 64, 64, "float32"),
           check_k2(torch, rng, 256, 32, 32, "float32"),
           check_k2(torch, rng, 2048, 52, 4, "float64")]
    if (2048, 52, 4) not in k2_blr:
        k2.append(check_k2(torch, rng, 2048, 52, 4, "float32"))
    if (16, 64, 64) not in k2_blr:
        k2.append(check_k2(torch, rng, 16, 64, 64, "float32"))
    k4 = [check_k4(torch, rng, nf, p, w, row0, "float32", ("cta", 1),
                   launches=n)
          for (nf, p, w, row0), n in sorted(k4_blr.items())]
    k4 += [check_k4(torch, rng, *shape, want)
           for shape, want in (
               ((64, 96, 96, 0, "float32"), ("cta", 1)),
               ((8, 256, 128, 0, "float32"), ("cta", 1)),
               ((8, 256, 128, 128, "float32"), ("cta", 1)),
               ((16, 192, 64, 128, "float32"), ("cta", 1)),
               ((8, 256, 128, 0, "float64"), ("cluster", 2)),
               ((4, 2048, 128, 0, "float32"), ("cluster", 8)),
               ((2, 4096, 128, 0, "float32"), ("cluster", 16)),
               ((1, 8192, 128, 0, "float32"), ("global", 0)))]
    blocked = check_blocked(torch, rng, 8, 256, "float32")
    torch.cuda.empty_cache()
    # K3 and K2 at the general-input phases' shapes not checked above: K3
    # and K2 without pivoting at every shape spd64 and aniso24_nopivot
    # launch, with pivoting at nd64's, metis64's, mc64's and the
    # orderings' new shapes
    k3_gen, k2_gen = general_checks(
        torch, rng, {n: g[1].pdev for n, g in general.items()},
        {(r["nf"], r["p"], r["s"], r["dtype"], True) for r in k3},
        {(r["nf"], r["p"], r["s"], r["dtype"], r["pivot"]) for r in k2})
    # every K1-K4 shape of the rank-structured phases not checked above
    struct = {}
    for name in STRUCT_PHASES:
        struct[name] = make_structured(name)
        A_, s_, t_ = struct[name]
        print(f"reorder {name}: {t_:.2f} s, n {A_.n}, {s_.plan.n_levels} "
              f"levels, buckets {json.dumps(s_.pdev.kinds())}, "
              f"factor nnz {s_.plan.factor_nnz}", flush=True)
    k3_done = ({(r["nf"], r["p"], r["s"], r["dtype"], True) for r in k3}
               | {(r["nf"], r["p"], r["s"], r["dtype"], r["pivot"])
                  for r in k3_gen})
    k2_done = {(r["nf"], r["p"], r["s"], r["dtype"], r["pivot"])
               for r in k2 + k2_gen}
    k4_done = {(r["nf"], r["p"], r["w"], r["row0"]) for r in k4
               if r["dtype"] == "float32"}
    k1_st, k3_st, k2_st, k4_st = structured_checks(
        torch, rng, {n: g[1].pdev for n, g in struct.items()}, k3_done,
        k2_done, k4_done)

    phase("4 exact32")
    exact32_run = run_solver(torch, "exact32", A32, s32, t_reorder32,
                             seed=32, res_tol=1e-4, profile=True)
    del A32, s32

    phase("5 exact64")
    torch.cuda.empty_cache()
    main_run = run_solver(torch, "exact64", A64, s64, t_reorder64, seed=64,
                          res_tol=1e-4, memory=True, profile=True)
    # exact64's solver stays for chunked64's comparison (phase 17)
    torch.cuda.empty_cache()

    phase("6 f64")
    f64_run = run_solver(torch, "f64_32", Ad, sd, t_reorderd, seed=3,
                         scaled_tol=1e-10)
    del Ad, sd
    torch.cuda.empty_cache()

    phase("7 blr50")
    blr_run = run_solver(torch, "blr50", A50, s50, t_reorder50, seed=50,
                         res_tol=1e-3, memory=True,
                         launched=tuple(_wrappers()), peak_check=False,
                         k4_design="cta")
    del A50, s50
    torch.cuda.empty_cache()

    runs = {r["phase"]: r for r in (exact32_run, main_run, f64_run,
                                    blr_run)}

    def general_run(name, **kw):
        A, s, t = general.pop(name)
        rec = run_solver(torch, name, A, s, t, seed=len(name), **kw)
        runs[name] = rec
        torch.cuda.empty_cache()
        return A, s, rec

    phase("8 nd64")
    for name in ("nd64", "metis64"):
        _, _, rec = general_run(name, res_tol=1e-4, x0_check=True)
        print(f"{name}: factor nnz {rec['factor_nnz']} against exact64's "
              f"geometric {main_run['factor_nnz']} "
              f"({rec['factor_nnz'] / main_run['factor_nnz']:.3f}x)",
              flush=True)

    phase("9 spd64")
    general_run("spd64", scaled_tol=1e-10, memory=True, nopivot=True,
                spd=True)

    phase("10 mc64")
    A, s, rec = general_run("mc64", scaled_tol=1e-10)
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 1e-3 * np.random.default_rng(7)
                         .standard_normal(A2.nnz))
    s.update_matrix_values(A2)
    b2 = A2.spmv(np.random.default_rng(8).standard_normal(A2.n))
    x2, rc2 = s.solve(b2)
    upd = dict(rc=rc2.name, its=s.Krylov_iterations(),
               max_scaled_residual=A2.max_scaled_residual(x2, b2),
               pivot_growth=s.pivot_growth(), subnormals=s.subnormals())
    print("mc64 after update_matrix_values", json.dumps(upd), flush=True)
    check(rc2.name == "SUCCESS" and upd["max_scaled_residual"] <= 1e-10,
          f"mc64 after update_matrix_values: {upd}")
    rec["after_update"] = upd
    del A, s, A2

    phase("11 orderings")
    for name in ORD_PHASES:
        general_run(name, scaled_tol=1e-10, steady=1,
                    nopivot=name == "aniso24_nopivot")

    phase("12 df32")
    general_run("df32", scaled_tol=1e-10)

    def struct_run(name, profile="factor", **kw):
        A, s, t = struct.pop(name)
        torch.cuda.empty_cache()
        # bench.py's gate (ERROR_TOL 1e2 times rel_tol), its right-hand
        # side from default_rng(0)
        rec = run_solver(torch, name, A, s, t, seed=0, memory=True,
                         scaled_tol=1e2 * s.opts.rel_tol, steady=1,
                         refresh=True, profile=profile, **kw)
        print(f"{name}: peak {rec['peak_bytes']} bytes against the model's "
              f"{rec['factor_peak_bytes_model']}; factor bytes "
              f"{rec['factor_bytes_effective']} against dense "
              f"{rec['dense_factor_bytes']}", flush=True)
        runs[name] = rec
        del A, s
        torch.cuda.empty_cache()

    phase("13 hodlr100")
    # no profile: reading its 908k-kernel trace took ~2 minutes of the
    # run's limit (tools/structured_cells.py hodlr100 still profiles it)
    struct_run("hodlr100", profile=None, launched=tuple(_wrappers()))

    phase("14 hss64, hodlr64")
    for name in ("hss64", "hodlr64"):
        struct_run(name)

    k1_cx = complex_phases(torch, rng, runs, main_run, s64)
    del A64
    torch.cuda.empty_cache()

    phase("18 dense16k")
    k2_dn, k4_dn = dense_phase(torch, rng, runs, k2_done | {
        (r["nf"], r["p"], r["s"], r["dtype"], r["pivot"]) for r in k2_st},
        k4_done | {(r["nf"], r["p"], r["w"], r["row0"]) for r in k4_st
                   if r["dtype"] == "float32"})
    torch.cuda.empty_cache()

    phase("19 kernel100k")
    kernel_phase(torch, runs)
    torch.cuda.empty_cache()

    phase("20 dist64")
    # exact64's solver stayed for the comparison with its factors
    dist_phase(torch, runs, s64, main_run)
    k1_ds, k3_ds, k4_ds = dist_checks(
        torch, rng, s64, k3_done | {
            (r["nf"], r["p"], r["s"], r["dtype"], True) for r in k3_st},
        k4_done | {(r["nf"], r["p"], r["w"], r["row0"])
                   for r in k4_st + k4_dn if r["dtype"] == "float32"})
    del s64
    torch.cuda.empty_cache()

    phase("21 summary")
    print("K4-blocked", json.dumps(blocked))
    print("K3-general", json.dumps(k3_gen))
    print("K2-general", json.dumps(k2_gen))
    print("K1-pairs", json.dumps(k1_pairs))
    print("K1-structured", json.dumps(k1_st))
    print("K3-structured", json.dumps(k3_st))
    print("K2-structured", json.dumps(k2_st))
    print("K4-structured", json.dumps(k4_st))
    print("K1-complex", json.dumps(k1_cx))
    print("K2-dense", json.dumps(k2_dn))
    print("K4-dense", json.dumps(k4_dn))
    print("K1-dist", json.dumps(k1_ds))
    print("K3-dist", json.dumps(k3_ds))
    print("K4-dist", json.dumps(k4_ds))
    print("ptxas", json.dumps(ptxas))

    def sums(recs):
        out = dict(checks=len(recs), nopivot_checks=sum(
            not r.get("pivot", True) for r in recs))
        if recs:
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                out[k] = sum(r[k] for r in recs if r[k] is not None)
            out["library_missing"] = sum(r["library_ms"] is None
                                         for r in recs)
        return out

    def entry(name, src, replaces, run, key, recs, general=(),
              structured=(), complex_=(), dense=(), dist=()):
        """One kernel's line: launches from ``run`` (and by phase), the
        sums over its main checks ``recs``, and its checks at the
        general-input, the rank-structured, the complex, the dense
        facade and the distributed phases' shapes summed apart (the
        library yardstick where it was timed)."""
        gen = sums(general)
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=run["launches"][key], launches_from=run["phase"],
            launches_by_phase={n: r["launches"][key]
                               for n, r in runs.items()},
            max_abs_err=max(r["max_abs_err"]
                            for r in (*recs, *general, *structured,
                                      *complex_, *dense, *dist)),
            ms=sum(r["ms"] for r in recs),
            plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(r["bound_ms"] for r in recs),
            bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in recs)
                      else "operations"),
            library_ms=(None if any(r["library_ms"] is None for r in recs)
                        else sum(r["library_ms"] for r in recs)),
            general_shapes=gen, structured_shapes=sums(structured),
            complex_shapes=sums(complex_), dense_shapes=sums(dense),
            dist_shapes=sums(dist), shapes=recs)

    def k3_entry(e):
        # the kernel alone beside the wrapper + Schur GEMM of ``ms``
        for key in ("kernel_ms", "schur_ms", "kernel_bound_ms"):
            vals = [r[key] for r in e["shapes"]]
            e[key] = None if None in vals else sum(vals)
        return e

    k1_entry = entry("extend_add", "strumpack_tpu_torch/csrc/extend_add.cu",
                     "strumpack_tpu/ops/pallas_extadd.py:204", main_run,
                     "extend_add", k1, general=k1_gen, structured=k1_st,
                     complex_=k1_cx, dist=k1_ds)
    # the kernel alone (profiler) beside the events' kernel + wrapper
    k1_entry["kernel_ms"] = (None if any(r["kernel_ms"] is None for r in k1)
                             else sum(r["kernel_ms"] for r in k1))
    kernels = [
        k1_entry,
        k3_entry(entry("front_lu_cross", "strumpack_tpu_torch/csrc/front_lu.cu",
                       "strumpack_tpu/ops/pallas_lu.py:286", main_run,
                       "front_lu_cross", k3, k3_gen, k3_st, dist=k3_ds)),
        entry("small_lu", "strumpack_tpu_torch/csrc/small_lu.cu",
              "strumpack_tpu/ops/pallas_lu.py:102", blr_run, "small_lu", k2,
              k2_gen, k2_st, dense=k2_dn),
        entry("panel_lu", "strumpack_tpu_torch/csrc/panel_lu.cu",
              "strumpack_tpu/ops/pallas_panel_lu.py:110", blr_run,
              "panel_lu", k4, structured=k4_st, dense=k4_dn, dist=k4_ds),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
