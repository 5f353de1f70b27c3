#!/usr/bin/env python3
"""Smoke run of strumpack_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: CUDA present; card name and power limit, torch/CUDA versions;
2. build: both CUDA kernels compiled from csrc/ with nvcc for sm_90a;
3. each kernel against its plain PyTorch version on the card, at shapes of
   the exact64 path: K1 (extend-add) bit-exact on real 64^3 plan maps, K3
   (cross-shape front LU) by the layered check below; kernel, plain and
   library times by CUDA events (median of 15 after 3 warm-ups);
4. exact32: Poisson 32^3, f32 factor + f32 iterative refinement to 1e-5;
5. exact64: Poisson 64^3, the same, plus peak device memory;
6. f64: Poisson 32^3 in float64 (the kernels' double instantiation);
7. one JSON line {"kernels": [...]}, then the last line
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


def phase(name):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_pairs(pdev):
    """Three (bucket, pair) of the plan: the smallest, a middle and the
    largest parent front that has an extend-add pair."""
    cands = []
    for li, lvl in enumerate(pdev.levels):
        for bi, bd in enumerate(lvl):
            for side in ("L", "R"):
                for pr in getattr(bd, "pairs" + side):
                    cands.append((bd.bp.p, bd.bp.nf, li, bi, side, pr))
    cands.sort(key=lambda c: (c[0], c[1]))
    pick = [cands[0], cands[len(cands) // 2], cands[-1]]
    return pick


def check_k1(torch, pdev, rng):
    from strumpack_tpu_torch.ops.extend_add import extend_add, extend_add_plain
    out = []
    for p, nf, li, bi, side, pr in k1_pairs(pdev):
        bd = pdev.levels[li][bi]
        cb = pdev.levels[li - 1][pr.bk].bp
        u, nfc = pr.u, cb.nf
        pos = getattr(bd, "pos" + side)
        F = torch.from_numpy(
            rng.standard_normal((nf, p, p), dtype=np.float32)).cuda()
        C = torch.from_numpy(
            rng.standard_normal((nfc, u, u), dtype=np.float32)).cuda()
        Fk = extend_add(F.clone(), C, pr.idx, pos)
        Fp = extend_add_plain(F.clone(), C, pr.idx, pos)
        torch.cuda.synchronize()
        err = float((Fk - Fp).abs().max())
        check(torch.equal(Fk, Fp), f"K1 bit-exact at p={p} u={u} nf={nf}")
        # bound: each touched element of F read and written once, its
        # addend read once, plus the maps of the fronts that have a child
        posn = pos.cpu().numpy()
        idxn = pr.idx.cpu().numpy()
        nval = ((posn >= 0) & (idxn >= 0)[:, None]).sum(axis=1)
        nbytes = (3 * 4 * int((nval.astype(np.int64) ** 2).sum())
                  + 4 * p * int((idxn >= 0).sum()) + 4 * nf)
        Fw = F.clone()
        ms = cuda_ms(lambda: extend_add(Fw, C, pr.idx, pos), torch)
        Fw = F.clone()
        plain = cuda_ms(lambda: extend_add_plain(Fw, C, pr.idx, pos), torch)
        rec = dict(p=p, u=u, nf=nf, nfc=nfc, level=li, bucket=bi, side=side,
                   max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                   library_ms=None)
        print("K1", json.dumps(rec), flush=True)
        out.append(rec)
        del F, C, Fk, Fp, Fw
    return out


def k3_flops(nf, p, s):
    """Elimination (divisions + rank-1 updates of A and B) and Schur GEMM."""
    u = p - s
    k = np.arange(s)
    elim = ((p - k - 1) + 2 * (p - k - 1) * (s - k - 1)
            + 2 * (s - k - 1) * u).sum()
    return nf * (int(elim) + 2 * u * u * s)


def check_k3(torch, rng, nf, p, s, dtype):
    from strumpack_tpu_torch.ops import front_lu as FL
    eps = float(np.finfo(dtype).eps)
    thresh = float(np.sqrt(eps))
    Fn = rng.standard_normal((nf, p, p)).astype(dtype)
    Fn[0, :, 0] = 0.0          # front 0: a zero pivot, replaced by thresh
    F = torch.from_numpy(Fn).cuda()
    k = FL.partial_factor(F, thresh, s)
    q = FL.partial_factor_plain(F, thresh, s)
    torch.cuda.synchronize()
    names = ("lu", "perm", "L21", "U12", "CB")
    # layer 1: permutations.  The kernel repeats the plain version's
    # rounding, so a flip would mean a bug; 99.9% leaves room for FMA-level
    # differences should the arithmetic ever change.
    same = (k[1] == q[1]).all(dim=1)
    flips = int((~same).sum())
    check(float(same.float().mean()) >= 0.999,
          f"K3 perm agreement {nf - flips}/{nf}")
    # layer 2: values on fronts with equal perm, relative to each output's
    # largest entry on the front: an operation-order change gives errors
    # of order s * eps * growth, well under these tolerances
    tol = 1e-5 if dtype == "float32" else 1e-12
    err = 0.0
    for name, a, b in zip(names, k, q):
        if name == "perm":
            continue
        d = (a[same] - b[same]).abs().amax(dim=(1, 2))
        scale = b[same].abs().amax(dim=(1, 2)).clamp(min=1e-300)
        check(bool((d <= tol * scale).all()), f"K3 {name} values")
        err = max(err, float(d.max()))
    # layer 3: backward error on every front without a replaced pivot,
    # |P [F11; F21] - L U| <= tol |L| |U| and |P F12 - L11 U12| <=
    # tol |L11| |U12|: LU with partial pivoting meets these with
    # gamma_s = s eps / (1 - s eps) (Higham, Thm 9.3), which is below tol
    lu, L21, U12 = (k[i].double() for i in (0, 2, 3))
    perm = k[1]
    eye = torch.eye(s, dtype=torch.float64, device=F.device)
    L11 = torch.tril(lu, -1) + eye
    U = torch.triu(lu)
    Fd = F.double()
    PF1 = torch.gather(Fd[:, :s, :s], 1, perm[:, :, None].expand(-1, -1, s))
    PF2 = torch.gather(Fd[:, :s, s:], 1,
                       perm[:, :, None].expand(-1, -1, p - s))
    L = torch.cat([L11, L21], dim=1)
    R1 = torch.cat([PF1, Fd[:, s:, :s]], dim=1) - L @ U
    B1 = L.abs() @ U.abs()
    R2 = PF2 - L11 @ U12
    B2 = L11.abs() @ U12.abs()
    replaced = (torch.diagonal(U, dim1=1, dim2=2).abs()
                == float(np.asarray(thresh, dtype))).any(dim=1)
    check(bool(replaced[0]), "K3 front 0 has its zero pivot replaced")
    ok = ~replaced
    be1 = (R1.abs().amax(dim=(1, 2)) / B1.amax(dim=(1, 2)))[ok]
    be2 = (R2.abs().amax(dim=(1, 2)) / B2.amax(dim=(1, 2)))[ok]
    check(bool((be1 <= tol).all() and (be2 <= tol).all()),
          f"K3 backward error {float(be1.max()):.3g} {float(be2.max()):.3g}")
    del lu, L21, U12, L11, U, Fd, PF1, PF2, L, R1, B1, R2, B2

    ms = cuda_ms(lambda: FL.partial_factor(F, thresh, s), torch)
    plain = cuda_ms(lambda: FL.partial_factor_plain(F, thresh, s), torch)

    # yardstick: lu_factor + pivot conversion + 2 solve_triangular + GEMM,
    # the port's library route, which never takes these K3 buckets
    lib = cuda_ms(lambda: FL.library_factor(F, thresh, s), torch)
    schur = cuda_ms(lambda: torch.baddbmm(F[:, s:, s:], k[2], k[3],
                                          alpha=-1), torch)
    # F read once (p^2), lu + L21 + U12 + CB written once (p^2), perm
    nbytes = nf * (np.dtype(dtype).itemsize * 2 * p * p + 8 * s)
    flops = k3_flops(nf, p, s)
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    rec = dict(nf=nf, p=p, s=s, dtype=dtype, perm_flips=flips,
               replaced_fronts=int(replaced.sum()), max_abs_err=err,
               backward_error=max(float(be1.max()), float(be2.max())),
               ms=ms, schur_ms=schur, plain_ms=plain, library_ms=lib,
               bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf
               else "operations")
    print("K3", json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# phases 4-6: the solver
# ---------------------------------------------------------------------------

def reset_counts():
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.ops.extend_add import extend_add
    from strumpack_tpu_torch.ops.front_lu import partial_factor
    extend_add.launches = 0
    partial_factor.launches = 0
    for k in numeric.route_counts:
        numeric.route_counts[k] = 0


def read_counts():
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.ops.extend_add import extend_add
    from strumpack_tpu_torch.ops.front_lu import partial_factor
    return dict(extend_add=extend_add.launches,
                front_lu_cross=partial_factor.launches,
                routes=dict(numeric.route_counts))


def make_solver(nx, dtype, rel_tol):
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson3d
    A = poisson3d(nx)
    opts = st.SPOptions(factor_dtype=dtype, refine_dtype=dtype,
                        krylov_solver=st.KrylovSolver.REFINE, nd_leaf=16)
    if rel_tol is not None:
        opts.rel_tol = rel_tol
    s = st.SparseSolver(opts)
    s.set_csr_matrix(A)
    t0 = time.perf_counter()
    check(s.reorder(nx, nx, nx) == st.ReturnCode.SUCCESS, "reorder")
    return A, s, time.perf_counter() - t0


def run_solver(torch, name, A, s, t_reorder, seed, res_tol=None,
               scaled_tol=None, memory=False, profile=False):
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.frontal import numeric
    plan, pdev = s.plan, s.pdev
    nb = sum(len(lvl) for lvl in pdev.levels)
    rng = np.random.default_rng(seed)
    b = A.spmv(rng.standard_normal(A.n))
    if memory:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    check(s.factor() == st.ReturnCode.SUCCESS, f"{name} factor")
    t_first = time.perf_counter() - t0
    if memory:
        peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    x, rc = s.solve(b)
    t_solve = time.perf_counter() - t0
    counts = read_counts()
    check(counts["extend_add"] == pdev.ea_pairs(),
          f"{name}: K1 launches {counts['extend_add']} == plan pairs "
          f"{pdev.ea_pairs()}")
    check(counts["front_lu_cross"] == pdev.k3_buckets(),
          f"{name}: K3 launches {counts['front_lu_cross']} == K3 buckets "
          f"{pdev.k3_buckets()}")
    check(counts["extend_add"] > 0 and counts["front_lu_cross"] > 0,
          f"{name}: both kernels launched")
    check(sum(counts["routes"].values()) == nb, f"{name}: every bucket routed")
    check(rc == st.ReturnCode.SUCCESS, f"{name}: solve returned {rc}")
    check(bool(np.isfinite(x).all()) and x.shape == (A.n,),
          f"{name}: finite solution of shape ({A.n},)")
    x64 = np.asarray(x, np.float64)
    res = float(np.linalg.norm(b - A.spmv(x64)) / np.linalg.norm(b))
    scaled = A.max_scaled_residual(x64, b)
    if res_tol is not None:
        check(res <= res_tol, f"{name}: host relative residual {res:.3g}")
    if scaled_tol is not None:
        check(scaled <= scaled_tol, f"{name}: max scaled residual {scaled:.3g}")
    # steady state: the same plan factored and solved again, 3 times
    steady, steady_solve = [], []
    for _ in range(3):
        s._factored = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.factor()
        steady.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        s.solve(b)
        steady_solve.append(time.perf_counter() - t0)
    t_steady = float(np.median(steady))
    rec = dict(phase=name, n=A.n, buckets=nb, k1_pairs=pdev.ea_pairs(),
               k3_buckets=pdev.k3_buckets(), launches=counts,
               factor_nnz=plan.factor_nnz, factor_flops=plan.factor_flops,
               reorder_s=t_reorder, factor_first_s=t_first,
               factor_steady_s=t_steady, factor_steady_all_s=steady,
               factor_gflops=plan.factor_flops / t_steady / 1e9,
               solve_first_s=t_solve,
               solve_steady_s=float(np.median(steady_solve)),
               ir_its=s.Krylov_iterations(),
               achieved_rtol=s.achieved_rtol, host_rel_residual=res,
               max_scaled_residual=scaled)
    if memory:
        itemsize = np.dtype(s.opts.factor_dtype).itemsize
        rec["peak_bytes"] = int(peak)
        rec["factor_peak_bytes_model"] = numeric.factor_peak_bytes(
            pdev, itemsize)
        rec["factor_bytes"] = s.fac.factor_memory()
        # the analytic model is the capacity planner's upper bound
        check(peak <= rec["factor_peak_bytes_model"],
              f"{name}: peak {peak} bytes within the factor_peak_bytes model")
    if profile:
        rec["profile"] = profile_factor(torch, s, b)
    print(name, json.dumps(rec), flush=True)
    return rec


# profiler rows by kernel name, in this order (first match wins)
KERNEL_GROUPS = (
    ("K1 extend_add", ("extend_add_kernel",)),
    ("K3 lu_cross", ("lu_cross_kernel",)),
    ("library LU (getrf, pivots)", ("getrf", "getf2", "laswp", "swap",
                                    "pivinfo", "computecolumn",
                                    "displace_pointers", "iamax")),
    ("library trsm", ("trsm",)),
    ("GEMM (Schur, solve)", ("gemm", "xmma", "cutlass")),
)
PROFILER_OVERHEAD = ("Activity Buffer Request", "Buffer Flush")


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
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if (dev > 0 and ev.device_type == DeviceType.CUDA
                and ev.key not in PROFILER_OVERHEAD):
            rows.append((dev / 1e3, ev.count, ev.key))
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
    for ms, count, key in rows[:12]:
        print(f"profile: {ms:9.2f} ms {count:6d}x {key[:90]}")
    return dict(wall_ms=wall * 1e3, kernel_ms=busy, groups=groups)


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
    secs = _build.build(verbose=True)
    print(f"build {time.perf_counter() - t0:.2f} s {json.dumps(secs)}",
          flush=True)

    phase("3 kernels against their plain versions")
    A64, s64, t_reorder64 = make_solver(64, "float32", 1e-5)
    print(f"exact64 reorder {t_reorder64:.2f} s", flush=True)
    rng = np.random.default_rng(20261016)
    k1 = check_k1(torch, s64.pdev, rng)
    k3 = [check_k3(torch, rng, nf, p, s, "float32")
          for nf, p, s in ((8192, 48, 16), (4096, 80, 16), (1024, 216, 24))]
    k3.append(check_k3(torch, rng, 4096, 80, 16, "float64"))
    torch.cuda.empty_cache()

    phase("4 exact32")
    A32, s32, t_reorder32 = make_solver(32, "float32", 1e-5)
    run_solver(torch, "exact32", A32, s32, t_reorder32, seed=32,
               res_tol=1e-4, profile=True)
    del A32, s32

    phase("5 exact64")
    torch.cuda.empty_cache()
    main_run = run_solver(torch, "exact64", A64, s64, t_reorder64, seed=64,
                          res_tol=1e-4, memory=True, profile=True)
    del A64, s64
    torch.cuda.empty_cache()

    phase("6 f64")
    Ad, sd, t_reorderd = make_solver(32, "float64", None)
    run_solver(torch, "f64_32", Ad, sd, t_reorderd, seed=3,
               scaled_tol=1e-10)

    phase("7 summary")

    def entry(name, src, replaces, key, recs):
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=main_run["launches"][key],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=sum(r["ms"] for r in recs),
            plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(r["bound_ms"] for r in recs),
            bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in recs)
                      else "operations"),
            library_ms=(None if any(r["library_ms"] is None for r in recs)
                        else sum(r["library_ms"] for r in recs)),
            shapes=recs)

    kernels = [
        entry("extend_add", "strumpack_tpu_torch/csrc/extend_add.cu",
              "strumpack_tpu/ops/pallas_extadd.py:204", "extend_add", k1),
        entry("front_lu_cross", "strumpack_tpu_torch/csrc/front_lu.cu",
              "strumpack_tpu/ops/pallas_lu.py:286", "front_lu_cross", k3),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
