#!/usr/bin/env python3
"""Run chip_smoke.py's distributed phase (20, dist64) alone.

    python3 tools/dist_cells.py [--cpu] [--batch-split]

On one GPU: builds the kernels, factors and solves exact64 (phase 5's
problem and options, its record as chip_smoke prints it), then phase 20:
one NCCL rank, then two gloo ranks sharing the card, then K1, K3 and K4
at the shapes the ranks launch.  --cpu rehearses
the same on the CPU at Poisson 12^3 (gloo for both parts, the four
kernel wrappers replaced by counting wrappers of their plain versions,
in the ranks too).  --batch-split instead factors the library-routed
shard buckets of dist64 that differed from exact64's (nf fronts of p, s
eliminated) on the library route whole and as two halves, and says
which of its steps (LU, the two triangular solves, the Schur GEMM) give
other bits for half the batch.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as C  # noqa: E402

CPU_NX = 12


def counting_wrappers():
    """The four kernel wrappers as counting wrappers of themselves (on CPU
    tensors they run the plain versions and count nothing), with K4's
    design tally and K3's / K2's pivot tallies."""
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.ops import extend_add as EA
    from strumpack_tpu_torch.ops import front_lu as FL
    from strumpack_tpu_torch.ops import panel_lu as PP

    def counted(orig, tally=None):
        def w(*a, **k):
            w.launches += 1
            if tally:
                tally(w, a, k)
            return orig(*a, **k)
        w.launches = 0
        return w

    def k1(orig):
        # the kernel's count: one per EA_MAX_PAIRS pairs where the fronts
        # take an addend
        def w(F, pairs, posL, posR, emap, f0=0):
            w.launches += emap.launches(f0, f0 + F.shape[0], len(pairs))
            return orig(F, pairs, posL, posR, emap, f0)
        w.launches = 0
        return w

    def pivot(w, a, k):
        w.modes["pivot" if k.get("pivot", True) else "nopivot"] += 1

    def design(w, a, k):
        pan, row0 = a[0], a[2]
        w.variants[PP.design(pan.shape[1], a[3], pan.element_size(),
                             row0)[0]] += 1

    EA.extend_add_bucket = numeric.extend_add_bucket = k1(
        EA.extend_add_bucket)
    FL.partial_factor = counted(FL.partial_factor, pivot)
    FL.partial_factor.modes = {"pivot": 0, "nopivot": 0}
    FL.factor_bucket = counted(FL.factor_bucket, pivot)
    FL.factor_bucket.modes = {"pivot": 0, "nopivot": 0}
    PP.panel_lu = counted(PP.panel_lu, design)
    PP.panel_lu.variants = dict.fromkeys(PP.DESIGNS, 0)


def cpu_rank(rank, world, port, q, done, nx, device):
    import torch
    torch.set_num_threads(1)
    counting_wrappers()
    return ORIG_RANK(rank, world, port, q, done, nx, device)


ORIG_RANK = C.dist_rank


BATCH_SPLIT_SHAPES = ((16, 2304, 256), (8, 3584, 512), (2, 6144, 2048))


def batch_split(torch):
    """The library route's steps on a batch and on its two halves."""
    from strumpack_tpu_torch.ops import front_lu as FL
    g = torch.Generator(device="cpu").manual_seed(0)
    for nf, p, s in BATCH_SPLIT_SHAPES:
        F = (torch.randn(nf, p, p, generator=g)
             + p * torch.eye(p)).to("cuda")

        def steps(F):
            lu, piv, _ = torch.linalg.lu_factor_ex(F[:, :s, :s])
            perm = FL.lapack_pivots_to_perm(lu, piv)
            F12 = torch.gather(F[:, :s, s:], 1,
                               perm[:, :, None].expand(-1, -1, p - s))
            U12 = torch.linalg.solve_triangular(lu, F12, upper=False,
                                                unitriangular=True)
            L21 = torch.linalg.solve_triangular(lu, F[:, s:, :s],
                                                upper=True, left=False)
            CB = torch.baddbmm(F[:, s:, s:], L21, U12, alpha=-1)
            # each later step also on the whole batch's inputs, so a
            # difference is the step's own
            return dict(lu=lu, U12=U12, L21=L21, CB=CB), (lu, F12, L21,
                                                          U12)
        whole, (lu, F12, L21, U12) = steps(F)
        h = nf // 2
        halves = [steps(F[:h])[0], steps(F[h:])[0]]
        own = {}
        for k in whole:
            own[k] = all(torch.equal(halves[i][k],
                                     whole[k][i * h:(i + 1) * h])
                         for i in range(2))
        # the steps alone on identical inputs
        alone = dict(
            trsm_U12=torch.equal(torch.linalg.solve_triangular(
                lu[:h], F12[:h], upper=False, unitriangular=True), U12[:h]),
            trsm_L21=torch.equal(torch.linalg.solve_triangular(
                lu[:h], F[:h, s:, :s], upper=True, left=False), L21[:h]),
            gemm=torch.equal(torch.baddbmm(F[:h, s:, s:], L21[:h], U12[:h],
                                           alpha=-1), whole["CB"][:h]))
        print(f"batch-split nf {nf} p {p} s {s}: halves equal the whole "
              f"{json.dumps(own)}; steps alone {json.dumps(alone)}",
              flush=True)


def main(argv):
    import torch
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson3d
    if "--cpu" in argv:
        torch.set_num_threads(1)
        counting_wrappers()
        A = poisson3d(CPU_NX)
        s64 = st.SparseSolver(C.dist_opts(), device="cpu")
        s64.set_csr_matrix(A)
        s64.reorder(CPU_NX, CPU_NX, CPU_NX)
        b = A.spmv(np.random.default_rng(64).standard_normal(A.n))
        x, _ = s64.solve(b)
        main_run = dict(its=s64.Krylov_iterations(),
                        max_scaled_residual=A.max_scaled_residual(x, b))
        C.dist_rank = cpu_rank
        rec = C.dist_phase(torch, {}, s64, main_run, nx=CPU_NX,
                           device="cpu", backend="gloo")
        print(json.dumps(rec)[:2000])
        return 0
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul
    from strumpack_tpu_torch.ops import _build
    C.check(torch.cuda.is_available(), "CUDA is available")
    use_full_fp32_matmul()
    if "--batch-split" in argv:
        batch_split(torch)
        return 0
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    A64, s64, t64 = C.make_solver(64, "float32", 1e-5)
    main_run = C.run_solver(torch, "exact64", A64, s64, t64, seed=64,
                            res_tol=1e-4, steady=1)
    runs = {}
    C.dist_phase(torch, runs, s64, main_run)
    t0 = time.perf_counter()
    k1, k3, k4 = C.dist_checks(torch, np.random.default_rng(0), s64, set(),
                               set())
    print(f"dist checks: K1 {len(k1)}, K3 {len(k3)}, K4 {len(k4)} shapes "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
