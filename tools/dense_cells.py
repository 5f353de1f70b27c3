#!/usr/bin/env python3
"""Run chip_smoke.py's structured-facade and kernel phases alone.

    python3 tools/dense_cells.py [--svd-time] [--cpu]

On one GPU: builds the kernels, then phases 18-19, dense16k (the facade's
types on the Gauss kernel matrix of 16,384 points; HODBF on its leading
2048 block, LR and BUTTERFLY on its leading 4096 block) and kernel100k
(examples/kernel_regression_100k.py's configuration, then the ann and
HODLR fits and the classifier at 8,192 points), printing chip_smoke's
JSON records.  --svd-time instead times LR and BUTTERFLY at 2048 and
4096 (the butterfly's SVDs by events) and cuSOLVER's SVD of each block
by driver.  --cpu rehearses both phases on the CPU at small sizes (n
1024, blocks of 256 and 512, 3000 and 1024 kernel points; the kernel
checks are skipped).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as C  # noqa: E402


def svd_time(torch):
    """LR and BUTTERFLY on the leading 2048 and 4096 blocks of dense16k's
    matrix (HODBF: its record in phase 18), and one full SVD of each block
    by torch.linalg.svd's drivers (time and the rank rule's rank)."""
    A = C.gauss_matrix(torch, C.DENSE_N, "cuda")
    g = np.random.default_rng(1)
    for n in (2048, 4096):
        An = A[:n, :n].contiguous()
        xv = torch.tensor(g.standard_normal(n), dtype=torch.float32,
                          device="cuda")
        Ax = An.double() @ xv.double()
        for name in ("LR", "BUTTERFLY"):
            out = {}

            def run(name=name):
                out["rec"] = C.facade_case(torch, An, name, 128, xv, Ax,
                                           None, None, "cuda", gate=False)[0]
            svd = C.svd_events(torch, run) if name != "LR" else run()
            print(f"svd-time {name} n {n}", json.dumps(
                dict(case=out["rec"], svd=svd)), flush=True)
        for driver in (None, "gesvd", "gesvdj", "gesvda"):
            try:
                ms = C.cuda_ms(lambda: torch.linalg.svd(
                    An, full_matrices=False, driver=driver), torch,
                    warmup=1, reps=3)
                S = torch.linalg.svd(An, full_matrices=False,
                                     driver=driver)[1]
                rank = int((S > 1e-4 * S[0]).sum())
            except RuntimeError as e:
                ms, rank = None, str(e)[:80]
            print(f"svd-time driver {driver} n {n}: {ms} ms, rank {rank}",
                  flush=True)


def main(argv):
    import torch
    cpu = "--cpu" in argv
    if cpu:
        torch.set_num_threads(1)
        runs = {}
        C.dense_phase(torch, None, runs, set(), set(), device="cpu", n=1024,
                      svd_types=(("HODBF", 256), ("LR", 512),
                                 ("BUTTERFLY", 512)))
        C.kernel_phase(torch, runs, device="cpu", n=3000, small=1024)
        return 0
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul
    from strumpack_tpu_torch.ops import _build
    C.check(torch.cuda.is_available(), "CUDA is available")
    use_full_fp32_matmul()
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if "--svd-time" in argv:
        svd_time(torch)
        return 0
    runs = {}
    rng = np.random.default_rng(20261017)
    C.phase("18 dense16k")
    k2, k4 = C.dense_phase(torch, rng, runs, set(), set())
    C.phase("19 kernel100k")
    C.kernel_phase(torch, runs)
    print("K2-dense", json.dumps(k2))
    print("K4-dense", json.dumps(k4))
    print("dense16k launches", json.dumps(runs["dense16k"]["launches"]))
    C.phase("done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
