#!/usr/bin/env python3
"""Run chip_smoke.py's complex and chunked phases alone on one GPU.

    python3 tools/complex_cells.py [--profile]

Builds the kernels, runs exact64 (chunked64's reference, as chip_smoke.py's
phase 5 does), then phases 15-17: helmholtz32 (bench.py's configuration),
helm32_native (native complex64 and complex128, K1's complex
instantiations at every K1 shape of the plan) and chunked64, printing
chip_smoke's JSON records.  With --profile, helmholtz32's steady
factorization runs under torch.profiler and prints the device time by
kernel group and range (``chip_smoke.device_groups``; its 7.46 million
kernels take minutes to trace and read) in place of chip_smoke's SVD
times by events.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as C  # noqa: E402


def main(profile=False):
    import torch
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul
    from strumpack_tpu_torch.ops import _build
    C.check(torch.cuda.is_available(), "CUDA is available")
    use_full_fp32_matmul()
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    C.phase("exact64")
    A64, s64, t64 = C.make_solver(64, "float32", 1e-5)
    main_run = C.run_solver(torch, "exact64", A64, s64, t64, seed=64,
                            res_tol=1e-4, memory=True)
    runs = {"exact64": main_run}
    k1 = C.complex_phases(torch, np.random.default_rng(20261016), runs,
                          main_run, s64,
                          profile="steady" if profile else "svd")
    print("K1-complex", json.dumps(k1))
    return 0


if __name__ == "__main__":
    sys.exit(main("--profile" in sys.argv[1:]))
