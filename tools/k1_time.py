#!/usr/bin/env python3
"""K1 (extend-add) alone on one GPU, as chip_smoke.py checks and times it.

    python3 tools/k1_time.py [exact64] [nd64] [hodlr100] [helm32_c64] ...

Builds the extend-add kernel, then for each named plan (default exact64
and nd64): K1 bit-equal to ``extend_add_bucket_plain`` at every call one
factorization makes, with the kernel's, the plain version's and the
index_add_ yardstick's times by CUDA events and the byte bound
(``chip_smoke.check_k1``); at exact64 also the three pairs earlier
designs timed, each as a table of one.  Then one factorization of the
plan with the launch counter zeroed: K1's launches against
``PlanDev.ea_launches``.  Names: exact64, the general-input phases
(chip_smoke.GENERAL_PHASES), the rank-structured ones (STRUCT_PHASES) and
the native complex ones (helm32_c64, helm32_c128).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def make(name):
    """(A, reordered solver) of a chip_smoke plan."""
    if name == "exact64":
        A, s, _ = C.make_solver(64, "float32", 1e-5)
    elif name in C.GENERAL_PHASES:
        A, s, _ = C.make_general(name)
    elif name in C.STRUCT_PHASES:
        A, s, _ = C.make_structured(name)
    else:
        A, s, _, _ = C.make_complex(name)
    return A, s


def main(names):
    import torch
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul
    from strumpack_tpu_torch.ops import _build
    from strumpack_tpu_torch.ops.extend_add import extend_add_bucket
    C.check(torch.cuda.is_available(), "CUDA is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    use_full_fp32_matmul()
    t0 = time.perf_counter()
    _build.build(("extend_add",), verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(20261016)
    for name in names or ("exact64", "nd64"):
        C.phase(name)
        A, s = make(name)
        dt = getattr(torch, s.opts.factor_dtype)
        recs = C.check_k1(torch, s.pdev, rng, dtype=dt, label=f"K1-{name}",
                          full=name == "exact64")
        if name == "exact64":
            C.check_k1(torch, s.pdev, rng, calls=C.k1_old_picks(s.pdev),
                       one_pair=True, label="K1-exact64-pairs")
        worst = sorted(recs, key=lambda r: r["bound_ms"] / r["ms"])[:5]
        print(f"{name}: lowest shares of the bound "
              f"{json.dumps(worst)}", flush=True)
        extend_add_bucket.launches = 0
        s.factor()
        torch.cuda.synchronize()
        got, want = extend_add_bucket.launches, s.pdev.ea_launches()
        print(f"{name}: K1 launches a factorization {got}, plan {want}",
              flush=True)
        C.check(got == want, f"{name}: K1 launches as the plan counts")
        del A, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
