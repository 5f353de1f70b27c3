#!/usr/bin/env python3
"""Run chip_smoke.py's rank-structured phases alone on one GPU.

    python3 tools/structured_cells.py [hodlr100] [hss64] [hodlr64]

Builds the kernels, then for each named phase (default: all three)
reorders, factors and solves it as chip_smoke.py's phases 13-14 do (launch
counts against the plan, the residual gate, peak memory against the
model, the device time by group), printing chip_smoke's JSON record.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main(names):
    import torch
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul
    from strumpack_tpu_torch.ops import _build
    C.check(torch.cuda.is_available(), "CUDA is available")
    use_full_fp32_matmul()
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in names or C.STRUCT_PHASES:
        C.phase(name)
        A, s, t = C.make_structured(name)
        print(f"reorder {name}: {t:.2f} s, buckets "
              f"{s.pdev.kinds()}", flush=True)
        C.run_solver(torch, name, A, s, t, seed=0, memory=True,
                     scaled_tol=1e2 * s.opts.rel_tol, steady=1,
                     refresh=True, profile="factor",
                     launched=("extend_add",))
        del A, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
