#!/usr/bin/env python3
"""Time the cross-shape front LU (K3) of one version of strumpack_tpu_torch
at every shape chip_smoke.py checks it at, on one NVIDIA GPU.

    python3 tools/k3_time.py [ROOT]

ROOT (default: this checkout) holds the strumpack_tpu_torch to time.  The
shapes always come from this checkout: the dense buckets of exact64,
exact32 and blr50 (float32) and of f64_32 (float64) that K3 launches
(chip_smoke.py ``k3_shapes``).  So two versions are timed at the same
shapes, e.g. the parent commit against this one, in turns on one card:

    mkdir -p _parent && git archive HEAD~1 | tar -x -C _parent
    for r in _parent . . _parent; do python3 tools/k3_time.py $r; done

(``_parent/`` is git-ignored.)

Prints the card's name and power limit, then one JSON line per shape:
the version's ROOT, the shape, K3's wrapper time with the Schur GEMM (CUDA
events), the wrapper's host time, the kernel alone (profiler device time)
and the library route's time (events), or "held": false where the
version refuses the shape.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_time: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cs = _chip_smoke()
    # the shapes, from this checkout's plans and routing
    sys.path.insert(0, HERE)
    lists = []
    for dtype, cells in (("float32", (("exact64", 64, "float32", False),
                                      ("exact32", 32, "float32", False),
                                      ("blr50", 50, "float32", True))),
                         ("float64", (("f64_32", 32, "float64", False),))):
        plans = {name: cs.make_solver(nx, dt, None, blr=blr)[1].pdev
                 for name, nx, dt, blr in cells}
        shapes, _ = cs.k3_shapes(plans, dtype)
        lists.append((dtype, sorted(shapes.items())))
        del plans
    # the version to time
    for name in [m for m in sys.modules if m.split(".")[0]
                 == "strumpack_tpu_torch"]:
        del sys.modules[name]
    sys.path[0] = os.path.abspath(args.root)
    from strumpack_tpu_torch.frontal.numeric import use_full_fp32_matmul
    from strumpack_tpu_torch.ops import front_lu as FL
    use_full_fp32_matmul()
    rng = np.random.default_rng(20261016)
    for dtype, shapes in lists:
        thresh = float(np.sqrt(np.finfo(dtype).eps))
        for (nf, p, s), buckets in shapes:
            F = cs.k3_fronts(torch, rng, nf, p, dtype)
            rec = dict(root=args.root, nf=nf, p=p, s=s, dtype=dtype, buckets=buckets)
            try:
                rec.update(cs.time_k3(torch, FL, F, thresh, s), held=True)
            except ValueError as e:
                rec.update(held=False, why=str(e))
            print("K3-time", json.dumps(rec), flush=True)
            del F
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
