#!/usr/bin/env python3
"""Time the steady factorization of exact32 and exact64 (chip_smoke.py's
configurations: Poisson 32^3 and 64^3, f32, nd_leaf 16), and with
``--nd64`` of nd64 (Poisson 64^3 without its grid, chip_smoke's phase 8),
with one version of strumpack_tpu_torch, on one NVIDIA GPU.

    python3 tools/factor_time.py [ROOT] [--nd64]

ROOT (default: this checkout) holds the strumpack_tpu_torch to time, so
that two versions can be timed in turns in one run on one card:

    mkdir -p _parent && git archive HEAD~1 | tar -x -C _parent
    for r in _parent . . _parent; do python3 tools/factor_time.py $r; done

(``_parent/`` is git-ignored.)  Prints the card's name and power limit,
then one JSON line per cell: the version, the K3 and library buckets of
one factorization and the wall seconds of 7 steady factorizations
(the plan built and factored once before; each one synchronised).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 7                    # steady factorizations a cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--nd64", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("factor_time: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # the version to time is the strumpack_tpu_torch under ROOT;
    # chip_smoke.py (its make_solver) always comes from this checkout
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from strumpack_tpu_torch.frontal import numeric
    numeric.use_full_fp32_matmul()
    for cell in ("exact32", "exact64") + (("nd64",) if args.nd64 else ()):
        A, s, _ = (cs.make_general(cell) if cell == "nd64" else
                   cs.make_solver(int(cell[5:]), "float32", 1e-5))
        for k in numeric.route_counts:
            numeric.route_counts[k] = 0
        s.factor()
        routes = dict(numeric.route_counts)
        walls = []
        for _ in range(REPS):
            s._factored = False
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.factor()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print("factor-time", json.dumps(dict(
            root=args.root, cell=cell, routes=routes, factor_s=walls)),
            flush=True)
        del A, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
