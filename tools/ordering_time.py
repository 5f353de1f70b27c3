#!/usr/bin/env python3
"""Time the two host-side reference algorithms that limit chip_smoke.py's
general-input cells, each case in its own process under a time limit:

    python3 tools/ordering_time.py matching 12 16 20 24 --limit 60
    python3 tools/ordering_time.py mlf 12 20 --limit 400

``matching``: ``max_product_matching`` (MC64 job 5's role: scipy's
``min_weight_full_bipartite_matching``) on chip_smoke's mc64 matrix,
jump3d(NX) with scaled rows and permuted columns; ``mlf``: the native
minimum local fill ordering (``mlf_order``) of Poisson NX^3.  Prints the
host's CPU model, then one JSON line a case: the algorithm's seconds, or
null with ``"timed_out": true`` when the case's process (imports and
matrix included) ran past the limit.  Needs no GPU.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(kind, nx, out):
    sys.path.insert(0, ROOT)
    if kind == "matching":
        from chip_smoke import jump3d_scrambled
        from strumpack_tpu_torch.sparse.matching import max_product_matching
        A = jump3d_scrambled(nx, seed=0)
        t0 = time.perf_counter()
        max_product_matching(A)
    else:
        from strumpack_tpu_torch.sparse.gen import poisson3d
        from strumpack_tpu_torch.sparse.ordering.amd import mlf_order
        A = poisson3d(nx)
        t0 = time.perf_counter()
        mlf_order(A.rowptr, A.colind, A.n)
    out.put(time.perf_counter() - t0)


def cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=("matching", "mlf"))
    ap.add_argument("nx", type=int, nargs="+")
    ap.add_argument("--limit", type=float, default=60.0,
                    help="seconds a case may run")
    args = ap.parse_args()
    print(f"host CPU: {cpu_model()}, {os.cpu_count()} cores", flush=True)
    ctx = mp.get_context("spawn")
    for nx in args.nx:
        out = ctx.Queue()
        p = ctx.Process(target=_case, args=(args.kind, nx, out))
        p.start()
        p.join(args.limit)
        timed_out = p.is_alive()
        if timed_out:
            p.kill()
            p.join()
        secs = None if timed_out else out.get(timeout=10)
        print(json.dumps(dict(kind=args.kind, nx=nx, n=nx ** 3,
                              seconds=secs, limit=args.limit,
                              timed_out=timed_out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
