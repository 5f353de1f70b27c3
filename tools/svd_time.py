#!/usr/bin/env python3
"""Time cuSOLVER's batched SVD at the block shapes of the structured
fronts, on one GPU.

    python3 tools/svd_time.py

For batches of [n, n] float32 blocks of rank 40 plus noise (the shape of
the butterfly transfer blocks and leaves, n = 2r = 128 at helmholtz32's
rank 64), prints the time and the kernel count of torch.linalg.svd with
the default driver (gesvdj, with gesvd on the blocks it does not
converge on), with gesvdj and with gesvd alone, and of the same SVDs on
the host CPU, each with the largest reconstruction error relative to the
block's largest entry.  The structured compressions (structured/hss.py
``_trunc_basis``) take these SVDs one batch at a time.
"""
import json
import sys
import time


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("svd_time: CUDA is not available", file=sys.stderr)
        return 1
    torch.manual_seed(0)

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def kernels(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in p.events() if e.device_type.name == "CUDA")

    print(torch.cuda.get_device_name(0), flush=True)
    for batch, n in ((128, 128), (128, 96), (512, 64), (128, 48)):
        X = (torch.randn(batch, n, 40, device="cuda")
             @ torch.randn(batch, 40, n, device="cuda")
             + 1e-4 * torch.randn(batch, n, n, device="cuda"))
        out = {}
        for name, driver, dev in (("default", None, "cuda"),
                                  ("gesvdj", "gesvdj", "cuda"),
                                  ("gesvd", "gesvd", "cuda"),
                                  ("host", None, "cpu")):
            Y = X.to(dev)

            def fn():
                return torch.linalg.svd(Y, driver=driver) if driver \
                    else torch.linalg.svd(Y)
            U, S, Vh = fn()
            err = float(((U * S[..., None, :]) @ Vh - Y).abs().max()
                        / Y.abs().max())
            out[name] = dict(ms=ms(fn), err=err,
                             kernels=kernels(fn) if dev == "cuda" else 0)
        print(json.dumps(dict(batch=batch, n=n, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
