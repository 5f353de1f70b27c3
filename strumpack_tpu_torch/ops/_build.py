"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``_build/lib<name>.so`` for Hopper (``sm_90a``), then loaded with
``ctypes``.  A library is rebuilt when its source, or a header of ``csrc/``,
is newer than it.  Nothing
here runs at import time, so the package imports on a machine without
``nvcc`` or a GPU; the first kernel launch builds what it needs.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
KERNEL_SOURCES = ("extend_add", "front_lu", "small_lu", "panel_lu")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or install the CUDA toolkit)")


def _paths(name):
    return (os.path.join(SRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name) -> bool:
    """Whether lib<name>.so is missing or older than its source or any
    header of csrc/ (the sources share ``lu_common.cuh``)."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + [os.path.join(SRC_DIR, h) for h in os.listdir(SRC_DIR)
                    if h.endswith(".cuh")]
    return os.path.getmtime(so) < max(map(os.path.getmtime, deps))


def build(names=KERNEL_SOURCES, verbose=False, log=None) -> dict:
    """Compile every stale source in ``names``, one ``nvcc`` process per
    source, all started together.  Returns {name: seconds} for the
    sources compiled; with ``verbose`` ptxas's register, spill and
    shared-memory report is printed, and stored in ``log[name]`` when a
    dict is given.  Raises RuntimeError on a failed build."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    secs, errors = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            continue
        if verbose and out:
            print(out, end="" if out.endswith("\n") else "\n")
            if log is not None:
                log[name] = out
        os.replace(tmp, so)   # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name, signatures) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed.  ``signatures``
    maps each C function to (restype, argtypes), set once at load; every
    library also exports ``<name>_error_string``."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, (res, args) in signatures.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        err_fn = getattr(lib, name + "_error_string")
        err_fn.restype = ctypes.c_char_p
        err_fn.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def stream(device) -> int:
    """The current CUDA stream of ``device`` as a raw handle, read without
    the Python Stream object ``torch.cuda.current_stream`` builds on every
    call (a launch's host time counts against the small kernels)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(lib, name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher of ``lib``."""
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
