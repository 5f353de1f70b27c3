"""Native C++ host-core loader (ctypes).

Builds ``libhostsym.so`` from hostsym.cpp on first use (g++ -O3), caches it
next to the source, and exposes a typed wrapper.  Returns None when no
compiler is available; the caller then uses the NumPy implementation.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hostsym.cpp")
_SO = os.path.join(_DIR, "libhostsym.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, _SO)  # concurrent loaders never see half a file
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.CalledProcessError):
        return None
    I64P = ctypes.POINTER(ctypes.c_int64)
    lib.symbolic_factorization.restype = ctypes.c_int
    lib.symbolic_factorization.argtypes = [
        ctypes.c_int64, I64P, I64P, ctypes.c_int64, I64P, I64P, I64P,
        I64P, ctypes.POINTER(I64P), ctypes.POINTER(I64P)]
    lib.hostsym_free.restype = None
    lib.hostsym_free.argtypes = [I64P]
    _lib = lib
    return _lib


def _as_i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _take(lib, ptr, size):
    arr = np.ctypeslib.as_array(ptr, shape=(size,)).copy()
    lib.hostsym_free(ptr)
    return arr


def symbolic_factorization_native(Ap, tree):
    """C++ symbolic factorization; returns list of upd arrays or None."""
    lib = _load()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(Ap.rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(Ap.colind, dtype=np.int64)
    sb = np.ascontiguousarray(tree.sep_begin, dtype=np.int64)
    se = np.ascontiguousarray(tree.sep_end, dtype=np.int64)
    lc = np.ascontiguousarray(tree.lch, dtype=np.int64)
    rc = np.ascontiguousarray(tree.rch, dtype=np.int64)
    I64P = ctypes.POINTER(ctypes.c_int64)
    out_upd = I64P()
    out_off = I64P()
    rc_code = lib.symbolic_factorization(
        Ap.n, _as_i64p(rowptr), _as_i64p(colind), tree.nseps,
        _as_i64p(sb), _as_i64p(se), _as_i64p(lc), _as_i64p(rc),
        ctypes.byref(out_upd), ctypes.byref(out_off))
    if rc_code != 0:
        return None
    off = _take(lib, out_off, tree.nseps + 1)
    flat = _take(lib, out_upd, max(int(off[-1]), 1))
    return [flat[off[i]:off[i + 1]] for i in range(tree.nseps)]
