"""Native C++ host-core loader (ctypes).

Builds ``libhostsym.so`` from hostsym.cpp on first use (g++ -O3), caches it
next to the source, and exposes typed wrappers: symbolic factorization,
BFS and multilevel nested dissection, minimum degree and minimum fill.
Each returns None when no compiler is available; the caller then uses its
NumPy implementation.
"""
from __future__ import annotations

import ctypes
import fcntl
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
        # one process builds; the others that start meanwhile wait for it
        # instead of compiling the same library
        with open(_SO + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, _SO)  # loaders never see half a file
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.CalledProcessError):
        return None
    I64P = ctypes.POINTER(ctypes.c_int64)
    lib.symbolic_factorization.restype = ctypes.c_int
    lib.symbolic_factorization.argtypes = [
        ctypes.c_int64, I64P, I64P, ctypes.c_int64, I64P, I64P, I64P,
        I64P, ctypes.POINTER(I64P), ctypes.POINTER(I64P)]
    lib.nested_dissection.restype = ctypes.c_int64
    lib.nested_dissection.argtypes = [
        ctypes.c_int64, I64P, I64P, ctypes.c_int64] + [
        ctypes.POINTER(I64P)] * 6
    lib.nested_dissection_ml.restype = ctypes.c_int64
    lib.nested_dissection_ml.argtypes = lib.nested_dissection.argtypes
    lib.min_degree_order.restype = ctypes.c_int64
    lib.min_degree_order.argtypes = [
        ctypes.c_int64, I64P, I64P, ctypes.c_int, ctypes.POINTER(I64P)]
    lib.min_fill_order.restype = ctypes.c_int64
    lib.min_fill_order.argtypes = [
        ctypes.c_int64, I64P, I64P, ctypes.POINTER(I64P)]
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


def _perm_call(fn, rowptr, colind, n, *args):
    """Run an ordering that returns perm[new] = old of length n; None when
    it fails."""
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int64)
    out = ctypes.POINTER(ctypes.c_int64)()
    got = fn(n, _as_i64p(rowptr), _as_i64p(colind), *args,
             ctypes.byref(out))
    if got != n:
        if got > 0:
            _lib.hostsym_free(out)
        return None
    return _take(_lib, out, n)


def min_degree_native(rowptr, colind, n, multiple=False):
    """C++ quotient-graph minimum degree (AMD role; multiple=True is the
    MMD variant).  Returns perm[new]=old or None without a compiler."""
    lib = _load()
    if lib is None:
        return None
    return _perm_call(lib.min_degree_order, rowptr, colind, n,
                      1 if multiple else 0)


def min_fill_native(rowptr, colind, n):
    """C++ exact greedy minimum local fill (MLF role).  Returns
    perm[new]=old or None without a compiler."""
    lib = _load()
    if lib is None:
        return None
    return _perm_call(lib.min_fill_order, rowptr, colind, n)


def nested_dissection_native(rowptr, colind, n, leaf=32, method="bfs"):
    """C++ ND; method "bfs" (level-set bisection, ANDSparspak role) or
    "ml" (multilevel HEM-coarsening + FM + vertex-cover separators, the
    METIS_NodeND role).  Returns (perm, iperm, SeparatorTree) or None."""
    lib = _load()
    if lib is None:
        return None
    from ..sparse.separator_tree import SeparatorTree
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int64)
    outs = [ctypes.POINTER(ctypes.c_int64)() for _ in range(6)]
    fn = lib.nested_dissection_ml if method == "ml" else lib.nested_dissection
    ns = fn(n, _as_i64p(rowptr), _as_i64p(colind), leaf,
            *[ctypes.byref(o) for o in outs])
    if ns <= 0:
        return None
    perm = _take(lib, outs[0], n)
    sb, se, par, lc, rc = (_take(lib, o, ns) for o in outs[1:])
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n)
    return perm, iperm, SeparatorTree(sb, se, par, lc, rc)
