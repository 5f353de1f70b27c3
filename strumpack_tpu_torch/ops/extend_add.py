"""K1: multifrontal extend-add, ``F[f, i, j] += C[idx[f], pos[f, i], pos[f, j]]``.

Replaces ``strumpack_tpu/ops/pallas_extadd.py`` (``extend_add_pallas``).
The CUDA kernel is ``csrc/extend_add.cu``; its note says what bounds it
on an H100 and how its design answers that.  ``extend_add_plain`` is the
gather form of ``strumpack_tpu/frontal/numeric.py:361-369``: the CPU path
and the kernel's reference in the tests and in ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_FN = {torch.float32: "extend_add_f32", torch.float64: "extend_add_f64",
       torch.complex64: "extend_add_c64", torch.complex128: "extend_add_c128"}
_SIG = (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p])


def extend_add_plain(F, C, idx, pos):
    """Gather form: ``posc`` maps each parent slot to its child row, with
    padded slots (``pos = -1``) and absent fronts (``idx = -1``) sent to an
    appended zero row/column of C.  Updates F in place and returns it."""
    nf, p, _ = F.shape
    u = C.shape[1]
    ok = (idx >= 0)[:, None] & (pos >= 0)
    posc = torch.where(ok, pos, u).long()                         # [nf, p]
    Csel = C[idx.clamp(0, max(C.shape[0] - 1, 0)).long()]         # [nf, u, u]
    Cpad = torch.nn.functional.pad(Csel, (0, 1, 0, 1))            # [nf, u+1, u+1]
    G = torch.gather(Cpad, 1, posc[:, :, None].expand(nf, p, u + 1))
    H = torch.gather(G, 2, posc[:, None, :].expand(nf, p, p))
    return F.add_(H)


def extend_add(F, C, idx, pos):
    """In-place extend-add of one (side, child bucket) pair.

    F [nf, p, p] float32/float64/complex64/complex128; C [nfc, u, u] of
    F's dtype; idx [nf]
    int32 child block in C (-1 = none); pos [nf, p] int32 parent slot ->
    child row (-1 = none).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``extend_add.launches`` counts launches)."""
    if F.device.type == "cpu":
        return extend_add_plain(F, C, idx, pos)
    if F.device.type != "cuda":
        raise NotImplementedError(f"extend_add on {F.device.type}")
    if F.dtype not in _FN:
        raise NotImplementedError(f"extend_add kernel: dtype {F.dtype}")
    nf, p, p2 = F.shape
    nfc, u, u2 = C.shape
    if (p != p2 or u != u2 or C.dtype != F.dtype
            or idx.shape != (nf,) or pos.shape != (nf, p)
            or idx.dtype != torch.int32 or pos.dtype != torch.int32):
        raise ValueError("extend_add: bad shapes or dtypes "
                         f"F{tuple(F.shape)} C{tuple(C.shape)} "
                         f"idx{tuple(idx.shape)} pos{tuple(pos.shape)}")
    for t in (C, idx, pos):
        if t.device != F.device:
            raise ValueError("extend_add: tensors on different devices")
    if not (F.is_contiguous() and C.is_contiguous() and idx.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("extend_add: tensors must be contiguous")
    lib = _build.load("extend_add", {fn: _SIG for fn in _FN.values()})
    stream = _build.stream(F.device)
    err = getattr(lib, _FN[F.dtype])(
        F.data_ptr(), C.data_ptr(), idx.data_ptr(), pos.data_ptr(),
        nf, p, u, stream)
    _build.check(lib, "extend_add", err)
    extend_add.launches += 1
    return F


extend_add.launches = 0
