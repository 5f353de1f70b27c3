"""K1: multifrontal extend-add of a bucket's children into its fronts,
``F[f, i, j] += C_k[idx_k[f], pos_k[f, i], pos_k[f, j]]`` for every pair k
of the bucket's pair table, in table order.

Replaces ``strumpack_tpu/ops/pallas_extadd.py`` (``extend_add_pallas``),
which the JAX sweep calls once per (side, child bucket) pair
(``strumpack_tpu/frontal/numeric.py:1046-1049``).  The CUDA kernel is
``csrc/extend_add.cu``: one launch covers a bucket (or a chunk of one),
both sides and every child pair; its note says what bounds it on an H100
and how its design answers that.  ``EAMap`` is the kernel's work map, built
once per plan on the plan's device (``numeric.BucketDev.ea_map``).

``extend_add_bucket_plain`` applies ``extend_add_plain`` (the gather form
of ``strumpack_tpu/frontal/numeric.py:361-369``) pair by pair in table
order: the CPU path, and the kernel's reference in the tests and in
``chip_smoke.py``.  A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import array
import ctypes

import numpy as np
import torch

from . import _build

_FN = {torch.float32: "extend_add_bucket_f32",
       torch.float64: "extend_add_bucket_f64",
       torch.complex64: "extend_add_bucket_c64",
       torch.complex128: "extend_add_bucket_c128"}
_P = ctypes.c_void_p
# one argument: the int64 vector csrc/extend_add.cu's ``Arg`` lays out
_SIG = (ctypes.c_int, [_P])

# The kernel's tile (compact rows x column groups), its column group (parent
# slots) and the pairs one launch takes: csrc/extend_add.cu's TR, TG, GS and
# MAX_PAIRS, checked against the library at its first load.
EA_TILE_ROWS = 32
EA_TILE_GROUPS = 16
EA_GROUP = 4
EA_MAX_PAIRS = 32


def _compact(mask):
    """Each row's True positions in ascending order, padded with -1
    ([n, most True in a row] int32), and the counts [n]."""
    cnt = mask.sum(1)
    m = int(cnt.max()) if mask.shape[0] else 0
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :m]
    ar = torch.arange(m, device=mask.device)
    return (torch.where(ar < cnt[:, None], order, -1).to(torch.int32)
            .contiguous(), cnt)


class EAMap:
    """K1's work map of one bucket, on the bucket's device: per front the
    parent slots that take an addend (the union of ``posL >= 0`` where the
    front has a left child and ``posR >= 0`` where it has a right one) as
    compact rows (``rows`` [nf, mr], -1 padded) and as aligned column
    groups of ``EA_GROUP`` slots (``groups`` [nf, mg], group g = slots
    g*EA_GROUP..), and the tiles of at most EA_TILE_ROWS rows x
    EA_TILE_GROUPS groups that cover them (``tiles`` [ntiles, 3]: front,
    first compact row, first compact group), front by front;
    ``tile_ptr`` [nf + 1] (host) is each front's first tile."""

    def __init__(self, posL, posR, hasL, hasR):
        dev = posL.device
        nf, p = posL.shape
        if posR.shape != (nf, p) or posL.dtype != torch.int32 \
                or posR.dtype != torch.int32:
            raise ValueError(f"EAMap: pos maps {tuple(posL.shape)} "
                             f"{tuple(posR.shape)} must be int32 [nf, p]")
        hL = torch.as_tensor(np.asarray(hasL), device=dev)[:, None]
        hR = torch.as_tensor(np.asarray(hasR), device=dev)[:, None]
        fill = ((posL >= 0) & hL) | ((posR >= 0) & hR)
        self.p = p
        self.rows, nr = _compact(fill)
        pg = -(-p // EA_GROUP)
        gfill = torch.nn.functional.pad(fill, (0, pg * EA_GROUP - p))
        self.groups, ng = _compact(gfill.view(nf, pg, EA_GROUP).any(2))
        tr = -(-nr // EA_TILE_ROWS)
        tg = -(-ng // EA_TILE_GROUPS)
        nt = tr * tg
        end = torch.cumsum(nt, 0)
        self.tile_ptr = np.concatenate([[0], end.cpu().numpy()]).astype(
            np.int64)
        f = torch.repeat_interleave(torch.arange(nf, device=dev), nt)
        k = torch.arange(int(self.tile_ptr[-1]), device=dev) - (end - nt)[f]
        tgf = tg[f]
        self.tiles = torch.stack(
            [f, torch.div(k, tgf, rounding_mode="floor") * EA_TILE_ROWS,
             (k % tgf) * EA_TILE_GROUPS], 1).to(torch.int32).contiguous()

    def slice(self, f0, f1):
        """The map of fronts f0..f1 alone (a shard slice of the bucket)."""
        out = object.__new__(EAMap)
        out.p = self.p
        out.rows = self.rows[f0:f1].contiguous()
        out.groups = self.groups[f0:f1].contiguous()
        t0, t1 = int(self.tile_ptr[f0]), int(self.tile_ptr[f1])
        tiles = self.tiles[t0:t1].clone()
        tiles[:, 0] -= f0
        out.tiles = tiles
        out.tile_ptr = self.tile_ptr[f0:f1 + 1] - t0
        return out

    def launches(self, f0, f1, npairs):
        """K1 launches of fronts f0..f1 with ``npairs`` pairs: one per
        EA_MAX_PAIRS pairs where any of these fronts takes an addend."""
        if self.tile_ptr[f1] == self.tile_ptr[f0]:
            return 0
        return -(-npairs // EA_MAX_PAIRS)


def extend_add_plain(F, C, idx, pos):
    """One pair in gather form: ``posc`` maps each parent slot to its child
    row, with padded slots (``pos = -1``) and absent fronts (``idx = -1``)
    sent to an appended zero row/column of C.  Updates F in place and
    returns it."""
    nf, p, _ = F.shape
    u = C.shape[1]
    ok = (idx >= 0)[:, None] & (pos >= 0)
    posc = torch.where(ok, pos, u).long()                         # [nf, p]
    Csel = C[idx.clamp(0, max(C.shape[0] - 1, 0)).long()]         # [nf, u, u]
    Cpad = torch.nn.functional.pad(Csel, (0, 1, 0, 1))            # [nf, u+1, u+1]
    G = torch.gather(Cpad, 1, posc[:, :, None].expand(nf, p, u + 1))
    H = torch.gather(G, 2, posc[:, None, :].expand(nf, p, p))
    return F.add_(H)


def extend_add_bucket_plain(F, pairs, posL, posR):
    """``extend_add_plain`` of each pair (C, idx, side) of ``pairs`` in
    order, side 0 with ``posL``, side 1 with ``posR``.  Updates F in place
    and returns it."""
    for C, idx, side in pairs:
        extend_add_plain(F, C, idx, posL if side == 0 else posR)
    return F


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("extend_add", {fn: _SIG for fn in _FN.values()})
        cfg = (ctypes.c_int32 * 4)()
        lib.extend_add_config.restype = None
        lib.extend_add_config.argtypes = [_P]
        lib.extend_add_config(cfg)
        want = (EA_TILE_ROWS, EA_TILE_GROUPS, EA_GROUP, EA_MAX_PAIRS)
        if tuple(cfg) != want:
            raise RuntimeError(f"extend_add.cu's TR, TG, GS, MAX_PAIRS "
                               f"{tuple(cfg)} differ from the wrapper's {want}")
        _lib = lib
    return _lib


def extend_add_bucket(F, pairs, posL, posR, emap, f0=0):
    """In-place extend-add of a bucket's children into fronts f0.. of it.

    F [nf, p, p] float32/float64/complex64/complex128, the fronts f0..f0+nf
    of the bucket (a chunk, or all); ``pairs``: the pair table in plan
    order, (C [nfc, u, u] of F's dtype, idx [nf] int32 block of C for each
    of these fronts, -1 = none, side 0 = left child / 1 = right);
    posL, posR [nf, p] int32 these fronts' maps (parent slot -> child row,
    -1 = none); ``emap``: the bucket's ``EAMap``.  CPU tensors take
    ``extend_add_bucket_plain``; CUDA tensors launch the kernel, once per
    EA_MAX_PAIRS pairs where these fronts take an addend
    (``extend_add_bucket.launches`` counts launches)."""
    if F.device.type == "cpu":
        return extend_add_bucket_plain(F, pairs, posL, posR)
    if F.device.type != "cuda":
        raise NotImplementedError(f"extend_add_bucket on {F.device.type}")
    if F.dtype not in _FN:
        raise NotImplementedError(f"extend_add kernel: dtype {F.dtype}")
    nf, p, p2 = F.shape
    dt, dev = F.dtype, F.get_device()
    if (p2 != p or p != emap.p or not F.is_contiguous()
            or tuple(posL.shape) != (nf, p) or tuple(posR.shape) != (nf, p)
            or posL.dtype != torch.int32 or posR.dtype != torch.int32
            or posL.get_device() != dev or posR.get_device() != dev
            or emap.tiles.get_device() != dev
            or not (posL.is_contiguous() and posR.is_contiguous())):
        raise ValueError(f"extend_add_bucket: F{tuple(F.shape)} posL"
                         f"{tuple(posL.shape)} posR{tuple(posR.shape)} "
                         f"(int32, contiguous, on F's device as the map; "
                         f"map width {emap.p})")
    t0, t1 = emap.tile_ptr[f0], emap.tile_ptr[f0 + nf]
    if t1 == t0 or not pairs:
        return F
    flat = []
    for C, idx, side in pairs:
        s = C.shape
        if (C.dtype != dt or C.get_device() != dev or len(s) != 3
                or s[1] != s[2] or not C.is_contiguous()
                or idx.dtype != torch.int32 or idx.get_device() != dev
                or tuple(idx.shape) != (nf,) or not idx.is_contiguous()
                or side not in (0, 1)):
            raise ValueError(f"extend_add_bucket: pair C{tuple(s)} "
                             f"{C.dtype} idx{tuple(idx.shape)} {idx.dtype} "
                             f"side {side} against F{tuple(F.shape)} "
                             f"{F.dtype} on {F.device}")
        flat += (C.data_ptr(), idx.data_ptr(), s[1], side)
    lib = _load()
    fn = getattr(lib, _FN[dt])
    mr, mg = emap.rows.shape[1], emap.groups.shape[1]
    # csrc/extend_add.cu's Arg order: F, posL, posR, rows, groups, tiles,
    # ntiles, f0, p, mr, mg, vec, stream, npairs, then the pairs
    head = [F.data_ptr(), posL.data_ptr(), posR.data_ptr(),
            emap.rows.data_ptr() + 4 * f0 * mr,
            emap.groups.data_ptr() + 4 * f0 * mg,
            emap.tiles.data_ptr() + 12 * int(t0), int(t1 - t0), f0, p, mr,
            mg, int(p % EA_GROUP == 0 and F.data_ptr() % 16 == 0),
            _build.stream(F.device)]
    for b in range(0, len(flat), 4 * EA_MAX_PAIRS):
        part = flat[b:b + 4 * EA_MAX_PAIRS]
        args = array.array("q", head + [len(part) // 4] + part)
        err = fn(args.buffer_info()[0])
        _build.check(lib, "extend_add", err)
        extend_add_bucket.launches += 1
    return F


extend_add_bucket.launches = 0
