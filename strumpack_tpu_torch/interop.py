"""State carried across from the JAX package, as numpy arrays.

Nothing here imports JAX: callers (the tests) turn the JAX package's
device arrays into numpy first.  The plan needs no converter: the port
builds its own, identical one from the same matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .frontal.numeric import BLRCB, Factors, PlanDev

# the JAX structured objects' plain attributes (the rest are arrays)
_STATIC = ("m", "t", "mp", "L", "r", "rel_tol")


def _tensor(arr, device):
    arr = np.array(arr)                 # a writable copy
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)      # perms and ranks index as int64
    return torch.as_tensor(arr, device=device)


def _tree(v, device, batch=False):
    """Nested lists/tuples/dicts of arrays -> the same of tensors, with a
    leading front axis added when ``batch``."""
    if isinstance(v, dict):
        return {k: _tree(x, device, batch) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_tree(x, device, batch) for x in v)
    t = _tensor(v, device)
    return t[None] if batch else t


def _lu_from_lapack(lu, piv, device, batch):
    """A JAX ``lu_factor`` pair (packed LU, 0-based LAPACK row swaps) as
    the port's (LU, applied-form permutation)."""
    piv = np.asarray(piv)
    k = piv.shape[-1]
    flat = piv.reshape(-1, k)
    perm = np.tile(np.arange(k), (flat.shape[0], 1))
    rows = np.arange(flat.shape[0])
    for i in range(k):
        j = flat[:, i]
        perm[rows, i], perm[rows, j] = perm[rows, j], perm[rows, i].copy()
    return (_tree(lu, device, batch),
            _tree(perm.reshape(piv.shape), device, batch))


def _fnode_from_numpy(d, device, batch):
    from .structured.hodbf import FNode
    if d is None:
        return None
    kind = d["kind"]
    W = None
    if kind == "bf":
        W = hodbf_from_numpy(d["W"], device, batch)
    elif kind == "dense":
        W = _lu_from_lapack(*d["W"], device, batch)

    def opt(x):
        return None if x is None else _tree(x, device, batch)
    return FNode(kind, d["ml"], d["Dg"], d["rg12"], d["rg21"],
                 lu=(None if d["lu"] is None
                     else _lu_from_lapack(*d["lu"], device, batch)),
                 G12=opt(d["G12"]), G21=opt(d["G21"]), W=W,
                 f1=_fnode_from_numpy(d["f1"], device, batch),
                 f2=_fnode_from_numpy(d["f2"], device, batch))


def hodbf_from_numpy(d, device, batch=None):
    """A JAX ``HODBFMatrix`` (``d``: its attributes and factor chain as
    numpy, ``d["froot"]`` the FNode chain as nested dicts) as the port's,
    with the front axis added to a JAX object of one front."""
    from .structured.hodbf import HODBFMatrix
    H = HODBFMatrix.__new__(HODBFMatrix)
    if batch is None:
        batch = np.ndim(d["D"]) == 3
    for k in _STATIC:
        setattr(H, k, d[k])
    H.bf_D, H.bf_r = list(d["bf_D"]), list(d["bf_r"])
    H.D = _tree(d["D"], device, batch)
    H.bf12 = [_tree(b, device, batch) for b in d["bf12"]]
    H.bf21 = [_tree(b, device, batch) for b in d["bf21"]]
    H.nf = H.D.shape[0]
    H.dtype = H.D.dtype
    H._froot = _fnode_from_numpy(d.get("froot"), device, batch)
    return H


def structured_from_numpy(d, device):
    """A JAX ``HSSMatrix``, ``HODLRMatrix`` or ``HODBFMatrix`` as the
    port's object of the same kind.  ``d`` is the JAX object's attributes
    with its arrays as numpy (``d["kind"]`` "hss", "hodlr" or "hodbf"); a
    JAX object of one front (unbatched, as the JAX package keeps buckets
    of one front) gains the front axis."""
    from .structured.hodlr import HODLRMatrix
    from .structured.hss import HSSMatrix
    if d["kind"] == "hodbf":
        return hodbf_from_numpy(d, device)
    hss = d["kind"] == "hss"
    H = (HSSMatrix if hss else HODLRMatrix).__new__(
        HSSMatrix if hss else HODLRMatrix)
    one = np.ndim(d["D"]) == 3          # [nl, t, t] without a front axis
    for k in _STATIC:
        setattr(H, k, d[k])
    names = (("D", "Uleaf", "Vleaf", "Ru", "Rv", "B12", "B21", "ranks",
              "_ulv", "_root") if hss else
             ("D", "P12", "Q12", "P21", "Q21", "_leaf", "_smw"))
    for k in names:
        setattr(H, k, _tree(d[k], device, one))
    if not hss:                         # [nf, 1] per level -> [nf]
        H.ranks = [_tensor(np.reshape(r, -1), device)
                   for r in d["rank_arrays"]]
    H.nf = H.D.shape[0]
    H.dtype = H.D.dtype
    H._factored = True
    return H


def blrcb_from_numpy(diag, U, V, u, t, device):
    """The JAX package's BLRCB leaves -> the port's BLRCB."""
    return BLRCB(*(_tensor(a, device) for a in (diag, U, V)), u, t)


def _entry(name, val, device):
    if name == "blr":
        return tuple(_tensor(a, device) for a in val)
    if name == "hss":
        H, S12, F21 = val
        one = np.ndim(H["D"]) == 3

        def pair(x):
            if x is None:
                return None
            if isinstance(x, dict):     # a HODBF front's butterfly
                return _tree(x, device, one)
            if isinstance(x, tuple):    # a sampled front's pair
                return tuple(_tensor(a, device)[None] if np.ndim(a) == 2
                             else _tensor(a, device) for a in x)
            return _tensor(x, device)
        return structured_from_numpy(H, device), pair(S12), pair(F21)
    if isinstance(val, tuple):          # quantized (codes, row scales)
        q, scale = val
        return (torch.as_tensor(np.array(q), device=device),
                _tensor(scale, device))
    if np.asarray(val).dtype.name == "bfloat16":
        return torch.as_tensor(np.asarray(val, np.float32),
                               device=device).to(torch.bfloat16)
    return _tensor(val, device)


def factors_from_numpy(pdev: PlanDev, tree_np, dtype=None,
                       device=None) -> Factors:
    """The JAX ``Factors.tree`` leaves as numpy -> the port's Factors on
    ``device`` (default: the plan's).  ``tree_np`` maps "lu", "perm",
    "L21", "U12" (dense buckets; a lossy bucket's entries bf16 arrays or
    (codes, scales) pairs), "blr" (the 8-tuples ``(lud, perms, Uu, Vu,
    Ul, Vl, Du, Dl)``), "blr_ranks" and "hss" (``(H, S12, F21)``, H as
    ``structured_from_numpy`` takes it, S12/F21 arrays, butterfly
    dicts, sampled pairs or None) to ``{"li,bi": value}``; missing names
    are empty.  ``dtype`` is the compute dtype (default: that of the
    first exact factor)."""
    device = pdev.device if device is None else torch.device(device)
    tree = {}
    for name in ("lu", "perm", "L21", "U12", "blr", "blr_ranks", "hss"):
        tree[name] = {key: _entry(name, val, device)
                      for key, val in tree_np.get(name, {}).items()}
    if dtype is None:
        firsts = ([v for v in tree["lu"].values() if torch.is_tensor(v)
                   and v.dtype != torch.bfloat16]
                  + [e[0] for e in tree["blr"].values()]
                  + [e[0].D for e in tree["hss"].values()])
        dtype = firsts[0].dtype
    return Factors(pdev, dtype, tree)
