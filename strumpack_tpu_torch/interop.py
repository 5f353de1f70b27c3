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
        if k in d:                      # the factors only once factored
            setattr(H, k, _tree(d[k], device, one))
    if not hss:                         # [nf, 1] per level -> [nf]
        H.ranks = [_tensor(np.reshape(r, -1), device)
                   for r in d["rank_arrays"]]
    H.nf = H.D.shape[0]
    H.dtype = H.D.dtype
    H._factored = ("_ulv" if hss else "_smw") in d
    return H


def facade_from_numpy(d, device):
    """A JAX ``StructuredMatrix`` (``structured/structured.py``) as the
    port's wrapper of the same type.  ``d`` holds ``type`` (the Type
    name), ``rows``, ``cols`` and the wrapper's state as numpy: ``h``
    (a ``structured_from_numpy`` dict) for HSS, HODLR and HODBF; ``bf``
    (the ButterflyMatrix's attributes, its butterfly ``bf`` a dict of
    arrays) for BUTTERFLY; ``U``, ``V`` for LR; ``q``, ``scale``, ``mp``,
    ``np_`` and ``lu`` (packed LU and applied-form permutation, or None)
    for LOSSY; ``t``, ``mpad``, ``r``, ``rel_tol``, ``Ap``, ``tiles``
    (diagonal tiles, U, V), ``ranks`` and ``fac`` (the 10-tuple of
    ``blr_factor_bucket``, or None) for BLR.  Each object gains the front
    axis the port's wrappers hold."""
    from .structured import structured as S
    from .structured.butterfly import ButterflyMatrix
    kind = S.Type[d["type"]]
    cls = {S.Type.HSS: S._HSSWrap, S.Type.HODLR: S._HODLRWrap,
           S.Type.HODBF: S._HODBFWrap, S.Type.BLR: S._BLRDense,
           S.Type.BUTTERFLY: S._ButterflyWrap, S.Type.LR: S._LRMatrix,
           S.Type.LOSSY: S._LossyMatrix}[kind]
    w = cls.__new__(cls)
    w.rows, w.cols = d["rows"], d["cols"]
    if kind in (S.Type.HSS, S.Type.HODLR, S.Type.HODBF):
        w.h = structured_from_numpy(d["h"], device)
    elif kind == S.Type.BUTTERFLY:
        b = d["bf"]
        w.bf = ButterflyMatrix.__new__(ButterflyMatrix)
        for k in ("m", "n", "D", "h", "b", "r", "rel_tol"):
            setattr(w.bf, k, b[k])
        w.bf.bf = _tree(b["bf"], device, batch=True)
        w.bf.ranks = (w.bf.bf["rkU"], w.bf.bf["rkV"])
        w.bf.dtype = w.bf.bf["B"].dtype
    elif kind == S.Type.LR:
        w.U, w.V = _tensor(d["U"], device), _tensor(d["V"], device)
    elif kind == S.Type.LOSSY:
        w.q = torch.as_tensor(np.array(d["q"]), device=device)
        w.scale = _tensor(d["scale"], device)
        w.mp, w.np_ = d["mp"], d["np_"]
        w._lu = None if d["lu"] is None else _tree(d["lu"], device)
    else:
        w.t, w.mpad, w.r = d["t"], d["mpad"], d["r"]
        w.opts = S.StructuredOptions(S.Type.BLR, rel_tol=d["rel_tol"],
                                     leaf_size=d["t"], max_rank=d["r"])
        w.Ap = _tensor(d["Ap"], device)
        w._tiles = _tree(d["tiles"], device)
        w._ranks = _tensor(d["ranks"], device)
        w._fac = None if d["fac"] is None else _tree(d["fac"], device)
    return w


def kernel_from_numpy(d, device):
    """A fitted JAX ``Kernel`` (``kernel/kernel.py``) as the port's on
    ``device``: ``d`` holds ``cls`` (the class name), ``h``, ``lam``
    (``p`` for ANOVA, ``K`` for a DenseKernel) and the fitted state as
    numpy, ``Xtrain``, ``weights``, ``order`` and ``M`` (a
    ``structured_from_numpy`` dict)."""
    from .kernel import kernel as KM
    k = getattr(KM, d["cls"]).__new__(getattr(KM, d["cls"]))
    k.h, k.lam = d["h"], d["lam"]
    k.device = torch.device(device)
    k.times = {}
    if "p" in d:
        k.p = d["p"]
    if "K" in d:
        k.K = _tensor(d["K"], device)
    k._Xtrain = _tensor(d["Xtrain"], device)
    k._weights = _tensor(d["weights"], device)
    k._order = _tensor(d["order"], device)
    k._M = structured_from_numpy(d["M"], device)
    return k


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


def _front_slice(v, f0, f1):
    """Fronts f0..f1 of a factor entry: tensors and tuples of tensors
    along their front axis."""
    if torch.is_tensor(v):
        return v[f0:f1]
    if isinstance(v, tuple):
        return tuple(_front_slice(x, f0, f1) for x in v)
    raise NotImplementedError(
        f"slicing a {type(v).__name__} factor entry over ranks (structured "
        "fronts of shard buckets come with slice 8 of the port)")


def shard_factors(fac: Factors, sp) -> dict:
    """One rank's share of single-device factors (e.g. carried from the
    JAX package by ``factors_from_numpy``) under a ``parallel.spmd.
    ShardedPlan``: its fronts of each shard bucket, the other buckets
    whole -- the tree ``parallel.spmd.solve`` takes."""
    tree = {}
    for name, entries in fac.tree.items():
        tree[name] = {}
        for key, val in entries.items():
            li, bi = map(int, key.split(","))
            if (li, bi) in sp.bounds:
                val = _front_slice(val, *sp.bounds[(li, bi)])
            tree[name][key] = val
    return tree
