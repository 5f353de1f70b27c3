"""State carried across from the JAX package, as numpy arrays.

Nothing here imports JAX: callers (the tests) turn the JAX package's
device arrays into numpy first.  The plan needs no converter: the port
builds its own, identical one from the same matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .frontal.numeric import Factors, PlanDev


def _tensor(arr, device):
    arr = np.array(arr)                 # a writable copy
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)      # perms and ranks index as int64
    return torch.as_tensor(arr, device=device)


def factors_from_numpy(pdev: PlanDev, tree_np, device=None) -> Factors:
    """The JAX ``Factors.tree`` leaves as numpy -> the port's Factors on
    ``device`` (default: the plan's).  ``tree_np`` maps "lu", "perm",
    "L21", "U12" (dense buckets), "blr" (the 8-tuples ``(lud, perms, Uu,
    Vu, Ul, Vl, Du, Dl)``) and "blr_ranks" to ``{"li,bi": ndarray(s)}``;
    missing names are empty.  Integer arrays become int64."""
    device = pdev.device if device is None else torch.device(device)
    tree = {}
    for name in ("lu", "perm", "L21", "U12", "blr", "blr_ranks"):
        tree[name] = {}
        for key, val in tree_np.get(name, {}).items():
            tree[name][key] = (tuple(_tensor(a, device) for a in val)
                               if name == "blr" else _tensor(val, device))
    lus = (list(tree["lu"].values())
           or [entry[0] for entry in tree["blr"].values()])
    return Factors(pdev, lus[0].dtype, tree)
