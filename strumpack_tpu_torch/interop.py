"""State carried across from the JAX package, as numpy arrays.

Nothing here imports JAX: callers (the tests) turn the JAX package's
device arrays into numpy first.  The plan needs no converter: the port
builds its own, identical one from the same matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .frontal.numeric import Factors, PlanDev


def factors_from_numpy(pdev: PlanDev, tree_np, device=None) -> Factors:
    """The JAX ``Factors.tree`` leaves as numpy,
    ``{"lu"|"perm"|"L21"|"U12": {"li,bi": ndarray}}``, -> the port's
    Factors on ``device`` (default: the plan's).  perm becomes int64."""
    device = pdev.device if device is None else torch.device(device)
    tree = {name: {} for name in ("lu", "perm", "L21", "U12")}
    for name in tree:
        for key, arr in tree_np[name].items():
            arr = np.asarray(arr)
            if name == "perm":
                arr = arr.astype(np.int64)
            tree[name][key] = torch.as_tensor(arr, device=device)
    dtype = next(iter(tree["lu"].values())).dtype
    return Factors(pdev, dtype, tree)
