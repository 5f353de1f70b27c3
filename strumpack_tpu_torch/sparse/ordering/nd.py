"""Breadth-first level sets and pseudo-peripheral vertices of an induced
subgraph: the two helpers of ``strumpack_tpu/sparse/ordering/nd.py`` that
separator reordering needs.  The general-graph nested dissection itself
is not ported yet.
"""
from __future__ import annotations

import numpy as np


def _bfs_levels(rowptr, colind, mask_ids, start):
    """BFS over the subgraph induced by mask_ids (global ids), returns
    level array aligned with mask_ids and the last-level vertices."""
    gid_to_local = {int(g): i for i, g in enumerate(mask_ids)}
    n = len(mask_ids)
    lev = np.full(n, -1, dtype=np.int64)
    frontier = [gid_to_local[int(start)]]
    lev[frontier[0]] = 0
    d = 0
    while frontier:
        nxt = []
        for ul in frontier:
            g = mask_ids[ul]
            for p in range(rowptr[g], rowptr[g + 1]):
                v = int(colind[p])
                vl = gid_to_local.get(v)
                if vl is not None and lev[vl] == -1:
                    lev[vl] = d + 1
                    nxt.append(vl)
        frontier = nxt
        d += 1
    return lev


def _pseudo_peripheral(rowptr, colind, ids):
    """Find a pseudo-peripheral vertex of the induced subgraph."""
    start = ids[0]
    best_ecc = -1
    for _ in range(4):
        lev = _bfs_levels(rowptr, colind, ids, start)
        reach = lev >= 0
        ecc = int(lev[reach].max()) if reach.any() else 0
        if ecc <= best_ecc:
            break
        best_ecc = ecc
        last = ids[reach & (lev == ecc)]
        # pick min-degree vertex of the last level
        degs = rowptr[last + 1] - rowptr[last]
        start = last[int(np.argmin(degs))]
    return start
