"""Separator reordering for compression cluster trees.

Role of the reference's ``MatrixReordering::separator_reordering``
(``MatrixReordering.cpp:159-175``) with the per-front partition of
``FrontHSS::partition`` (``FrontHSS.cpp:531-551``) / ``FrontBLR``: before
numeric factorization, each large separator's induced graph is re-ordered
so that index-contiguous blocks are graph clusters; the BLR tiles / HSS
leaves (which in this framework are contiguous, uniformly sized blocks of
the padded separator) then correspond to graph neighborhoods, which is
what makes the off-diagonal blocks low-rank on non-geometric orderings.

Like the reference, the clustering is RECURSIVE BALANCED BISECTION of the
separator's induced graph (``CSRGraph::recursive_bisection``): each half
is a compact graph neighborhood, so contiguous index blocks at every scale
are clusters — exactly the structure HSS leaves and BLR tiles want.
(Bandwidth-minimizing RCM was measured WORSE than the natural ND order
here: it traverses a 2D separator surface as long thin strips, and strip-
to-strip interfaces have high rank; bisection gives square-ish patches.)
The numeric layer's uniform padded tiles approximate the reference's
uneven cluster tree; the bisection is balanced (exact halves) so cluster
boundaries land near uniform tile boundaries.

The permutation composes into the global fill-reducing permutation BEFORE
symbolic factorization (it permutes only within separators, so the
separator tree and the fill structure are unchanged — the reference
applies it after symbolic and renames the upd arrays instead,
``Front::permute_CB``, ``Front.cpp:615-631``)."""
from __future__ import annotations

import numpy as np

from .nd import _bfs_levels, _pseudo_peripheral


def _cluster_order(rowptr, colind, ids, leaf, out):
    """Recursive balanced bisection order of the induced subgraph: append
    ids to ``out`` so that contiguous runs at every power-of-two scale are
    graph neighborhoods (clusters of <= leaf at the finest level)."""
    if len(ids) <= leaf:
        out.append(ids)
        return
    lev = _bfs_levels(rowptr, colind, ids,
                      _pseudo_peripheral(rowptr, colind, ids))
    # order by (BFS level, id); exact-half split keeps clusters aligned
    # with the uniform tile boundaries of the padded fronts
    lev = np.where(lev < 0, lev.max() + 1, lev)
    order = np.lexsort((ids, lev))
    half = len(ids) // 2
    _cluster_order(rowptr, colind, ids[order[:half]], leaf, out)
    _cluster_order(rowptr, colind, ids[order[half:]], leaf, out)


def separator_reordering(Asymp, tree, opts) -> np.ndarray | None:
    """Within-separator clustering permutation.

    Asymp: the pattern-symmetrized matrix ALREADY permuted by the
    fill-reducing ordering (new[i,j] = old[perm[i], perm[j]]).
    tree:  SeparatorTree over that layout.
    opts:  SPOptions (compression type + thresholds).

    Returns q (new -> old, over Asymp's indexing) or None when no
    separator qualifies.  Compose as perm_total = perm[q].
    """
    from ...options import CompressionType as CT
    comp = getattr(opts, "compression", CT.NONE)
    if comp == CT.NONE or not getattr(opts, "separator_reordering", True):
        return None
    min_sep = int(getattr(opts, "compression_min_sep_size", 256))
    if comp == CT.HODLR:
        min_sep = int(getattr(opts, "hodlr_min_sep_size", min_sep))
    leaf = {CT.BLR: getattr(opts.blr, "leaf_size", 128)
            if hasattr(opts, "blr") else 128,
            CT.HSS: getattr(opts.hss, "leaf_size", 512)
            if hasattr(opts, "hss") else 512}.get(comp, 128)

    rowptr, colind = Asymp.rowptr, Asymp.colind
    q = np.arange(Asymp.n, dtype=np.int64)
    changed = False
    for i in range(tree.nseps):
        lo, hi = int(tree.sep_begin[i]), int(tree.sep_end[i])
        ds = hi - lo
        # every separator large enough to be compressed gets clustered
        # (the reference partitions every compressed front; leaf only
        # bounds the cluster size, not the eligibility)
        if ds < min(min_sep, 2 * leaf):
            continue
        parts = []
        _cluster_order(rowptr, colind,
                       np.arange(lo, hi, dtype=np.int64),
                       max(leaf // 4, 16), parts)
        r = np.concatenate(parts)
        if (r == np.arange(lo, hi)).all():
            continue
        q[lo:hi] = r
        changed = True
    return q if changed else None
