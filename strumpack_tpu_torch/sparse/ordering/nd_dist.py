"""Distributed-work nested dissection (MatrixReorderingMPI role).

The counterpart of ``strumpack_tpu/sparse/ordering/nd_dist.py`` on
``torch.distributed``: the reference's parallel reordering
(``sparse/ordering/MatrixReorderingMPI.{hpp,cpp}``: ParMETIS / PT-Scotch
compute the ND in parallel; each rank then owns local subtrees).

* every rank deterministically computes the TOP ``ceil(log2 P)``
  bisection levels over the pattern it holds (the replicated-symbolic
  model: every rank has the whole matrix);
* the resulting subgraphs are ordered IN PARALLEL, subgraph g on rank
  ``g % P``, with the native nested dissection (the heavy part of the
  analysis, where ParMETIS spends its time too);
* the per-subgraph permutations and separator subtrees are all-gathered
  (``parallel/dist.all_gather_object``) and composed into the global
  postorder (perm, iperm, SeparatorTree) identically on every rank.

The ordering is the JAX package's array for array: the same top
bisection, the same leaf split and the same composition.
"""
from __future__ import annotations

import numpy as np

from ..separator_tree import TreeAssembler
from .nd import _bisect, nested_dissection


def _top_bisection(rowptr, colind, n, levels):
    """Deterministic top ``levels`` bisection levels.  Returns a nested
    top-tree: leaves are id arrays (subgraphs), internal nodes
    ("sep", left, right, sep_ids)."""
    def rec(ids, d):
        if d == 0 or len(ids) <= 1:
            return ("leaf", ids)
        left, right, sep = _bisect(rowptr, colind, ids)
        if len(left) == 0 or len(right) == 0:
            return ("leaf", ids)
        return ("sep", rec(left, d - 1), rec(right, d - 1), sep)
    return rec(np.arange(n, dtype=np.int64), levels)


def _collect_leaves(node, out):
    if node[0] == "leaf":
        out.append(node[1])
        return
    _collect_leaves(node[1], out)
    _collect_leaves(node[2], out)


def _order_leaf(rowptr, colind, n, ids, leaf, splitter):
    """(perm ids, sep_begin, sep_end, lch, rch) of the subgraph ``ids``
    ordered by nested dissection on its own local numbering."""
    if len(ids) == 0:
        z = np.zeros(0, np.int64)
        return ids, z, z, z, z
    gl = np.full(n, -1, np.int64)
    gl[ids] = np.arange(len(ids))
    lrp, lci = [0], []
    for v in ids:
        cs = gl[colind[rowptr[v]:rowptr[v + 1]]]
        cs = cs[cs >= 0]
        lci.append(cs)
        lrp.append(lrp[-1] + len(cs))
    perm_l, _, tree_l = nested_dissection(
        np.asarray(lrp, np.int64),
        np.concatenate(lci) if lci else np.zeros(0, np.int64),
        len(ids), leaf=leaf, splitter=splitter)
    return (ids[perm_l], tree_l.sep_begin, tree_l.sep_end, tree_l.lch,
            tree_l.rch)


def nested_dissection_distributed(rowptr, colind, n, leaf: int = 32,
                                  splitter: str = "ml", group=None):
    """(perm, iperm, SeparatorTree) with the subgraph orderings computed in
    parallel across the ranks of ``group`` (default: the world); the
    sequential ND where ``torch.distributed`` is not initialized or the
    group has one rank.  Every rank of the group must call it."""
    import torch.distributed as dist
    P = (dist.get_world_size(group)
         if dist.is_available() and dist.is_initialized() else 1)
    if P <= 1:
        return nested_dissection(rowptr, colind, n, leaf=leaf,
                                 splitter=splitter)
    from ...parallel.dist import all_gather_object
    rowptr = np.asarray(rowptr)
    colind = np.asarray(colind)
    T = max(1, int(np.ceil(np.log2(P))))
    top = _top_bisection(rowptr, colind, n, T)
    leaves = []
    _collect_leaves(top, leaves)
    me = dist.get_rank(group)
    mine = {g: _order_leaf(rowptr, colind, n, ids, leaf, splitter)
            for g, ids in enumerate(leaves) if g % P == me}
    results = {}
    for part in all_gather_object(mine, group):
        results.update(part)

    # compose the global postorder on every rank identically
    tb = TreeAssembler()
    leaf_counter = [0]

    def compose(node):
        if node[0] == "leaf":
            g = leaf_counter[0]
            leaf_counter[0] += 1
            perm_ids, sb, se, lch, rch = results[g]
            if len(sb) == 0:
                lo, hi = tb.emit(perm_ids)
                return tb.add_node(lo, hi, -1, -1)
            off_v = tb._count
            off_n = len(tb.sep_begin)
            tb.emit(perm_ids)
            root = -1
            for i in range(len(sb)):
                root = tb.add_node(int(sb[i]) + off_v, int(se[i]) + off_v,
                                   int(lch[i]) + off_n if lch[i] >= 0
                                   else -1,
                                   int(rch[i]) + off_n if rch[i] >= 0
                                   else -1)
            return root
        _, lnode, rnode, sep = node
        lroot = compose(lnode)
        rroot = compose(rnode)
        lo, hi = tb.emit(sep)
        return tb.add_node(lo, hi, lroot, rroot)

    compose(top)
    return tb.finish(n)
