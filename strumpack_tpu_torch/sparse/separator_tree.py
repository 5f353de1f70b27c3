"""Binary separator / supernode tree.

Role of the reference's ``sparse/SeparatorTree.{hpp,cpp}`` (flat-array binary
tree: sizes/parent/lch/rch, SeparatorTree.hpp:83-99; built either directly by
nested dissection or from the etree of a permuted matrix,
``build_sep_tree_from_perm:115``).  Nodes are stored in postorder; node i's
separator occupies the contiguous index range [sep_begin[i], sep_end[i]) of
the permuted matrix.
"""
from __future__ import annotations

import numpy as np


class SeparatorTree:
    def __init__(self, sep_begin, sep_end, parent, lch, rch):
        self.sep_begin = np.asarray(sep_begin, dtype=np.int64)
        self.sep_end = np.asarray(sep_end, dtype=np.int64)
        self.parent = np.asarray(parent, dtype=np.int64)
        self.lch = np.asarray(lch, dtype=np.int64)
        self.rch = np.asarray(rch, dtype=np.int64)
        self.nseps = len(self.sep_begin)

    @property
    def root(self) -> int:
        return self.nseps - 1  # postorder: root is last

    def sep_size(self, i: int) -> int:
        return int(self.sep_end[i] - self.sep_begin[i])

    def depths(self) -> np.ndarray:
        """Depth of each node from the root (root depth 0)."""
        d = np.zeros(self.nseps, dtype=np.int64)
        for i in range(self.nseps - 2, -1, -1):  # reverse postorder: parents first
            d[i] = d[self.parent[i]] + 1
        return d

    def n_levels(self) -> int:
        return int(self.depths().max()) + 1 if self.nseps else 0

    def check(self, n: int) -> None:
        """Structural invariants (postorder, contiguous coverage of [0,n))."""
        assert self.sep_end[self.root] == n
        cov = np.zeros(n, dtype=bool)
        for i in range(self.nseps):
            lo, hi = self.sep_begin[i], self.sep_end[i]
            assert lo <= hi
            assert not cov[lo:hi].any()
            cov[lo:hi] = True
            l, r = self.lch[i], self.rch[i]
            if l >= 0:
                assert l < i and self.parent[l] == i
                assert self.sep_end[l] <= lo
            if r >= 0:
                assert r < i and self.parent[r] == i
                assert self.sep_end[r] <= lo
        assert cov.all()


class TreeAssembler:
    """Accumulates nodes in postorder while a recursive ND emits vertices."""

    def __init__(self):
        self.sep_begin = []
        self.sep_end = []
        self.parent = []
        self.lch = []
        self.rch = []
        self.perm = []  # perm[new] = old
        self._count = 0

    def emit(self, vertices) -> tuple[int, int]:
        lo = self._count
        self.perm.extend(int(v) for v in vertices)
        self._count += len(vertices)
        return lo, self._count

    def add_node(self, lo: int, hi: int, left: int, right: int) -> int:
        nid = len(self.sep_begin)
        self.sep_begin.append(lo)
        self.sep_end.append(hi)
        self.parent.append(-1)
        self.lch.append(left)
        self.rch.append(right)
        if left >= 0:
            self.parent[left] = nid
        if right >= 0:
            self.parent[right] = nid
        return nid

    def finish(self, n: int):
        assert self._count == n, (self._count, n)
        tree = SeparatorTree(self.sep_begin, self.sep_end, self.parent,
                             self.lch, self.rch)
        perm = np.asarray(self.perm, dtype=np.int64)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(n, dtype=np.int64)
        return perm, iperm, tree


def from_etree_perm(rowptr, colind, n, perm, iperm, leaf: int = 32,
                    amalg: int = 8, return_perm: bool = False):
    """Build a separator tree from an arbitrary fill-reducing permutation by
    supernode-amalgamating the elimination tree of the permuted pattern.

    Role of SeparatorTree::build_sep_tree_from_perm (SeparatorTree.cpp) plus
    the MUMPS SYMQAMD relaxed amalgamation (mumps_symqamd.hpp, enabled by
    --sp_enable_MUMPS_SYMQAMD in the reference), used for RCM/AMD/MMD
    orderings that do not produce a tree themselves.  Two amalgamation
    stages:

    1. chain supernodes: consecutive columns forming an etree chain merge
       up to ``leaf`` columns (fundamental-supernode relaxation);
    2. relaxed amalgamation: a child supernode of <= ``amalg`` columns is
       absorbed into its parent (the absorbed columns are *reordered* to sit
       directly below the parent's), trading a little fill for far fewer /
       larger fronts — exactly the tradeoff that feeds the level-batched
       execution model.

    Stage 2 changes the ordering, so with ``return_perm`` the function
    returns ``(perm2, iperm2, tree)`` where perm2 is the composed
    permutation; the plain return (tree only, stage 2 disabled) keeps the
    given order, as NATURAL needs.
    """
    from scipy.sparse import csr_matrix
    A = csr_matrix((np.ones(len(colind), np.int8), colind, rowptr),
                   shape=(n, n))
    Ap = A[perm, :][:, perm]
    Ap = (Ap + Ap.T).tocsr()

    # elimination tree of the (structurally symmetric) permuted pattern
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for p in range(Ap.indptr[j], Ap.indptr[j + 1]):
            i = Ap.indices[p]
            if i >= j:
                continue
            while True:
                a = ancestor[i]
                ancestor[i] = j
                if a == -1:
                    if parent[i] == -1:
                        parent[i] = j
                    break
                if a == j:
                    break
                i = a

    # ---- stage 1: group consecutive chain columns into supernodes
    snode = np.full(n, -1, dtype=np.int64)
    heads = []
    j = 0
    while j < n:
        lo = j
        hi = j + 1
        while (hi < n and parent[hi - 1] == hi and hi - lo < leaf):
            hi += 1
        heads.append((lo, hi))
        snode[lo:hi] = len(heads) - 1
        j = hi

    ns = len(heads)
    sparent = np.full(ns, -1, dtype=np.int64)
    for s, (lo, hi) in enumerate(heads):
        p = parent[hi - 1]
        if p >= 0:
            sparent[s] = snode[p]

    # member column lists + children lists (supernodes are in postorder-
    # compatible ascending order: sparent[s] > s always)
    members = [list(range(lo, hi)) for lo, hi in heads]
    kids = [[] for _ in range(ns)]
    for s in range(ns):
        if sparent[s] >= 0:
            kids[sparent[s]].append(s)

    # ---- stage 2: relaxed amalgamation (SYMQAMD role) — absorb small
    # child supernodes into their parent, reordering their columns up
    if return_perm and amalg > 0:
        alive = np.ones(ns, dtype=bool)
        for s in range(ns):  # ascending = children before parents
            p = sparent[s]
            if p < 0 or not alive[s]:
                continue
            if len(members[s]) <= amalg:
                # absorb: columns join the parent's supernode (eliminated
                # together in one dense block), children reparent
                members[p] = members[s] + members[p]
                for c in kids[s]:
                    sparent[c] = p
                kids[p] = kids[s] + [c for c in kids[p] if c != s]
                alive[s] = False
                members[s] = []
                kids[s] = []
    else:
        alive = np.ones(ns, dtype=bool)

    roots = [s for s in range(ns) if alive[s] and sparent[s] < 0]

    # ---- emit: postorder traversal producing the (re)composed column
    # order and contiguous supernode ranges; binarize multi-child nodes
    # with empty-separator internal nodes
    sb, se, par, lc, rc = [], [], [], [], []
    order = []  # permuted-matrix column ids in final order

    def _set_parent(c, p):
        par[c] = p

    def build(s):
        ch = [build(c) for c in kids[s]]
        left = right = -1
        if len(ch) == 1:
            left = ch[0]
        elif len(ch) >= 2:
            left = ch[0]
            for c in ch[1:-1]:  # fold extras into dummy internal nodes
                nid = len(sb)
                sb.append(len(order))
                se.append(len(order))
                par.append(-1)
                lc.append(left)
                rc.append(c)
                _set_parent(left, nid)
                _set_parent(c, nid)
                left = nid
            right = ch[-1]
        lo = len(order)
        order.extend(members[s])
        nid = len(sb)
        sb.append(lo)
        se.append(len(order))
        par.append(-1)
        lc.append(left)
        rc.append(right)
        if left >= 0:
            _set_parent(left, nid)
        if right >= 0:
            _set_parent(right, nid)
        return nid

    if len(roots) == 1:
        build(roots[0])
    else:
        # forest: join roots under dummy empty-separator nodes
        built = [build(r) for r in roots]
        left = built[0]
        for c in built[1:]:
            nid = len(sb)
            sb.append(len(order))
            se.append(len(order))
            par.append(-1)
            lc.append(left)
            rc.append(c)
            _set_parent(left, nid)
            _set_parent(c, nid)
            left = nid

    tree = SeparatorTree(sb, se, par, lc, rc)
    if not return_perm:
        return tree
    order = np.asarray(order, dtype=np.int64)
    perm2 = np.asarray(perm, dtype=np.int64)[order]
    iperm2 = np.empty_like(perm2)
    iperm2[perm2] = np.arange(n, dtype=np.int64)
    return perm2, iperm2, tree
