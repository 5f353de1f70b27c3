"""Binary separator / supernode tree.

Role of the reference's ``sparse/SeparatorTree.{hpp,cpp}`` (flat-array binary
tree: sizes/parent/lch/rch, SeparatorTree.hpp:83-99), built here directly by
geometric nested dissection.  Nodes are stored in postorder; node i's
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
