"""Approximate minimum degree ordering (host).

Role of the reference's ``sparse/ordering/minimum_degree/AMDReordering.hpp``
+ ``amdbar.F`` (Amestoy-Davis-Duff AMD).  This is a compact quotient-graph
minimum-degree with element absorption — not the full AMD heuristic set, but
the same external-degree greedy core; adequate as a fallback ordering for
small/irregular problems (the primary ordering is nested dissection).
"""
from __future__ import annotations

import heapq

import numpy as np


def amd_order(rowptr, colind, n) -> np.ndarray:
    """Return perm with perm[new] = old (elimination order).

    Dispatches to the native C++ quotient-graph approximate minimum
    degree (native/hostsym.cpp min_degree_order — the amdbar.F role,
    usable at 64^3 scale); this Python clique-update version remains as
    the no-compiler fallback."""
    from ...native import min_degree_native
    p = min_degree_native(rowptr, colind, n, multiple=False)
    if p is not None:
        return p
    # adjacency sets, diagonal removed
    adj = [set() for _ in range(n)]
    for i in range(n):
        for p in range(rowptr[i], rowptr[i + 1]):
            j = int(colind[p])
            if j != i:
                adj[i].add(j)
                adj[j].add(i)

    eliminated = np.zeros(n, dtype=bool)
    heap = [(len(adj[i]), i) for i in range(n)]
    heapq.heapify(heap)
    perm = []
    while heap:
        d, v = heapq.heappop(heap)
        if eliminated[v] or d != len(adj[v]):
            continue  # stale entry
        eliminated[v] = True
        perm.append(v)
        nbrs = [u for u in adj[v] if not eliminated[u]]
        # form clique among neighbors (element absorption)
        for u in nbrs:
            adj[u].discard(v)
            adj[u].update(w for w in nbrs if w != u)
            heapq.heappush(heap, (len(adj[u]), u))
        adj[v] = set()
    return np.asarray(perm, dtype=np.int64)


def mmd_order(rowptr, colind, n) -> np.ndarray:
    """Multiple minimum degree: per pass, eliminate a maximal independent
    set of current-minimum-degree vertices before updating degrees.

    Role of the reference's ``sparse/ordering/genmmd/mmd*.F`` (Liu's
    multiple elimination MMD); same quotient-graph clique-update core as
    amd_order above.  Native C++ path first (hostsym.cpp, multiple=1)."""
    from ...native import min_degree_native
    p = min_degree_native(rowptr, colind, n, multiple=True)
    if p is not None:
        return p
    adj = [set() for _ in range(n)]
    for i in range(n):
        for p in range(rowptr[i], rowptr[i + 1]):
            j = int(colind[p])
            if j != i:
                adj[i].add(j)
                adj[j].add(i)
    eliminated = np.zeros(n, dtype=bool)
    perm = []
    remaining = n
    while remaining:
        degs = np.array([len(adj[i]) if not eliminated[i] else n + 1
                         for i in range(n)])
        dmin = int(degs.min())
        # maximal independent set among min-degree vertices
        batch = []
        blocked = set()
        for v in np.nonzero(degs == dmin)[0]:
            if v in blocked:
                continue
            batch.append(int(v))
            blocked.update(adj[v])
        for v in batch:
            eliminated[v] = True
            perm.append(v)
            nbrs = [u for u in adj[v] if not eliminated[u]]
            for u in nbrs:
                adj[u].discard(v)
                adj[u].update(w for w in nbrs if w != u)
            adj[v] = set()
        remaining -= len(batch)
    return np.asarray(perm, dtype=np.int64)


def mlf_order(rowptr, colind, n) -> np.ndarray:
    """Minimum local fill: greedily eliminate the vertex whose elimination
    creates the fewest new edges (the reference's MLF option,
    StrumpackOptions.hpp ReorderingStrategy::MLF).

    Native C++ exact-greedy path first (hostsym.cpp min_fill_order, lazy
    heap with per-vertex version counters — usable at 10^4-10^5 scale);
    this Python version remains as the no-compiler fallback."""
    from ...native import min_fill_native
    p = min_fill_native(rowptr, colind, n)
    if p is not None:
        return p
    adj = [set() for _ in range(n)]
    for i in range(n):
        for p in range(rowptr[i], rowptr[i + 1]):
            j = int(colind[p])
            if j != i:
                adj[i].add(j)
                adj[j].add(i)
    eliminated = np.zeros(n, dtype=bool)

    def fill(v):
        nbrs = [u for u in adj[v] if not eliminated[u]]
        f = 0
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                if nbrs[b] not in adj[nbrs[a]]:
                    f += 1
        return f

    heap = [(fill(i), len(adj[i]), i) for i in range(n)]
    heapq.heapify(heap)
    perm = []
    while heap:
        f, d, v = heapq.heappop(heap)
        if eliminated[v] or d != len(adj[v]):
            continue
        if f != fill(v):
            heapq.heappush(heap, (fill(v), len(adj[v]), v))
            continue
        eliminated[v] = True
        perm.append(v)
        nbrs = [u for u in adj[v] if not eliminated[u]]
        for u in nbrs:
            adj[u].discard(v)
            adj[u].update(w for w in nbrs if w != u)
            heapq.heappush(heap, (fill(u), len(adj[u]), u))
        adj[v] = set()
    return np.asarray(perm, dtype=np.int64)
