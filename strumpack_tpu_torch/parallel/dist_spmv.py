"""Block-row distributed sparse matrix with a halo-exchange spmv.

The counterpart of ``strumpack_tpu/parallel/dist_spmv.py`` (``DistCSR``,
:86-427), the role of the reference's ``CSRMatrixMPI``
(CSRMatrixMPI.hpp:72-262): rows in contiguous blocks of ceil(n / P) over
the ranks (the mesh's axis-major order); each rank stores its block split
into a diagonal part (the columns it owns, local indices) and an
off-diagonal part (columns owned by others, indexed into its halo), both
padded ELL; a static halo plan lists, for every (source, destination)
pair, the source-local x entries the destination reads.  ``spmv_local``
sends those entries with one ``all_to_all`` (only the boundary moves),
then y = D x_local + O x_halo.

Built from the global matrix (every rank holds it in the replicated-
symbolic model) or from each rank's own contiguous block of rows
(``from_local_block``: the rows re-routed to their owners and the halo
lists exchanged through ``p2p.alltoallv``; no rank assembles the global
pattern).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dist as D
from . import p2p


def _ell(rows, cols, vidx, nrows, zcol, znnz):
    """COO (local row, column slot, value index) -> padded ELL (cols,
    value indices), padding at column ``zcol`` / value ``znnz``."""
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vidx[order]
    counts = np.bincount(r, minlength=nrows)
    w = max(int(counts.max(initial=0)), 1)
    off = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    k = np.arange(len(r)) - off[r]
    ec = np.full((nrows, w), zcol, np.int64)
    ev = np.full((nrows, w), znnz, np.int64)
    ec[r, k] = c
    ev[r, k] = v
    return ec, ev


class DistCSR:
    """Halo-exchange block-row distributed CSR over a Grid."""

    def __init__(self, A, grid, dtype=None, device=None):
        """From the global matrix ``A`` (a CSRMatrix every rank holds), on
        ``device`` (None: this rank's CUDA device, ``D.resolve_rank_device``;
        raises without CUDA)."""
        n = A.n
        self._setup(grid, n, device, dtype or A.data.dtype)
        lo, hi = self.lo, self.hi
        rowptr = np.asarray(A.rowptr)
        p0, p1 = int(rowptr[lo]), int(rowptr[hi])
        counts = np.diff(rowptr[lo:hi + 1])
        cols = np.asarray(A.colind[p0:p1], np.int64)
        # every rank's halo columns, to know what it must send
        need = []
        for d in range(self.nd):
            a, b = self.blocks[d]
            q0, q1 = int(rowptr[a]), int(rowptr[b])
            cc = np.asarray(A.colind[q0:q1], np.int64)
            need.append(np.unique(cc[(cc < a) | (cc >= b)]))
        self._build(counts, cols, need[self.me],
                    [self._mine(need[d]) for d in range(self.nd)])
        self._vsel = (p0, p1)
        self.set_values(A.data)

    def _setup(self, grid, n, device, dtype):
        self.grid = grid
        self.group = grid.group
        self.nd = grid.ndev
        self.me = grid.me
        self.n = n
        nb = -(-n // self.nd)
        self.nb = nb
        self.blocks = [(min(d * nb, n), min((d + 1) * nb, n))
                       for d in range(self.nd)]
        self.lo, self.hi = self.blocks[self.me]
        self.device = D.resolve_rank_device(device)
        self.dtype = np.dtype(dtype)

    def _owner(self, c):
        return np.minimum(c // self.nb, self.nd - 1)

    def _mine(self, halo):
        """The local indices (in this rank's block) among ``halo`` columns
        of another rank."""
        return halo[(halo >= self.lo) & (halo < self.hi)] - self.lo

    def _build(self, counts, cols, halo, send):
        """The ELL blocks of this rank's rows (``counts`` per row, global
        ``cols`` in CSR order, value i = the i-th entry of the block), its
        sorted halo columns and ``send[d]``: the local entries rank d
        reads."""
        nloc = self.hi - self.lo
        rows = np.repeat(np.arange(nloc, dtype=np.int64), counts)
        vidx = np.arange(len(cols), dtype=np.int64)
        own = (cols >= self.lo) & (cols < self.hi)
        self.nnz_local = len(cols)
        dc, dv = _ell(rows[own], cols[own] - self.lo, vidx[own], nloc, nloc,
                      len(cols))
        # halo slots: grouped by source rank, ascending columns
        self.halo = halo
        self.halo_counts = np.bincount(self._owner(halo),
                                       minlength=self.nd)
        slot = np.searchsorted(halo, cols[~own])
        oc, ov = _ell(rows[~own], slot, vidx[~own], nloc, len(halo),
                      len(cols))
        t = lambda a: torch.as_tensor(a, device=self.device)
        self.dcols, self.dvidx, self.ocols, self.ovidx = (
            t(dc), t(dv), t(oc), t(ov))
        self.send = [t(np.asarray(s, np.int64)) for s in send]

    @classmethod
    def from_local_block(cls, begin_row, local_rowptr, local_colind,
                         local_vals, n, grid, dtype=None, device=None):
        """From each rank's contiguous block of rows (``local_rowptr`` its
        [nrows + 1] pointer, global column indices), without assembling
        the global pattern (``dist_spmv.py:169``): the rows go to the ranks
        that own them in the ceil(n / P) layout (one alltoallv), then each
        rank tells the owners of its halo columns what it reads (a
        second)."""
        self = object.__new__(cls)
        lv = np.asarray(local_vals)
        self._setup(grid, n, device, dtype or lv.dtype)
        lrp = np.asarray(local_rowptr, np.int64)
        lci = np.asarray(local_colind, np.int64)
        begin = int(begin_row)
        nrows = len(lrp) - 1
        out, plan = {}, []
        for d in range(self.nd):
            a, b = self.blocks[d]
            a, b = max(a, begin), min(b, begin + nrows)
            if a >= b:
                continue
            q0, q1 = int(lrp[a - begin]), int(lrp[b - begin])
            out.setdefault(d, []).append(
                (a, np.diff(lrp[a - begin:b - begin + 1]), lci[q0:q1],
                 lv[q0:q1]))
            plan.append((d, q0, q1))
        got = p2p.alltoallv(out, self.group)
        parts = sorted((item for items in got.values() for item in items),
                       key=lambda t: t[0])
        # the order the value segments arrive in, for set_local_values
        self._send_plan = plan
        self._recv_order = sorted(
            ((item[0], src) for src, items in got.items() for item in items))
        counts = np.zeros(self.hi - self.lo, np.int64)
        for a, cnt, _, _ in parts:
            counts[a - self.lo:a - self.lo + len(cnt)] = cnt
        cols = (np.concatenate([p[2] for p in parts]) if parts
                else np.zeros(0, np.int64))
        vals = (np.concatenate([p[3] for p in parts]) if parts
                else np.zeros(0, self.dtype))
        halo = np.unique(cols[(cols < self.lo) | (cols >= self.hi)])
        own = self._owner(halo)
        ask = {s: halo[own == s] for s in np.unique(own).tolist()}
        asked = p2p.alltoallv(ask, self.group)
        send = [self._mine(asked[d]) if d in asked
                else np.zeros(0, np.int64) for d in range(self.nd)]
        self._build(counts, cols, halo, send)
        self._stage(vals)
        return self

    def _stage(self, vals):
        """Values of this rank's block (in block CSR order) into the ELL
        arrays."""
        ext = torch.as_tensor(np.concatenate(
            [np.asarray(vals, self.dtype), np.zeros(1, self.dtype)]),
            device=self.device)
        self.dvals = ext[self.dvidx]
        self.ovals = ext[self.ovidx]

    def set_values(self, data):
        """New values, same pattern, from the global value array."""
        p0, p1 = self._vsel
        self._stage(np.asarray(data)[p0:p1])

    def set_local_values(self, local_vals):
        """New values, same pattern, from each rank's own block rows
        (collective: the segments re-routed as at construction)."""
        lv = np.asarray(local_vals)
        out = {}
        for d, q0, q1 in self._send_plan:
            out.setdefault(d, []).append(lv[q0:q1])
        got = p2p.alltoallv(out, self.group)
        pos = {src: 0 for src in got}
        segs = []
        for _, src in self._recv_order:
            segs.append(got[src][pos[src]])
            pos[src] += 1
        self._stage(np.concatenate(segs) if segs
                    else np.zeros(0, self.dtype))

    def spmv_local(self, xl):
        """y = A x on this rank's rows, from its block of x: the halo
        entries exchanged, then the two padded-ELL products.  ``xl``
        [nloc] or [nloc, nrhs]."""
        squeeze = xl.ndim == 1
        X = xl[:, None] if squeeze else xl
        nrhs = X.shape[1]
        got = D.all_to_all([X[s].reshape(-1) for s in self.send], self.group)
        halo = torch.cat([g.view(-1, nrhs) for g in got]
                         + [X.new_zeros((1, nrhs))])
        xe = torch.cat([X, X.new_zeros((1, nrhs))])
        y = (torch.einsum("nw,nwr->nr", self.dvals.to(X.dtype),
                          xe[self.dcols])
             + torch.einsum("nw,nwr->nr", self.ovals.to(X.dtype),
                            halo[self.ocols]))
        return y[:, 0] if squeeze else y

    def spmv(self, x):
        """y = A x for a replicated x [n] (or [n, nrhs]): this rank's rows
        computed, then all-gathered."""
        x = torch.as_tensor(x, device=self.device)
        yl = self.spmv_local(x[self.lo:self.hi])
        return torch.cat(D.all_gather(yl, self.group))
