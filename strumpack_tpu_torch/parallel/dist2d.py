"""Dense LU of large fronts over the process grid.

The counterpart of ``strumpack_tpu/parallel/dist2d.py``: the role of the
reference's distributed dense front factorization (FrontDenseMPI.cpp:
150-205, ScaLAPACK pgetrf + ptrsm + pgemm on a 2D BLACS grid).  The JAX
package lays the front out with GSPMD sharding constraints or an owned
``shard_map`` layout and lets XLA insert the broadcasts; here every rank
holds its own blocks and the broadcasts, gathers and row exchanges are
the explicit collectives of ``parallel/dist.py``:

* ``grid_partial_factor`` (``dist2d.py:209``): contiguous blocks over the
  grid (rows over the grid rows, columns over the grid columns, chunks
  of ceil(p / parts) as GSPMD cuts them).  A panel loop: the [p - o, w]
  panel gathered to every rank and factored there
  (``_panel_factor_restricted``: kernel K4 where its design is not
  "global", else the library branch), its row interchanges applied to
  the blocks by exchanging the moved rows between the owners of each
  column block (the pdlaswp role), the U12 row panel solved on each
  column block, and the trailing update local to every rank.
* ``cyclic_partial_factor`` (``dist2d.py:459``): the tile-cyclic layout
  (rank (ri, ci) owns tiles I % pr == ri, J % pc == ci), pivoting within
  each diagonal tile with the owner row block physically permuted: the
  diagonal tile broadcast to all, the L column panel along grid rows,
  the U row panel along grid columns, then the local trailing update.
* ``sharded_blocked_lu`` / ``cyclic_blocked_lu`` (diagonal-tile
  pivoting, contiguous or cyclic tiles), ``sharded_blocked_lu_pivoted``
  (full partial pivoting: the grid factorization of the whole matrix)
  and their solves.

The factorizations end with one all-gather of the blocks, so their
outputs are replicated (the JAX package's cyclic code makes the same
trade-off: one gather per bucket against an owned layout kept resident).
Every decision that shapes a collective is taken from replicated data.
"""
from __future__ import annotations

import torch

from . import dist as D
from ..ops import front_lu as FL
from ..ops import panel_lu as PP


def _lu(D_, thresh):
    """Batched LU with partial pivoting, the tiny-pivot rule on U's
    diagonal: (lu, perm applied form)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(D_)
    perm = FL.lapack_pivots_to_perm(lu, piv)
    FL.replace_tiny_diagonal(lu, thresh)
    return lu, perm


def panel_route(rows, w, dtype):
    """Where ``_panel_factor_restricted`` factors a [rows, w] panel: "k4"
    when the kernel takes the dtype and its design for the panel's first
    (tallest) 128-column sub-panel is not the global-memory one, else
    "library" (``dist2d.py:153-190`` routes to the Pallas panel kernel up
    to MAX_PANEL_P rows on the TPU)."""
    if not (FL.kernel_dtype(dtype) and w > 0 and rows <= PP.MAX_PANEL_P):
        return "library"
    itemsize = torch.empty((), dtype=dtype).element_size()
    if PP.design(rows, min(w, PP.PANEL_W), itemsize)[0] == "global":
        return "library"
    return "k4"


def _k4_panel(pan, thresh, w, slim, pivot):
    """The panel over K4 in sub-panels of up to 128 columns (the kernel's
    width): each sub-panel's pivots applied to the panel by one row
    gather, then its U row block solved and the rest of the panel
    updated, as ``panel_lu.blocked_factor_bucket`` does for square
    fronts.  Returns (packed in permuted row order, pj)."""
    nf, rows, _ = pan.shape
    G = pan.clone()
    pj = torch.arange(rows, device=pan.device).expand(nf, rows)
    for jb in range(0, w, PP.PANEL_W):
        ws = min(PP.PANEL_W, w - jb)
        sub, pr = PP.panel_lu(G[:, :, jb:jb + ws].contiguous(), thresh, jb,
                              ws, slim, pivot=pivot)
        G[:, :, jb:jb + ws] = sub
        if pivot:
            q = PP.panel_perm(pr, rows, jb, ws)
            G = torch.gather(G, 1, q[:, :, None].expand(-1, -1, w))
            pj = torch.gather(pj, 1, q)
        if jb + ws < w:
            U = torch.linalg.solve_triangular(
                G[:, jb:jb + ws, jb:jb + ws], G[:, jb:jb + ws, jb + ws:],
                upper=False, unitriangular=True)
            G[:, jb:jb + ws, jb + ws:] = U
            G[:, jb + ws:, jb + ws:] -= torch.matmul(
                G[:, jb + ws:, jb:jb + ws], U)
    return G, pj


def _panel_factor_restricted(pan, thresh, w, slim, pivot=True):
    """Factor one [nf, rows, w] panel with pivoting restricted to the first
    ``slim`` rows (update rows belong to ancestors and never pivot into
    F11).  Returns (packed [nf, rows, w] in PERMUTED row order, pj [nf,
    rows] applied-form row permutation).  K4 (``ops/panel_lu.panel_lu``,
    ``_k4_panel``) where ``panel_route`` says so; else LU of the
    pivotable rows and a right triangular solve for the update rows."""
    nf, rows, _ = pan.shape
    if panel_route(rows, w, pan.dtype) == "k4":
        return _k4_panel(pan, thresh, w, slim, pivot)
    top = pan[:, :slim]
    dev = pan.device
    if pivot:
        lu_t, piv, _ = torch.linalg.lu_factor_ex(top)
        pp = FL.lapack_pivots_to_perm(lu_t, piv)
    else:
        lu_sq = FL.nopivot_factor_bucket(top[:, :w], thresh, w)[:, :w, :w]
        if slim > w:
            below1 = torch.linalg.solve_triangular(
                torch.triu(lu_sq), top[:, w:], upper=True, left=False)
            lu_t = torch.cat([lu_sq, below1], dim=1)
        else:
            lu_t = lu_sq
        pp = torch.arange(slim, device=dev).expand(nf, slim)
    FL.replace_tiny_diagonal(lu_t[:, :w, :w], thresh)
    if rows > slim:
        below = torch.linalg.solve_triangular(
            torch.triu(lu_t[:, :w, :w]), pan[:, slim:], upper=True,
            left=False)
        packed = torch.cat([lu_t, below], dim=1)
    else:
        packed = lu_t
    pj = torch.cat([pp, torch.arange(slim, rows, device=dev)
                    .expand(nf, rows - slim)], dim=1)
    return packed, pj


def _grid_blk(s: int) -> int:
    """Panel width of the grid partial factorization: the widest power of
    two dividing s giving at least 3 panels (``dist2d.py:195``)."""
    for b in (256, 128, 64, 32, 16, 8):
        if s % b == 0 and s // b >= 3:
            return b
    for b in (256, 128, 64, 32, 16, 8):
        if s % b == 0 and b < s:
            return b
    return s


def _cyclic_blk(p: int, s: int, pr: int, pc: int) -> int:
    """Tile size of the cyclic layout: the largest power of two dividing p
    and s whose tile count both grid dimensions divide, with enough
    separator tiles to balance (``dist2d.py:447``); 0 when none."""
    for b in (256, 128, 64, 32, 16, 8):
        if (p % b == 0 and s % b == 0
                and (p // b) % pr == 0 and (p // b) % pc == 0
                and s // b >= max(pr, pc, 2)):
            return b
    return 0


# ---------------------------------------------------------------------------
# contiguous blocks
# ---------------------------------------------------------------------------

def _chunks(n, parts):
    c = -(-n // parts)
    return [(min(i * c, n), min((i + 1) * c, n)) for i in range(parts)]


def _cut(a, b, lo, hi):
    """[a, b) cut to [lo, hi), as (start, stop) with start <= stop."""
    s, e = max(a, lo), min(b, hi)
    return (s, max(s, e))


class _Blocks:
    """A contiguous 2D layout of [nf, p, p] fronts over a Grid: rank
    (ri, ci) holds rows ``rows[ri]`` and columns ``cols[ci]``."""

    def __init__(self, grid, p):
        self.grid = grid
        self.rows = _chunks(p, grid.pr)
        self.cols = _chunks(p, grid.pc)
        self.r0, self.r1 = self.rows[grid.ri]
        self.c0, self.c1 = self.cols[grid.ci]

    def members(self, group):
        """Grid coordinates of the ranks of ``group`` in group rank order
        (the grid's group, a row group or a column group)."""
        g = self.grid
        if group == "all":
            ranks = g.ranks
        elif group == "column":          # same ci: g.row_group
            ranks = [g.rank_at(r, g.ci) for r in range(g.pr)]
        else:                            # same ri: g.col_group
            ranks = [g.rank_at(g.ri, c) for c in range(g.pc)]
        return [divmod(g.ranks.index(r), g.pc) for r in sorted(ranks)]

    def handle(self, group):
        g = self.grid
        return {"all": g.group, "column": g.row_group,
                "row": g.col_group}[group]

    def gather_region(self, Gl, r0, r1, c0, c1, group):
        """The region [r0, r1) x [c0, c1) of the distributed fronts, put
        together on every rank of ``group`` from the blocks of its ranks
        (each rank sends its part of the region)."""
        nf = Gl.shape[0]
        out = Gl.new_empty((nf, r1 - r0, c1 - c0))
        mem = self.members(group)
        cuts = []
        for ri, ci in mem:
            rr = _cut(*self.rows[ri], r0, r1)
            cc = _cut(*self.cols[ci], c0, c1)
            cuts.append((rr, cc))
        (mr, mc) = _cut(self.r0, self.r1, r0, r1), _cut(self.c0, self.c1,
                                                        c0, c1)
        mine = Gl[:, mr[0] - self.r0:mr[1] - self.r0,
                  mc[0] - self.c0:mc[1] - self.c0].reshape(-1)
        sizes = [nf * (rr[1] - rr[0]) * (cc[1] - cc[0]) for rr, cc in cuts]
        parts = D.all_gather(mine, self.handle(group), sizes=sizes)
        for (rr, cc), part in zip(cuts, parts):
            out[:, rr[0] - r0:rr[1] - r0, cc[0] - c0:cc[1] - c0] = \
                part.view(nf, rr[1] - rr[0], cc[1] - cc[0])
        return out

    def put(self, Gl, X, r0, c0):
        """Write the replicated block X (at global rows r0.., cols c0..)
        into this rank's part."""
        rr = _cut(self.r0, self.r1, r0, r0 + X.shape[1])
        cc = _cut(self.c0, self.c1, c0, c0 + X.shape[2])
        Gl[:, rr[0] - self.r0:rr[1] - self.r0,
           cc[0] - self.c0:cc[1] - self.c0] = \
            X[:, rr[0] - r0:rr[1] - r0, cc[0] - c0:cc[1] - c0]

    def swap_rows(self, Gl, pjf):
        """Apply the applied-form row permutation ``pjf`` [nf, p] (new row
        i = old row pjf[:, i]) to the blocks: the moved rows of each
        column block are exchanged between the ranks that hold them (the
        pdlaswp role); rows no front moves stay put."""
        nf, p = pjf.shape
        moved = (pjf != torch.arange(p, device=pjf.device)).any(dim=0)
        M = torch.nonzero(moved).flatten().tolist()     # replicated
        if not M:
            return Gl
        mem = self.members("column")
        owned = [[i for i in M if self.rows[ri][0] <= i < self.rows[ri][1]]
                 for ri, _ in mem]
        mine = [i - self.r0 for i in M if self.r0 <= i < self.r1]
        ncol = Gl.shape[2]
        part = Gl[:, mine].reshape(-1)
        got = D.all_gather(part, self.handle("column"),
                           sizes=[nf * len(o) * ncol for o in owned])
        old = Gl.new_empty((nf, p, ncol))       # rows M filled only
        for o, g in zip(owned, got):
            if o:
                old[:, o] = g.view(nf, len(o), ncol)
        if mine:
            rows_l = torch.tensor(mine, device=Gl.device)
            src = pjf[:, rows_l + self.r0]               # [nf, nm]
            Gl[:, rows_l] = torch.gather(
                old, 1, src[:, :, None].expand(-1, -1, ncol))
        return Gl

    def gather_all(self, Gl, p):
        return self.gather_region(Gl, 0, p, 0, p, "all")


def grid_partial_factor(F, grid, thresh, s_pad, pivot=True, blk=None):
    """Partial factorization of a small batch of large fronts F [nf, p, p]
    (replicated on every rank) over the grid's contiguous blocks
    (``dist2d.py:209``): the leading ``s_pad`` columns eliminated, in
    panels of ``blk`` (``_grid_blk(s_pad)``), pivoting restricted to the
    F11 rows.  Returns the bucket-factor tuple (lu [nf,s,s], perm [nf,s],
    L21 [nf,u,s], U12 [nf,s,u], CB [nf,u,u]), replicated."""
    nf, p, _ = F.shape
    s = int(s_pad)
    w0 = blk or _grid_blk(s)
    lay = _Blocks(grid, p)
    Gl = F[:, lay.r0:lay.r1, lay.c0:lay.c1].clone()
    ptot = torch.arange(p, device=F.device).expand(nf, p)
    for o in range(0, s, w0):
        w = min(w0, s - o)
        pan = lay.gather_region(Gl, o, p, o, o + w, "all")
        packed, pj = _panel_factor_restricted(pan, thresh, w, s - o,
                                              pivot=pivot)
        if pivot:
            pjf = torch.cat([torch.arange(o, device=F.device).expand(nf, o),
                             o + pj], dim=1)
            Gl = lay.swap_rows(Gl, pjf)
            ptot = torch.gather(ptot, 1, pjf)
        lay.put(Gl, packed, o, o)
        if o + w < p:
            c0, c1 = _cut(lay.c0, lay.c1, o + w, p)
            A12 = lay.gather_region(Gl, o, o + w, c0, c1, "column")
            U12 = torch.linalg.solve_triangular(
                packed[:, :w], A12, upper=False, unitriangular=True)
            lay.put(Gl, U12, o, c0)
            r0, r1 = _cut(lay.r0, lay.r1, o + w, p)
            if r1 > r0 and c1 > c0:
                L21 = packed[:, r0 - o:r1 - o]
                Gl[:, r0 - lay.r0:r1 - lay.r0, c0 - lay.c0:c1 - lay.c0] -= \
                    torch.matmul(L21, U12)
    G = lay.gather_all(Gl, p)
    return (G[:, :s, :s].contiguous(), ptot[:, :s].contiguous(),
            G[:, s:, :s].contiguous(), G[:, :s, s:].contiguous(),
            G[:, s:, s:].contiguous())


# ---------------------------------------------------------------------------
# tiles: cyclic and contiguous tile ownership
# ---------------------------------------------------------------------------

def _tile_lu(F, grid, thresh, ns, blk, cyclic, permute_left):
    """Tile LU of F [nf, p, p] (replicated) over the grid, ``ns`` diagonal
    tiles eliminated.  Tile row I belongs to grid row I % pr (cyclic) or
    I // ceil(nb / pr) (contiguous), tile column J likewise.  Each step:
    the diagonal tile broadcast from its owner and factored everywhere
    (pivoting within it, the tiny-pivot rule), the owner tile row
    physically permuted when ``permute_left`` (else only its part right
    of the diagonal, as the pivots are applied in the solve), the L
    column panel broadcast along grid rows, the U row panel along grid
    columns, the trailing update local.  Returns (G [nf, p, p]
    replicated, [perm of each diagonal tile])."""
    nf, p, _ = F.shape
    nb = p // blk
    g = grid
    if cyclic:
        orow = [I % g.pr for I in range(nb)]
        ocol = [J % g.pc for J in range(nb)]
    else:
        cr, cc = -(-nb // g.pr), -(-nb // g.pc)
        orow = [I // cr for I in range(nb)]
        ocol = [J // cc for J in range(nb)]
    rsel = [I for I in range(nb) if orow[I] == g.ri]
    csel = [J for J in range(nb) if ocol[J] == g.ci]
    T = F.reshape(nf, nb, blk, nb, blk).transpose(2, 3)  # [nf,I,J,b,b]
    Tl = T[:, rsel][:, :, csel].clone()
    perms = []
    for k in range(ns):
        own_r, own_c = orow[k] == g.ri, ocol[k] == g.ci
        lkr = rsel.index(k) if own_r else None
        lkc = csel.index(k) if own_c else None
        ir0 = sum(I <= k for I in rsel)       # local tiles below / right
        ic0 = sum(J <= k for J in csel)
        owner = g.rank_at(orow[k], ocol[k])
        Dk = (Tl[:, lkr, lkc].clone() if own_r and own_c
              else Tl.new_empty((nf, blk, blk)))
        D.broadcast(Dk, owner, g.group)
        lu_d, perm = _lu(Dk, thresh)
        perms.append(perm)
        idx = perm[:, :, None].expand(-1, -1, blk)
        if own_r and permute_left:
            Tl[:, lkr] = torch.gather(
                Tl[:, lkr], 2, idx[:, None].expand(-1, Tl.shape[2], -1, -1))
        Lcol = Tl.new_empty((nf, len(rsel) - ir0, blk, blk))
        if own_c and Lcol.shape[1]:
            Lcol = torch.linalg.solve_triangular(
                lu_d[:, None], Tl[:, ir0:, lkc], upper=True, left=False)
        if Lcol.shape[1]:
            D.broadcast(Lcol, g.rank_at(g.ri, ocol[k]), g.col_group)
        Urow = Tl.new_empty((nf, len(csel) - ic0, blk, blk))
        if own_r and Urow.shape[1]:
            rowp = Tl[:, lkr, ic0:]
            if not permute_left:
                rowp = torch.gather(rowp, 2, idx[:, None].expand(
                    -1, rowp.shape[1], -1, -1))
            Urow = torch.linalg.solve_triangular(
                lu_d[:, None], rowp, upper=False, unitriangular=True)
        if Urow.shape[1]:
            D.broadcast(Urow, g.rank_at(orow[k], g.ci), g.row_group)
        if Lcol.shape[1] and Urow.shape[1]:
            Tl[:, ir0:, ic0:] -= torch.matmul(Lcol[:, :, None],
                                              Urow[:, None, :])
        if own_c:
            Tl[:, ir0:, lkc] = Lcol
        if own_r:
            Tl[:, lkr, ic0:] = Urow
        if own_r and own_c:
            Tl[:, lkr, lkc] = lu_d
    # every rank's tiles, put together on all
    sizes, sels = [], []
    for r in sorted(g.ranks):
        ri, ci = divmod(g.ranks.index(r), g.pc)
        rs = [I for I in range(nb) if orow[I] == ri]
        cs = [J for J in range(nb) if ocol[J] == ci]
        sels.append((rs, cs))
        sizes.append(nf * len(rs) * len(cs) * blk * blk)
    parts = D.all_gather(Tl.reshape(-1), g.group, sizes=sizes)
    G = Tl.new_empty((nf, nb, nb, blk, blk))
    for (rs, cs), part in zip(sels, parts):
        if rs and cs:
            G[:, torch.tensor(rs)[:, None], torch.tensor(cs)[None, :]] = \
                part.view(nf, len(rs), len(cs), blk, blk)
    return G.transpose(2, 3).reshape(nf, p, p), perms


def cyclic_partial_factor(F, grid, thresh, s_pad, blk=None):
    """Tile-cyclic partial factorization of a batch of large fronts
    (``dist2d.py:459``): pivoting within each diagonal tile, the owner
    tile row physically permuted, so P A = L U with P block diagonal.
    Returns the bucket-factor tuple, replicated."""
    nf, p, _ = F.shape
    s = int(s_pad)
    if blk is None:
        blk = _cyclic_blk(p, s, grid.pr, grid.pc)
    if not (blk and p % blk == 0 and s % blk == 0
            and (p // blk) % grid.pr == 0 and (p // blk) % grid.pc == 0):
        raise ValueError(f"cyclic_partial_factor: p={p}, s={s}, blk={blk} "
                         f"on a {grid.pr} x {grid.pc} grid")
    G, perms = _tile_lu(F, grid, thresh, s // blk, blk, cyclic=True,
                        permute_left=True)
    perm = torch.cat([k * blk + q for k, q in enumerate(perms)], dim=1)
    return (G[:, :s, :s].contiguous(), perm, G[:, s:, :s].contiguous(),
            G[:, :s, s:].contiguous(), G[:, s:, s:].contiguous())


def sharded_blocked_lu(A, grid, blk=256, thresh=0.0):
    """Blocked LU of A [m, m] over contiguous tiles of the grid with
    pivoting within each diagonal block (``dist2d.py:36``).  Returns
    (LU packed [m, m] replicated, perms [nb, blk])."""
    m = A.shape[0]
    if m % blk:
        raise ValueError(f"sharded_blocked_lu: {m} % {blk} != 0")
    G, perms = _tile_lu(A[None], grid, thresh, m // blk, blk, cyclic=False,
                        permute_left=False)
    return G[0], torch.stack([q[0] for q in perms])


def cyclic_blocked_lu(A, grid, blk=256, thresh=0.0):
    """The tile-cyclic blocked LU (``dist2d.py:359``): the same
    factorization as ``sharded_blocked_lu`` with tile I x J on grid rank
    (I % pr, J % pc).  Returns (LU packed [m, m] replicated, perms [nb,
    blk])."""
    m = A.shape[0]
    nb = m // blk
    if m % blk or nb % grid.pr or nb % grid.pc:
        raise ValueError(f"cyclic_blocked_lu: {m} / {blk} tiles on a "
                         f"{grid.pr} x {grid.pc} grid")
    G, perms = _tile_lu(A[None], grid, thresh, nb, blk, cyclic=True,
                        permute_left=False)
    return G[0], torch.stack([q[0] for q in perms])


def sharded_blocked_lu_pivoted(A, grid, blk=256, thresh=0.0):
    """Blocked LU of A [m, m] with full partial pivoting across panels
    (``dist2d.py:94``, the pgetrf semantics): the grid factorization of
    the whole matrix.  Returns (LU of P A [m, m] replicated, perm [m]:
    row i of P A is row perm[i] of A)."""
    m = A.shape[0]
    if m % blk:
        raise ValueError(f"sharded_blocked_lu_pivoted: {m} % {blk} != 0")
    lu, perm, _, _, _ = grid_partial_factor(A[None], grid, thresh, m,
                                            pivot=True, blk=blk)
    return lu[0], perm[0]


def _block_sweeps(LU, b, blk, perms=None):
    """Forward (unit lower, per-block pivots ``perms`` if given) and
    backward block sweeps of LU x = b."""
    m = LU.shape[0]
    nb = m // blk
    b = b.clone()
    for k in range(nb):
        o = k * blk
        bk = b[o:o + blk]
        if perms is not None:
            bk = bk[perms[k]]
        yk = torch.linalg.solve_triangular(LU[o:o + blk, o:o + blk], bk,
                                           upper=False, unitriangular=True)
        b[o:o + blk] = yk
        if k < nb - 1:
            b[o + blk:] -= LU[o + blk:, o:o + blk] @ yk
    for k in range(nb - 1, -1, -1):
        o = k * blk
        xk = torch.linalg.solve_triangular(LU[o:o + blk, o:o + blk],
                                           b[o:o + blk], upper=True)
        b[o:o + blk] = xk
        if k > 0:
            b[:o] -= LU[:o, o:o + blk] @ xk
    return b


def sharded_lu_solve(LU, perms, b, blk=256):
    """Solve with ``sharded_blocked_lu`` / ``cyclic_blocked_lu`` factors
    (``dist2d.py:315``); the factors are replicated, so every rank runs
    the block sweeps.  b [m] or [m, k]."""
    squeeze = b.ndim == 1
    b2 = (b[:, None] if squeeze else b).to(LU.dtype)
    x = _block_sweeps(LU, b2, blk, perms)
    return x[:, 0] if squeeze else x


def sharded_lu_solve_pivoted(LU, perm, b, blk=256):
    """Solve with ``sharded_blocked_lu_pivoted`` factors (``dist2d.py:
    272``): b permuted by the composed row permutation, then the block
    sweeps."""
    squeeze = b.ndim == 1
    b2 = (b[:, None] if squeeze else b).to(LU.dtype)[perm]
    x = _block_sweeps(LU, b2, blk)
    return x[:, 0] if squeeze else x
