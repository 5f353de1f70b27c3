"""Level-batched execution plan for multifrontal factorization.

Role of the reference's GPU ``LevelInfo`` (FrontGPU.cpp:43-215) generalized
into the *only* numeric execution model: the host flattens the elimination
tree into levels (all fronts of equal depth), bins each level's fronts into
padded (sep_pad, upd_pad) buckets, and emits static index plans so the
numeric phase is gathers, scatter-adds and batched dense kernels over
uniform shapes.

* ragged separator sizes inside a bucket are handled by **identity padding**
  of F11: padding rows/cols hold 1 on the diagonal and 0 elsewhere, which is
  exact under partial-pivoted LU (a padding row can never be selected as a
  pivot for a real column and contributes nothing to the Schur update).
* sparse assembly is a single scatter-add of ``Avals[asm_vidx]`` into the
  bucket tensor; values are gathered from the device copy of the permuted
  CSR values, so ``update_matrix_values`` reuses the entire plan
  (the reference's structure-reuse feature, StrumpackSparseSolver.hpp:196).

The counterpart of ``strumpack_tpu/frontal/plan.py``: the plan arrays
and front-type flags are identical to that module's for every compression
the port runs (dense, BLR with or without compressed contribution blocks,
HSS built dense or by sampling, HODLR, HODBF (butterfly), lossy and
lossless, and the BLR_HODLR/ZFP_BLR_HODLR composites), chosen per bucket
as FrontFactory does, and so are the nf-chunks of the memory planner.
The distributed plan build is not part of this package yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..sparse.csr import CSRMatrix
from ..sparse.separator_tree import SeparatorTree

# Padded-size schedule: fine at small sizes (batch parallelism dominates),
# ~1.5x geometric at large sizes (bounds the number of bucket shapes and
# the pad waste).
_PAD_SCHEDULE = [0, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384,
                 24576, 32768]


def _build_ell(r, c, vidx_in, nrows, nnz_pad):
    """Pack COO (r, c, vidx) into padded ELL [nrows, kmax]: (cols, vidx)
    with padding slots pointing at the zero value (vals_ext[nnz_pad])."""
    if len(r) == 0:
        return (np.zeros((nrows, 1), np.int32),
                np.full((nrows, 1), nnz_pad, np.int64))
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], vidx_in[order]
    counts = np.bincount(r, minlength=nrows)
    kmax = max(int(counts.max()), 1)
    off = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    k = np.arange(len(r)) - off[r]
    cols = np.zeros((nrows, kmax), np.int32)
    vidx = np.full((nrows, kmax), nnz_pad, np.int64)
    cols[r, k] = c
    vidx[r, k] = v
    return cols, vidx


def pad_size(x: int) -> int:
    for p in _PAD_SCHEDULE:
        if p >= x:
            return p
    raise ValueError(f"front dimension {x} exceeds pad schedule")


def chunk_cap_bytes() -> int:
    """Working-set cap of one bucket above which it runs in nf-chunks:
    ``STRUMPACK_TPU_CHUNK_GB`` when set, else 3 GB, as in the JAX package
    (``strumpack_tpu/frontal/plan.py:69-78``)."""
    env = os.environ.get("STRUMPACK_TPU_CHUNK_GB")
    return int(float(env) * 1e9) if env else 3 * 10 ** 9


def choose_chunks(nf: int, p: int, itemsize: int = 4) -> int:
    """Sequential chunks of an [nf, p, p] bucket
    (``strumpack_tpu/frontal/plan.py:81-100``): 1 while the plain assembly
    model (3 dense [p, p] buffers a front) fits the cap, else the smallest
    power of two whose chunk fits the cap at 8 buffers a front."""
    cap = chunk_cap_bytes()
    if nf * 3 * p * p * itemsize <= cap:
        return 1
    per_front = 8 * p * p * itemsize
    chunks = 1
    while chunks < nf and (nf // chunks) * per_front > cap:
        chunks *= 2
    return chunks


def batch_pad(x: int) -> int:
    """Round a bucket's batch count up to a power of two (dummy identity
    fronts fill the tail), as the JAX plan does."""
    p = 1
    while p < x:
        p *= 2
    return p


@dataclass
class BucketPlan:
    """All fronts of one level sharing a padded (s_pad, u_pad) shape."""

    level: int
    s_pad: int
    u_pad: int
    fronts: np.ndarray          # [nf_real] global front ids
    ds: np.ndarray              # [nf] separator sizes (0 for dummy tail)
    du: np.ndarray              # [nf] update sizes (0 for dummy tail)
    # sparse assembly: F[asm_bidx, asm_r, asm_c] += vals_ext[asm_vidx]
    asm_bidx: np.ndarray = None   # [na] batch index
    asm_r: np.ndarray = None      # [na] row within the padded front
    asm_c: np.ndarray = None      # [na] col within the padded front
    asm_vidx: np.ndarray = None   # [na] index into extended values array
    # extend-add maps, one set per child side
    posL: np.ndarray = None     # [nf, p] slot -> index in left child's upd, -1
    posR: np.ndarray = None
    offL: np.ndarray = None     # [nf] offset into child level's flat CB buffer
    offR: np.ndarray = None
    strideL: np.ndarray = None  # [nf] child u_pad
    strideR: np.ndarray = None
    voffL: np.ndarray = None    # [nf] offset into child level's flat CB vector
    voffR: np.ndarray = None
    # solve-phase global index maps (value n = zero padding slot)
    sep_glob: np.ndarray = None  # [nf, s_pad]
    upd_glob: np.ndarray = None  # [nf, u_pad]
    # structural child-presence flags: hasL[k] == front k has a left
    # child with a nonempty update set
    hasL: np.ndarray = None      # [nf] bool
    hasR: np.ndarray = None      # [nf] bool
    # BLR front type (FrontFactory role: per-bucket front selection)
    blr: bool = False
    tile: int = 0                # BLR tile size t
    max_rank: int = 0            # BLR fixed max rank r
    adm_band: int = 0            # 0 = weak admissibility, 1 = strong
    blr_variant: str = "rl"      # "rl" eager / "ll" LUAR-accumulated
    lr_algo: str = "rrqr"        # tile compressor (LowRankAlgorithm role)
    cb_comp: int = 0             # CB BLR tile size, 0 = dense CB (F22blr_)
    cb_rank: int = 0             # compressed-CB rank cap (0 = tile/4)
    lossy: int = 0               # 0 = off, 4/8/16 = factor storage bits
    hss: bool = False            # HSS front built from the dense F11
    hodlr: bool = False          # HODLR front built from the dense F11
    hss_leaf: int = 0
    hss_rank: int = 0
    # sampling-constructed HSS front (FrontHSS::random_sampling role,
    # FrontHSS.cpp:241): never assembles the dense front; its closures
    # read the sparse block (ELL) and the children's CBs
    hss_sample: bool = False
    samp: dict = None            # per-front ELL arrays of the sparse block
    samp_meta: dict = None       # {"p": padded front width}
    # HODBF fronts (FrontHODLR with butterfly levels): F11 as HODLR with
    # butterfly off-diagonal blocks, S12 = F11^-1 F12 and F21 stored as
    # rectangular butterflies of depth bf_D and rank bf_r where bf_D >= 2;
    # bf_direct factors F11 by the direct butterfly factorization (dense
    # nodes up to bf_cutoff), else F11 is a HODLR front
    hodbf: bool = False
    bf_D: int = 0
    bf_r: int = 0
    bf_direct: bool = False
    bf_cutoff: int = 256
    # memory-bounded execution: the bucket's fronts are assembled and
    # factored nf / chunks at a time (``choose_chunks``)
    chunks: int = 1

    @property
    def nf(self) -> int:
        return len(self.ds)  # padded batch count

    @property
    def nf_real(self) -> int:
        return len(self.fronts)

    @property
    def p(self) -> int:
        return self.s_pad + self.u_pad

    @property
    def structured(self) -> bool:
        """HSS (dense-built or sampled), HODLR or HODBF fronts."""
        return self.hss or self.hodlr or self.hodbf or self.hss_sample

    @property
    def compressed(self) -> bool:
        """Rank-structured fronts: BLR, HSS, HODLR or HODBF."""
        return self.blr or self.structured


@dataclass
class LevelPlan:
    """Full factorization schedule: levels[0] is the deepest level."""

    n: int
    nnz: int
    tree: SeparatorTree
    upd: list
    levels: list = field(default_factory=list)  # list[list[BucketPlan]]
    cb_sizes: list = field(default_factory=list)   # flat CB floats per level
    cbv_sizes: list = field(default_factory=list)  # flat CB vector rows/level
    factor_nnz: int = 0
    factor_flops: int = 0
    max_front: int = 0

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def _assign_bucket_compression(bp: BucketPlan, compression) -> None:
    """Per-bucket front-type selection (FrontFactory role,
    FrontFactory.hpp:84-133; ``strumpack_tpu/frontal/plan.py:216-318``):
    resolves the configured CompressionType and its size thresholds into
    the bucket's blr/hss/hss_sample/hodlr/hodbf/lossy flags, with the BLR
    tile, rank cap, admissibility, schedule and compressor, the
    HSS/HODLR/HODBF leaf and rank, the butterfly depth, rank and direct
    factorization of HODBF fronts, and the compressed-CB tile and rank."""
    if compression is None:
        return
    from ..options import CompressionType as CT
    comp = compression.compression
    sp, up = bp.s_pad, bp.u_pad
    min_sep = compression.compression_min_sep_size
    # composite schemes resolve to a type per bucket (FrontFactory.hpp:
    # 92-124 + StrumpackOptions.hpp:1023-1040 per-level thresholds)
    eff = None
    if comp in (CT.BLR_HODLR, CT.ZFP_BLR_HODLR):
        if sp >= compression.hodlr_min_sep_size:
            # with hss.sampling the composite's top fronts are sampled HSS
            eff = CT.HSS if compression.hss.sampling else CT.HODLR
        elif sp >= min_sep:
            eff = CT.BLR
        elif (comp == CT.ZFP_BLR_HODLR
              and sp >= compression.lossy_min_sep_size):
            eff = CT.LOSSY
    elif comp not in (CT.NONE, CT.LOSSLESS) and sp >= min_sep:
        # LOSSLESS (the ZFP reversible role) stores exact factors
        eff = comp
    cb_comp = (compression.blr.cb_compression and up >= 128
               and up % 64 == 0)
    if eff == CT.BLR:
        from .blr import choose_tile
        bp.blr = True
        bp.tile = choose_tile(sp, up, compression.blr.leaf_size)
        bp.max_rank = max(4, min(compression.blr.max_rank, bp.tile // 2))
        if compression.blr.admissibility == "strong":
            bp.adm_band = 1
        bp.blr_variant = compression.blr.factor_algorithm
        bp.lr_algo = compression.blr.low_rank_algorithm
    elif eff == CT.LOSSY:
        bp.lossy = compression.lossy_precision
    elif eff in (CT.HSS, CT.HODLR, CT.HODBF):
        if eff == CT.HSS:
            if compression.hss.sampling:
                bp.hss_sample = True
            else:
                bp.hss = True
        elif eff == CT.HODBF or compression.hodlr_butterfly_levels > 0:
            bp.hodbf = True
        else:
            bp.hodlr = True
        bp.hss_leaf = min(compression.hss.leaf_size, max(sp // 4, 16))
        bp.hss_rank = min(compression.hss.max_rank, bp.hss_leaf)
        if bp.hodbf and sp >= 2 * bp.hss_leaf and compression.hodbf_direct:
            # the direct butterfly factorization of F11 when its HODLR
            # tree has a level
            bp.bf_direct = True
            bp.bf_cutoff = int(compression.hodbf_dense_cutoff)
        if bp.hodbf and up > 0:
            # the deepest even butterfly depth the [s_pad, u_pad] blocks
            # take (``structured/butterfly.bf_depth2`` at leaves >= 16)
            D = 0
            while (sp % 2 ** (D + 2) == 0 and up % 2 ** (D + 2) == 0
                   and min(sp, up) // 2 ** (D + 2) >= 16):
                D += 2
            bp.bf_D = D
            bp.bf_r = bp.hss_rank
    if cb_comp and bp.compressed:
        # memory-efficient variant: hand the parent a BLR-compressed CB
        # (FrontBLR F22blr_ role), 128-wide tiles where they divide u
        bp.cb_comp = 128 if up % 128 == 0 else 64
        bp.cb_rank = compression.blr.cb_rank_cap


def _sample_ell(bp, bidx, rr, cc, vv, nnz):
    """A sampled bucket's sparse block as per-front ELL arrays (rows and
    columns in padded front slots 0..p, F11's identity padding included,
    value indices into vals_ext so update_matrix_values reuses the plan),
    row-major and transposed; the bucket assembles nothing dense
    (``strumpack_tpu/frontal/plan.py:543-592``)."""
    p = bp.p
    per = []
    for bi in range(bp.nf):
        fm = bidx == bi
        padi = np.arange(int(bp.ds[bi]), bp.s_pad, dtype=np.int64)
        r1 = np.concatenate([rr[fm], padi])
        c1 = np.concatenate([cc[fm], padi])
        v1 = np.concatenate([vv[fm], np.full(len(padi), nnz + 1,
                                             dtype=np.int64)])
        per.append((_build_ell(r1, c1, v1, p, nnz),
                    _build_ell(c1, r1, v1, p, nnz)))

    def stack(side):
        w = max(e[side][0].shape[1] for e in per)
        cols = [np.pad(e[side][0], ((0, 0), (0, w - e[side][0].shape[1])))
                for e in per]
        vidx = [np.pad(e[side][1], ((0, 0), (0, w - e[side][1].shape[1])),
                       constant_values=nnz) for e in per]
        return np.stack(cols), np.stack(vidx)
    (c, v), (cT, vT) = stack(0), stack(1)
    bp.samp = dict(samp_ell_cols=c, samp_ell_vidx=v, samp_ellT_cols=cT,
                   samp_ellT_vidx=vT)
    bp.samp_meta = dict(p=p)
    z32 = np.zeros(0, dtype=np.int32)
    bp.asm_bidx = bp.asm_r = bp.asm_c = z32
    bp.asm_vidx = np.zeros(0, dtype=np.int64)


def build_plan(Ap: CSRMatrix, tree: SeparatorTree,
               upd: list[np.ndarray], compression=None,
               hbm_bytes=None) -> LevelPlan:
    """compression: None or an SPOptions-like object with fields
    ``compression`` (CompressionType), ``compression_min_sep_size`` and
    ``blr`` (BLROptions).  ``hbm_bytes``: the device memory the rank-cap
    pass plans for (``numeric.hbm_budget_bytes``)."""
    n, nnz = Ap.n, Ap.nnz
    nseps = tree.nseps
    depths = tree.depths()
    maxd = int(depths.max()) if nseps else 0

    ds_all = (tree.sep_end - tree.sep_begin).astype(np.int64)
    du_all = np.array([len(u) for u in upd], dtype=np.int64)

    # ---- global helper arrays ------------------------------------------
    # owner front of each matrix index
    front_of = np.empty(n, dtype=np.int64)
    for i in range(nseps):
        front_of[tree.sep_begin[i]:tree.sep_end[i]] = i
    # concatenated upd arrays with keyed search support
    cat_off = np.zeros(nseps + 1, dtype=np.int64)
    np.cumsum(du_all, out=cat_off[1:])
    upd_cat = (np.concatenate([np.asarray(u) for u in upd])
               if cat_off[-1] > 0 else np.empty(0, dtype=np.int64))
    # key = front * (n+1) + index, globally sorted (postorder front-major)
    upd_keys = (np.repeat(np.arange(nseps, dtype=np.int64), du_all) * (n + 1)
                + upd_cat if cat_off[-1] > 0
                else np.empty(0, dtype=np.int64))
    upd_off = cat_off[:-1]

    def find_in_upd(front_ids, glob):
        """Vectorized: position of glob[k] in upd[front_ids[k]], or -1."""
        key = front_ids * (n + 1) + glob
        pos = np.searchsorted(upd_keys, key)
        ok = (pos < len(upd_keys)) & (glob >= 0)
        hit = np.zeros(len(key), dtype=bool)
        hit[ok] = upd_keys[pos[ok]] == key[ok]
        local = np.where(hit, pos - upd_off[front_ids], -1)
        return local.astype(np.int64)

    # ---- bucket assignment ---------------------------------------------
    s_pad_all = np.array([pad_size(int(d)) for d in ds_all], dtype=np.int64)
    u_pad_all = np.array([pad_size(int(d)) for d in du_all], dtype=np.int64)

    plan = LevelPlan(n=n, nnz=nnz, tree=tree, upd=upd)
    # front -> cb offset / vec offset / batch index, assigned as levels build
    cb_off_of = np.full(nseps, -1, dtype=np.int64)
    cbv_off_of = np.full(nseps, -1, dtype=np.int64)
    batch_of = np.full(nseps, -1, dtype=np.int64)

    # global per-entry ownership for assembly (vectorized)
    rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ap.rowptr))
    cols_all = Ap.colind
    owner = front_of[np.minimum(rows_all, cols_all)]
    owner_depth = depths[owner]
    bucket_id_of = np.full(nseps, -1, dtype=np.int64)

    for k in range(maxd + 1):
        depth = maxd - k
        fids = np.nonzero(depths == depth)[0]
        level_buckets = []
        cb_total = 0
        cbv_total = 0
        # group by (s_pad, u_pad)
        keys = s_pad_all[fids] * (10**9) + u_pad_all[fids]
        for key in np.unique(keys):
            sel = fids[keys == key]
            nfr = len(sel)
            nf = batch_pad(nfr)
            ds_b = np.zeros(nf, dtype=np.int32)
            du_b = np.zeros(nf, dtype=np.int32)
            ds_b[:nfr] = ds_all[sel]
            du_b[:nfr] = du_all[sel]
            bp = BucketPlan(level=k, s_pad=int(s_pad_all[sel[0]]),
                            u_pad=int(u_pad_all[sel[0]]),
                            fronts=sel, ds=ds_b, du=du_b)
            sp, up, p = bp.s_pad, bp.u_pad, bp.p
            bp.chunks = choose_chunks(nf, p)
            _assign_bucket_compression(bp, compression)
            if bp.hss_sample:
                # sampled fronts are never assembled
                # (``strumpack_tpu/frontal/numeric.py:164-165``)
                bp.chunks = 1
            # structural child-presence flags (see BucketPlan.hasL doc)
            for side, cha in (("L", tree.lch), ("R", tree.rch)):
                chb = np.full(nf, -1, dtype=np.int64)
                chb[:nfr] = cha[sel]
                setattr(bp, "has" + side,
                        (chb >= 0) & (du_all[np.maximum(chb, 0)] > 0))
            batch_of[sel] = np.arange(nfr)
            # CB offsets in this level's flat buffers
            cb_off_of[sel] = cb_total + np.arange(nfr, dtype=np.int64) * (up * up)
            cbv_off_of[sel] = cbv_total + np.arange(nfr, dtype=np.int64) * up
            cb_total += nf * up * up
            cbv_total += nf * up

            # ---- solve index maps
            sb = np.zeros((nf, 1), dtype=np.int64)
            sb[:nfr, 0] = tree.sep_begin[sel]
            i_s = np.arange(sp)[None, :]
            bp.sep_glob = np.where(i_s < ds_b[:, None], sb + i_s, n)
            bp.sep_glob = bp.sep_glob.astype(np.int32)
            ug = np.full((nf, up), n, dtype=np.int32)
            for bi, f in enumerate(sel):
                ug[bi, :du_all[f]] = upd[int(f)]
            bp.upd_glob = ug

            # ---- extend-add pos arrays
            glob = np.full((nf, p), -1, dtype=np.int64)
            glob[:, :sp] = np.where(i_s < ds_b[:, None], sb + i_s, -1)
            glob[:, sp:] = np.where(ug[:, :up] < n, ug[:, :up], -1)
            for side in ("L", "R"):
                ch = np.full(nf, -1, dtype=np.int64)
                ch[:nfr] = (tree.lch if side == "L" else tree.rch)[sel]
                has = ch >= 0
                pos = np.full((nf, p), -1, dtype=np.int64)
                if has.any() and p > 0:
                    chh = ch[has]
                    pos[has] = find_in_upd(
                        np.repeat(chh, p), glob[has].ravel()).reshape(-1, p)
                off = np.where(has, cb_off_of[np.maximum(ch, 0)], 0)
                voff = np.where(has, cbv_off_of[np.maximum(ch, 0)], 0)
                stride = np.where(has, u_pad_all[np.maximum(ch, 0)], 1)
                setattr(bp, "pos" + side, pos.astype(np.int32))
                setattr(bp, "off" + side, off.astype(np.int64))
                setattr(bp, "voff" + side, voff.astype(np.int64))
                setattr(bp, "stride" + side, stride.astype(np.int32))
            level_buckets.append(bp)

        # ---- assembly plan for this level (vectorized over all entries)
        in_level = owner_depth == depth
        er = rows_all[in_level]
        ec = cols_all[in_level]
        eo = owner[in_level]
        ev = np.nonzero(in_level)[0]
        sb_e = tree.sep_begin[eo]
        se_e = tree.sep_end[eo]
        r_in_sep = (er >= sb_e) & (er < se_e)
        c_in_sep = (ec >= sb_e) & (ec < se_e)
        sp_e = s_pad_all[eo]
        rpos = np.where(r_in_sep, er - sb_e, sp_e + find_in_upd(eo, er))
        cpos = np.where(c_in_sep, ec - sb_e, sp_e + find_in_upd(eo, ec))
        # drop F22 entries (assembled at an ancestor) and any misses
        keep = r_in_sep | c_in_sep
        for bi_b, bp in enumerate(level_buckets):
            bucket_id_of[bp.fronts] = bi_b
        ebkt = bucket_id_of[eo]
        for bi_b, bp in enumerate(level_buckets):
            m = keep & (ebkt == bi_b)
            bidx = batch_of[eo[m]]
            vidx = ev[m]
            # identity padding of F11: diagonal ones on slots [ds, s_pad)
            pad_b, pad_i = np.nonzero(
                np.arange(bp.s_pad)[None, :] >= bp.ds[:, None])
            bp.asm_bidx = np.concatenate([bidx, pad_b]).astype(np.int32)
            bp.asm_r = np.concatenate([rpos[m], pad_i]).astype(np.int32)
            bp.asm_c = np.concatenate([cpos[m], pad_i]).astype(np.int32)
            bp.asm_vidx = np.concatenate(
                [vidx, np.full(len(pad_b), nnz + 1)]).astype(np.int64)
            if bp.hss_sample:
                _sample_ell(bp, batch_of[eo[m]], rpos[m], cpos[m], vidx,
                            nnz)

        plan.levels.append(level_buckets)
        plan.cb_sizes.append(cb_total)
        plan.cbv_sizes.append(cbv_total)

    # ---- generous initial rank caps (skip the adaptive restart) ---------
    # Start compressed buckets at the caps the adaptive-rank restart would
    # converge to (BLR: the tile size, HSS/HODLR: the leaf size, never
    # above an explicit user cap) when that storage fits in a quarter of
    # the device memory, as the JAX package does (plan.py:607-636);
    # saturation then cannot trigger.
    if any(bp.compressed for lvl in plan.levels for bp in lvl):
        from .numeric import hbm_budget_bytes, static_factor_bytes
        saved = [(bp.max_rank, bp.hss_rank)
                 for lvl in plan.levels for bp in lvl]
        for lvl in plan.levels:
            for bp in lvl:
                if bp.blr:
                    bp.max_rank = min(bp.tile, compression.blr.max_rank)
                if bp.structured:
                    bp.hss_rank = min(bp.hss_leaf, compression.hss.max_rank)
        budget = hbm_budget_bytes(None) if hbm_bytes is None else hbm_bytes
        if static_factor_bytes(plan) > 0.25 * budget:
            it = iter(saved)
            for lvl in plan.levels:
                for bp in lvl:
                    bp.max_rank, bp.hss_rank = next(it)

    # ---- stats ----------------------------------------------------------
    from ..sparse.symbolic import factor_flops, factor_nonzeros
    plan.factor_nnz = factor_nonzeros(tree, upd)
    plan.factor_flops = factor_flops(tree, upd)
    plan.max_front = int((ds_all + du_all).max()) if nseps else 0
    return plan
