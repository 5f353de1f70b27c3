"""K1 (extend-add): the port's plain versions against the JAX package's
Pallas kernel in interpret mode, its XLA gather path and its two-side
composition on the buckets of a real plan, and the CUDA kernel's work map
(``EAMap``) against the plain version by a tile-by-tile emulation of the
kernel.  Each output element receives at most one addend a side, added in
the same order (left child, then right) in every version, so every
comparison here is bit-exact (tolerance 0)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref  # noqa: F401  (one torch thread a test worker)

import strumpack_tpu as sj
from strumpack_tpu.frontal import numeric as NJ
from strumpack_tpu.frontal.numeric import _extend_add_blocks
from strumpack_tpu.ops.pallas_extadd import (extend_add_pallas,
                                             precompute_windows)
from strumpack_tpu.sparse.gen import poisson3d

import strumpack_tpu_torch as st
from strumpack_tpu_torch.frontal import numeric as NT
from strumpack_tpu_torch.ops import extend_add as EA
from strumpack_tpu_torch.ops.extend_add import (EAMap, extend_add_bucket,
                                                extend_add_bucket_plain,
                                                extend_add_plain)


def _random_pos(rng, nf, p, u):
    """pos [nf, p]: each front embeds child rows 0..u-1 at u sorted parent
    slots (order preserving, total on the child), -1 elsewhere."""
    pos = np.full((nf, p), -1, np.int32)
    for f in range(nf):
        slots = np.sort(rng.choice(p, size=u, replace=False))
        pos[f, slots] = np.arange(u)
    return pos


def _port(F, C, idx, pos):
    """One pair through the bucket wrapper (its CPU path)."""
    pos = torch.from_numpy(pos)
    emap = EAMap(pos, pos, idx >= 0, idx >= 0)
    return extend_add_bucket(torch.from_numpy(F.copy()),
                             [(torch.from_numpy(C), torch.from_numpy(idx),
                               0)], pos, pos, emap).numpy()


@pytest.mark.parametrize("nf,p,u", [(3, 128, 64), (2, 256, 192)])
def test_plain_matches_pallas_interpret(nf, p, u):
    rng = np.random.default_rng(nf * 1000 + p)
    pos = _random_pos(rng, nf, p, u)
    idx = rng.permutation(nf).astype(np.int32)
    idx[0] = -1  # an absent front: F passes through untouched
    C = rng.standard_normal((nf, u, u)).astype(np.float32)
    F = rng.standard_normal((nf, p, p)).astype(np.float32)
    pos_m, clo = precompute_windows(pos, idx, u)
    want = np.asarray(extend_add_pallas(
        jnp.asarray(F), jnp.asarray(C), jnp.asarray(idx),
        jnp.asarray(pos_m), jnp.asarray(clo), interpret=True))
    np.testing.assert_array_equal(_port(F, C, idx, pos), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_gather_path(dtype):
    """Shapes the TPU kernel's gate rejects (p % 64 != 0, u < 64), a child
    bucket with more blocks than parent fronts, and fronts without a child
    (idx = -1) against ``_extend_add_blocks(..., pallas_ok=False)``."""
    rng = np.random.default_rng(7)
    nf, p, u, nfc = 6, 40, 24, 9
    pos = _random_pos(rng, nf, p, u)
    pos[4, :] = -1                      # a front whose slots all miss
    idx = rng.choice(nfc, size=nf, replace=False).astype(np.int32)
    idx[[1, 3]] = -1
    C = rng.standard_normal((nfc, u, u)).astype(dtype)
    F = rng.standard_normal((nf, p, p)).astype(dtype)
    want = np.asarray(_extend_add_blocks(
        jnp.asarray(F), [jnp.asarray(C)], jnp.asarray(pos),
        [(0, u, "idx")], {"idx": jnp.asarray(idx)}, pallas_ok=False))
    got = _port(F, C, idx, pos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[1, 3, 4]], F[[1, 3, 4]])


def test_plain_is_in_place():
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(_random_pos(rng, 2, 16, 8))
    F = torch.zeros(2, 16, 16, dtype=torch.float64)
    C = torch.ones(2, 8, 8, dtype=torch.float64)
    out = extend_add_plain(F, C, torch.tensor([1, 0], dtype=torch.int32),
                           pos)
    assert out.data_ptr() == F.data_ptr() and float(F.sum()) == 2 * 64


# ---------------------------------------------------------------------------
# a whole bucket: the pair table of a real plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plans():
    """The JAX package's and the port's PlanDev of Poisson 8^3 (geometric
    ND, the default options: 6 levels, 9 buckets that extend-add)."""
    A = poisson3d(8)
    ref = sj.SparseSolver(sj.SPOptions())
    ref.set_csr_matrix(A)
    ref.reorder(8, 8, 8)
    port = st.SparseSolver(st.SPOptions(), device="cpu")
    port.set_csr_matrix(st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
    port.reorder(8, 8, 8)
    return ref.pdev, port.pdev


def _draw(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _exact_blrcb(rng, nf, u, dtype):
    """Tiles of a BLR-compressed CB batch (t = u / 2, rank 2) with small
    integer entries, so that both packages densify it exactly: the
    comparison is of the extend-add, not of a product's rounding."""
    t = u // 2
    diag = rng.integers(-4, 5, (nf, 2, t, t)).astype(dtype)
    U = rng.integers(-3, 4, (nf, 2, t, 2)).astype(dtype)
    V = rng.integers(-3, 4, (nf, 2, 2, t)).astype(dtype)
    return (NJ.BLRCB(*(jnp.asarray(x) for x in (diag, U, V)), u, t),
            NT.BLRCB(*(torch.from_numpy(x) for x in (diag, U, V)), u, t))


def _child_cbs(rng, jp, tp, li, dtype, comp):
    """Random CBs of every bucket of level li - 1 as the two packages'
    cb_lists; the bucket ``comp`` as a BLR-compressed batch."""
    jcb, tcb = [], []
    for bi, bd in enumerate(tp.levels[li - 1]):
        nf, u = bd.bp.nf, bd.bp.u_pad
        if bi == comp:
            j, t = _exact_blrcb(rng, nf, u, dtype)
        else:
            x = _draw(rng, (nf, u, u), dtype)
            j, t = jnp.asarray(x), torch.from_numpy(x)
        jcb.append(j)
        tcb.append(t)
    return jcb, tcb


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_assemble(F, cb_list, a, pairsL, pairsR):
    """The JAX package's extend-add step of one bucket, traced as one
    program (op by op its gathers cost a compile each)."""
    for side, pairs in (("L", pairsL), ("R", pairsR)):
        if pairs:
            F = _extend_add_blocks(F, cb_list, a["pos" + side], list(pairs),
                                   a, pallas_ok=False)
    return F


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_bucket_plain_matches_jax_composition(plans, dtype):
    """``extend_add_bucket_plain`` on each bucket's pair table
    (``numeric._ea_pairs``) against the JAX package's assembly step
    (``strumpack_tpu/frontal/numeric.py:1046-1049``: ``_extend_add_blocks``
    for the left pairs, then the right), on every bucket of the plan that
    extend-adds, tolerance 0.  At each level one child bucket (one with an
    even u, referenced by a pair) hands on BLR-compressed CBs; fronts with
    idx = -1 in a pair, and dummy fronts without children, are among
    them."""
    jp, tp = plans
    rng = np.random.default_rng(5)
    seen = dict(buckets=0, compressed=0, idx_none=0, no_child=0)
    for li in range(1, len(tp.levels)):
        used = {pr.bk for bd in tp.levels[li]
                for pr in bd.pairsL + bd.pairsR}
        comp = min((bk for bk in used
                    if tp.levels[li - 1][bk].bp.u_pad % 2 == 0), default=-1)
        jcb, tcb = _child_cbs(rng, jp, tp, li, dtype, comp)
        for jbd, tbd in zip(jp.levels[li], tp.levels[li]):
            if not (tbd.has_L or tbd.has_R):
                continue
            a = jbd.host_arrays
            bp = tbd.bp
            F = _draw(rng, (bp.nf, bp.p, bp.p), dtype)
            want = _jax_assemble(
                jnp.asarray(F), jcb, {k: jnp.asarray(v) for k, v in a.items()
                                      if k.startswith(("pos", "idx"))},
                tuple(jbd.pairsL) if jbd.has_L else (),
                tuple(jbd.pairsR) if jbd.has_R else ())
            pairs = NT._ea_pairs(tbd, tcb, 0, bp.nf)
            got = extend_add_bucket_plain(torch.from_numpy(F.copy()), pairs,
                                          tbd.posL, tbd.posR)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            prs = tbd.pairsL + tbd.pairsR
            seen["buckets"] += 1
            seen["compressed"] += any(pr.bk == comp for pr in prs)
            seen["idx_none"] += any(bool((pr.idx < 0).any()) for pr in prs)
            seen["no_child"] += int((~bp.hasL & ~bp.hasR).sum())
    assert seen["buckets"] == 9 and seen["compressed"] > 0
    assert seen["idx_none"] > 0 and seen["no_child"] > 0, seen


def _emulate(F, pairs, posL, posR, emap, f0=0):
    """The CUDA kernel's walk over ``emap`` in numpy, tile by tile: the
    tile's compact rows and column groups, and for each pair in table
    order that holds the front, the addends where both maps hit.  Equal to
    the plain version only if the tiles cover every addend exactly once."""
    F = F.numpy().copy()
    pos = (posL.numpy(), posR.numpy())
    rows, groups = emap.rows.numpy(), emap.groups.numpy()
    t0, t1 = emap.tile_ptr[f0], emap.tile_ptr[f0 + F.shape[0]]
    for fg, r0, g0 in emap.tiles[t0:t1].numpy():
        f = fg - f0
        r = rows[fg, r0:r0 + EA.EA_TILE_ROWS]
        g = groups[fg, g0:g0 + EA.EA_TILE_GROUPS]
        r, g = r[r >= 0], g[g >= 0]
        c = (g[:, None] * EA.EA_GROUP + np.arange(EA.EA_GROUP)).ravel()
        c = c[c < F.shape[1]]
        for C, idx, side in pairs:
            k = int(idx[f])
            if k < 0:
                continue
            pr, pc = pos[side][f, r], pos[side][f, c]
            hit = (pr >= 0)[:, None] & (pc >= 0)[None, :]
            blk = F[f][np.ix_(r, c)]
            blk[hit] += C[k].numpy()[np.ix_(pr, pc)][hit]
            F[f][np.ix_(r, c)] = blk
    return F


def test_work_map_covers_every_addend(plans):
    """The kernel's work map of every bucket that extend-adds, walked as
    the kernel walks it: the whole bucket, its two halves as chunks (the
    map's front offset), and its second half as a shard slice
    (``EAMap.slice``), each bit-equal to the plain version; the launches
    the map counts are the plan's (one a bucket with pairs)."""
    _, tp = plans
    rng = np.random.default_rng(8)
    n = 0
    for li in range(1, len(tp.levels)):
        cbs = [torch.from_numpy(rng.standard_normal(
            (bd.bp.nf, bd.bp.u_pad, bd.bp.u_pad)))
            for bd in tp.levels[li - 1]]
        for bd in tp.levels[li]:
            if not (bd.has_L or bd.has_R):
                continue
            bp, emap = bd.bp, bd.ea_map()
            F = torch.from_numpy(rng.standard_normal((bp.nf, bp.p, bp.p)))
            pairs = NT._ea_pairs(bd, cbs, 0, bp.nf)
            want = extend_add_bucket_plain(F.clone(), pairs, bd.posL,
                                           bd.posR).numpy()
            np.testing.assert_array_equal(
                _emulate(F, pairs, bd.posL, bd.posR, emap), want)
            h = bp.nf // 2
            for f0, f1 in ((0, h), (h, bp.nf)):
                part = NT._ea_pairs(bd, cbs, f0, f1)
                np.testing.assert_array_equal(
                    _emulate(F[f0:f1], part, bd.posL[f0:f1], bd.posR[f0:f1],
                             emap, f0), want[f0:f1])
            np.testing.assert_array_equal(
                _emulate(F[h:], NT._ea_pairs(bd, cbs, h, bp.nf),
                         bd.posL[h:], bd.posR[h:], emap.slice(h, bp.nf)),
                want[h:])
            assert bd.ea_launches() == 1
            n += 1
    assert n == 9 == tp.ea_launches()


def _mixed_table(rng, nf, p, npairs):
    """``tests/test_torch_cuda.py``'s mixed pair tables on the CPU: sides
    mixed, child buckets of several u and block counts, each front taking
    a block from about a third of the pairs (some fronts from none, many
    from both sides and from several pairs of a side)."""
    posL = torch.from_numpy(_random_pos(rng, nf, p, p // 2))
    posR = torch.from_numpy(_random_pos(rng, nf, p, p // 3))
    has = np.zeros((2, nf), bool)
    pairs = []
    for k in range(npairs):
        side = int(rng.integers(2))
        u = (p // 2, p // 3)[side]
        nfc = int(rng.integers(1, 2 * nf + 1))
        idx = rng.integers(0, nfc, nf).astype(np.int32)
        idx[rng.random(nf) < 2 / 3] = -1
        has[side][idx >= 0] = True
        pairs.append((torch.from_numpy(rng.standard_normal((nfc, u, u))),
                      torch.from_numpy(idx), side))
    return pairs, posL, posR, has[0], has[1]


@pytest.mark.parametrize("nf,p,npairs", [(6, 40, 3), (5, 37, 5),
                                         (3, 130, 2 * EA.EA_MAX_PAIRS + 3)])
def test_work_map_mixed_tables(nf, p, npairs):
    """The kernel's walk over its map on the card tests' mixed pair tables
    (a table longer than one launch takes, p not a multiple of the column
    group): whole, by chunks and as a slice, bit-equal to the plain
    version; the launches the map counts."""
    rng = np.random.default_rng(nf * 100 + p)
    pairs, posL, posR, hasL, hasR = _mixed_table(rng, nf, p, npairs)
    emap = EAMap(posL, posR, hasL, hasR)
    F = torch.from_numpy(rng.standard_normal((nf, p, p)))
    want = extend_add_bucket_plain(F.clone(), pairs, posL, posR).numpy()
    np.testing.assert_array_equal(_emulate(F, pairs, posL, posR, emap), want)
    h = nf // 2
    for f0, f1 in ((0, h), (h, nf)):
        part = [(C, idx[f0:f1], side) for C, idx, side in pairs]
        np.testing.assert_array_equal(
            _emulate(F[f0:f1], part, posL[f0:f1], posR[f0:f1], emap, f0),
            want[f0:f1])
    part = [(C, idx[h:], side) for C, idx, side in pairs]
    np.testing.assert_array_equal(
        _emulate(F[h:], part, posL[h:], posR[h:], emap.slice(h, nf)),
        want[h:])
    assert emap.launches(0, nf, npairs) == -(-npairs // EA.EA_MAX_PAIRS)
