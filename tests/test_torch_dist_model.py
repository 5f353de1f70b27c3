"""The distributed solver's work model and routing, without processes.

The port's ``parallel.spmd.choose_modes`` gives the JAX package's mode map
and report for the plans of poisson2d(20) and Poisson 12^3 (dense, BLR
and HSS fronts) on meshes of 8, 2x2x2, 4x2 and 4 devices;
``dist2d._grid_blk`` and ``_cyclic_blk`` are the JAX package's; grid
panels go to kernel K4 exactly where its design is not the global one;
and the refusals: ``fully_distributed``, the slice-8 modes, no device."""
import types

import numpy as np
import pytest
import torch

from torch_ref import solver_pair

from strumpack_tpu.parallel import dist2d as GJ
from strumpack_tpu.parallel import spmd as SJ
from strumpack_tpu.sparse.gen import poisson2d, poisson3d

from strumpack_tpu_torch.ops import panel_lu as PP
from strumpack_tpu_torch.parallel import dist2d as GT
from strumpack_tpu_torch.parallel import spmd as ST


def _blr(o):
    o.blr.leaf_size = 16


def _hss(o):
    o.hss.leaf_size, o.hss.rel_tol = 16, 1e-6


# name: (matrix, grid, compression, tweak, SPOptions fields)
PLANS = {
    "p2d20": (lambda: poisson2d(20), (20, 20), "NONE", None,
              dict(nd_leaf=4)),
    "p3d12": (lambda: poisson3d(12), (12, 12, 12), "NONE", None, {}),
    "p3d12_blr": (lambda: poisson3d(12), (12, 12, 12), "BLR", _blr,
                  dict(compression_min_sep_size=16)),
    "p3d12_hss": (lambda: poisson3d(12), (12, 12, 12), "HSS", _hss,
                  dict(compression_min_sep_size=32)),
}
SHAPES = ((8,), (2, 2, 2), (4, 2), (4,))
_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        make, dims, comp, tweak, kw = PLANS[name]
        _PAIRS[name] = solver_pair(make(), dims, comp, tweak, **kw)
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_choose_modes_matches_jax(name):
    """Identical mode maps, reports within 1e-12, on every mesh shape."""
    ref, port = _pair(name)
    seen = set()
    for shape in SHAPES:
        mesh = types.SimpleNamespace(shape=dict(zip("abc", shape)))
        mj, rj = SJ.choose_modes(ref.pdev, mesh)
        mt, rt = ST.choose_modes(port.pdev, shape)
        assert mt == mj
        assert rt.keys() == rj.keys()
        for k, v in rj.items():
            assert abs(rt[k] - v) <= 1e-12 * max(abs(v), 1.0), k
        seen |= set(mj.values())
    if name == "p3d12":
        assert {"shard", "grid", "repl"} <= seen
    if name == "p3d12_blr":
        assert "tile" in seen


def test_panel_and_tile_widths_match_jax():
    for s in range(8, 2049, 8):
        assert GT._grid_blk(s) == GJ._grid_blk(s)
        for p in (s, s + 8, s + 64, 2 * s):
            for pr, pc in ((1, 1), (2, 1), (2, 2), (4, 2), (8, 1)):
                assert GT._cyclic_blk(p, s, pr, pc) == \
                    GJ._cyclic_blk(p, s, pr, pc)


def test_grid_panels_route_to_k4_unless_global(monkeypatch):
    """``panel_route`` picks the library branch exactly where
    ``panel_lu.design`` says "global" (and for complex or too-tall
    panels); the two branches factor a panel alike (the same pivots, the
    same entries row by row)."""
    for dt in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dt).element_size()
        for rows in range(8, PP.MAX_PANEL_P + 1, 40):
            for w in (8, 64, 128, 256):
                want = ("library"
                        if PP.design(rows, min(w, PP.PANEL_W), size)[0]
                        == "global" else "k4")
                assert GT.panel_route(rows, w, dt) == want
    assert GT.panel_route(64, 8, torch.complex128) == "library"
    assert GT.panel_route(PP.MAX_PANEL_P + 8, 8, torch.float32) == "library"
    calls = []
    plain = PP.panel_lu_plain
    monkeypatch.setattr(PP, "panel_lu",
                        lambda *a, **k: calls.append(a[0].shape)
                        or plain(*a, **k))
    rng = np.random.default_rng(0)
    glob = 16 * PP.K4_THREADS // 2 + 8          # f64 rows past a cluster
    for rows, w, k4 in ((glob, 8, False), (200, 136, True)):
        pan = torch.from_numpy(rng.standard_normal((2, rows, w)))
        n0 = len(calls)
        packed, pj = GT._panel_factor_restricted(pan, 0.0, w, rows - 16)
        assert (len(calls) > n0) == k4
        if k4:      # the library branch on the same panel
            monkeypatch.setattr(GT, "panel_route", lambda *a: "library")
            lib, pl = GT._panel_factor_restricted(pan, 0.0, w, rows - 16)
            monkeypatch.undo()
            # the same pivots; the rows not pivoted follow in another
            # order (K4: ascending, LAPACK: its swaps), so compare by row
            assert torch.equal(pj[:, :w], pl[:, :w])
            for a, q in ((packed, pj), (lib, pl)):
                a.scatter_(1, q[:, :, None].expand(-1, -1, w), a.clone())
            assert torch.allclose(packed, lib, rtol=0, atol=1e-12)


def test_refusals():
    """fully_distributed and the tile/struct/samp modes name slice 8; no
    CUDA and no device raises, in the solver, DistCSR and
    DistributedMatrix."""
    from strumpack_tpu_torch.parallel import DistributedSparseSolver
    with pytest.raises(NotImplementedError, match="slice 8"):
        DistributedSparseSolver(None, fully_distributed=True)
    _, port = _pair("p3d12_blr")
    grid = types.SimpleNamespace(ndev=4, me=0)
    with pytest.raises(NotImplementedError, match="slice 8"):
        ST.ShardedPlan(port.pdev, grid)
    if not torch.cuda.is_available():
        from strumpack_tpu_torch.parallel.dist_matrix import \
            DistributedMatrix
        from strumpack_tpu_torch.parallel.dist_spmv import DistCSR
        from strumpack_tpu_torch.sparse.gen import poisson2d as p2d
        g = types.SimpleNamespace(group=None, ndev=1, me=0)
        for make in (lambda: DistributedSparseSolver(None),
                     lambda: DistCSR(p2d(4), g),
                     lambda: DistributedMatrix(np.eye(4), g)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
