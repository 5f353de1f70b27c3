"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` and skip elsewhere.  The file
imports neither JAX nor strumpack_tpu, so it also runs on a machine without
them, with the JAX-pinning conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from strumpack_tpu_torch.ops import front_lu as FL
from strumpack_tpu_torch.ops import panel_lu as PP
from strumpack_tpu_torch.ops.extend_add import extend_add, extend_add_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _random_pos(rng, nf, p, u):
    pos = np.full((nf, p), -1, np.int32)
    for f in range(nf):
        slots = np.sort(rng.choice(p, size=u, replace=False))
        pos[f, slots] = np.arange(u)
    return pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_extend_add_kernel_bit_exact(cuda_device, dtype):
    rng = np.random.default_rng(11)
    for nf, p, u, nfc in ((5, 40, 24, 7), (2, 300, 200, 3)):
        pos = torch.from_numpy(_random_pos(rng, nf, p, u)).to(cuda_device)
        idx = rng.choice(nfc, size=nf, replace=False).astype(np.int32)
        idx[0] = -1
        idx = torch.from_numpy(idx).to(cuda_device)
        C = torch.randn(nfc, u, u, dtype=dtype, device=cuda_device)
        F = torch.randn(nf, p, p, dtype=dtype, device=cuda_device)
        before = extend_add.launches
        got = extend_add(F.clone(), C, idx, pos)
        assert extend_add.launches == before + 1
        assert torch.equal(got, extend_add_plain(F.clone(), C, idx, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf,p,s", [(300, 48, 16), (40, 216, 24)])
def test_front_lu_kernel_matches_plain(cuda_device, dtype, nf, p, s):
    """The kernel repeats the plain version's rounding (separate multiply
    and subtract), so perm and all factors agree exactly."""
    gen = torch.Generator(device="cpu").manual_seed(nf + p)
    F = torch.randn(nf, p, p, dtype=dtype, generator=gen).to(cuda_device)
    F[0, :, 0] = 0.0
    before = FL.partial_factor.launches
    got = FL.partial_factor(F, 1e-4, s)
    assert FL.partial_factor.launches == before + 1
    want = FL.partial_factor_plain(F, 1e-4, s)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_front_lu_kernel_without_pivoting(cuda_device, dtype):
    gen = torch.Generator(device="cpu").manual_seed(3)
    F = (torch.randn(50, 48, 48, dtype=dtype, generator=gen)
         + 96 * torch.eye(48, dtype=dtype)).to(cuda_device)
    got = FL.partial_factor(F, 1e-4, 16, pivot=False)
    want = FL.partial_factor_plain(F, 1e-4, 16, pivot=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[1].cpu(), torch.arange(16).expand(50, 16))


# (nf, p, s, (width bucket, warps per front, fronts per CTA) on 132 SMs):
# every width bucket, one to twenty warps a front, one to eight fronts a
# CTA with nf not a multiple of it, the rows < s in one warp or two
K3_CASES = [
    (2048, 32, 8, (8, 1, 8)),
    (1001, 24, 8, (8, 1, 8)),
    (130, 56, 8, (8, 2, 1)),
    (4, 640, 8, (8, 20, 1)),
    (501, 40, 16, (16, 2, 4)),
    (300, 48, 16, (16, 2, 3)),
    (300, 96, 32, (32, 3, 2)),
    (40, 216, 24, (24, 7, 1)),
    (2, 384, 32, (32, 12, 1)),
    (10, 100, 48, (48, 4, 1)),
    (20, 128, 64, (64, 4, 1)),
    (3, 256, 64, (64, 8, 1)),
]


def _k3_fronts(nf, p, dtype, pivot, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    F = torch.randn(nf, p, p, dtype=dtype, generator=gen)
    if not pivot:       # diagonally dominant: stable without pivoting
        F += 2 * p * torch.eye(p, dtype=dtype)
    F[0, :, 0] = 0.0    # front 0: a zero pivot, replaced by thresh
    return F


@pytest.mark.cuda
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf,p,s,layout", K3_CASES)
def test_front_lu_kernel_layouts(cuda_device, dtype, nf, p, s, layout,
                                 pivot):
    """Every width bucket and fronts-per-CTA layout: perm and the factors
    bit for bit against the plain version, the zero pivot of front 0
    replaced."""
    assert FL.k3_layout(p, s, nf, dtype.itemsize, 132) == layout
    F = _k3_fronts(nf, p, dtype, pivot, nf + p + s).to(cuda_device)
    before = FL.partial_factor.launches
    got = FL.partial_factor(F, 1e-4, s, pivot)
    assert FL.partial_factor.launches == before + 1
    want = FL.partial_factor_plain(F, 1e-4, s, pivot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[0][0, 0, 0]) == float(torch.tensor(1e-4, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf,p,s,layout", K3_CASES)
def test_front_lu_kernel_ties_and_nan(cuda_device, dtype, nf, p, s, layout):
    """Integer-valued fronts (many equal magnitudes: the lowest current
    position must win every tie, after the earlier swaps) and a NaN in
    front 3's column 2 (NaN beats every number): perm identical to the
    plain version's, every output bit for bit, NaNs where the plain
    version has them (neither updates a row that is already pivoted)."""
    rng = np.random.default_rng(p + s)
    F = torch.from_numpy(rng.integers(-2, 3, size=(nf, p, p))).to(dtype)
    F[min(3, nf - 1), 5, 2] = float("nan")
    F = F.to(cuda_device)
    got = FL.partial_factor(F, 1e-4, s)
    want = FL.partial_factor_plain(F, 1e-4, s)
    assert torch.equal(got[1], want[1])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_front_lu_takes_the_fronts_it_now_routes(cuda_device, dtype):
    """A bucket past the JAX package's cross thresholds (p = 256 > 128 with
    8 fronts < 32) that the port's predicate sends to K3: the solver's
    bucket step launches K3, bit for bit against the plain version."""
    from strumpack_tpu_torch.frontal import numeric
    nf, p, s = 8, 256, 64
    assert FL.use_cross(s, p, dtype)
    F = _k3_fronts(nf, p, dtype, True, 7).to(cuda_device)
    before = FL.partial_factor.launches, numeric.route_counts["k3"]
    got = numeric._factor_bucket(F, 1e-4, s)
    assert (FL.partial_factor.launches, numeric.route_counts["k3"]) == (
        before[0] + 1, before[1] + 1)
    want = FL.partial_factor_plain(F, 1e-4, s)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _assert_same_with_nan(got, want, nan_front):
    """Every front but ``nan_front`` bit for bit.  On ``nan_front`` the
    values equal wherever the plain version's are finite, and the kernel
    has NaN only where the plain version has: K4 copies the rows < row0
    through (its global design also leaves pivoted rows alone), while the
    plain version subtracts 0 * (pivot row) from them, which is NaN once
    the pivot row holds a NaN or an inf."""
    keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    keep[nan_front] = False
    assert torch.equal(got[keep], want[keep])
    g, w = got[nan_front], want[nan_front]
    fin = torch.isfinite(w)
    assert torch.equal(g[fin], w[fin])
    assert not (torch.isnan(g) & ~torch.isnan(w)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf,p,s,pivot", [(301, 52, 4, True),
                                          (1001, 30, 30, True),
                                          (16, 64, 64, True),
                                          (16, 64, 64, False),
                                          (5, 28, 28, True),
                                          (13, 30, 7, True),
                                          (13, 32, 32, False),
                                          (9, 40, 40, True),
                                          (7, 33, 12, False),
                                          (1, 64, 64, True)])
def test_small_lu_kernel_matches_plain(cuda_device, dtype, nf, p, s, pivot):
    """K2 repeats its plain version's rounding: perm and the packed front
    agree exactly, the zero pivot of front 0 included.  The shapes cover
    both layouts (one warp per front for p <= 32, two above), nf not a
    multiple of the fronts per CTA (3 and 8 at nf = 301 and 1001), s < p
    and s = p."""
    gen = torch.Generator(device="cpu").manual_seed(nf + p + s)
    F = torch.randn(nf, p, p, dtype=dtype, generator=gen)
    if not pivot:
        F += 2 * p * torch.eye(p, dtype=dtype)
    F[0, :, 0] = 0.0
    F = F.to(cuda_device)
    before = FL.factor_bucket.launches
    got = FL.factor_bucket(F, 1e-4, s, pivot)
    assert FL.factor_bucket.launches == before + 1
    want = FL.factor_bucket_plain(F, 1e-4, s, pivot)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p,s", [(24, 24), (52, 20), (64, 64)])
def test_small_lu_kernel_ties_and_nan(cuda_device, dtype, p, s):
    """Integer-valued fronts (many equal magnitudes: the lower row must
    win every tie) and a front with a NaN (NaN beats every number): perm
    identical to the plain version's, values bit for bit (K2 subtracts
    0 * (pivot row) from frozen rows as the plain version does, so a NaN
    spreads alike)."""
    rng = np.random.default_rng(p + s)
    F = torch.from_numpy(rng.integers(-2, 3, size=(11, p, p))).to(dtype)
    F[3, 5, 2] = float("nan")
    F = F.to(cuda_device)
    got = FL.factor_bucket(F, 1e-4, s)
    want = FL.factor_bucket_plain(F, 1e-4, s)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)


# (nf, p, w, row0, slim, dtype, design, cluster size): every design, each
# width bucket, row0 > 0 with slim < p, f64's two threads per row
K4_CASES = [
    (64, 96, 96, 0, 96, torch.float32, "cta", 1),
    (8, 256, 128, 0, 256, torch.float32, "cta", 1),
    (8, 256, 128, 128, 256, torch.float32, "cta", 1),
    (16, 192, 64, 128, 192, torch.float32, "cta", 1),
    (5, 200, 64, 64, 160, torch.float32, "cta", 1),
    (3, 100, 20, 10, 90, torch.float64, "cta", 1),
    (8, 256, 128, 0, 256, torch.float64, "cluster", 2),
    (4, 300, 96, 30, 280, torch.float64, "cluster", 3),
    (2, 2048, 128, 0, 2048, torch.float32, "cluster", 8),
    (1, 4096, 128, 0, 4096, torch.float32, "cluster", 16),
    (1, 8192, 128, 0, 8192, torch.float32, "global", 0),
    (2, 4096, 64, 0, 4096, torch.float64, "global", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("nf,p,w,row0,slim,dtype,kind,c", K4_CASES)
def test_panel_lu_kernel_matches_plain(cuda_device, nf, p, w, row0, slim,
                                       dtype, kind, c, pivot):
    gen = torch.Generator(device="cpu").manual_seed(p + row0)
    panel = torch.randn(nf, p, w, dtype=dtype, generator=gen)
    if not pivot:
        panel[:, row0:row0 + w] += 2 * p * torch.eye(w, dtype=dtype)
    panel[0, :, 0] = 0.0
    panel = panel.to(cuda_device)
    assert PP.design(p, w, panel.element_size(), row0) == (kind, c)
    before = dict(PP.panel_lu.variants)
    got = PP.panel_lu(panel, 1e-4, row0, w, slim, pivot)
    assert PP.panel_lu.variants[kind] == before[kind] + 1
    want = PP.panel_lu_plain(panel, 1e-4, row0, w, slim, pivot)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("nf,p,w,row0,slim,dtype,kind,c",
                         [K4_CASES[i] for i in (1, 4, 6, 8, 11)])
def test_panel_lu_kernel_ties_and_nan(cuda_device, nf, p, w, row0, slim,
                                      dtype, kind, c):
    """Integer-valued panels (ties everywhere: the lower row wins, across
    warps and across the CTAs of a cluster too) and a NaN in one column
    (NaN beats every number): pivot rows as the plain version's, values
    as ``_assert_same_with_nan`` says."""
    rng = np.random.default_rng(p + w)
    panel = torch.from_numpy(rng.integers(-2, 3, size=(nf, p, w))).to(dtype)
    panel[-1, p - 3, 5] = float("nan")
    panel = panel.to(cuda_device)
    got = PP.panel_lu(panel, 1e-4, row0, w, slim)
    want = PP.panel_lu_plain(panel, 1e-4, row0, w, slim)
    assert torch.equal(got[1], want[1])
    _assert_same_with_nan(got[0], want[0], nf - 1)


@pytest.mark.cuda
def test_blocked_lu_kernel_matches_plain(cuda_device):
    gen = torch.Generator(device="cpu").manual_seed(8)
    F = torch.randn(4, 256, 256, generator=gen).to(cuda_device)
    got = PP.blocked_factor_bucket(F, 1e-4, 256)
    want = PP.blocked_factor_bucket(F, 1e-4, 256, panel=PP.panel_lu_plain)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_blr_launches_match_the_plan(cuda_device):
    """A Poisson 16^3 BLR factorization launches K2 and K4 exactly as
    often as the plan says."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson3d
    A = poisson3d(16)
    opts = st.SPOptions(compression=st.CompressionType.BLR,
                        compression_min_sep_size=64, factor_dtype="float32",
                        refine_dtype="float32", rel_tol=1e-5)
    opts.blr.leaf_size = 128
    s = st.SparseSolver(opts)
    s.set_csr_matrix(A)
    s.reorder(16, 16, 16)
    k2, k4 = FL.factor_bucket.launches, PP.panel_lu.launches
    s.factor()
    assert s.factor_passes == 1
    assert FL.factor_bucket.launches - k2 == s.pdev.k2_launches(torch.float32) > 0
    assert PP.panel_lu.launches - k4 == s.pdev.k4_launches() > 0
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert np.linalg.norm(b - A.spmv(x.astype(np.float64))) \
        <= 1e-4 * np.linalg.norm(b)


@pytest.mark.cuda
def test_front_lu_capacity_matches_the_kernel(cuda_device):
    """The routing's copy of what K3 holds (threads a CTA by width bucket,
    shared memory of a front, the limits) equals the kernel's own at
    every width bucket, value size, front height and s."""
    assert FL.k3_capacity_drift() == []


@pytest.mark.cuda
def test_front_lu_rejects_what_it_cannot_launch(cuda_device):
    F = torch.zeros(1, 1024, 1024, device=cuda_device)
    with pytest.raises(ValueError, match="s <= 64"):
        FL.partial_factor(F, 0.0, 512)
    with pytest.raises(ValueError, match="threads"):
        FL.partial_factor(F, 0.0, 32)
    with pytest.raises(NotImplementedError):
        FL.partial_factor(F.to(torch.complex64), 0.0, 8)
    with pytest.raises(ValueError, match="p <= 64"):
        FL.factor_bucket(torch.zeros(1, 65, 65, device=cuda_device), 0.0, 4)
    with pytest.raises(ValueError, match="w <= 128"):
        PP.panel_lu(torch.zeros(1, 256, 129, device=cuda_device), 0.0, 0,
                    129, 256)


def _solve_on(device, A, b, **opts):
    """The port's solver on ``device`` with f64 factors, DIRECT: (x, the
    solver)."""
    import strumpack_tpu_torch as st
    o = st.SPOptions(factor_dtype="float64", refine_dtype="float64",
                     krylov_solver=st.KrylovSolver.DIRECT, **opts)
    s = st.SparseSolver(o, device=device)
    s.set_csr_matrix(A)
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    return x, s


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spd", "nopivot"])
def test_spd_and_nopivot_paths_match_the_cpu(cuda_device, case):
    """The SPD (Cholesky) and the no-pivot paths on the card against the
    port on the CPU: K3 and K2 launched in no-pivot mode only, the
    factors and the solution equal to rounding."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import anisotropic3d, poisson3d
    if case == "spd":
        A, opts = poisson3d(12), dict(symmetric=True, positive_definite=True)
    else:
        A, opts = anisotropic3d(12), dict(pivoting=False)
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    x_cpu, s_cpu = _solve_on("cpu", A, b, **opts)
    before = {k: dict(f.modes) for k, f in
              (("k3", FL.partial_factor), ("k2", FL.factor_bucket))}
    x, s = _solve_on(cuda_device, A, b, **opts)
    k3 = FL.partial_factor.modes["nopivot"] - before["k3"]["nopivot"]
    assert k3 == s.pdev.k3_buckets(torch.float64) > 0
    assert FL.partial_factor.modes["pivot"] == before["k3"]["pivot"]
    assert FL.factor_bucket.modes["pivot"] == before["k2"]["pivot"]
    np.testing.assert_allclose(x, x_cpu, rtol=0, atol=1e-10 * np.abs(x).max())
    assert A.max_scaled_residual(x, b) < 1e-12
    for key, lu in s_cpu.fac.tree["lu"].items():
        torch.testing.assert_close(s.fac.tree["lu"][key].cpu(), lu,
                                   rtol=1e-10, atol=1e-12)
    if case == "spd":
        assert s.inertia()[:3] == (A.n, 0, 0)
        assert s.inertia()[3] == st.ReturnCode.SUCCESS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf,p,s", [(128, 40, 16), (16, 152, 24),
                                    (64, 12, 4), (1, 48, 48)])
def test_nopivot_kernels_at_spd_shapes(cuda_device, dtype, nf, p, s):
    """K3 (s < p, the shapes it holds) and K2 (p <= 64 with s < 8, or a
    root front s = p) without pivoting, bit-exact against their plain
    versions on SPD fronts, as the Cholesky path calls them."""
    gen = torch.Generator().manual_seed(nf * p + s)
    G = torch.randn(nf, p, p, generator=gen, dtype=torch.float64)
    F = (G @ G.mT + p * torch.eye(p, dtype=torch.float64)).to(dtype)
    F = F.to(cuda_device)
    if FL.use_cross(s, p, dtype):
        got = FL.partial_factor(F, 0.0, s, pivot=False)
        want = FL.partial_factor_plain(F, 0.0, s, pivot=False)
    else:
        assert p <= FL.MAX_PALLAS_P
        got = FL.factor_bucket(F, 0.0, s, pivot=False)
        want = FL.factor_bucket_plain(F, 0.0, s, pivot=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_empty_separator_fronts(cuda_device):
    """AMD's etree binarization makes buckets of empty separators (s = 0):
    they launch no LU kernel, pass their assembled fronts on as the CB
    through K1, and the solution equals the CPU's."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.sparse.gen import poisson3d
    A = poisson3d(8)
    b = A.spmv(np.random.default_rng(1).standard_normal(A.n))
    opts = dict(reordering_method=st.ReorderingStrategy.AMD)
    x_cpu, _ = _solve_on("cpu", A, b, **opts)
    numeric.route_counts["empty"] = 0
    ea = extend_add.launches
    x, s = _solve_on(cuda_device, A, b, **opts)
    assert numeric.route_counts["empty"] == s.pdev.empty_buckets() > 0
    assert extend_add.launches - ea == s.pdev.ea_pairs()
    np.testing.assert_allclose(x, x_cpu, rtol=0, atol=1e-10 * np.abs(x).max())


def _every_option():
    import strumpack_tpu_torch as st
    out = [dict(reordering_method=m) for m in st.ReorderingStrategy
           if m.name != "GEOMETRIC"]
    out += [dict(matching=m) for m in st.MatchingJob if m.name != "NONE"]
    out += [dict(positive_definite=True, symmetric=True),
            dict(pivoting=False),
            dict(factor_dtype="float32", refine_dtype="float32x2",
                 rel_tol=1e-12, abs_tol=1e-13),
            dict(factor_dtype="float32", refine_dtype="float64",
                 rel_tol=1e-12)]
    return out


@pytest.mark.cuda
def test_every_option_solves_without_a_grid(cuda_device):
    """On the card, ``SparseSolver(SPOptions(...))`` with every ordering
    but GEOMETRIC, every matching, the SPD and no-pivot paths and the
    mixed and double-float refinements solves a matrix given without a
    grid, from zero and from an initial guess."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import random_spd
    A = random_spd(300, seed=3)
    b = A.spmv(np.random.default_rng(2).standard_normal(A.n))
    for kw in _every_option():
        s = st.SparseSolver(st.SPOptions(**kw), device=cuda_device)
        s.set_csr_matrix(A)
        x, rc = s.solve(b)
        assert rc == st.ReturnCode.SUCCESS, kw
        assert A.max_scaled_residual(x, b) < 1e2 * s.opts.rel_tol, kw
        x0, rc = s.solve(b, x0=x)
        assert rc == st.ReturnCode.SUCCESS and s.Krylov_iterations() <= 1, kw


def _structured_cases():
    """(name, matrix grid, SPOptions fields, nested option setter) of
    each compression this slice ports, small Poisson problems in f32."""
    def hss(sampling):
        def tweak(o):
            o.hss.leaf_size, o.hss.max_rank, o.hss.rel_tol = 16, 16, 1e-6
            o.hss.sampling = sampling
        return tweak

    def composite(o):
        o.hodlr_min_sep_size, o.lossy_min_sep_size = 256, 8
        o.hss.leaf_size, o.hss.rel_tol = 32, 1e-6
        o.blr.rel_tol, o.blr.cb_compression = 1e-6, True

    def blr(algo, cbc):
        def tweak(o):
            o.blr.rel_tol, o.blr.low_rank_algorithm = 1e-6, algo
            o.blr.cb_compression = cbc
        return tweak
    return [
        ("hss", (40, 40), dict(compression="HSS",
                               compression_min_sep_size=32), hss(False)),
        ("hss_sample", (64, 64), dict(compression="HSS",
                                      compression_min_sep_size=30),
         hss(True)),
        ("hodlr", (40, 40), dict(compression="HODLR",
                                 compression_min_sep_size=32), hss(False)),
        ("blr_hodlr", (16, 16, 16), dict(compression="BLR_HODLR",
                                         compression_min_sep_size=64),
         composite),
        ("zfp_blr_hodlr", (16, 16, 16), dict(
            compression="ZFP_BLR_HODLR", compression_min_sep_size=64),
         composite),
        ("lossy8", (30, 30), dict(compression="LOSSY",
                                  compression_min_sep_size=16,
                                  lossy_precision=8), None),
        ("lossless", (30, 30), dict(compression="LOSSLESS"), None),
        ("blr_cb_aca", (16, 16, 16), dict(compression="BLR",
                                          compression_min_sep_size=64),
         blr("aca", True)),
        # BACA's core pseudo-inverse cuts at 1e-10 (as the JAX package's),
        # below f32 resolution: its tiles run in f64
        ("blr_baca", (16, 16, 16), dict(compression="BLR",
                                        compression_min_sep_size=64,
                                        factor_dtype="float64",
                                        refine_dtype="float64"),
         blr("baca", False)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[0] for c in _structured_cases()])
def test_structured_compression_solves(cuda_device, case):
    """Each compression this slice ports solves a small Poisson problem on
    the card (f32 but for BACA) under preconditioned GMRES, within the
    JAX tests' gate (1e2 x rel_tol), and launches K1 as often as the plan
    says."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson2d, poisson3d
    _, dims, kw, tweak = next(c for c in _structured_cases()
                              if c[0] == case)
    A = poisson2d(dims[0]) if len(dims) == 2 else poisson3d(dims[0])
    kw = dict(kw, compression=st.CompressionType[kw["compression"]])
    kw = dict(dict(factor_dtype="float32", refine_dtype="float32"), **kw)
    opts = st.SPOptions(rel_tol=1e-5, **kw)
    if tweak is not None:
        tweak(opts)
    s = st.SparseSolver(opts, device=cuda_device)
    s.set_csr_matrix(A)
    s.reorder(*dims)
    k1 = extend_add.launches
    s.factor()
    assert extend_add.launches - k1 == s.pdev.ea_pairs() * s.factor_passes
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert A.max_scaled_residual(x.astype(np.float64), b) < 1e2 * 1e-5


@pytest.mark.cuda
def test_extend_add_of_compressed_child_on_card(cuda_device):
    """K1 on a BLR-compressed child densified for its parent's fronts (the
    solver's ``_child_blocks`` and the pair's ``loc`` map) is bit-exact
    against the plain gather."""
    from strumpack_tpu_torch.frontal import numeric as N
    rng = np.random.default_rng(12)
    nf, p, u, nfc, t = 4, 300, 256, 6, 64
    pos = torch.from_numpy(_random_pos(rng, nf, p, u)).to(cuda_device)
    idx = torch.tensor([2, -1, 5, 0], dtype=torch.int32, device=cuda_device)
    loc = torch.where(idx >= 0, torch.arange(nf, device=cuda_device,
                                             dtype=torch.int32), -1)
    CB = torch.randn(nfc, u, u, device=cuda_device)
    comp = N._compress_cb(CB, t, 1e-3, 8)
    C = N._child_blocks(comp, idx).contiguous()
    F = torch.randn(nf, p, p, device=cuda_device)
    before = extend_add.launches
    got = extend_add(F.clone(), C, loc, pos)
    assert extend_add.launches == before + 1
    assert torch.equal(got, extend_add_plain(F.clone(), C, loc, pos))


def _grid_solver(device, A, dtype, tweak=None, **kw):
    """The port's solver on A of a cubic grid, reordered on it;
    ``tweak(opts)`` sets nested options."""
    import strumpack_tpu_torch as st
    o = st.SPOptions(factor_dtype=dtype, refine_dtype=dtype, **kw)
    if tweak is not None:
        tweak(o)
    s = st.SparseSolver(o, device=device)
    s.set_csr_matrix(A)
    n = round(A.n ** (1 / 3))
    assert s.reorder(n, n, n) == st.ReturnCode.SUCCESS
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,via_real", [("complex128", False),
                                            ("complex64", False),
                                            ("complex64", True)])
def test_complex_solves_match_the_cpu(cuda_device, dtype, via_real):
    """Native complex factors (the library route, K1's complex
    instantiations) and the interleaved real form on the card against the
    port on the CPU: the same plan, K1 launched as the plan says, the
    solutions equal to the dtype's rounding."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import helmholtz3d
    A = helmholtz3d(10, k0=8.0)
    rng = np.random.default_rng(0)
    b = A.spmv(rng.standard_normal(A.n) + 1j * rng.standard_normal(A.n))
    xs = {}
    for dev in ("cpu", cuda_device):
        s = _grid_solver(dev, A, dtype, complex_via_real=via_real)
        k1 = extend_add.launches
        x, rc = s.solve(b)
        assert rc == st.ReturnCode.SUCCESS
        assert np.iscomplexobj(x)
        if dev != "cpu":
            assert extend_add.launches - k1 == s.pdev.ea_pairs() > 0
        xs[dev] = x
    tol = 1e-12 if dtype == "complex128" else 1e-4
    assert A.max_scaled_residual(xs[cuda_device], b) < tol
    np.testing.assert_allclose(xs[cuda_device], xs["cpu"], rtol=0,
                               atol=tol * np.abs(xs["cpu"]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("complex_input", [False, True])
def test_hodbf_front_solves(cuda_device, complex_input):
    """HODBF fronts on the card (the direct butterfly factorization of
    F11, butterfly S12 and F21): Poisson 16^3 in f64 and a complex
    Helmholtz 12^3, preconditioned GMRES within the JAX tests' gate."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import helmholtz3d, poisson3d
    A = helmholtz3d(12, k0=8.0) if complex_input else poisson3d(16)
    dtype = "complex128" if complex_input else "float64"

    def tweak(o):
        o.hss.leaf_size, o.hss.max_rank, o.hss.rel_tol = 32, 32, 1e-8
    s = _grid_solver(cuda_device, A, dtype, tweak,
                     compression=st.CompressionType.HODBF,
                     compression_min_sep_size=64, rel_tol=1e-8,
                     krylov_solver=st.KrylovSolver.PREC_GMRES)
    assert any(bp.hodbf and bp.bf_D >= 2 and bp.u_pad > 0
               for lvl in s.plan.levels for bp in lvl)
    rng = np.random.default_rng(0)
    xex = rng.standard_normal(A.n) + (1j * rng.standard_normal(A.n)
                                      if complex_input else 0)
    b = A.spmv(xex)
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert A.max_scaled_residual(x, b) < 1e2 * 1e-8


@pytest.mark.cuda
def test_chunked_exact_solve(cuda_device, monkeypatch):
    """A plan chunked by a tiny cap on the card: K1, K3 and K2 launched
    once a chunk as the plan counts them, and the solution equal to the
    unchunked run's to f64 rounding."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.sparse.gen import poisson3d
    A = poisson3d(12)
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    xs = {}
    for cap in ("0.001", "100"):
        monkeypatch.setenv("STRUMPACK_TPU_CHUNK_GB", cap)
        before = (extend_add.launches, FL.partial_factor.launches,
                  FL.factor_bucket.launches)
        s = _grid_solver(cuda_device, A, "float64", nd_leaf=8,
                         krylov_solver=st.KrylovSolver.DIRECT)
        x, rc = s.solve(b)
        assert rc == st.ReturnCode.SUCCESS
        got = (extend_add.launches - before[0],
               FL.partial_factor.launches - before[1],
               FL.factor_bucket.launches - before[2])
        dt = torch.float64
        assert got == (s.pdev.ea_pairs(), s.pdev.k3_buckets(dt),
                       s.pdev.k2_launches(dt))
        assert (s.pdev.chunked_buckets() > 0) == (cap == "0.001")
        xs[cap] = x
    np.testing.assert_allclose(xs["0.001"], xs["100"], rtol=0,
                               atol=1e-12 * np.abs(xs["100"]).max())


def _gauss_blr(n, device):
    """K + 2 I of n 2-D standard-normal points (h = 1), float32."""
    P = np.random.default_rng(0).standard_normal((n, 2))
    K = np.exp(-((P[:, None] - P[None]) ** 2).sum(-1) / 2.0) + 2 * np.eye(n)
    return torch.tensor(K, dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", [128, 64])
def test_blr_facade_kernels_match_plain(cuda_device, leaf, monkeypatch):
    """The dense BLR facade at n = 1024: tiles of 128 factor their
    diagonal tiles by the blocked LU over K4, tiles of 64 by K2, once a
    tile; the factors equal those of the same facade over the plain
    versions bit for bit, and the solve meets the tolerance."""
    from strumpack_tpu_torch.structured import structured as S
    A = _gauss_blr(1024, cuda_device)
    opts = S.StructuredOptions(type="blr", leaf_size=leaf)
    Sk = S.construct_from_dense(A, opts)
    k2, k4 = FL.factor_bucket.launches, PP.panel_lu.launches
    Sk.factor()
    n2, n4 = FL.factor_bucket.launches - k2, PP.panel_lu.launches - k4
    nt = 1024 // Sk.t
    assert Sk.t == leaf
    assert (n2, n4) == ((0, nt) if leaf == 128 else (nt, 0))
    monkeypatch.setattr(FL, "factor_bucket", FL.factor_bucket_plain)
    monkeypatch.setattr(PP, "panel_lu", PP.panel_lu_plain)
    Sp = S.construct_from_dense(A, opts)
    Sp.factor()
    assert torch.equal(Sk._fac[0], Sp._fac[0])
    assert torch.equal(Sk._fac[1], Sp._fac[1])
    b = torch.randn(1024, generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    x = Sk.solve(b)
    want = torch.linalg.solve(A.double(), b.double())
    assert float((x.double() - want).norm() / want.norm()) < 1e-2


@pytest.mark.cuda
def test_facade_and_kernels_default_to_cuda(cuda_device):
    """Without ``device`` the facade's constructors and the kernels build
    on the card; a kernel fit keeps its state there."""
    import strumpack_tpu_torch as st
    A = _gauss_blr(256, cuda_device).cpu().numpy()
    opts = st.StructuredOptions(type=st.StructuredType.HSS, leaf_size=32)
    assert st.construct_from_dense(A, opts).h.D.device.type == "cuda"
    At = torch.from_numpy(A).double().to(cuda_device)
    S = st.construct_matrix_free(lambda X, trans: At @ X, 256, opts)
    assert S.h.D.device.type == "cuda"
    S = st.construct_from_elements(lambda i, j: A[i, j], 256, 256,
                                   st.StructuredOptions(leaf_size=32))
    assert S.Ap.device.type == "cuda"
    P = np.random.default_rng(2).standard_normal((600, 2))
    k = st.GaussKernel(h=1.0, lam=1.0)
    k.fit_HSS(P, np.sin(P[:, 0]), leaf_size=64, matrix_free=True)
    assert k.device.type == "cuda"
    for t in (k._Xtrain, k._weights, k._order, k._M.D):
        assert t.device.type == "cuda"
    assert st.KernelRegressionClassifier().device.type == "cuda"


@pytest.mark.cuda
def test_factor_runs_past_the_memory_model(cuda_device, monkeypatch):
    """With STRUMPACK_TPU_HBM_GB below exact32's peak model the port
    factors anyway, as the JAX package does in split mode, and its
    factors equal those of a run without the variable."""
    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.frontal import numeric
    from strumpack_tpu_torch.sparse.gen import poisson3d
    A = poisson3d(32)

    def factored():
        s = st.SparseSolver(st.SPOptions(factor_dtype="float32",
                                         refine_dtype="float32",
                                         rel_tol=1e-5, nd_leaf=16))
        s.set_csr_matrix(A)
        s.reorder(32, 32, 32)
        assert s.factor() == st.ReturnCode.SUCCESS
        return s
    ref = factored()
    model = numeric.factor_peak_bytes(ref.pdev, 4)
    monkeypatch.setenv("STRUMPACK_TPU_HBM_GB", str(0.5 * model / 1e9))
    assert numeric.hbm_budget_bytes(cuda_device) < model
    s = factored()
    for name in ("lu", "perm", "L21", "U12"):
        assert ref.fac.tree[name].keys() == s.fac.tree[name].keys()
        for key, a in ref.fac.tree[name].items():
            assert torch.equal(a, s.fac.tree[name][key]), (name, key)
    b = A.spmv(np.random.default_rng(3).standard_normal(A.n))
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS


@pytest.mark.cuda
def test_distributed_one_nccl_rank(cuda_device):
    """DistributedSparseSolver on one NCCL rank (mesh ('b',) of 1) at
    Poisson 32^3 with exact32's options: every bucket repl, the factors
    bit-equal to SparseSolver's, the same IR iteration count."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import strumpack_tpu_torch as st
    from strumpack_tpu_torch.parallel import DistributedSparseSolver
    from strumpack_tpu_torch.parallel import dist as D
    from strumpack_tpu_torch.sparse.gen import poisson3d

    def opts():
        return st.SPOptions(factor_dtype="float32", refine_dtype="float32",
                            krylov_solver=st.KrylovSolver.REFINE,
                            nd_leaf=16, rel_tol=1e-5)
    A = poisson3d(32)
    b = A.spmv(np.random.default_rng(32).standard_normal(A.n))
    one = st.SparseSolver(opts())
    one.set_csr_matrix(A)
    one.reorder(32, 32, 32)
    x1, rc1 = one.solve(b)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    D.init_process_group("nccl", 0, 1, port, timeout_s=120)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("b",))
        s = DistributedSparseSolver(mesh, opts())
        s.set_csr_matrix(A)
        s.reorder(32, 32, 32)
        x, rc = s.solve(b)
        assert s.sp.counts()["repl"] == sum(len(lv) for lv in s.plan.levels)
        for name in ("lu", "perm", "L21", "U12"):
            for key, t in one.fac.tree[name].items():
                assert torch.equal(s._tree[name][key], t), (name, key)
        assert rc == rc1 == st.ReturnCode.SUCCESS
        assert s.Krylov_iterations() == one.Krylov_iterations()
        assert A.max_scaled_residual(x, b) <= 10 * max(
            A.max_scaled_residual(x1, b), 1e-7)
    finally:
        dist.destroy_process_group()
