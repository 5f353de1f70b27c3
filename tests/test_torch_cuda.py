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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf,p,s,pivot", [(300, 52, 4, True),
                                          (16, 64, 64, True),
                                          (16, 64, 64, False),
                                          (5, 28, 28, True)])
def test_small_lu_kernel_matches_plain(cuda_device, dtype, nf, p, s, pivot):
    """K2 repeats its plain version's rounding: perm and the packed front
    agree exactly, the zero pivot of front 0 included."""
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
@pytest.mark.parametrize("nf,p,w,row0,dtype,kind", [
    (64, 96, 96, 0, torch.float32, "shared"),
    (8, 256, 128, 128, torch.float32, "shared"),
    (8, 256, 128, 0, torch.float64, "global"),
    (2, 2048, 128, 0, torch.float32, "global")])
def test_panel_lu_kernel_matches_plain(cuda_device, nf, p, w, row0, dtype,
                                       kind):
    gen = torch.Generator(device="cpu").manual_seed(p + row0)
    panel = torch.randn(nf, p, w, dtype=dtype, generator=gen)
    panel[0, :, 0] = 0.0
    panel = panel.to(cuda_device)
    assert PP.variant(p, w, panel.element_size()) == kind
    before = dict(PP.panel_lu.variants)
    got = PP.panel_lu(panel, 1e-4, row0, w, p)
    assert PP.panel_lu.variants[kind] == before[kind] + 1
    want = PP.panel_lu_plain(panel, 1e-4, row0, w, p)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


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
    assert FL.factor_bucket.launches - k2 == s.pdev.k2_launches() > 0
    assert PP.panel_lu.launches - k4 == s.pdev.k4_launches() > 0
    b = A.spmv(np.random.default_rng(0).standard_normal(A.n))
    x, rc = s.solve(b)
    assert rc == st.ReturnCode.SUCCESS
    assert np.linalg.norm(b - A.spmv(x.astype(np.float64))) \
        <= 1e-4 * np.linalg.norm(b)


@pytest.mark.cuda
def test_front_lu_rejects_what_it_cannot_launch(cuda_device):
    F = torch.zeros(1, 1024, 1024, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        FL.partial_factor(F, 0.0, 512)
    with pytest.raises(NotImplementedError):
        FL.partial_factor(F.to(torch.complex64), 0.0, 8)
    with pytest.raises(ValueError, match="p <= 64"):
        FL.factor_bucket(torch.zeros(1, 65, 65, device=cuda_device), 0.0, 4)
    with pytest.raises(ValueError, match="w <= 128"):
        PP.panel_lu(torch.zeros(1, 256, 129, device=cuda_device), 0.0, 0,
                    129, 256)
