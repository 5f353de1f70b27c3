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
def test_front_lu_rejects_what_it_cannot_launch(cuda_device):
    F = torch.zeros(1, 1024, 1024, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        FL.partial_factor(F, 0.0, 512)
    with pytest.raises(NotImplementedError):
        FL.partial_factor(F.to(torch.complex64), 0.0, 8)
