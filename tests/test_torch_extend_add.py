"""K1 (extend-add): the port's plain version against the JAX package's
Pallas kernel in interpret mode and against its XLA gather path.  Each
output element receives exactly one addend, so every comparison here is
bit-exact (tolerance 0)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_ref  # noqa: F401  (one torch thread a test worker)

from strumpack_tpu.frontal.numeric import _extend_add_blocks
from strumpack_tpu.ops.pallas_extadd import (extend_add_pallas,
                                             precompute_windows)

from strumpack_tpu_torch.ops.extend_add import extend_add, extend_add_plain


def _random_pos(rng, nf, p, u):
    """pos [nf, p]: each front embeds child rows 0..u-1 at u sorted parent
    slots (order preserving, total on the child), -1 elsewhere."""
    pos = np.full((nf, p), -1, np.int32)
    for f in range(nf):
        slots = np.sort(rng.choice(p, size=u, replace=False))
        pos[f, slots] = np.arange(u)
    return pos


def _port(F, C, idx, pos):
    return extend_add(torch.from_numpy(F.copy()), torch.from_numpy(C),
                      torch.from_numpy(idx), torch.from_numpy(pos)).numpy()


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

