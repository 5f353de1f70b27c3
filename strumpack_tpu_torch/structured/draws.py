"""The random draws of the structured compressors, in one place.

Every sketch the port draws goes through ``draw``: the Gaussian and SJLT
sketches of ``hss_sample.hss_from_sampling``, the F12/F21 sketches of the
sampled fronts (``frontal/numeric.py``) and HODLR's randomized range
finder (``hodlr.py``) and the butterfly and HODBF compressions
(``butterfly.py``, ``hodbf.py``).  Each call names the draw the JAX
package makes at the same place by its key: a tuple
``(seed, op, arg, op, arg, ...)`` that starts from
``jax.random.PRNGKey(seed)`` and applies each ``("fold", v)`` as
``fold_in(key, v)``, each ``("split", i)`` as the i-th key of
``split(key)`` and each ``("split", (n, i))`` as the i-th key of
``split(key, n)`` (``split`` below builds them).  Here a
``torch.Generator`` serves the draw and the key is not used; a caller
that wants the JAX package's own numbers (the tests) replaces ``draw`` by
one that computes them from the key.
"""
from __future__ import annotations

import torch


def generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def split(key, n=2):
    """The n keys of ``jax.random.split(key, n)``."""
    return [key + ("split", i if n == 2 else (n, i)) for i in range(n)]


def draw(kind, shape, dtype, gen, key, high=None):
    """One draw of ``shape`` on ``gen``'s device.

    ``kind`` "normal": standard normal values of ``dtype``, for a complex
    dtype ``(x + 1j y) sqrt(1/2)`` from two real draws named by the two
    keys of ``split(key)`` (the JAX package's ``_randn``,
    ``strumpack_tpu/structured/butterfly.py:125-133``); "randint":
    integers in ``[0, high)``; "bernoulli": booleans, true with
    probability 1/2.  ``key`` is the JAX package's key of this draw (see
    the module docstring)."""
    dev = gen.device
    if kind == "normal" and dtype.is_complex:
        rdt = torch.empty((), dtype=dtype).real.dtype
        kr, ki = split(key)
        re = draw("normal", shape, rdt, gen, kr)
        im = draw("normal", shape, rdt, gen, ki)
        return torch.complex(re, im) * (0.5 ** 0.5)
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    if kind == "randint":
        return torch.randint(0, int(high), shape, generator=gen,
                             device=dev)
    if kind == "bernoulli":
        return torch.rand(shape, generator=gen, device=dev) < 0.5
    raise ValueError(f"draw kind {kind!r}")
