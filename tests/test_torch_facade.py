"""The port's structured dense facade (``strumpack_tpu_torch/structured/
structured.py``) against the JAX package's, f64 on the CPU.

The matrix is ``tests/test_structured.py``'s ``cauchyish(256)``; the
options are its facade test's (leaf 32, rank 24, tolerance 1e-8, LOSSY
1e-2).  The deterministic types (HSS, BLR, HODLR, BUTTERFLY, LR) give the
JAX package's ``rank()`` and ``memory()`` exactly and its products and
solves within 1e-10 relative; HODBF draws in its factorization, replayed
from the JAX package's keys (``torch_ref.jax_draw``), within 1e-8; LOSSY
stores the same int8 tiles and scales and computes in float32.  The
constructors from elements and from products (sampled, so replayed) are
held the same way, and state carried over from the JAX package
(``interop.facade_from_numpy``) solves as it does to 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref

from strumpack_tpu.structured import structured as SJ

from strumpack_tpu_torch import interop
from strumpack_tpu_torch.structured import draws
from strumpack_tpu_torch.structured import structured as ST

TYPES = ["HSS", "BLR", "HODLR", "HODBF", "BUTTERFLY", "LR", "LOSSY"]
SOLVES = {"HSS", "BLR", "HODLR", "HODBF", "LOSSY"}
# relative agreement of products and solves with the JAX package's
TOL = {"HODBF": 1e-8, "LOSSY": 1e-5}


def cauchyish(m, seed=0):
    """``tests/test_structured.py:15``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, m))
    return 1.0 / (0.05 + np.abs(x[:, None] - x[None, :])) + np.eye(m) * 50


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _opts(mod, name):
    return mod.StructuredOptions(
        type=mod.Type[name], rel_tol=1e-2 if name == "LOSSY" else 1e-8,
        leaf_size=32, max_rank=24)


@pytest.fixture(autouse=True)
def replay(monkeypatch):
    monkeypatch.setattr(draws, "draw", torch_ref.jax_draw)
    torch_ref.jit_jax_structured(monkeypatch)


def _jax_facade(name):
    """The JAX package's facade object of ``name`` on cauchyish(256),
    factored where it factors, as host data: its rank and memory, its
    state (``torch_ref.facade_numpy``), its product of x [256, 2] and its
    solve of A x (one build a type for the run: ``torch_ref.shared``)."""
    def build():
        A = cauchyish(256)
        x = np.random.default_rng(1).standard_normal((256, 2))
        S = SJ.construct_from_dense(A, _opts(SJ, name))
        y = np.asarray(S.mult(jnp.asarray(x)))
        xs = None
        if name in SOLVES:
            S.factor()
            xs = np.asarray(S.solve(jnp.asarray(A @ x)))
        return dict(A=A, x=x, y=y, xs=xs, rank=np.asarray(S.rank()).item(),
                    memory=np.asarray(S.memory()).item(),
                    state=torch_ref.facade_numpy(S))
    return torch_ref.shared("facade-" + name, build)


@pytest.mark.parametrize("name", TYPES)
def test_construct_from_dense_matches_jax(name):
    """Every Type through ``construct_from_dense``: the same rank and
    memory, products and solves of one and of two right-hand sides
    within the tolerance, a 1-D x giving a 1-D result."""
    ref = _jax_facade(name)
    A, x, yj, xj = ref["A"], ref["x"], ref["y"], ref["xs"]
    St = ST.construct_from_dense(A, _opts(ST, name), device="cpu")
    assert St.rank() == ref["rank"]
    assert St.memory() == ref["memory"]
    tol = TOL.get(name, 1e-10)
    yt = St.mult(x)
    assert yt.shape == (256, 2)
    assert _rel(yt, yj) < tol
    y1 = St.mult(x[:, 0])
    assert y1.shape == (256,)
    assert _rel(y1, yj[:, 0]) < tol
    if name == "LOSSY":
        np.testing.assert_array_equal(St.q.numpy(), ref["state"]["q"])
        np.testing.assert_array_equal(St.scale.numpy(),
                                      ref["state"]["scale"])
    if name in SOLVES:
        St.factor()
        xt = St.solve(A @ x)
        assert _rel(xt, xj) < tol
        assert St.solve(A @ x[:, 0]).shape == (256,)


@pytest.mark.parametrize("name", TYPES)
def test_facade_state_carried_across(name):
    """The JAX package's compressed (and factored) state carried into the
    port's wrapper gives the JAX package's products and solves: to 1e-12
    in f64, LOSSY to float32 rounding."""
    ref = _jax_facade(name)
    A, x, yj, xj = ref["A"], ref["x"], ref["y"], ref["xs"]
    St = interop.facade_from_numpy(ref["state"], "cpu")
    tol = 1e-5 if name == "LOSSY" else 1e-12
    assert St.rank() == ref["rank"] and St.memory() == ref["memory"]
    assert _rel(St.mult(x), yj) < tol
    if name in SOLVES:
        assert _rel(St.solve(A @ x), xj) < tol


def test_construct_from_elements_matches_jax():
    """``tests/test_structured.py``'s element function, HSS."""
    m = 128

    def elem(i, j):
        return 1.0 / (1.0 + np.abs(i - j)) + 4.0 * (i == j)
    kw = dict(type="hss", rel_tol=1e-8, leaf_size=32)
    Sj = SJ.construct_from_elements(elem, m, m, SJ.StructuredOptions(**kw))
    St = ST.construct_from_elements(elem, m, m, ST.StructuredOptions(**kw),
                                    device="cpu")
    x = np.random.default_rng(0).standard_normal(m)
    assert St.rank() == Sj.rank() and St.memory() == Sj.memory()
    assert _rel(St.mult(x), Sj.mult(x)) < 1e-10


@pytest.mark.parametrize("free", ["matrix_free", "partially_matrix_free"])
def test_construct_from_products_matches_jax(free):
    """HSS from products only (elements read by unit-vector products) and
    from products and elements, at the JAX tests' configurations
    (``tests/test_structured.py``: cauchyish(200, seed 9) at 1e-8, and
    cauchyish(300) at 1e-9): the sketch replayed, the same ranks and
    memory, products and solves within 1e-8.  The greedy IDs pick among
    near ties by rounding, so the two agree to within their compression
    error (each solve 2-3e-8 from the exact one), not to rounding."""
    m, seed, tol = ((200, 9, 1e-8) if free == "matrix_free"
                    else (300, 0, 1e-9))
    A = cauchyish(m, seed=seed)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    kw = dict(type="hss", rel_tol=tol, leaf_size=32, max_rank=24)
    if free == "matrix_free":
        Sj = SJ.construct_matrix_free(
            lambda X, trans: (Aj.T if trans else Aj) @ X, m,
            SJ.StructuredOptions(**kw))
        St = ST.construct_matrix_free(
            lambda X, trans: (At.T if trans else At) @ X, m,
            ST.StructuredOptions(**kw), device="cpu")
    else:
        Sj = SJ.construct_partially_matrix_free(
            lambda X, trans: (Aj.T if trans else Aj) @ X,
            lambda I, J: Aj[I, J], m, SJ.StructuredOptions(**kw))
        St = ST.construct_partially_matrix_free(
            lambda X, trans: (At.T if trans else At) @ X,
            lambda I, J: At[I, J], m, ST.StructuredOptions(**kw),
            device="cpu")
    v = np.random.default_rng(1).standard_normal(m)
    assert St.rank() == Sj.rank() and St.memory() == Sj.memory()
    assert _rel(St.mult(v), Sj.mult(jnp.asarray(v))) < 1e-8
    Sj.factor()
    St.factor()
    assert _rel(St.solve(A @ v), Sj.solve(jnp.asarray(A @ v))) < 1e-8


def test_default_device_needs_cuda():
    """The constructors default to the card, as the sparse solver does."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ST.construct_from_dense(np.eye(4), ST.StructuredOptions())
