"""Helpers of the port's tests (``tests/test_torch_*.py``).

* One torch thread and one BLAS thread a process: pytest-xdist runs six
  workers on the host's cores, and the port's small CPU tensors gain
  nothing from intra-op threads there, while their spinning threads slow
  every worker (on an 8-core host the port's test files took 12.3 min of
  CPU with the default thread count; with one thread, and three more
  files, 10.8).
* ``jax_draw``: the JAX package's own random draws for the port's draw
  function (``strumpack_tpu_torch/structured/draws.py``), so a test can
  replay the JAX package's sketches.
* ``jax_tree_numpy``: a JAX ``Factors.tree`` as the numpy tree
  ``strumpack_tpu_torch.interop.factors_from_numpy`` takes;
  ``facade_numpy`` and ``kernel_numpy``: a JAX structured facade object
  and a fitted JAX kernel as the dicts ``interop.facade_from_numpy`` and
  ``interop.kernel_from_numpy`` take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import threadpoolctl
import torch

torch.set_num_threads(1)
# numpy's BLAS the same way: six workers of 8 OpenBLAS threads each
# oversubscribe the host's cores, and the test processes' reference
# products (Schur complements, dense solves) are small
threadpoolctl.threadpool_limits(1, user_api="blas")

_JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64,
        torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}
_KEYS = {}


def jax_key(key):
    """The JAX key a port draw names: (seed, op, arg, ...) with "fold"
    (fold_in), "split" with an int i (the i-th key of split) and "split"
    with (n, i) (the i-th key of split(key, n)); keys are remembered, so
    a long chain replays its prefix once."""
    if key in _KEYS:
        return _KEYS[key]
    if len(key) == 1:
        k = jax.random.PRNGKey(key[0])
    else:
        k = jax_key(key[:-2])
        op, arg = key[-2:]
        if op == "fold":
            k = jax.random.fold_in(k, jnp.asarray(arg, jnp.int32))
        elif isinstance(arg, tuple):
            k = jax.random.split(k, arg[0])[arg[1]]
        else:
            k = jax.random.split(k)[arg]
    _KEYS[key] = k
    return k


def jax_draw(kind, shape, dtype, gen, key, high=None):
    """``draws.draw`` answered with the JAX package's draw of ``key``
    (a complex normal draw as the JAX package's butterfly ``_randn``)."""
    k = jax_key(key)
    if kind == "normal":
        from strumpack_tpu.structured.butterfly import _randn
        a = _randn(k, shape, _JDT[dtype])
    elif kind == "randint":
        a = jax.random.randint(k, shape, 0, high)
    else:
        a = jax.random.bernoulli(k, 0.5, shape)
    return torch.from_numpy(np.array(a)).to(gen.device)


def _np(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _fnode_numpy(f):
    """A JAX HODBF factor node (``FNode``) as a dict of numpy arrays."""
    if f is None:
        return None
    return dict(kind=f.kind, ml=f.ml, Dg=f.Dg, rg12=f.rg12, rg21=f.rg21,
                lu=_np(f.lu), G12=_np(f.G12), G21=_np(f.G21),
                W=(structured_numpy(f.W) if f.kind == "bf" else _np(f.W)),
                f1=_fnode_numpy(f.f1), f2=_fnode_numpy(f.f2))


def structured_numpy(H):
    """A JAX HSSMatrix/HODLRMatrix/HODBFMatrix as the attribute dict
    ``interop.structured_from_numpy`` takes."""
    if hasattr(H, "bf12"):
        return dict(kind="hodbf", m=H.m, t=H.t, mp=H.mp, L=H.L, r=H.r,
                    rel_tol=H.rel_tol, bf_D=list(H.bf_D),
                    bf_r=list(H.bf_r), D=np.asarray(H.D),
                    bf12=[_np(b) for b in H.bf12],
                    bf21=[_np(b) for b in H.bf21],
                    froot=_fnode_numpy(getattr(H, "_froot", None)))
    kind = "hss" if hasattr(H, "Uleaf") else "hodlr"
    d = {k: v for k, v in H.__dict__.items()
         if k not in ("dtype", "_constrain", "_shard_level", "_factored")}
    out = {k: (_np(v) if k not in ("m", "t", "mp", "L", "r", "rel_tol")
               else v) for k, v in d.items()}
    out["kind"] = kind
    return out


def facade_numpy(S):
    """A JAX ``StructuredMatrix`` wrapper as the dict
    ``interop.facade_from_numpy`` takes."""
    name = type(S).__name__
    t = {"_HSSWrap": "HSS", "_HODLRWrap": "HODLR", "_HODBFWrap": "HODBF",
         "_BLRDense": "BLR", "_ButterflyWrap": "BUTTERFLY",
         "_LRMatrix": "LR", "_LossyMatrix": "LOSSY"}[name]
    d = dict(type=t, rows=S.rows, cols=S.cols)
    if t in ("HSS", "HODLR", "HODBF"):
        d["h"] = structured_numpy(S.h)
    elif t == "BUTTERFLY":
        d["bf"] = {k: (_np(v) if k == "bf" else v)
                   for k, v in S.bf.__dict__.items()
                   if k not in ("dtype", "ranks")}
    elif t == "LR":
        d.update(U=np.asarray(S.U), V=np.asarray(S.V))
    elif t == "LOSSY":
        d.update(q=np.asarray(S.q), scale=np.asarray(S.scale), mp=S.mp,
                 np_=S.np_, lu=_np(S._lu))
    else:
        d.update(t=S.t, mpad=S.mpad, r=S.r, rel_tol=S.opts.rel_tol,
                 Ap=np.asarray(S.Ap), tiles=_np(S._tiles),
                 ranks=np.asarray(S._ranks), fac=_np(S._fac))
    return d


def kernel_numpy(k):
    """A fitted JAX ``Kernel`` as the dict ``interop.kernel_from_numpy``
    takes."""
    d = dict(cls=type(k).__name__, h=k.h, lam=k.lam,
             Xtrain=np.asarray(k._Xtrain), weights=np.asarray(k._weights),
             order=np.asarray(k._order), M=structured_numpy(k._M))
    if hasattr(k, "p"):
        d["p"] = k.p
    if hasattr(k, "K"):
        d["K"] = np.asarray(k.K)
    return d


def jit_jax_structured(monkeypatch):
    """Traces the JAX package's structured matrices as one program per
    call: the HSS, HODLR and HODBF constructors and products, the HSS and
    HODLR factorizations and solves, and the sampled and neighbour-built
    HSS constructors (op by op they cost 5-15 s of compiles a call on the
    CPU).  The code traced is the JAX package's own; a sampled build whose
    closures do not trace (the facade's element emulation reads numpy)
    runs op by op."""
    from strumpack_tpu.structured import hodbf as BJ
    from strumpack_tpu.structured import hodlr as OJ
    from strumpack_tpu.structured import hss as HJ
    from strumpack_tpu.structured import hss_sample as SJ
    for cls in (HJ.HSSMatrix, OJ.HODLRMatrix, BJ.HODBFMatrix):
        def init(self, A, *a, _cls=cls, _init=cls.__init__, **kw):
            def build(A):
                h = _cls.__new__(_cls)
                _init(h, A, *a, **kw)
                return h
            self.__dict__.update(jax.jit(build)(jnp.asarray(A)).__dict__)
        monkeypatch.setattr(cls, "__init__", init)
        monkeypatch.setattr(cls, "matvec", _jitted(cls.matvec))
        if cls is BJ.HODBFMatrix:       # its factorization adapts ranks
            continue
        monkeypatch.setattr(cls, "solve", _jitted(cls.solve))
        factored = jax.jit(lambda h, _factor=cls.factor: (_factor(h), h)[1])

        def jfactor(self, _f=factored):
            self.__dict__.update(_f(self).__dict__)
        monkeypatch.setattr(cls, "factor", jfactor)
    for name in ("hss_from_sampling", "hss_from_neighbors"):
        def build(*a, _orig=getattr(SJ, name), **kw):
            try:
                return jax.jit(lambda: _orig(*a, **kw))()
            except jax.errors.TracerArrayConversionError:
                return _orig(*a, **kw)
        monkeypatch.setattr(SJ, name, build)


def _jitted(method):
    fn = jax.jit(method)

    def call(self, x):
        return fn(self, jnp.asarray(x))
    return call


def jax_tree_numpy(tree):
    """A JAX ``Factors.tree`` with its arrays as numpy, structured
    entries as ``structured_numpy`` dicts."""
    out = {}
    for name in ("lu", "perm", "L21", "U12", "blr", "blr_ranks"):
        out[name] = {k: _np(v) for k, v in tree.get(name, {}).items()}
    out["hss"] = {k: (structured_numpy(H), _np(S12), _np(F21))
                  for k, (H, S12, F21) in tree.get("hss", {}).items()}
    return out


def solver_pair(A, dims, compression="NONE", tweak=None, **kw):
    """The JAX package's and the port's (CPU) solvers on A with the same
    options, reordered: ``compression`` a CompressionType name, ``kw``
    SPOptions fields (an enum value is taken by name from each package's
    own enum), ``tweak(opts)`` sets nested options in both."""
    import enum

    import strumpack_tpu as sj
    import strumpack_tpu_torch as st
    out = []
    for mod, dev in ((sj, {}), (st, {"device": "cpu"})):
        own = {k: (getattr(mod, type(v).__name__)[v.name]
                   if isinstance(v, enum.Enum) else v)
               for k, v in kw.items()}
        o = mod.SPOptions(
            compression=getattr(mod.CompressionType, compression), **own)
        if tweak is not None:
            tweak(o)
        s = mod.SparseSolver(o, **dev)
        s.set_csr_matrix(A if mod is sj else
                         st.CSRMatrix(A.n, A.rowptr, A.colind, A.data))
        assert s.reorder(*dims).name == "SUCCESS"
        out.append(s)
    return tuple(out)


BUCKET_FLAGS = ("blr", "tile", "max_rank", "adm_band", "blr_variant",
                "lr_algo", "cb_comp", "cb_rank", "lossy", "hss", "hodlr",
                "hss_leaf", "hss_rank", "hss_sample", "hodbf", "bf_D", "bf_r",
                "bf_direct", "bf_cutoff", "chunks")


def assert_flags_identical(ref, port):
    """The plans identical array for array (``test_torch_plan``) and flag
    for flag: front types, BLR tiles and caps, compressed CBs, lossy
    bits, HSS/HODLR leaves and ranks, HODBF butterfly depths, ranks and
    direct factorizations, chunks, the sampled buckets' ELL arrays."""
    from test_torch_plan import assert_plans_identical
    assert_plans_identical(ref, port)
    for lr, lp in zip(ref.plan.levels, port.plan.levels):
        for br, bp in zip(lr, lp):
            for name in BUCKET_FLAGS:
                assert getattr(bp, name) == getattr(br, name), name
            assert (bp.samp is None) == (br.samp is None)
            if bp.samp is not None:
                assert bp.samp_meta == br.samp_meta
                for k, v in br.samp.items():
                    assert bp.samp[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(bp.samp[k], v, err_msg=k)


def solve_on_jax_factors(ref, port, b, dtype=torch.float64):
    """(port solution, JAX solution) of one multifrontal solve of the
    permuted b on the JAX package's factors, carried into the port."""
    from strumpack_tpu.frontal import numeric as sj_numeric
    from strumpack_tpu_torch.frontal import numeric as st_numeric
    from strumpack_tpu_torch.interop import factors_from_numpy
    bp = ref._transform_b(b)
    want = np.asarray(sj_numeric.solve(ref.fac, bp))
    fac = factors_from_numpy(port.pdev, jax_tree_numpy(ref.fac.tree),
                             dtype=dtype)
    got = st_numeric.solve(fac, torch.from_numpy(np.asarray(bp))).numpy()
    return got, want
