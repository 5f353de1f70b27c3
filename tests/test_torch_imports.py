"""The port stands alone: strumpack_tpu_torch and chip_smoke.py import
neither JAX nor anything of strumpack_tpu, and the port's entry points do
not fall back to the CPU quietly."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "strumpack_tpu_torch")


def _forbidden(mod):
    return (mod == "jax" or mod.startswith("jax.") or mod.startswith("jaxlib")
            or mod == "strumpack_tpu" or mod.startswith("strumpack_tpu."))


def _imports(path):
    """Absolute module names a source file imports (relative imports stay
    inside its own package)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_package_run_imports_no_jax():
    """A fresh interpreter (no test conftest) imports the package and runs
    its host pipeline, a small CPU solve, a small BLR + GMRES solve, the
    general-input paths (no grid, every ordering module, the distributed
    ND's single-process case, matching, SPD, double float), the rank-structured fronts (HSS, sampled HSS, HODLR,
    the ZFP_BLR_HODLR composite with compressed CBs and ACA tiles), and
    complex input (native complex128 and complex_via_real) with HODBF
    fronts, every structured facade type and kernel fits (dense, sketch
    and ann), and it imports the distributed solver's modules: no jax*
    and no strumpack_tpu.* module may appear in sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "import strumpack_tpu_torch as st\n"
        "from strumpack_tpu_torch.sparse.gen import poisson2d\n"
        "import strumpack_tpu_torch.interop\n"
        "from strumpack_tpu_torch.parallel import (dist, p2p, dist2d,\n"
        "    dist_matrix, spmd, dist_spmv, krylov_dist, driver)\n"
        "A = poisson2d(8)\n"
        "s = st.SparseSolver(st.SPOptions(), device='cpu')\n"
        "s.set_csr_matrix(A)\n"
        "s.reorder(8, 8)\n"
        "x, rc = s.solve(A.spmv(np.ones(A.n)))\n"
        "assert rc == st.ReturnCode.SUCCESS\n"
        "o = st.SPOptions(compression=st.CompressionType.BLR,\n"
        "                 compression_min_sep_size=16)\n"
        "o.blr.leaf_size = 16\n"
        "s = st.SparseSolver(o, device='cpu')\n"
        "s.set_csr_matrix(A)\n"
        "s.reorder(8, 8)\n"
        "assert any(bp.blr for lvl in s.plan.levels for bp in lvl)\n"
        "x, rc = s.solve(A.spmv(np.ones(A.n)))\n"
        "assert rc == st.ReturnCode.SUCCESS\n"
        "for kw in (dict(), dict(reordering_method=st.ReorderingStrategy.AMD),\n"
        "           dict(reordering_method=st.ReorderingStrategy.PARMETIS),\n"
        "           dict(reordering_method=st.ReorderingStrategy.SPECTRAL),\n"
        "           dict(matching=st.MatchingJob.MAX_DIAGONAL_PRODUCT_SCALING,\n"
        "                positive_definite=True),\n"
        "           dict(factor_dtype='float32', refine_dtype='float32x2',\n"
        "                rel_tol=1e-12, abs_tol=1e-13)):\n"
        "    s = st.SparseSolver(st.SPOptions(**kw), device='cpu')\n"
        "    s.set_csr_matrix(A)\n"
        "    x, rc = s.solve(A.spmv(np.ones(A.n)))\n"
        "    assert rc == st.ReturnCode.SUCCESS, kw\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "B = poisson2d(16)\n"
        "for comp, samp in (('HSS', False), ('HODLR', False),\n"
        "                   ('ZFP_BLR_HODLR', True)):\n"
        "    o = st.SPOptions(compression=st.CompressionType[comp],\n"
        "                     compression_min_sep_size=8, hodlr_min_sep_size=16,\n"
        "                     lossy_min_sep_size=4)\n"
        "    o.hss.leaf_size, o.hss.sampling = 8, samp\n"
        "    o.blr.leaf_size, o.blr.low_rank_algorithm = 8, 'aca'\n"
        "    s = st.SparseSolver(o, device='cpu')\n"
        "    s.set_csr_matrix(B)\n"
        "    s.reorder(16, 16)\n"
        "    x, rc = s.solve(B.spmv(np.ones(B.n)))\n"
        "    assert rc == st.ReturnCode.SUCCESS, comp\n"
        "from strumpack_tpu_torch.sparse.gen import helmholtz3d, poisson3d\n"
        "H = helmholtz3d(8, k0=8.0)\n"
        "for A, via in ((H, False), (H, True), (poisson3d(8), False)):\n"
        "    o = st.SPOptions(compression=st.CompressionType.HODBF,\n"
        "                     compression_min_sep_size=16,\n"
        "                     complex_via_real=via,\n"
        "                     factor_dtype=A.data.dtype.name,\n"
        "                     refine_dtype=A.data.dtype.name)\n"
        "    o.hss.leaf_size = 16\n"
        "    s = st.SparseSolver(o, device='cpu')\n"
        "    s.set_csr_matrix(A)\n"
        "    s.reorder(8, 8, 8)\n"
        "    assert s.pdev.kinds()['hodbf'] > 0\n"
        "    x, rc = s.solve(A.spmv(np.ones(A.n, A.data.dtype)))\n"
        "    assert rc == st.ReturnCode.SUCCESS and x.dtype == A.data.dtype\n"
        "M = np.random.default_rng(0).standard_normal((96, 96)) + 96 * np.eye(96)\n"
        "for t in st.StructuredType:\n"
        "    S = st.construct_from_dense(M, st.StructuredOptions(\n"
        "        type=t, leaf_size=16, rel_tol=1e-6), device='cpu')\n"
        "    assert S.mult(np.ones(96)).shape == (96,) and S.memory() > 0\n"
        "    if t.name not in ('BUTTERFLY', 'LR'):\n"
        "        S.factor()\n"
        "        assert S.solve(np.ones(96)).shape == (96,)\n"
        "P = np.random.default_rng(1).standard_normal((300, 2))\n"
        "for kw in (dict(), dict(matrix_free=True),\n"
        "           dict(matrix_free=True, compression='ann')):\n"
        "    k = st.GaussKernel(h=1.0, lam=1.0, device='cpu')\n"
        "    k.fit_HSS(P, np.sin(P[:, 0]), leaf_size=32, **kw)\n"
        "    assert np.isfinite(k.predict(P[:10])).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'strumpack_tpu' or m.startswith('strumpack_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax():
    """Every module of the package and chip_smoke.py, by their ASTs."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = {f: m for f in files for m in _imports(f) if _forbidden(m)}
    names = {os.path.relpath(f, PKG) for f in files}
    for mod in ("ops/rrqr.py", "ops/panel_lu.py", "frontal/blr.py",
                "krylov/solvers.py", "sparse/ordering/nd.py",
                "sparse/ordering/separator_reorder.py", "ops/twofloat.py",
                "sparse/ordering/nd_dist.py",
                "sparse/matching.py", "sparse/ordering/amd.py",
                "native/__init__.py", "ops/aca.py", "structured/hss.py",
                "structured/hodlr.py", "structured/hss_sample.py",
                "structured/draws.py", "structured/butterfly.py",
                "structured/hodbf.py", "structured/structured.py",
                "kernel/kernel.py", "kernel/clustering.py",
                "parallel/dist.py", "parallel/p2p.py", "parallel/dist2d.py",
                "parallel/dist_matrix.py", "parallel/spmd.py",
                "parallel/dist_spmv.py", "parallel/krylov_dist.py",
                "parallel/driver.py", "parallel/__init__.py"):
        assert mod in names, mod
    assert len(files) > 20 and not bad, bad


def test_solver_without_device_needs_cuda():
    from strumpack_tpu_torch import SparseSolver
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseSolver()
    assert SparseSolver(device="cpu").device.type == "cpu"
