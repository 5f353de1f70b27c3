"""strumpack_tpu_torch — the PyTorch/CUDA port of strumpack_tpu.

The multifrontal solver on an NVIDIA H100 for real sparse matrices given
with or without a grid: MC64-family matching and scaling, equilibration,
a fill-reducing ordering (geometric, BFS or multilevel nested dissection,
spectral, natural, RCM, AMD, MMD, MLF), the level-batched numeric
factorization (LU with or without pivoting, Cholesky for SPD matrices,
or BLR fronts), the two-phase solve, and iterative refinement (f32, f64
or double float, from an initial guess), GMRES or BiCGStab; with the
factor diagnostics (inertia, pivot growth, subnormals).  Hand-written CUDA
kernels carry extend-add (``ops/extend_add.py``), the cross-shape and
small-front LUs (``ops/front_lu.py``) and the panel LU
(``ops/panel_lu.py``).  Beside the sparse solver: the structured dense
facade (``construct_from_dense`` and the matrix-free constructors over
HSS, HODLR, HODBF, butterfly, BLR, low-rank and lossy matrices) and
kernel ridge regression and classification (``GaussKernel`` and its
kin, ``KernelRegressionClassifier``).  The JAX package ``strumpack_tpu``
is the reference this package is held against; nothing here imports it
or JAX.
"""

from .options import (CompressionType, EquilibrationType, KrylovSolver,
                      MatchingJob, ReorderingStrategy, SPOptions)
from .solver import SparseSolver
from .sparse.csr import CSRMatrix
from .utils.params import ReturnCode

# structured dense API (structured::StructuredMatrix facade)
from .structured.structured import (StructuredMatrix, StructuredOptions,
                                    construct_from_dense,
                                    construct_from_elements,
                                    construct_matrix_free,
                                    construct_partially_matrix_free)
from .structured.structured import Type as StructuredType
from .structured.hss import HSSMatrix
from .structured.hodlr import HODLRMatrix
from .structured.butterfly import ButterflyMatrix

# kernel-matrix machine learning
from .kernel.kernel import (ANOVAKernel, DenseKernel, GaussKernel,
                            KernelRegressionClassifier, LaplaceKernel)

__version__ = "0.1.0"

__all__ = [
    "SparseSolver", "SPOptions", "CSRMatrix", "ReturnCode",
    "ReorderingStrategy", "CompressionType", "MatchingJob", "KrylovSolver",
    "EquilibrationType",
    "StructuredMatrix", "StructuredOptions", "StructuredType",
    "construct_from_dense", "construct_from_elements",
    "construct_matrix_free", "construct_partially_matrix_free",
    "HSSMatrix", "HODLRMatrix", "ButterflyMatrix",
    "GaussKernel", "LaplaceKernel", "ANOVAKernel", "DenseKernel",
    "KernelRegressionClassifier",
]
