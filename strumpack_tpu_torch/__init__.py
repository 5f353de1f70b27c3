"""strumpack_tpu_torch — the PyTorch/CUDA port of strumpack_tpu.

The exact multifrontal LU path (geometric nested dissection, level-batched
numeric factorization, two-phase solve, iterative refinement) on an NVIDIA
H100, with hand-written CUDA kernels for extend-add (``ops/extend_add.py``)
and the cross-shape front LU (``ops/front_lu.py``).  The JAX package
``strumpack_tpu`` is the reference this package is held against; nothing
here imports it or JAX.
"""

from .options import (CompressionType, EquilibrationType, KrylovSolver,
                      MatchingJob, ReorderingStrategy, SPOptions)
from .solver import SparseSolver
from .sparse.csr import CSRMatrix
from .utils.params import ReturnCode

__version__ = "0.1.0"

__all__ = [
    "SparseSolver", "SPOptions", "CSRMatrix", "ReturnCode",
    "ReorderingStrategy", "CompressionType", "MatchingJob", "KrylovSolver",
    "EquilibrationType",
]
