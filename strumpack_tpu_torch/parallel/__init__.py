"""The distributed solver over torch.distributed (the counterpart of
``strumpack_tpu/parallel``: the reference's MPI layer)."""
from .driver import DistributedSparseSolver  # noqa: F401
