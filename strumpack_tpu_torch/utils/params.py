"""Return codes and global counters.

Analog of the reference's ``StrumpackParameters.hpp:50-110`` (flop/memory
counters, ``ReturnCode`` enum).  The counters are plain Python ints updated
from host code; flops are computed analytically from the static level plan,
which is exact for dense factorization.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class ReturnCode(enum.Enum):
    """Mirror of the reference's ReturnCode (StrumpackParameters.hpp:50-58)."""

    SUCCESS = 0
    MATRIX_NOT_SET = 1
    REORDERING_ERROR = 2
    ZERO_PIVOT = 3
    NO_CONVERGENCE = 4
    INACCURATE_INERTIA = 5


@dataclass
class Counters:
    """Flop / memory counters (role of strumpack::params globals)."""

    flops: int = 0
    peak_device_bytes: int = 0
    factor_nonzeros: int = 0
    factor_memory: int = 0

    def reset(self) -> None:
        self.flops = 0
        self.peak_device_bytes = 0
        self.factor_nonzeros = 0
        self.factor_memory = 0


counters = Counters()
