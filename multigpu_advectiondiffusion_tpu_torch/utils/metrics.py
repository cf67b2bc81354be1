"""Error norms and the MLUPS rate (JAX ``utils/metrics.py``).

Norms mirror the MATLAB post-processing (``heat3d.m:106-109``):
``L1 = prod(dx) * sum|e|``, ``L2 = sqrt(prod(dx) * sum e^2)``,
``Linf = max|e|``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ErrorNorms:
    l1: float
    l2: float
    linf: float

    def __iter__(self):
        return iter((self.l1, self.l2, self.linf))


def error_norms(u: torch.Tensor, u_exact: torch.Tensor,
                spacing: Sequence[float]) -> ErrorNorms:
    vol = math.prod(spacing)
    err = torch.abs(u - u_exact.to(u.dtype))
    l1 = vol * torch.sum(err)
    l2 = torch.sqrt(vol * torch.sum(err * err))
    linf = torch.max(err)
    return ErrorNorms(float(l1), float(l2), float(linf))


def mlups(num_cells: int, iters: int, stages: int, seconds: float) -> float:
    """Million lattice (cell) updates per second, counting RK stages."""
    return num_cells * iters * stages / seconds / 1e6
