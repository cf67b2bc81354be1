"""Solver state (JAX ``models/state.py`` counterpart).

``u`` is a tensor on the solver's device; ``t`` and ``it`` live on the
host — ``t`` as a numpy scalar of the state's precision (float32 for a
float32 field, as in the JAX package) and ``it`` as a Python int — so
the time loop advances them without a device sync per step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def time_dtype(u_dtype: torch.dtype):
    """The numpy scalar type that carries ``t`` for a field of ``u_dtype``."""
    return np.float64 if u_dtype == torch.float64 else np.float32


class SolverState(NamedTuple):
    """The evolving solution plus simulated time and iteration count."""

    u: torch.Tensor
    t: np.floating
    it: int

    @staticmethod
    def create(u: torch.Tensor, t: float = 0.0) -> "SolverState":
        return SolverState(u=u, t=time_dtype(u.dtype)(t), it=0)
