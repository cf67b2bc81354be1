"""Solver states (JAX ``models/state.py`` counterpart).

``u`` is a tensor on the solver's device; ``t`` and ``it`` live on the
host — ``t`` as a numpy scalar of the state's precision (float32 for a
float32 field, as in the JAX package) and ``it`` as a Python int — so
the time loop advances them without a device sync per step. An
:class:`EnsembleState` batches B members: ``u`` is ``(B, *grid)`` on
the device, ``t`` and ``it`` are ``(B,)`` numpy arrays.
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


class EnsembleState(NamedTuple):
    """A batch of B independent solver states advanced by one dispatch.

    The member axis leads every field: ``u`` is ``(B, *grid.shape)`` on
    the device, ``t`` a ``(B,)`` numpy array in the time dtype and
    ``it`` a ``(B,)`` int32 array — members may sit at different
    simulated times (member-varying dt) and, in ``advance_to`` mode,
    different step counts.
    """

    u: torch.Tensor  # (B, *grid.shape)
    t: np.ndarray    # (B,)
    it: np.ndarray   # (B,) int32

    @property
    def members(self) -> int:
        return int(self.u.shape[0])

    @staticmethod
    def stack(states) -> "EnsembleState":
        """Batch B single-member states into one ensemble state."""
        states = list(states)
        if not states:
            raise ValueError("an ensemble needs at least one member")
        u = torch.stack([s.u for s in states])
        return EnsembleState(
            u=u,
            t=np.array([s.t for s in states], dtype=time_dtype(u.dtype)),
            it=np.array([int(s.it) for s in states], dtype=np.int32),
        )

    def member(self, i: int) -> SolverState:
        """Member ``i`` as a plain :class:`SolverState` view."""
        return SolverState(u=self.u[i], t=self.t[i], it=int(self.it[i]))
