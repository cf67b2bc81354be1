"""Time-step selection (JAX ``timestepping/cfl.py``): the diffusive bound
``dt = safety / (2 K sum_i 1/dx_i^2)`` (``main.c:64``, ``heat3d.m:39``)."""

from __future__ import annotations

from typing import Sequence


def diffusive_dt(diffusivity: float, spacing: Sequence[float],
                 safety: float = 0.8) -> float:
    inv = sum(1.0 / (dx * dx) for dx in spacing)
    return safety / (2.0 * diffusivity * inv)
