"""Central-difference Laplacians, 2nd and 4th order (JAX ``ops/laplacian.py``).

Plain PyTorch: the JAX package computes this generic operator outside
Pallas too. Each axis term is a sum of shifted slices of a padded
array, in the JAX package's term order, so float64 results agree to
rounding.
"""

from __future__ import annotations

from typing import Sequence

import torch

from multigpu_advectiondiffusion_tpu_torch.ops.stencils import Padder, shifted

# order -> (coefficients, halo radius, denominator)
D2_STENCILS = {
    2: ((1.0, -2.0, 1.0), 1, 1.0),
    4: ((-1.0, 16.0, -30.0, 16.0, -1.0), 2, 12.0),
}


def d2_from_padded(up: torch.Tensor, axis: int, dx: float, order: int = 4):
    """Second derivative along ``axis`` of an array padded by the radius."""
    coefs, r, denom = D2_STENCILS[order]
    n = up.shape[axis] - 2 * r
    scale = 1.0 / (denom * dx * dx)
    acc = None
    for j, c in enumerate(coefs):
        term = shifted(up, axis, j, n) * (c * scale)
        acc = term if acc is None else acc + term
    return acc


def laplacian(
    u: torch.Tensor,
    spacing: Sequence[float],
    padder: Padder,
    diffusivity: float | Sequence[float] = 1.0,
    order: int = 4,
) -> torch.Tensor:
    """``sum_axis K_axis * d2u/dx_axis^2`` over all array axes, each axis
    padded by ``padder``. The generic path only: the JAX package's
    per-axis stencil kernel is not ported yet.
    """
    if isinstance(diffusivity, (int, float)):
        diffusivity = [float(diffusivity)] * u.ndim
    _, r, _ = D2_STENCILS[order]
    acc = None
    for axis in range(u.ndim):
        term = diffusivity[axis] * d2_from_padded(
            padder(u, axis, r), axis, spacing[axis], order
        )
        acc = term if acc is None else acc + term
    return acc
