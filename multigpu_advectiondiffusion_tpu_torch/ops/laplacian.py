"""Central-difference Laplacians, 2nd and 4th order (JAX ``ops/laplacian.py``).

The generic operator is plain PyTorch, as the JAX package computes it
outside Pallas: each axis term is a sum of shifted slices of a padded
array, in the JAX package's term order, so float64 results agree to
rounding. ``impl="pallas"`` runs the per-axis stencil kernel instead.
"""

from __future__ import annotations

from typing import Sequence

import torch

from multigpu_advectiondiffusion_tpu_torch.ops.stencils import (
    GhostFn,
    Padder,
    shifted,
    split_axis_apply,
)

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
    impl: str = "xla",
    ghost_fn: GhostFn | None = None,
) -> torch.Tensor:
    """``sum_axis K_axis * d2u/dx_axis^2`` over all array axes, each axis
    padded by ``padder``. ``ghost_fn`` (sharded axes only) switches those
    axes to the overlapped interior/boundary schedule
    (:func:`ops.stencils.split_axis_apply`); the kernel path ignores it,
    as it consumes one padded array. ``impl`` selects the kernel strategy:
    ``"xla"`` (the generic shifted-slice sum) or ``"pallas"`` (every
    axis padded, then the per-axis stencil kernel K11/K11b,
    :mod:`ops.kernels.laplacian`). A problem the kernel does not
    compute raises: the caller names that decline and asks for
    ``"xla"``.
    """
    if isinstance(diffusivity, (int, float)):
        diffusivity = [float(diffusivity)] * u.ndim
    _, r, _ = D2_STENCILS[order]
    if impl == "pallas":
        from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
            laplacian as klap,
        )

        if not klap.supported(u.shape, order, u.element_size()):
            raise ValueError(
                f"no Laplacian kernel for order {order}, {u.dtype}, "
                f"{u.ndim}-D; use impl='xla'")
        up = u
        for axis in range(u.ndim):
            up = padder(up, axis, r)
        fn = klap.laplacian_o4_3d if u.ndim == 3 else klap.laplacian_o4_2d
        return fn(up, spacing, diffusivity)
    if impl != "xla":
        raise ValueError(f"unknown laplacian impl {impl!r}; use 'xla'/'pallas'")
    acc = None
    for axis in range(u.ndim):
        ghosts = ghost_fn(u, axis, r) if ghost_fn is not None else None
        if ghosts is not None:
            term = diffusivity[axis] * split_axis_apply(
                lambda up, a=axis: d2_from_padded(up, a, spacing[a], order),
                u, axis, r, *ghosts)
        else:
            term = diffusivity[axis] * d2_from_padded(
                padder(u, axis, r), axis, spacing[axis], order
            )
        acc = term if acc is None else acc + term
    return acc
