"""Initial conditions (JAX ``utils/ic.py`` counterpart).

Only the analytic heat-kernel Gaussian of the diffusion main path is
ported (``heat3d.m:33``: ``exp(-r²/(4 D t0))``); the other ICs of the
JAX registry raise until they are ported.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid


def heat_kernel(grid: Grid, dtype=torch.float32, device=None, t0=0.1,
                diffusivity=1.0):
    """Gaussian that solves the heat equation exactly (heat3d.m:33)."""
    r2 = grid.radius_sq(dtype, device)
    return torch.exp(-r2 / (4.0 * diffusivity * t0)).to(dtype)


REGISTRY: Dict[str, Callable] = {
    "heat_kernel": heat_kernel,
}


def initial_condition(name, grid: Grid, dtype=torch.float32, device=None,
                      **params) -> torch.Tensor:
    """Look up an IC by name and evaluate it."""
    if name not in REGISTRY:
        raise NotImplementedError(
            f"initial condition {name!r} is not ported; "
            f"available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name](grid, dtype=dtype, device=device, **params)
