"""Initial conditions (JAX ``utils/ic.py`` counterpart).

Ported: the analytic heat-kernel Gaussian of the diffusion main path
(``heat3d.m:33``: ``exp(-r²/(4 D t0))``) and the Burgers Gaussian
(``LFWENO5FDM3d.m:58``: ``amp exp(-r²/width)``); the other ICs of the
JAX registry raise until they are ported.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid


def gaussian(grid: Grid, dtype=torch.float32, device=None, amplitude=1.0,
             width=0.1):
    """``amp * exp(-r²/width)`` — DiffusionMPICUDA.h:58 and LFWENO5FDM3d.m:58."""
    return (amplitude * torch.exp(-grid.radius_sq(dtype, device) / width)
            ).to(dtype)


def heat_kernel(grid: Grid, dtype=torch.float32, device=None, t0=0.1,
                diffusivity=1.0):
    """Gaussian that solves the heat equation exactly (heat3d.m:33)."""
    r2 = grid.radius_sq(dtype, device)
    return torch.exp(-r2 / (4.0 * diffusivity * t0)).to(dtype)


REGISTRY: Dict[str, Callable] = {
    "gaussian": gaussian,
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
