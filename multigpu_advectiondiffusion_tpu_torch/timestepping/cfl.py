"""Time-step selection (JAX ``timestepping/cfl.py`` counterpart).

* Diffusive stability bound — ``dt = safety / (2 K sum_i 1/dx_i^2)``
  (``main.c:64``, ``heat3d.m:39``).
* Advective CFL — ``dt = CFL * min dx / max|f'(u)|`` (``LFWENO5FDM3d.m:71``),
  with the global wave-speed reduction the CUDA drivers hard-coded away
  (``MultiGPU/Burgers3d_Baseline/main.c:193``).
* Advection–diffusion–reaction — the harmonic combination of the
  advective, diffusive and decay rates (:func:`advection_diffusion_dt`).

The advective functions return 0-d tensors on the field's device, so a
caller that keeps dt on the device never waits for it. In float32,
``cfl * min dx`` is rounded to float32 before the division, as the JAX
package's weak typing rounds it, and the division is a true division of
two tensors (a division by a Python scalar may run as a product with
its reciprocal on the GPU, which rounds twice).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def diffusive_dt(diffusivity: float, spacing: Sequence[float],
                 safety: float = 0.8) -> float:
    inv = sum(1.0 / (dx * dx) for dx in spacing)
    return safety / (2.0 * diffusivity * inv)


def max_wave_speed(u: torch.Tensor,
                   dflux: Callable[[torch.Tensor], torch.Tensor]):
    """Global ``max |f'(u)|`` as a 0-d tensor (NaN if any cell is NaN)."""
    return torch.amax(torch.abs(dflux(u)))


def dt_from_wave_speed(a: torch.Tensor, spacing: Sequence[float],
                       cfl: float, floor: float = 1e-12):
    """CFL dt from an already-computed ``max|f'(u)|`` 0-d tensor — the
    consumer of the fused stepper's in-kernel wave-speed emission. The
    one definition of the CFL formula: :func:`advective_dt` composes
    it."""
    num = torch.full((), cfl * min(spacing), dtype=a.dtype, device=a.device)
    lo = torch.full((), floor, dtype=a.dtype, device=a.device)
    return torch.div(num, torch.maximum(a, lo))


def advective_dt(u: torch.Tensor, dflux, spacing: Sequence[float],
                 cfl: float, floor: float = 1e-12):
    return dt_from_wave_speed(max_wave_speed(u, dflux), spacing, cfl,
                              floor=floor)


def advection_diffusion_dt(velocity: Sequence[float], diffusivity: float,
                           spacing: Sequence[float], cfl: float = 0.4,
                           safety: float = 0.8,
                           reaction: float = 0.0) -> float:
    """Combined stability bound of the advection–diffusion(–reaction)
    operator: the inverse rates add,

        1/dt = sum_i |a_i|/dx_i / cfl + 2 K sum_i 1/dx_i^2 / safety
             + lambda / safety,

    with ``diffusivity`` the maximum of the (possibly varying)
    coefficient. The JAX package's static-rate branch: every argument a
    Python number, the result a Python float (the fused kernels take dt
    by value). A member-varying rate waits for the ensemble engine."""
    inv = 0.0
    adv = sum(abs(float(a)) / dx for a, dx in zip(velocity, spacing))
    if adv:
        inv = inv + adv / cfl
    inv = inv + (
        2.0 * diffusivity * sum(1.0 / (dx * dx) for dx in spacing)
    ) / safety
    if reaction > 0.0:
        inv = inv + float(reaction) / safety
    return 1.0 / inv
