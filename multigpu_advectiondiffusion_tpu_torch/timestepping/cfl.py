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

Member-varying operands (the ensemble engine's ``K``, ``cfl`` and decay
rate) arrive as 0-d float32 tensors, as the JAX package packs them
(``models/base.py`` ``_ensemble_pack``). Then every function takes the
JAX package's traced branch: each operation in float32, Python numbers
rounded to float32 where they meet the operand, true divisions — so dt
rounds as the JAX package's does. The result is a 0-d tensor that
carries the operand's autograd history.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one rounded division (``num / tensor`` in
    PyTorch is ``reciprocal(den) * num``, rounded twice)."""
    return torch.div(torch.full((), num, dtype=den.dtype,
                                device=den.device), den)


def diffusive_dt(diffusivity, spacing: Sequence[float],
                 safety: float = 0.8):
    """``safety / (2 K sum_i 1/dx_i^2)``: a Python float for a Python
    ``K``; a 0-d tensor for a member-varying (tensor) ``K``."""
    inv = sum(1.0 / (dx * dx) for dx in spacing)
    if isinstance(diffusivity, torch.Tensor):
        return _rdiv(safety, 2.0 * diffusivity * inv)
    return safety / (2.0 * diffusivity * inv)


def max_wave_speed(u: torch.Tensor,
                   dflux: Callable[[torch.Tensor], torch.Tensor],
                   reduce_max=None):
    """Global ``max |f'(u)|`` as a 0-d tensor (NaN if any cell is NaN);
    ``reduce_max`` adds the cross-shard max."""
    local = torch.amax(torch.abs(dflux(u)))
    return reduce_max(local) if reduce_max is not None else local


def dt_from_wave_speed(a: torch.Tensor, spacing: Sequence[float],
                       cfl: float, reduce_max=None, floor: float = 1e-12):
    """CFL dt from an already-computed (shard-local) ``max|f'(u)|`` 0-d
    tensor — the consumer of the fused stepper's in-kernel wave-speed
    emission; ``reduce_max`` adds the cross-shard max. The one
    definition of the CFL formula: :func:`advective_dt` composes it. A
    member-varying (tensor) ``cfl`` forms ``cfl * min dx`` in its own
    float32, as the JAX package's traced operand does."""
    if reduce_max is not None:
        a = reduce_max(a)
    if isinstance(cfl, torch.Tensor):
        num = (cfl * min(spacing)).to(a.device)
    else:
        num = torch.full((), cfl * min(spacing), dtype=a.dtype,
                         device=a.device)
    lo = torch.full((), floor, dtype=a.dtype, device=a.device)
    return torch.div(num, torch.maximum(a, lo))


def advective_dt(u: torch.Tensor, dflux, spacing: Sequence[float],
                 cfl: float, reduce_max=None, floor: float = 1e-12):
    return dt_from_wave_speed(max_wave_speed(u, dflux, reduce_max),
                              spacing, cfl, floor=floor)


def advection_diffusion_dt(velocity: Sequence[float], diffusivity,
                           spacing: Sequence[float], cfl: float = 0.4,
                           safety: float = 0.8, reaction=0.0):
    """Combined stability bound of the advection–diffusion(–reaction)
    operator: the inverse rates add,

        1/dt = sum_i |a_i|/dx_i / cfl + 2 K sum_i 1/dx_i^2 / safety
             + lambda / safety,

    with ``diffusivity`` the maximum of the (possibly varying)
    coefficient. With every argument a Python number the result is a
    Python float (the fused kernels take dt by value); a member-varying
    (tensor) ``diffusivity`` or ``reaction`` takes the JAX package's
    traced branch and returns a 0-d tensor."""
    inv = 0.0
    adv = sum(abs(float(a)) / dx for a, dx in zip(velocity, spacing))
    if adv:
        inv = inv + adv / cfl
    inv = inv + (
        2.0 * diffusivity * sum(1.0 / (dx * dx) for dx in spacing)
    ) / safety
    if isinstance(reaction, torch.Tensor):
        inv = inv + torch.clamp_min(reaction, 0.0) / safety
    elif reaction > 0.0:
        inv = inv + float(reaction) / safety
    if isinstance(inv, torch.Tensor):
        return _rdiv(1.0, inv)
    return 1.0 / inv
