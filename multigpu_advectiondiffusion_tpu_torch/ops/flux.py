"""Scalar flux functions for the hyperbolic solvers (JAX ``ops/flux.py``
counterpart, on tensors).

The selectable flux menu of the MATLAB drivers
(``Matlab_Prototipes/InviscidBurgersNd/LFWENO5FDM3d.m:30-40``): linear
advection, Burgers ``u^2/2`` (``MultiGPU/Burgers3d_Baseline/Kernels.cu:32-35``)
and Buckley–Leverett. Each entry provides ``f(u)`` and its wave speed
``f'(u)``, with the JAX package's operation order, so float64 results
agree to rounding and float32 ones bit for bit. Squares are written
``x * x``: the JAX package's ``x ** 2`` lowers to that product.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Flux:
    name: str
    f: Callable[[torch.Tensor], torch.Tensor]
    df: Callable[[torch.Tensor], torch.Tensor]
    cfl_max: float  # author-recommended CFL ceiling (LFWENO5FDM3d.m:31-39)
    # the constant speed of the linear flux, which the CUDA stage kernel
    # takes as a number; None for the nonlinear fluxes
    c: Optional[float] = None


def _sq(x):
    return x * x


def linear(c: float = -1.0) -> Flux:
    return Flux(
        name="linear",
        f=lambda w: c * w,
        df=lambda w: torch.full_like(w, c),
        cfl_max=0.65,
        c=float(c),
    )


def burgers() -> Flux:
    return Flux(
        name="burgers",
        f=lambda w: 0.5 * w * w,
        df=lambda w: w,
        cfl_max=0.40,
    )


def buckley_leverett() -> Flux:
    def f(w):
        return 4.0 * w * w / (4.0 * w * w + _sq(1.0 - w))

    def df(w):
        return 8.0 * w * (1.0 - w) / _sq(5.0 * w * w - 2.0 * w + 1.0)

    return Flux(name="buckley", f=f, df=df, cfl_max=0.20)


def get(name: str, **kwargs) -> Flux:
    registry = {
        "linear": linear,
        "burgers": burgers,
        "buckley": buckley_leverett,
        "buckley_leverett": buckley_leverett,
    }
    if name not in registry:
        raise ValueError(f"unknown flux {name!r}; use {sorted(registry)}")
    return registry[name](**kwargs)
