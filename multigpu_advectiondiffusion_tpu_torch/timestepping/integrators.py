"""Explicit SSP integrators (JAX ``timestepping/integrators.py``).

Higher-order functions ``(rhs, u, dt, post) -> u``; ``post`` (the wall
fix-up) runs after every stage, as the reference re-imposes BCs per RK
stage (``heat3d.m:50-67``). ``dt`` is a Python float already rounded to
the field's precision.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Rhs = Callable[[torch.Tensor], torch.Tensor]
Post = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _id(u):
    return u


def euler(rhs: Rhs, u: torch.Tensor, dt, post: Post = None):
    post = post or _id
    return post(u + dt * rhs(u))


def ssp_rk2(rhs: Rhs, u: torch.Tensor, dt, post: Post = None):
    post = post or _id
    u1 = post(u + dt * rhs(u))
    return post(0.5 * (u + u1 + dt * rhs(u1)))


def ssp_rk3(rhs: Rhs, u: torch.Tensor, dt, post: Post = None):
    post = post or _id
    u1 = post(u + dt * rhs(u))
    u2 = post(0.75 * u + 0.25 * (u1 + dt * rhs(u1)))
    return post((u + 2.0 * (u2 + dt * rhs(u2))) / 3.0)


INTEGRATORS = {"euler": euler, "ssp_rk2": ssp_rk2, "ssp_rk3": ssp_rk3}

# rhs evaluations per step, for MLUPS-style accounting
STAGES = {"euler": 1, "ssp_rk2": 2, "ssp_rk3": 3}
