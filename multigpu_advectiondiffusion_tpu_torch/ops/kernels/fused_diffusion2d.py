"""Whole-run SSP-RK3 stepping for 2-D diffusion: one kernel launch per
run (JAX ``ops/pallas/fused_diffusion2d.py`` counterpart; kernel K7,
diffusion body, ``csrc/whole_run_diffusion2d.cu``).

A reference-scale 2-D grid (1001², ``SingleGPU/Diffusion2d/Run.m``) is
4 MB in float32, so the three padded buffers of a step fit the H100's
50 MB L2 four times over: the state is read from device memory once,
every stage of every step runs in one cooperative launch
(:mod:`whole_run`), and the result is written once.

* The state lives padded, ``(ny+4, nx+4)`` float32, the K1 layout in one
  dimension fewer (the TPU's (8, 128) rounding is gone). The 2-deep
  ghost ring holds the Dirichlet wall value and is never written: with
  reference-parity walls the RHS is zero on the boundary band
  (``Laplace3d.m:21``) and faces are clamped after every stage
  (``heat3d.m:65-67``).
* The plain stage is K1's twin (:func:`fused_diffusion.stage_reference`),
  which is dimension-generic: the 2-D body is K1's stage with the z axis
  gone, the same taps, combine, mask and clamp, rounded alike.
* :func:`whole_run_diffusion2d` launches K7 for a CUDA tensor and raises
  if it cannot; for a CPU tensor — and only then — the plain twin runs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    R,
    PaddedDiffusionState,
    stage_reference as _stage_nd,
)

SOURCE = "whole_run_diffusion2d.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _I, _I, _P, _F, _I, _F, _I, _I, _P, _P)


def library():
    """The built K7 diffusion kernel (compiled at first use)."""
    return wr.library(SOURCE, "whole_run_diffusion2d", _ARGTYPES)


def stage_reference(v, u, out, dt, *, taps, a, b, band, bc_value):
    """The plain K7 diffusion stage on a padded ``(ny+4, nx+4)`` state:
    ``out``'s interior ``<- where(interior, a*u + b*(v + dt*acc),
    where(face, bc_value, v))``, the taps summed y then x — K1's twin in
    two dimensions (``fused_diffusion2d.py:45-62``)."""
    if v.dim() != 2:
        raise ValueError(f"padded 2-D state expected, got {tuple(v.shape)}")
    return _stage_nd(v, u, out, dt, taps=taps, a=a, b=b, band=band,
                     bc_value=bc_value)


def whole_run_diffusion2d(S, T1, T2, num_iters: int, dt, *, taps, band,
                          bc_value, sync_floor: bool = False,
                          grid_blocks: list | None = None):
    """``num_iters`` SSP-RK3 steps on the padded state ``S`` in place,
    ``T1``/``T2`` scratch with ``S``'s ghost ring; returns ``S``. A CUDA
    tensor launches K7 once (counted in ``whole_run.whole_run.launches``);
    with ``sync_floor`` the same grid runs only its barriers. ``dt`` is
    rounded to float32. ``grid_blocks``, a list, receives the grid's
    block count."""
    if S.dim() != 2 or min(S.shape) <= 2 * R:
        raise ValueError(f"padded 2-D state expected, got {tuple(S.shape)}")
    ny, nx = (n - 2 * R for n in S.shape)
    dt32 = float(np.float32(dt))
    host_taps = np.asarray(taps, dtype=np.float32)
    if host_taps.size != 10:
        raise ValueError(f"10 taps expected, got {host_taps.size}")
    blocks = ctypes.c_int(0)

    def kernel(S, T1, T2, n):
        rc = library().whole_run_diffusion2d(
            S.data_ptr(), T1.data_ptr(), T2.data_ptr(), ny, nx,
            host_taps.ctypes.data, dt32, int(band), float(bc_value), n,
            int(not sync_floor), ctypes.byref(blocks), wr.stream_of(S))
        if grid_blocks is not None:
            grid_blocks.append(blocks.value)
        return rc

    def stage(v, u, out, dt_, a, b):
        return stage_reference(v, u, out, dt_, taps=taps, a=a, b=b,
                               band=band, bc_value=bc_value)

    return wr.whole_run(kernel, stage, S, T1, T2, num_iters, dt32)


class FusedDiffusion2DStepper(PaddedDiffusionState):
    """Whole-run stepper for one (grid, dt) configuration on one device.
    It has no ``run_to``: ``advance_to`` runs the generic loop, as in the
    JAX package."""

    engaged_label = "fused-whole-run"

    def stencil_spec(self) -> dict:
        """Stencil metadata, the JAX stepper's keys: whole-run residency
        with an ``R``-deep frozen Dirichlet pad, no exchange."""
        return {
            "kernel": self.engaged_label,
            "stage_radius": R,
            "fused_stages": 1,
            "ghost_depth": R,
            "exchange_depth": None,
            "steps_per_exchange": 1,
            "storage_dtype": "float32",
            "bytes_per_cell": 4,
        }

    @staticmethod
    def supported(interior_shape, dtype) -> bool:
        """Float32, and the three padded buffers fit the L2 gate
        (:func:`whole_run.fits_l2`)."""
        return dtype == torch.float32 and wr.fits_l2(
            [n + 2 * R for n in interior_shape])

    def run(self, u, t, num_iters: int):
        """``num_iters`` steps in one launch; returns ``(u, t)``, ``t``
        advanced on the host in its own precision."""
        if num_iters == 0:
            return u, t
        S = self.embed(u)
        whole_run_diffusion2d(S, S.clone(), S.clone(), num_iters, self.dt,
                              taps=self.taps, band=self.band,
                              bc_value=self.bc_value)
        return self.extract(S), wr.accumulate_t(t, np.float32(self.dt),
                                                num_iters)
