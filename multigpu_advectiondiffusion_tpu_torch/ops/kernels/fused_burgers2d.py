"""Whole-run SSP-RK3 stepping for 2-D Burgers/WENO5: one kernel launch
per run (JAX ``ops/pallas/fused_burgers2d.py`` counterpart; kernels K7,
Burgers body, and K7a, adaptive dt, both ``csrc/whole_run_burgers2d.cu``).

A reference-scale 2-D grid (400×406, ``MultiGPU/Burgers2d_Baseline``)
is under 1 MB in float32: the state is read from device memory once,
every WENO sweep of every stage of every step runs in one cooperative
launch (:mod:`whole_run`), and the result is written once.

* The state is kept **unpadded**, ``(ny, nx)`` float32, as K5 keeps it:
  edge boundaries are replicated ghosts, so the kernel clamps every
  neighbour index into the grid and the TPU body's ghost re-synthesis
  after each stage (``fused_burgers2d.py:60-67``) has nothing to do.
* dt modes, as in the JAX stepper: fixed (CUDA parity,
  ``main.c:193``) or adaptive — ``dt = f32(cfl min dx) / max(max|f'(u)|,
  1e-12)`` from the state at the start of every step, taken inside the
  kernel (K7a), and the float32 sum of the steps' dt read back once.
* The plain stage is K5's twin (:func:`fused_burgers.stage_reference`),
  which is dimension-generic: its Lax–Friedrichs split
  (``fused_burgers._split``), e-form WENO5 (``ops/weno._weno5_side_nd_e``)
  and O4 taps, two axes instead of three. K7 is built with
  ``-fmad=false``, as K5 is, so kernel and twin round alike.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_burgers import (
    FLUX_CODES,
    NVCC_EXTRA,
    R,
    StageParams,
    stage_params,
    stage_reference as _stage_nd,
)
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import (
    advective_dt,
)

SOURCE = "whole_run_burgers2d.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _F, _F, _P, _P, _I, _I,
             _P, _P)


def library():
    """The built K7/K7a Burgers kernel (compiled at first use)."""
    return wr.library(SOURCE, "whole_run_burgers2d", _ARGTYPES, NVCC_EXTRA)


def stage_reference(v, u, out, dt, *, params: StageParams, a: float,
                    b: float):
    """The plain K7 Burgers stage on an unpadded ``(ny, nx)`` state:
    ``out <- a*u + b*(v + dt*rhs)``, ``rhs = -(div_y + div_x) [+ lap]`` —
    K5's twin in two dimensions (``fused_burgers2d.py:79-94``)."""
    if v.dim() != 2:
        raise ValueError(f"2-D state expected, got {tuple(v.shape)}")
    return _stage_nd(v, u, out, dt, params=params, a=a, b=b)


def whole_run_burgers2d(S, T1, T2, num_iters: int, *, params: StageParams,
                        dt=None, spacing=None, cfl=None,
                        sync_floor: bool = False,
                        grid_blocks: list | None = None):
    """``num_iters`` SSP-RK3 steps on the ``(ny, nx)`` state ``S`` in
    place, ``T1``/``T2`` scratch. Exactly one of ``dt`` (fixed, rounded
    to float32; returns ``S``) and ``spacing`` with ``cfl`` (adaptive;
    returns ``(S, t_sum)``) is given. A CUDA tensor launches the kernel
    once (counted in ``whole_run.whole_run.launches`` or
    ``whole_run.whole_run_adaptive.launches``); with ``sync_floor`` the
    same grid runs only its barriers. ``grid_blocks``, a list, receives
    the grid's block count."""
    adaptive = dt is None
    if adaptive == (spacing is None or cfl is None):
        raise ValueError("give exactly one of dt and (spacing, cfl)")
    if S.dim() != 2:
        raise ValueError(f"2-D state expected, got {tuple(S.shape)}")
    if len(params.inv_dx) != 2:
        raise ValueError("2-D stage parameters expected")
    ny, nx = S.shape
    inv_dx = np.asarray(params.inv_dx, dtype=np.float32)
    taps = (None if params.lap_taps is None
            else np.asarray(params.lap_taps, dtype=np.float32))
    c = params.flux.c if params.flux.c is not None else 0.0
    dt32 = 0.0 if adaptive else float(np.float32(dt))
    cfl_dx = float(np.float32(cfl * min(spacing))) if adaptive else 0.0
    blocks = ctypes.c_int(0)

    def kernel(S, T1, T2, n, mx=None, t_sum=None):
        rc = library().whole_run_burgers2d(
            S.data_ptr(), T1.data_ptr(), T2.data_ptr(), ny, nx,
            FLUX_CODES[params.flux.name], float(c),
            int(params.variant == "z"), inv_dx.ctypes.data,
            None if taps is None else taps.ctypes.data, dt32, cfl_dx,
            None if mx is None else mx.data_ptr(),
            None if t_sum is None else t_sum.data_ptr(), n,
            int(not sync_floor), ctypes.byref(blocks), wr.stream_of(S))
        if grid_blocks is not None:
            grid_blocks.append(blocks.value)
        return rc

    def stage(v, u, out, dt_, a, b):
        return stage_reference(v, u, out, dt_, params=params, a=a, b=b)

    if not adaptive:
        return wr.whole_run(kernel, stage, S, T1, T2, num_iters, dt32)
    flux = params.flux
    return wr.whole_run_adaptive(
        kernel, stage, lambda u: advective_dt(u, flux.df, spacing, cfl),
        S, T1, T2, num_iters)


class FusedBurgers2DStepper:
    """Whole-run WENO5 stepper for one (grid, flux, dt mode) configuration
    on one device. Exactly one of ``dt`` (fixed, CUDA parity) and
    ``cfl`` (adaptive) is given, as the JAX stepper takes exactly one of
    ``dt`` and ``dt_fn`` (``fused_burgers2d.py:126-127``). It has no
    ``run_to``: ``advance_to`` runs the generic loop."""

    engaged_label = "fused-whole-run"

    def __init__(self, interior_shape, spacing, flux: Flux, variant: str,
                 nu: float, device, dt: float | None = None,
                 cfl: float | None = None):
        if (dt is None) == (cfl is None):
            raise ValueError("provide exactly one of dt/cfl")
        self.interior_shape = tuple(interior_shape)
        self.dtype = torch.float32
        self.device = torch.device(device)
        self.params = stage_params(flux, variant, spacing, nu)
        self.spacing = tuple(spacing)
        self.dt = None if dt is None else float(dt)
        self.cfl = None if cfl is None else float(cfl)

    def stencil_spec(self) -> dict:
        """Stencil metadata, the JAX stepper's keys: whole-run residency
        with an ``r``-deep edge pad (clamped indices here), no
        exchange."""
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
        """Float32, and the three buffers fit the L2 gate
        (:func:`whole_run.fits_l2`)."""
        return dtype == torch.float32 and wr.fits_l2(interior_shape)

    def embed(self, u):
        return u.to(device=self.device, dtype=self.dtype,
                    copy=True).contiguous()

    def extract(self, S):
        return S

    def run(self, u, t, num_iters: int):
        """``num_iters`` steps in one launch; returns ``(u, t)``. Fixed
        dt advances ``t`` on the host; adaptive reads the float32 sum of
        the steps' dt back once and adds it in ``t``'s precision
        (``fused_burgers2d.py:201-204``)."""
        if num_iters == 0:
            return u, t
        S = self.embed(u)
        T1, T2 = torch.empty_like(S), torch.empty_like(S)
        if self.dt is not None:
            whole_run_burgers2d(S, T1, T2, num_iters, params=self.params,
                                dt=self.dt)
            return S, wr.accumulate_t(t, np.float32(self.dt), num_iters)
        S, t_sum = whole_run_burgers2d(S, T1, T2, num_iters,
                                       params=self.params,
                                       spacing=self.spacing, cfl=self.cfl)
        tdt = type(t)
        return S, t + tdt(t_sum.item())  # the one read-back of the run
