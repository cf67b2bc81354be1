"""Per-stage fused SSP-RK3 stepping of sharded 2-D grids (JAX
``ops/pallas/fused2d_sharded.py`` counterpart; kernels K8 and K8b,
``csrc/fused2d_sharded.cu``).

The reference runs its 2-D kernels under MPI (``MultiGPU/
Diffusion2d_Baseline/main.c:189-280``, ``MultiGPU/Burgers2d_Baseline/
main.c:186+``). One device runs them as one whole-run launch (K7,
:mod:`whole_run`), whose steps cross the points where a shard's ghosts
must refresh, so under a mesh each RK stage is one launch over the
shard and the caller refreshes the ghosts between stages, as on the TPU:

* the state lives padded by the stencil reach ``h`` on both axes,
  ``(ly + 2h, lx + 2h)`` float32 (``h`` = 2 for the O4 heat equation, 3
  for WENO5, 4 for WENO7-JS, ``HALO[order]``); the ghost rows and
  columns of a sharded axis hold
  neighbour data (``parallel/halo.py``), the rest the wall value
  (diffusion) or edge replicas (Burgers, never read: a neighbour outside
  the global domain is the nearest global edge cell, as K7 clamps);
* global walls and edges are decided from the shard's ``offsets``
  against the global shape, as the TPU kernels decide them from their
  SMEM offsets operand;
* :func:`fused2d_stage` (K8) writes one stage over the whole shard,
  :func:`fused2d_band_stage` (K8b) over one band of the split schedule:
  the interior rows ``[h, ly - h)``, which read no ghost row, while the
  ghost slabs travel, then the bottom ``[0, h)`` and top ``[ly - h, ly)``
  rows from the exchanged slabs ``lo``/``hi`` (the JAX band calls' 3h-row
  inputs with the slabs concatenated on; the kernel reads the operands in
  place of the buffer's ghost rows, so nothing is concatenated);
* each stage's arithmetic is K7's, rounded alike (diffusion with
  ``__fmul_rn``/``__fadd_rn``; Burgers built with ``-fmad=false``), so a
  sharded run equals K7's unsharded run to the bit. The plain twins,
  :func:`diffusion_stage_reference` and :func:`burgers_stage_reference`,
  are the JAX bodies ``_diffusion_stage`` (:143) and ``_burgers_stage``
  (:121) with ``_edge_fill_global`` (:102) and ``_global_coords`` (:95)
  in the port's layout and operation order (K1's and K5's twins).

A CUDA tensor launches the kernel or raises; a CPU tensor, and only a
CPU tensor, runs the twin. The JAX steppers' VMEM ``supported()`` gates
have no counterpart: a one-thread-a-cell stage needs no shard to fit a
fast memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as fb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.stepper_base import (
    FusedStepperBase,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import wait_exchange
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import (
    dt_from_wave_speed,
    max_wave_speed,
)

SOURCE = "fused2d_sharded.cu"
NVCC_EXTRA = fb.NVCC_EXTRA  # K7's flags: the Burgers body rounds as K7's
H_DIFFUSION = fd.R  # the O4 reach; Burgers' is the WENO reach, params.r


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    """What one diffusion configuration's stages share: the ten O4 taps
    ``c_j K/(12 dx^2)`` (y then x, :func:`fused_diffusion.stage_taps`),
    the frozen boundary band and the Dirichlet wall value."""

    taps: tuple
    band: int
    bc_value: float


def halo_of(params) -> int:
    """The ghost depth of a configuration's padded layout: the O4 reach,
    or the WENO reach of the order (3 or 4)."""
    return H_DIFFUSION if isinstance(params, DiffusionParams) else params.r


def split_bands(ly: int, h: int):
    """The split schedule's three K8b calls on a shard of ``ly`` rows, in
    launch order: ``(rows, operand)`` of the interior band (no ghost row
    read), the bottom band (reads ``lo``) and the top band (reads
    ``hi``); JAX's three band calls (``fused2d_sharded.py:296-306``).
    The schedule needs ``ly >= 3h`` (``:400-402``)."""
    if ly < 3 * h:
        raise ValueError(
            f"the split schedule's bands need a shard of >= {3 * h} rows, "
            f"got {ly}")
    return (((h, ly - h), None), ((0, h), "lo"), ((ly - h, ly), "hi"))


# --------------------------------------------------------------------- #
# The plain PyTorch twins
# --------------------------------------------------------------------- #
def diffusion_stage_reference(v, u, out, dt, offsets, *,
                              params: DiffusionParams, a: float, b: float,
                              global_shape, window=None, lo=None, hi=None):
    """The plain K8/K8b diffusion stage on a shard padded by 2: ``out``'s
    interior rows ``window`` (all by default) ``<- where(interior,
    a*u + b*(v + dt*acc), where(face, bc_value, v))`` on global masks —
    JAX's ``_diffusion_stage`` (``fused2d_sharded.py:143-167``), which is
    K1's twin in two dimensions (:func:`fused_diffusion.stage_reference`,
    the taps y then x, each product rounded). ``lo``/``hi`` replace the
    ghost rows below/above (the split schedule's operands)."""
    if v.dim() != 2:
        raise ValueError(f"padded 2-D shard expected, got {tuple(v.shape)}")
    return fd.stage_reference(
        v, u, out, dt, taps=params.taps, a=a, b=b, band=params.band,
        bc_value=params.bc_value, global_shape=tuple(global_shape),
        offsets=list(offsets), window=window, lo=lo, hi=hi)


def burgers_stage_reference(v, u, out, dt, offsets, *,
                            params: fb.StageParams, a: float, b: float,
                            global_shape, window=None, lo=None, hi=None,
                            emit: bool = False):
    """The plain K8/K8b Burgers stage on a shard padded by the reach
    ``r = params.r`` (3 at WENO5, 4 at WENO7):
    ``out``'s interior rows ``window`` (all by default) ``<- a*u + b*(v +
    dt*rhs)``, ``rhs = -(div_y + div_x) [+ lap]`` — JAX's
    ``_burgers_stage`` (``fused2d_sharded.py:121-140``) in K5's twin's
    operation order. A neighbour outside the global domain is the
    nearest global edge cell (``_edge_fill_global``'s replicas); one in
    another shard comes from the ghost rows and columns, or from
    ``lo``/``hi`` in place of the ghost rows below/above. With ``emit``
    also returns ``max|f'(out)|`` over the rows written."""
    if v.dim() != 2:
        raise ValueError(f"padded 2-D shard expected, got {tuple(v.shape)}")
    h = params.r
    ly, lx = (n - 2 * h for n in v.shape)
    r0, r1 = window if window is not None else (0, ly)
    (oy, ox), (gy, gx) = offsets, global_shape
    if lo is not None or hi is not None:
        v = v.clone()
        if lo is not None:
            v[:h] = lo
        if hi is not None:
            v[ly + h:] = hi
    dev = v.device
    rows = (torch.arange(r0 - h, r1 + h, device=dev) + oy).clamp_(
        0, gy - 1) - oy + h
    cols = (torch.arange(-h, lx + h, device=dev) + ox).clamp_(
        0, gx - 1) - ox + h
    vp = v.index_select(0, rows).index_select(1, cols)
    uw = None if u is None else u[r0 + h:r1 + h, h:h + lx]
    rk = fb._stage_rk(vp, vp[h:-h, h:-h], uw, dt, params, a, b)
    dst = out[r0 + h:r1 + h, h:h + lx]
    dst.copy_(rk)
    if emit:
        return out, max_wave_speed(dst, params.flux.df)
    return out


def stage_reference(v, u, out, dt, offsets, *, params, a: float, b: float,
                    global_shape, window=None, lo=None, hi=None,
                    emit: bool = False):
    """The plain stage of either family (by ``params``' type)."""
    kw = dict(params=params, a=a, b=b, global_shape=global_shape,
              window=window, lo=lo, hi=hi)
    if isinstance(params, DiffusionParams):
        if emit:
            raise ValueError("the diffusion stage emits no wave speed")
        return diffusion_stage_reference(v, u, out, dt, offsets, **kw)
    return burgers_stage_reference(v, u, out, dt, offsets, emit=emit, **kw)


# --------------------------------------------------------------------- #
# The kernels
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built K8/K8b kernel (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE, NVCC_EXTRA).path))
    fn = lib.fused2d_sharded_stage
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, i, p, p, i, f, f, p, i, f, i, i, f, f,
                   p, i, p]
    fn.restype = ctypes.c_int
    return lib


def _launch(counter, v, u, out, dt, offsets, *, params, a, b,
            global_shape, rows, lo, hi, mx, mx_init):
    """Check the operands, then run the twin (a CPU tensor) or launch the
    kernel on the current stream and count it in ``counter.launches``."""
    h = halo_of(params)
    if v.dim() != 2 or min(v.shape) <= 2 * h:
        raise ValueError(
            f"a 2-D shard padded by {h} expected, got {tuple(v.shape)}")
    for name, t in (("v", v), ("u", u), ("out", out)):
        if t is not None:
            fd._check(name, t, v.shape, v.device)
    if v.data_ptr() == out.data_ptr():
        raise ValueError("v and out must be different buffers")
    ly, lx = (n - 2 * h for n in v.shape)
    oy, ox = (int(o) for o in offsets)
    gy, gx = (int(n) for n in global_shape)
    if not (0 <= oy <= gy - ly and 0 <= ox <= gx - lx):
        raise ValueError(f"a {ly}x{lx} shard at offsets {(oy, ox)} does not "
                         f"fit the global {gy}x{gx}")
    for name, t in (("lo", lo), ("hi", hi)):
        if t is not None:
            fd._check(name, t, (h, lx + 2 * h), v.device)
    diffusion = isinstance(params, DiffusionParams)
    if diffusion and mx is not None:
        raise ValueError("the diffusion stage emits no wave speed")
    kw = dict(params=params, a=a, b=b, global_shape=(gy, gx), window=rows,
              lo=lo, hi=hi)
    if v.device.type == "cpu":
        res = stage_reference(v, u, out, dt, (oy, ox), emit=mx is not None,
                              **kw)
        if mx is None:
            return res
        m = res[1].reshape(mx.shape)
        mx.copy_(m if mx_init else torch.maximum(mx, m))
        return out
    if v.device.type != "cuda":
        raise ValueError(f"no 2-D sharded stage kernel for device {v.device}")
    geo = np.asarray((ly, lx, gy, gx, oy, ox, *rows), dtype=np.int32)
    if diffusion:
        if isinstance(dt, torch.Tensor):
            raise TypeError("the diffusion stage takes dt by value")
        coeffs = np.asarray(params.taps, dtype=np.float32)
        lap, kind, dt_val, dt_ptr = None, 0, float(np.float32(dt)), None
        flux, c, weno_z, order, mx_ptr = 0, 0.0, 0, 5, None
        band, bc_value = int(params.band), float(params.bc_value)
    else:
        for name, t in (("dt", dt), ("mx", mx)):
            if name == "mx" and t is None:
                continue
            if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                    or t.numel() != 1 or t.device != v.device):
                raise TypeError(f"{name}: a float32 tensor of one element "
                                f"on {v.device} expected")
        coeffs = np.asarray(params.inv_dx, dtype=np.float32)
        lap = (None if params.lap_taps is None
               else np.asarray(params.lap_taps, dtype=np.float32))
        kind, dt_val, dt_ptr = 1, 0.0, dt.data_ptr()
        flux = fb.FLUX_CODES[params.flux.name]
        c = float(params.flux.c if params.flux.c is not None else 0.0)
        weno_z = int(params.variant == "z")
        order = int(params.order)
        mx_ptr = None if mx is None else mx.data_ptr()
        band, bc_value = 0, 0.0
    with torch.cuda.device(v.device):
        rc = library().fused2d_sharded_stage(
            v.data_ptr(), None if u is None else u.data_ptr(),
            out.data_ptr(), geo.ctypes.data,
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), kind, coeffs.ctypes.data,
            None if lap is None else lap.ctypes.data, band, bc_value, dt_val,
            dt_ptr, flux, c, weno_z, order, float(a), float(b), mx_ptr,
            int(mx_init), torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused2d_sharded_stage launch failed: CUDA error {rc}")
    build.count_launch(counter)
    return out


def fused2d_stage(v, u, out, dt, offsets, *, params, a: float, b: float,
                  global_shape, mx=None):
    """K8: one RK stage over a whole padded 2-D shard, ``out <- stage(v,
    u)``. ``params`` is :class:`DiffusionParams` (``dt`` a number) or
    :class:`fused_burgers.StageParams` (``dt`` a float32 tensor of one
    element on ``v``'s device; a float is accepted for a CPU tensor).
    ``offsets`` is the shard's global ``(oy, ox)`` and ``global_shape``
    the global interior. ``u`` is ``None`` for the first stage and may be
    ``out``; ``v`` must not be ``out``. ``mx`` (Burgers) receives
    ``max|f'(out)|``. Launches on the current stream (no
    synchronisation) and counts in ``fused2d_stage.launches``; a CPU
    tensor runs the twin."""
    h = halo_of(params)
    return _launch(fused2d_stage, v, u, out, dt, offsets, params=params,
                   a=a, b=b, global_shape=global_shape,
                   rows=(0, v.shape[0] - 2 * h), lo=None, hi=None, mx=mx,
                   mx_init=True)


fused2d_stage.launches = 0


def fused2d_band_stage(v, u, out, dt, offsets, *, params, a: float,
                       b: float, global_shape, rows, lo=None, hi=None,
                       mx=None, mx_init: bool = True):
    """K8b: :func:`fused2d_stage` over one band of the split schedule,
    writing the interior rows ``rows`` only: ``(h, ly - h)`` with no
    operand, ``(0, h)`` with ``lo`` or ``(ly - h, ly)`` with ``hi``
    (``(h, lx + 2h)`` each, standing in for the ghost rows below/above;
    :func:`split_bands`). Any other window raises, as the JAX kernel
    asserts its band contract (``fused2d_sharded.py:221``). ``mx`` folds
    into its value unless ``mx_init``. Counts in
    ``fused2d_band_stage.launches``."""
    h = halo_of(params)
    ly = v.shape[0] - 2 * h
    given = {(False, False): None, (True, False): "lo",
             (False, True): "hi", (True, True): "both"}[
                 (lo is not None, hi is not None)]
    if (tuple(rows), given) not in split_bands(ly, h):
        raise ValueError(
            f"rows {tuple(rows)} with operand {given} is not a band of the "
            f"split schedule on {ly} rows: {split_bands(ly, h)}")
    return _launch(fused2d_band_stage, v, u, out, dt, offsets,
                   params=params, a=a, b=b, global_shape=global_shape,
                   rows=tuple(rows), lo=lo, hi=hi, mx=mx, mx_init=mx_init)


fused2d_band_stage.launches = 0


# --------------------------------------------------------------------- #
# The steppers
# --------------------------------------------------------------------- #
class _Sharded2DStepper(FusedStepperBase):
    """Shared plumbing of the two 2-D sharded steppers (JAX
    ``_Sharded2DStepperBase``): the three-buffer step, each stage one K8
    launch followed by the ghost ``refresh``, or under the split schedule
    (a y-sharded shard of at least ``3h`` rows) the three K8b launches of
    :func:`split_bands` around the exchange of the y slabs (``exch``).
    ``run``/``run_to`` come from :class:`FusedStepperBase`; a shard's
    global ``offsets`` reach every launch (zeros unsharded)."""

    needs_offsets = True

    def __init__(self, interior_shape, halo: int, device, global_shape,
                 overlap_split: bool):
        self.interior_shape = tuple(interior_shape)
        self.global_shape = tuple(global_shape or interior_shape)
        self.sharded = self.global_shape != self.interior_shape
        self.halo = int(halo)
        self.core_offsets = (self.halo, self.halo)
        self.exchange_depth = self.halo
        self.padded_shape = tuple(n + 2 * self.halo for n in interior_shape)
        self.dtype = torch.float32
        self.device = torch.device(device)
        # the split needs a non-degenerate interior band (>= h rows)
        self.overlap_split = bool(overlap_split and self.sharded
                                  and self.interior_shape[0] >= 3 * halo)

    def extract(self, S):
        h = self.halo
        return S[h:S.shape[0] - h, h:S.shape[1] - h].contiguous()

    def _step(self, S, T1, T2, dt, m=None, refresh=None, offsets=None,
              exch=None):
        offs = tuple(offsets) if offsets is not None else (0, 0)
        kw = dict(params=self.params, global_shape=self.global_shape)
        (a1, b1), (a2, b2), (a3, b3) = fd.STAGES
        stages = ((S, None, T1, a1, b1, None),  # u1 = u + dt L(u)
                  (T1, S, T2, a2, b2, None),    # 3/4 u + 1/4 (...)
                  (T2, S, S, a3, b3, m))        # 1/3 u + 2/3 (...), in place
        for v, u, out, a, b, mx in stages:
            if self.overlap_split:
                self._split_stage(v, u, out, dt, offs, exch, mx, a=a, b=b,
                                  **kw)
            else:
                fused2d_stage(v, u, out, dt, offs, a=a, b=b, mx=mx, **kw)
            if refresh is not None:
                refresh(out)
        return S, T1, T2

    def _split_stage(self, v, u, out, dt, offs, exch, mx, **kw):
        """One stage as the split schedule's three K8b launches: the
        interior band while ``v``'s y slabs are exchanged on the exchange
        stream, then the bottom and top bands from those slabs; the
        emitted maximum folds the three."""
        lo, hi = exch(v)
        (mid, _), (bottom, _), (top, _) = split_bands(
            self.interior_shape[0], self.halo)
        fused2d_band_stage(v, u, out, dt, offs, rows=mid, mx=mx, **kw)
        wait_exchange(lo, hi)
        fused2d_band_stage(v, u, out, dt, offs, rows=bottom, lo=lo, mx=mx,
                           mx_init=False, **kw)
        fused2d_band_stage(v, u, out, dt, offs, rows=top, hi=hi, mx=mx,
                           mx_init=False, **kw)


class ShardedFusedDiffusion2DStepper(_Sharded2DStepper):
    """Per-stage fused 2-D O4 diffusion on one shard of a device mesh (JAX
    ``ShardedFusedDiffusion2DStepper``): K8 three times a step with the
    ghost refresh after each, reference-parity walls on the global faces
    (``MultiGPU/Diffusion2d_Baseline/main.c:189-280``); ``dt`` and ``t``
    host scalars."""

    def __init__(self, interior_shape, spacing, diffusivity, dt, band,
                 bc_value, device, global_shape=None,
                 overlap_split: bool = False):
        super().__init__(interior_shape, H_DIFFUSION, device, global_shape,
                         overlap_split)
        self.params = DiffusionParams(fd.stage_taps(spacing, diffusivity),
                                      int(band), float(bc_value))
        self.bc_value = float(bc_value)
        self.dt = float(dt)

    def embed(self, u):
        h = self.halo
        S = torch.full(self.padded_shape, self.bc_value, dtype=self.dtype,
                       device=self.device)
        S[h:-h, h:-h].copy_(u)
        return S

    def _dt_value(self):
        return np.float32(self.dt)


class ShardedFusedBurgers2DStepper(_Sharded2DStepper):
    """Per-stage fused 2-D Burgers (WENO5-JS/Z or WENO7-JS) on one shard
    of a device mesh (JAX ``ShardedFusedBurgers2DStepper``,
    ``MultiGPU/Burgers2d_Baseline/main.c:186+``): K8 three times a step,
    the shard padded by the order's reach ``HALO[order]`` (3 or 4), the
    split schedule's bands ``3h`` rows deep as JAX's.
    ``dt`` fixes the step (CUDA parity), else the CFL step
    ``float32(cfl min dx) / max(m, 1e-12)`` follows the wave speed ``m``
    that the last stage of each step emits, the max over the shards
    (``reduce_max``) kept on the card (the device-scalar mode of
    :class:`FusedStepperBase`), as K7a takes it from the whole state."""

    device_scalars = True

    def __init__(self, interior_shape, spacing, flux: Flux, variant: str,
                 nu: float, cfl: float, device, dt: float | None = None,
                 global_shape=None, overlap_split: bool = False,
                 reduce_max=None, order: int = 5):
        self.params = fb.stage_params(flux, variant, spacing, nu, order)
        self.order = int(order)
        super().__init__(interior_shape, self.params.r, device, global_shape,
                         overlap_split)
        self.spacing = tuple(spacing)
        self.cfl = float(cfl)
        self.adaptive = dt is None
        self.dt = None if dt is None else torch.full(
            (), dt, dtype=torch.float32, device=self.device)
        self.reduce_max = reduce_max

    def embed(self, u):
        # ghosts start as edge replicas; the refresh (or the exchanged
        # operands) replaces them where the domain goes on
        return fb._edge_pad(u.to(device=self.device, dtype=self.dtype),
                            self.halo).contiguous()

    def _initial_max(self, u):
        if not self.adaptive:
            return None
        return max_wave_speed(u.to(self.dtype), self.params.flux.df)

    def _dt_of(self, m):
        if not self.adaptive:
            return self.dt
        return dt_from_wave_speed(m, self.spacing, self.cfl,
                                  reduce_max=self.reduce_max)
