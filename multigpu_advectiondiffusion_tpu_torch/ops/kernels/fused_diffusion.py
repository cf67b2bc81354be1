"""Fused SSP-RK3 diffusion stepping on a persistent padded state
(JAX ``ops/pallas/fused_diffusion.py`` counterpart).

Each RK stage is ONE kernel launch at minimum device-memory traffic:
read the stage input ``v`` (and the step input ``u``), write the
interior — 8 B/cell for stage 1, 12 B/cell for stages 2 and 3.

* The state lives padded, ``(nz+4, ny+4, nx+4)`` float32, for the
  whole run. The 2-deep ghost ring is set to the wall value once and
  never rewritten: with reference-parity walls the RHS is zero on the
  2-cell boundary band (``Laplace3d.m:21``), so band cells and ghosts
  stay constant. (The TPU layout's (8, 128) tile rounding and dead
  z-rows have no purpose on a GPU and are gone.)
* Three buffers per step, no allocation: ``T1 = s1(S)``,
  ``T2 = s2(T1, S)``, ``S = s3(T2, S)`` in place — see the aliasing
  note in ``csrc/fused_diffusion_stage.cu``.
* :func:`fused_stage` launches the CUDA kernel for a CUDA tensor and
  raises if it cannot; for a CPU tensor — and only then — it runs
  :func:`stage_reference`, the plain PyTorch twin with the kernel's
  layout, term order and roundings.
* :func:`fused_stage_bf16` is K1's instance on bfloat16 buffers (the
  JAX kernel's ``compute_dtype`` upcast, ``fused_diffusion.py:205-212``):
  it loads bf16, computes the float32 stage of :func:`fused_stage` and
  rounds the written cells to bf16 once, after the stage
  (``:269``); its twin is :func:`upcast_twin` of :func:`stage_reference`.
* A stepper's buffers may differ from the state it faces
  (:class:`PaddedDiffusionState`, ``storage_dtype``): float64 states on
  the float32 kernels and float32 states on the bf16 instance, cast at
  ``embed`` and ``extract`` as the JAX steppers cast them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.stepper_base import (
    FusedStepperBase,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import wait_exchange

R = 2  # stencil radius of the O4 second derivative
O4_COEFFS = (-1.0, 16.0, -30.0, 16.0, -1.0)  # / (12 dx^2), Laplace3d.m:22-25

# SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
# (Compute_RK, MultiGPU/Diffusion3d_Baseline/Kernels.cu:266-300)
STAGES = ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))

SOURCE = "fused_diffusion_stage.cu"
# z planes one thread marches; more chunks = more threads. 8 was the
# fastest of 4, 8, 16, 32 on the reference grid (chip_smoke.py's sweep).
Z_CHUNK = 8


def stage_taps(spacing: Sequence[float], diffusivity: Sequence[float]):
    """The tap coefficients ``c_j * K_axis / (12 dx_axis^2)``, five an
    axis in array order (z, y, x in 3-D), each rounded once to float32
    (as the TPU kernels fold K into each coefficient)."""
    taps = []
    for axis in range(len(spacing)):
        scale = float(diffusivity[axis]) / (
            12.0 * spacing[axis] * spacing[axis]
        )
        taps += [float(np.float32(c * scale)) for c in O4_COEFFS]
    return tuple(taps)


def _interior(t: torch.Tensor):
    return t[tuple(slice(R, s - R) for s in t.shape)]


def stage_reference(v, u, out, dt, *, taps, a, b, band, bc_value,
                    global_shape=None, offsets=None, window=None, lo=None,
                    hi=None):
    """Plain PyTorch twin of the stage kernel, on the same padded layout
    and in any dimension (the 2-D whole-run kernel K7 runs this stage
    with one axis fewer).

    Writes the interior of ``out`` (which may be ``u``) and returns it.
    Term order and roundings are the kernel's: taps axis by axis in
    array order, each product rounded, then ``b*(v + dt*acc)`` and
    ``a*u + ...``. A shard passes ``global_shape`` and its ``offsets``
    (global wall masks); ``window = (k_begin, k_end)`` writes only those
    interior planes of the leading axis, and ``lo``/``hi`` replace the
    ``R`` ghost planes below/above it (the split schedule's roles).
    """
    n = tuple(s - 2 * R for s in v.shape)
    ndim = len(n)
    k0, k1 = window if window is not None else (0, n[0])
    if lo is not None or hi is not None:
        v = v.clone()
        if lo is not None:
            v[:R] = lo
        if hi is not None:
            v[n[0] + R:] = hi
    # the planes that feed the window: its rows and R ghosts a side
    v = v[k0:k1 + 2 * R]
    n = (k1 - k0,) + n[1:]
    acc = None
    for axis in range(ndim):
        for j in range(5):
            idx = [slice(R, R + m) for m in n]
            idx[axis] = slice(j, j + n[axis])
            term = v[tuple(idx)] * taps[5 * axis + j]
            acc = term if acc is None else acc + term
    vc = _interior(v)
    dt = float(np.float32(dt))
    rk = b * (vc + dt * acc)
    if u is not None:
        rk = a * _interior(u[k0:k1 + 2 * R]) + rk
    offsets = list(offsets) if offsets is not None else [0] * ndim
    offsets[0] += k0
    write_walled(out[k0:k1 + 2 * R], rk, vc, band, bc_value,
                 global_shape=global_shape, offsets=offsets)
    return out


def bf16_value(x: float) -> float:
    """``x`` rounded to bfloat16 (to nearest even), as a float: the wall
    value a bf16 buffer's ghost ring holds."""
    return float(torch.tensor(float(x), dtype=torch.bfloat16).float())


def upcast_twin(reference, v, u, out, *args, **kwargs):
    """A bf16-buffer kernel's plain twin: ``reference`` (a float32 stage
    or step twin writing ``out``) on the buffers' float32 values, its
    output rounded to bf16 once (round to nearest even, as the kernels'
    ``__float2bfloat16_rn``); cells ``reference`` leaves alone keep their
    bits. ``u`` may be ``out`` (read before the write) or ``None``."""
    f = out.float()
    reference(v.float(), None if u is None else u.float(), f, *args,
              **kwargs)
    out.copy_(f)
    return out


def write_walled(out, rk, vc, band, bc_value, global_shape=None,
                 offsets=None):
    """The stage kernels' epilogue: ``out``'s interior becomes ``rk`` on
    cells ``>= band`` from every global face, ``bc_value`` on the global
    faces, and ``vc`` (the stage input) on the rest of the band; a shard
    passes the global interior shape and the global index of its first
    interior cell (``offsets``)."""
    n = tuple(vc.shape)
    global_shape = tuple(global_shape) if global_shape else n
    offsets = offsets if offsets is not None else [0] * len(n)
    interior = face = None
    for axis, m in enumerate(n):
        g = (torch.arange(m, device=vc.device) + offsets[axis]).reshape(
            [m if ax == axis else 1 for ax in range(len(n))])
        G = global_shape[axis]
        inside = (g >= band) & (g < G - band)
        on_face = (g == 0) | (g == G - 1)
        interior = inside if interior is None else interior & inside
        face = on_face if face is None else face | on_face
    wall = torch.full((), bc_value, dtype=vc.dtype, device=vc.device)
    _interior(out).copy_(
        torch.where(interior, rk, torch.where(face, wall, vc))
    )
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built stage kernel (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE).path))
    fn = lib.fused_diffusion_stage
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, i, i, i, p, f, f, f, i, f, i, p, p, i, i, p, p,
                   p]
    fn.restype = ctypes.c_int
    fn = lib.fused_diffusion_stage_bf16
    fn.argtypes = lib.fused_diffusion_stage.argtypes
    fn.restype = ctypes.c_int
    return lib


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {str(dtype).replace('torch.', '')} "
                        f"only, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} on {device}, "
            f"got {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stage_args(v, u, out, lo, hi, window, dtype):
    """Check a stage launch's buffers (``dtype``) and return its window
    ``(k0, k1)`` of interior planes."""
    for name, t in (("v", v), ("u", u), ("out", out)):
        if t is not None:
            _check(name, t, v.shape, v.device, dtype)
    if v.dim() != 3 or min(v.shape) <= 2 * R:
        raise ValueError(f"padded 3-D state expected, got {tuple(v.shape)}")
    if v.data_ptr() == out.data_ptr():
        raise ValueError("v and out must be different buffers")
    nz = v.shape[0] - 2 * R
    k0, k1 = window if window is not None else (0, nz)
    if not 0 <= k0 < k1 <= nz:
        raise ValueError(f"window {window} outside the {nz} interior planes")
    for name, t in (("lo", lo), ("hi", hi)):
        if t is not None:
            _check(name, t, (R,) + tuple(v.shape[1:]), v.device, dtype)
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stage kernel for device {v.device}")
    return k0, k1


def _launch_stage(symbol, v, u, out, dt, a, b, taps, band, bc_value,
                  zchunk, global_shape, offsets, window, lo, hi) -> None:
    """Launch ``symbol`` (K1's float32 or bf16 entry) on the current
    stream, raising on a CUDA error."""
    nz, ny, nx = (s - 2 * R for s in v.shape)
    host_taps = np.asarray(taps, dtype=np.float32)
    geo = np.asarray(global_shape or (nz, ny, nx), dtype=np.int32)
    offs = np.asarray(offsets or (0, 0, 0), dtype=np.int32)
    with torch.cuda.device(v.device):
        rc = getattr(library(), symbol)(
            v.data_ptr(), None if u is None else u.data_ptr(),
            out.data_ptr(), nz, ny, nx, host_taps.ctypes.data,
            float(np.float32(dt)), float(a), float(b), int(band),
            float(bc_value), int(zchunk), geo.ctypes.data, offs.ctypes.data,
            int(window[0]), int(window[1]),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(),
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def fused_stage(v, u, out, dt, *, taps, a, b, band, bc_value,
                zchunk=Z_CHUNK, global_shape=None, offsets=None,
                window=None, lo=None, hi=None):
    """One fused RK stage: ``out <- stage(v, u)`` on padded buffers.

    ``u`` is ``None`` for the first stage (a == 0) and may be ``out``
    (in-place final stage); ``v`` must not be ``out``. ``dt`` is
    rounded to float32 and passed by value, so a trimmed last step
    needs no rebuild. A shard of a mesh passes the ``global_shape`` of
    the interior and its ``offsets``; ``window = (k_begin, k_end)``
    writes those interior z planes only, and ``lo``/``hi``
    (``(R, ny+4, nx+4)``) replace the z-ghost planes below/above (the
    split schedule's edge calls). Launches the CUDA kernel on the current
    stream (no synchronisation), each thread marching ``zchunk`` z
    planes, and counts the launch in ``fused_stage.launches``; a CPU
    tensor runs :func:`stage_reference`.
    """
    window = _stage_args(v, u, out, lo, hi, window, torch.float32)
    kw = dict(taps=taps, a=a, b=b, band=band, bc_value=bc_value,
              global_shape=global_shape, offsets=offsets, window=window,
              lo=lo, hi=hi)
    if v.device.type == "cpu":
        return stage_reference(v, u, out, dt, **kw)
    _launch_stage("fused_diffusion_stage", v, u, out, dt, zchunk=zchunk,
                  **kw)
    build.count_launch(fused_stage)
    return out


fused_stage.launches = 0


def fused_stage_bf16(v, u, out, dt, *, taps, a, b, band, bc_value,
                     zchunk=Z_CHUNK, global_shape=None, offsets=None,
                     window=None, lo=None, hi=None):
    """:func:`fused_stage` on bfloat16 buffers (K1's bf16 instances, the
    sharded geometry, window and bf16 ``lo``/``hi`` operands as there):
    the stage's float32 arithmetic on the loaded bf16 values, every
    written cell rounded to bf16 once (the ghost ring, whose bf16 wall
    value the kernel reads, is never written). Launches the kernel on the
    current stream, counted in ``fused_stage_bf16.launches``; a CPU
    tensor runs :func:`upcast_twin` of :func:`stage_reference`."""
    window = _stage_args(v, u, out, lo, hi, window, torch.bfloat16)
    kw = dict(taps=taps, a=a, b=b, band=band, bc_value=bc_value,
              global_shape=global_shape, offsets=offsets, window=window)
    if v.device.type == "cpu":
        return upcast_twin(stage_reference, v, u, out, dt,
                           lo=None if lo is None else lo.float(),
                           hi=None if hi is None else hi.float(), **kw)
    _launch_stage("fused_diffusion_stage_bf16", v, u, out, dt,
                  zchunk=zchunk, lo=lo, hi=hi, **kw)
    build.count_launch(fused_stage_bf16)
    return out


fused_stage_bf16.launches = 0


class PaddedDiffusionState:
    """The padded layout every diffusion stepper keeps (K1, K10, K2 and,
    in 2-D, K7): the interior at offset ``R`` on every axis and an
    ``R``-deep ghost ring at the Dirichlet wall value, and what one
    (grid, dt) configuration's kernels take: the taps, ``dt``, the band
    and the wall value.

    ``dtype`` is the buffers' (float32, or bfloat16 for the bf16
    instances) and ``storage_dtype`` the state's the stepper faces
    (default ``dtype``): ``embed`` casts the state to the buffers,
    ``extract`` back (JAX ``fused_diffusion.py:545-552``), so a float64
    state runs the float32 kernels and a float32 state the bf16 ones."""

    def __init__(self, interior_shape, spacing, diffusivity, dt, band,
                 bc_value, device, dtype=torch.float32, storage_dtype=None):
        self.interior_shape = tuple(interior_shape)
        self.padded_shape = tuple(n + 2 * R for n in interior_shape)
        self.dtype = dtype
        self.storage_dtype = storage_dtype or dtype
        self.device = torch.device(device)
        self.taps = stage_taps(spacing, diffusivity)
        self.dt = float(dt)
        self.band = int(band)
        self.bc_value = float(bc_value)

    def embed(self, u):
        S = torch.full(self.padded_shape, self.bc_value, dtype=self.dtype,
                       device=self.device)
        _interior(S).copy_(u)
        return S

    def extract(self, S):
        return _interior(S).contiguous().to(self.storage_dtype)


class FusedDiffusionStepper(PaddedDiffusionState, FusedStepperBase):
    """Fused runner for one (grid, dt) configuration on one device, or on
    one shard of a mesh.

    ``global_shape`` (when it differs from ``interior_shape``) makes the
    stepper shard-local, as the JAX stepper's: ``interior_shape`` is this
    shard's block, the kernel's wall masks are global (``offsets``), and
    ``run`` takes the ghost ``refresh`` run after every stage. With
    ``overlap_split`` (and at least three z chunks of ``Z_CHUNK`` >= R
    planes) a stage is the split schedule's three launches: the interior
    planes ``[Z_CHUNK, lz - Z_CHUNK)`` while the z slabs are exchanged,
    then the bottom and top ``Z_CHUNK`` planes from the exchanged slabs
    (``exch``); other sharded axes of a pencil keep the refresh.

    ``dtype=torch.bfloat16`` runs K1's bf16 instances
    (:func:`fused_stage_bf16`), on a shard too, where the refresh and the
    split schedule's slabs move the buffers' bf16 values; ``storage_dtype``
    is the state it faces (:class:`PaddedDiffusionState`)."""

    halo = R
    needs_offsets = True

    def __init__(self, interior_shape, spacing, diffusivity, dt, band,
                 bc_value, device, global_shape=None,
                 overlap_split: bool = False, dtype=torch.float32,
                 storage_dtype=None):
        super().__init__(interior_shape, spacing, diffusivity, dt, band,
                         bc_value, device, dtype, storage_dtype)
        self.global_shape = tuple(global_shape or interior_shape)
        self.sharded = self.global_shape != self.interior_shape
        self.stage = (fused_stage_bf16 if dtype == torch.bfloat16
                      else fused_stage)
        self.core_offsets = (R,) * len(self.interior_shape)
        self.exchange_depth = R
        lz = self.interior_shape[0]
        self.overlap_split = bool(overlap_split and self.sharded
                                  and lz // Z_CHUNK >= 3 and Z_CHUNK >= R)

    def _dt_value(self):
        return np.float32(self.dt)

    def _step(self, S, T1, T2, dt, refresh=None, offsets=None, exch=None):
        kw = dict(taps=self.taps, band=self.band, bc_value=self.bc_value)
        if self.sharded:
            kw.update(global_shape=self.global_shape, offsets=offsets)
        (a1, b1), (a2, b2), (a3, b3) = STAGES
        stages = ((S, None, T1, a1, b1),  # u1 = u + dt L(u)
                  (T1, S, T2, a2, b2),    # 3/4 u + 1/4 (u1 + dt L(u1))
                  (T2, S, S, a3, b3))     # 1/3 u + 2/3 (...), in place
        for v, u, out, a, b in stages:
            if self.overlap_split:
                self._split_stage(v, u, out, dt, a, b, exch, kw)
            else:
                self.stage(v, u, out, dt, a=a, b=b, **kw)
            if refresh is not None:
                refresh(out)
        return S, T1, T2

    def _split_stage(self, v, u, out, dt, a, b, exch, kw):
        """One stage as the split schedule's three launches: the interior
        planes while ``v``'s z slabs are exchanged on the exchange
        stream, then the bottom and top planes from those slabs."""
        lz, bz = self.interior_shape[0], Z_CHUNK
        lo, hi = exch(v)
        self.stage(v, u, out, dt, a=a, b=b, window=(bz, lz - bz), **kw)
        wait_exchange(lo, hi)
        self.stage(v, u, out, dt, a=a, b=b, window=(0, bz), lo=lo, **kw)
        self.stage(v, u, out, dt, a=a, b=b, window=(lz - bz, lz), hi=hi,
                   **kw)
