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


def stage_reference(v, u, out, dt, *, taps, a, b, band, bc_value):
    """Plain PyTorch twin of the stage kernel, on the same padded layout
    and in any dimension (the 2-D whole-run kernel K7 runs this stage
    with one axis fewer).

    Writes the interior of ``out`` (which may be ``u``) and returns it.
    Term order and roundings are the kernel's: taps axis by axis in
    array order, each product rounded, then ``b*(v + dt*acc)`` and
    ``a*u + ...``.
    """
    n = tuple(s - 2 * R for s in v.shape)
    ndim = len(n)
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
        rk = a * _interior(u) + rk
    return write_walled(out, rk, vc, band, bc_value)


def write_walled(out, rk, vc, band, bc_value):
    """The stage kernels' epilogue: ``out``'s interior becomes ``rk`` on
    cells ``>= band`` from every face, ``bc_value`` on the faces, and
    ``vc`` (the stage input) on the rest of the band."""
    n = tuple(vc.shape)
    interior = face = None
    for axis, m in enumerate(n):
        g = torch.arange(m, device=vc.device).reshape(
            [m if ax == axis else 1 for ax in range(len(n))])
        inside = (g >= band) & (g < m - band)
        on_face = (g == 0) | (g == m - 1)
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
    fn.argtypes = [p, p, p, i, i, i, p, f, f, f, i, f, i, p]
    fn.restype = ctypes.c_int
    return lib


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} on {device}, "
            f"got {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def fused_stage(v, u, out, dt, *, taps, a, b, band, bc_value,
                zchunk=Z_CHUNK):
    """One fused RK stage: ``out <- stage(v, u)`` on padded buffers.

    ``u`` is ``None`` for the first stage (a == 0) and may be ``out``
    (in-place final stage); ``v`` must not be ``out``. ``dt`` is
    rounded to float32 and passed by value, so a trimmed last step
    needs no rebuild. Launches the CUDA kernel on the current stream
    (no synchronisation), each thread marching ``zchunk`` z planes, and
    counts the launch in ``fused_stage.launches``; a CPU tensor runs
    :func:`stage_reference`.
    """
    for name, t in (("v", v), ("u", u), ("out", out)):
        if t is not None:
            _check(name, t, v.shape, v.device)
    if v.dim() != 3 or min(v.shape) <= 2 * R:
        raise ValueError(f"padded 3-D state expected, got {tuple(v.shape)}")
    if v.data_ptr() == out.data_ptr():
        raise ValueError("v and out must be different buffers")
    if v.device.type == "cpu":
        return stage_reference(v, u, out, dt, taps=taps, a=a, b=b,
                               band=band, bc_value=bc_value)
    if v.device.type != "cuda":
        raise ValueError(f"no stage kernel for device {v.device}")
    nz, ny, nx = (s - 2 * R for s in v.shape)
    host_taps = np.asarray(taps, dtype=np.float32)
    with torch.cuda.device(v.device):
        rc = library().fused_diffusion_stage(
            v.data_ptr(), None if u is None else u.data_ptr(),
            out.data_ptr(), nz, ny, nx, host_taps.ctypes.data,
            float(np.float32(dt)), float(a), float(b), int(band),
            float(bc_value), int(zchunk),
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_diffusion_stage launch failed: CUDA error {rc}")
    fused_stage.launches += 1
    return out


fused_stage.launches = 0


class PaddedDiffusionState:
    """The padded layout every diffusion stepper keeps (K1, K10, K2 and,
    in 2-D, K7): the interior at offset ``R`` on every axis and an
    ``R``-deep ghost ring at the Dirichlet wall value, and what one
    (grid, dt) configuration's kernels take: the taps, ``dt``, the band
    and the wall value."""

    def __init__(self, interior_shape, spacing, diffusivity, dt, band,
                 bc_value, device):
        self.interior_shape = tuple(interior_shape)
        self.padded_shape = tuple(n + 2 * R for n in interior_shape)
        self.dtype = torch.float32
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
        return _interior(S).contiguous()


class FusedDiffusionStepper(PaddedDiffusionState, FusedStepperBase):
    """Fused runner for one (grid, dt) configuration on one device."""

    def _dt_value(self):
        return np.float32(self.dt)

    def _step(self, S, T1, T2, dt):
        kw = dict(taps=self.taps, band=self.band, bc_value=self.bc_value)
        (a1, b1), (a2, b2), (a3, b3) = STAGES
        fused_stage(S, None, T1, dt, a=a1, b=b1, **kw)  # u1 = u + dt L(u)
        fused_stage(T1, S, T2, dt, a=a2, b=b2, **kw)    # 3/4 u + 1/4 (...)
        fused_stage(T2, S, S, dt, a=a3, b=b3, **kw)     # 1/3 u + 2/3 (...)
        return S, T1, T2
