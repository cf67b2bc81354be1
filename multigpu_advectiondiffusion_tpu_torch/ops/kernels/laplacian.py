"""The per-axis O4 Laplacian kernels (JAX ``ops/pallas/laplacian.py``
counterpart): K11 in 3-D, K11b in 2-D (``csrc/laplacian_o4.cu``).

Both consume an array padded by 2 on every axis (ghost cells attached
by the caller, ``ops/laplacian.py``) and return the interior
``sum_a K_a d2u/da^2``. :func:`laplacian_o4_3d` and
:func:`laplacian_o4_2d` launch the kernel for a CUDA tensor and raise
if they cannot; for a CPU tensor — and only then — they run
:func:`laplacian_reference`, the plain PyTorch twin: the generic path's
``d2_from_padded`` sum, in the kernel's term order and roundings.

The TPU kernels' VMEM block model has no counterpart: a thread marches
a column of the padded array, so no block has to fit a fast memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.laplacian import d2_from_padded

R = 2  # stencil radius of the O4 second derivative
O4_COEFFS = (-1.0, 16.0, -30.0, 16.0, -1.0)  # / (12 dx^2), Laplace3d.m:22-25

SOURCE = "laplacian_o4.cu"
# z planes one K11 thread marches
Z_CHUNK = 8


def supported(shape: Sequence[int], order: int, itemsize: int = 4) -> bool:
    """Whether K11/K11b compute this problem: the O4 stencil on a 2-D or
    3-D float32 array."""
    return order == 4 and itemsize == 4 and len(shape) in (2, 3)


def coefficients(spacing: Sequence[float], diffusivity: Sequence[float]):
    """``(taps, k)``: per axis the taps ``c_j / (12 dx^2)``, each formed
    in double and rounded once to float32, and ``K`` rounded to float32
    — the values the TPU kernel and the generic path multiply by."""
    taps, k = [], []
    for dx, kd in zip(spacing, diffusivity):
        scale = 1.0 / (12.0 * dx * dx)
        taps += [float(np.float32(c * scale)) for c in O4_COEFFS]
        k.append(float(np.float32(kd)))
    return tuple(taps), tuple(k)


def laplacian_reference(up: torch.Tensor, spacing: Sequence[float],
                        diffusivity: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch twin of K11/K11b: per axis ``sum_j u[j] * t_j``
    (j ascending), times ``K``, axes summed in array order."""
    acc = None
    for axis in range(up.dim()):
        idx = [slice(R, s - R) for s in up.shape]
        idx[axis] = slice(None)
        term = diffusivity[axis] * d2_from_padded(
            up[tuple(idx)], axis, spacing[axis], 4)
        acc = term if acc is None else acc + term
    return acc


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernels (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE).path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.laplacian_o4_3d.argtypes = [p, p, i, i, i, p, p, i, p]
    lib.laplacian_o4_2d.argtypes = [p, p, i, i, p, p, p]
    lib.laplacian_o4_3d.restype = lib.laplacian_o4_2d.restype = ctypes.c_int
    return lib


def _prepare(up, ndim, spacing, diffusivity):
    """Check ``up``; ``None`` for a CPU tensor (the caller runs the
    twin), else the output buffer and the host coefficients."""
    if up.dim() != ndim or min(up.shape) <= 2 * R:
        raise ValueError(f"padded {ndim}-D array expected, got "
                         f"{tuple(up.shape)}")
    if up.dtype != torch.float32:
        raise TypeError(f"float32 only, got {up.dtype}")
    if len(spacing) != ndim or len(diffusivity) != ndim:
        raise ValueError("one spacing and one diffusivity per axis")
    if up.device.type == "cpu":
        return None
    if up.device.type != "cuda":
        raise ValueError(f"no Laplacian kernel for device {up.device}")
    if not up.is_contiguous():
        raise ValueError("up: must be contiguous")
    out = torch.empty(tuple(s - 2 * R for s in up.shape),
                      dtype=torch.float32, device=up.device)
    taps, k = coefficients(spacing, diffusivity)
    return (out, np.asarray(taps, dtype=np.float32),
            np.asarray(k, dtype=np.float32))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def laplacian_o4_3d(up: torch.Tensor, spacing: Sequence[float],
                    diffusivity: Sequence[float],
                    zchunk: int = Z_CHUNK) -> torch.Tensor:
    """``sum_a K_a d2/da^2`` of ``up``, ``(nz+4, ny+4, nx+4)`` float32,
    returned as ``(nz, ny, nx)``. Launches K11 on the current stream (no
    synchronisation), each thread marching ``zchunk`` z planes, and
    counts the launch in ``laplacian_o4_3d.launches``; a CPU tensor runs
    :func:`laplacian_reference`."""
    prep = _prepare(up, 3, spacing, diffusivity)
    if prep is None:
        return laplacian_reference(up, spacing, diffusivity)
    out, taps, k = prep
    nz, ny, nx = out.shape
    with torch.cuda.device(up.device):
        rc = library().laplacian_o4_3d(
            up.data_ptr(), out.data_ptr(), nz, ny, nx, taps.ctypes.data,
            k.ctypes.data, int(zchunk),
            torch.cuda.current_stream(up.device).cuda_stream)
    _raise_on(rc, "laplacian_o4_3d")
    build.count_launch(laplacian_o4_3d)
    return out


laplacian_o4_3d.launches = 0


def laplacian_o4_2d(up: torch.Tensor, spacing: Sequence[float],
                    diffusivity: Sequence[float]) -> torch.Tensor:
    """The 2-D counterpart: ``up`` ``(ny+4, nx+4)`` -> ``(ny, nx)``.
    Launches K11b, counted in ``laplacian_o4_2d.launches``; a CPU tensor
    runs :func:`laplacian_reference`."""
    prep = _prepare(up, 2, spacing, diffusivity)
    if prep is None:
        return laplacian_reference(up, spacing, diffusivity)
    out, taps, k = prep
    ny, nx = out.shape
    with torch.cuda.device(up.device):
        rc = library().laplacian_o4_2d(
            up.data_ptr(), out.data_ptr(), ny, nx, taps.ctypes.data,
            k.ctypes.data, torch.cuda.current_stream(up.device).cuda_stream)
    _raise_on(rc, "laplacian_o4_2d")
    build.count_launch(laplacian_o4_2d)
    return out


laplacian_o4_2d.launches = 0
