"""The per-axis WENO flux-divergence kernels (JAX ``ops/pallas/weno.py``
counterpart): K12 in 3-D, along any axis, and K12b in 2-D, one CUDA
kernel (``csrc/weno_axis.cu``) for both.

Each consumes an array padded by the order's radius (3 for WENO5, 4 for
WENO7) on the sweep axis only — ghost cells attached by the caller,
``ops/weno.py::flux_divergence`` — and returns ``d f(u)/dx`` along that
axis: the local Lax–Friedrichs split of ``ops/kernels/fused_burgers.py``,
WENO5-JS/Z faces in the e-form the fused kernels evaluate
(``csrc/weno5.cuh``) or WENO7-JS faces in the q-form
(``csrc/weno7.cuh``), then ``(h[i+1/2] - h[i-1/2]) * (1/dx)``.

:func:`flux_divergence_3d` and :func:`flux_divergence_2d` launch the
kernel for a CUDA tensor and raise if they cannot; for a CPU tensor —
and only then — they run :func:`flux_divergence_reference`, the plain
PyTorch twin with the kernel's operation order and roundings. The TPU
kernels' VMEM block model has no counterpart: a thread marches a
column of the sweep axis, so no block has to fit a fast memory.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_burgers import (
    FLUX_CODES,
    NVCC_EXTRA,
    _divergence,
    _split,
)
from multigpu_advectiondiffusion_tpu_torch.ops.weno import (
    HALO,
    _weno7_minus,
    _weno7_plus,
)

SOURCE = "weno_axis.cu"
# cells one thread marches along the sweep axis: a sweep along the
# last axis (consecutive threads on consecutive chunks) and along any
# other (consecutive threads on consecutive columns). The fastest of 4,
# 8, 16 and 32 at 512^3 on the H100 (chip_smoke.py phase 17): 4 along
# x; 32 along z and y, by 4-6 % over 16.
CHUNK_LAST = 4
CHUNK = 32


def supported(ndim: int, order: int, variant: str, shape=None,
              dtype=torch.float32) -> bool:
    """Whether K12/K12b compute this problem: WENO5-JS/Z or WENO7-JS on
    a 2-D or 3-D float32 array (``shape`` is accepted for the JAX
    package's signature; no size is declined)."""
    del shape
    if (order, variant) not in {(5, "js"), (5, "z"), (7, "js")}:
        return False
    return dtype == torch.float32 and ndim in (2, 3)


def flux_divergence_reference(up: torch.Tensor, axis: int, dx: float,
                              flux: Flux, variant: str = "js",
                              order: int = 5) -> torch.Tensor:
    """Plain PyTorch twin of K12/K12b: ``_split``, then for WENO5 the
    fused kernels' divergence (``fused_burgers._divergence``), for WENO7
    the q-form faces and ``(h[1:] - h[:-1]) * (1/dx)``, as the JAX
    kernel computes them."""
    r = HALO[order]
    n = up.shape[axis] - 2 * r
    inv_dx = float(np.float32(1.0 / dx))
    P, M = _split(flux, up)
    if order == 5:
        return _divergence(P, M, axis, n, inv_dx, variant)
    h = (_weno7_minus([P.narrow(axis, j, n + 1) for j in range(7)])
         + _weno7_plus([M.narrow(axis, j + 1, n + 1) for j in range(7)]))
    return (h.narrow(axis, 1, n) - h.narrow(axis, 0, n)) * inv_dx


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE, NVCC_EXTRA).path))
    fn = lib.weno_axis
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    fn.argtypes = [p, p, ll, i, ll, i, i, f, i, i, f, p]
    fn.restype = ctypes.c_int
    return lib


def _launch(counter, ndim, up, axis, dx, flux, variant, order, chunk):
    """Check ``up`` (``ndim``-D) and run the twin (a CPU tensor) or launch
    the kernel and count the launch in ``counter.launches``."""
    if up.dim() != ndim:
        raise ValueError(f"{ndim}-D array expected, got {tuple(up.shape)}")
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim}-D")
    axis %= ndim
    if not supported(ndim, order, variant, dtype=up.dtype):
        raise ValueError(f"no WENO kernel for order {order}, variant "
                         f"{variant!r}, {up.dtype}")
    if flux.name not in FLUX_CODES:
        raise ValueError(f"no WENO kernel for flux {flux.name!r}")
    r = HALO[order]
    n = up.shape[axis] - 2 * r
    if n < 1:
        raise ValueError(f"axis {axis} of {tuple(up.shape)} is not padded "
                         f"by {r}")
    if up.device.type == "cpu":
        return flux_divergence_reference(up, axis, dx, flux, variant, order)
    if up.device.type != "cuda":
        raise ValueError(f"no WENO kernel for device {up.device}")
    if not up.is_contiguous():
        raise ValueError("up: must be contiguous")
    shape = list(up.shape)
    shape[axis] = n
    out = torch.empty(shape, dtype=torch.float32, device=up.device)
    outer = math.prod(up.shape[:axis])
    inner = math.prod(up.shape[axis + 1:])
    if chunk is None:
        chunk = CHUNK_LAST if inner == 1 else CHUNK
    c = flux.c if flux.c is not None else 0.0
    with torch.cuda.device(up.device):
        rc = library().weno_axis(
            up.data_ptr(), out.data_ptr(), outer, n, inner, int(chunk),
            FLUX_CODES[flux.name], float(c), int(order),
            int(variant == "z"), float(np.float32(1.0 / dx)),
            torch.cuda.current_stream(up.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"weno_axis launch failed: CUDA error {rc}")
    build.count_launch(counter)
    return out


def flux_divergence_3d(up: torch.Tensor, axis: int, dx: float, flux: Flux,
                       variant: str = "js", order: int = 5,
                       chunk: int | None = None) -> torch.Tensor:
    """``d f(u)/dx`` along ``axis`` of a 3-D float32 array padded by the
    order's radius on that axis. Launches K12 on the current stream (no
    synchronisation), each thread marching ``chunk`` cells (default
    :data:`CHUNK`, :data:`CHUNK_LAST` along the last axis), and counts
    the launch in ``flux_divergence_3d.launches``; a CPU tensor runs
    :func:`flux_divergence_reference`."""
    return _launch(flux_divergence_3d, 3, up, axis, dx, flux, variant, order,
                   chunk)


flux_divergence_3d.launches = 0


def flux_divergence_2d(up: torch.Tensor, axis: int, dx: float, flux: Flux,
                       variant: str = "js", order: int = 5,
                       chunk: int | None = None) -> torch.Tensor:
    """The 2-D counterpart (K12b), counted in
    ``flux_divergence_2d.launches``."""
    return _launch(flux_divergence_2d, 2, up, axis, dx, flux, variant, order,
                   chunk)


flux_divergence_2d.launches = 0


def flux_divergence_kernel(up: torch.Tensor, axis: int, dx: float,
                           flux: Flux, variant: str = "js",
                           order: int = 5) -> torch.Tensor:
    """K12 for a 3-D array, K12b for a 2-D one (the JAX package's
    ``flux_divergence_pallas``)."""
    fn = flux_divergence_2d if up.dim() == 2 else flux_divergence_3d
    return fn(up, axis, dx, flux, variant, order)
