"""The per-axis WENO flux-divergence kernels (JAX ``ops/pallas/weno.py``
counterpart): K12 in 3-D, along any axis, and K12b in 2-D, one CUDA
source (``csrc/weno_axis.cu``) for both.

Each takes the unpadded array and returns ``d f(u)/dx`` along one axis:
the local Lax–Friedrichs split of ``ops/kernels/fused_burgers.py``,
WENO5-JS/Z faces in the e-form the fused kernels evaluate
(``csrc/weno5.cuh``) or WENO7-JS faces in the q-form
(``csrc/weno7.cuh``), then ``(h[i+1/2] - h[i-1/2]) * (1/dx)``. The
``r`` ghost cells a side of the sweep axis (3 for WENO5, 4 for WENO7)
are formed in the kernel, from the axis's :class:`Boundary` or from
the ``(lo, hi)`` slabs of a halo exchange on a sharded axis; the store
carries the running sum over the axes (``acc``, updated in place) and
its sign (``negate``), so the per-axis rung's right-hand side is one
launch an axis and nothing else (``models/burgers.py``).

:func:`flux_divergence_3d` and :func:`flux_divergence_2d` launch the
kernel for a CUDA tensor and raise if they cannot; for a CPU tensor —
and only then — they run :func:`flux_divergence_axis_reference`, which
composes the plain PyTorch twin of the padded problem
(:func:`flux_divergence_reference`, the JAX kernel's counterpart, with
the kernel's operation order and roundings) with the ghosts, the sum
and the sign. The TPU kernels' VMEM block model has no counterpart: a
thread marches a column of a column axis, a block stages row segments
of the last axis in shared memory, so no block has to fit a fast
memory.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary, pad_axis
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
# ghost sources of the C entry (csrc/weno_axis.cu::Ghosts)
GHOST_KINDS = {"edge": 0, "periodic": 1, "dirichlet": 2}
GHOST_SLABS = 3


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
    """Plain PyTorch twin of K12/K12b on an array ``up`` padded by the
    order's radius on ``axis`` (the JAX kernel's operand): ``_split``,
    then for WENO5 the fused kernels' divergence
    (``fused_burgers._divergence``), for WENO7 the q-form faces and
    ``(h[1:] - h[:-1]) * (1/dx)``, as the JAX kernel computes them."""
    r = HALO[order]
    n = up.shape[axis] - 2 * r
    inv_dx = float(np.float32(1.0 / dx))
    P, M = _split(flux, up)
    if order == 5:
        return _divergence(P, M, axis, n, inv_dx, variant)
    h = (_weno7_minus([P.narrow(axis, j, n + 1) for j in range(7)])
         + _weno7_plus([M.narrow(axis, j + 1, n + 1) for j in range(7)]))
    return (h.narrow(axis, 1, n) - h.narrow(axis, 0, n)) * inv_dx


def _padded(u: torch.Tensor, axis: int, r: int, bc, ghosts):
    """``u`` with its ``r`` ghosts a side on ``axis``: the boundary's
    (:func:`core.bc.pad_axis`) or the ``(lo, hi)`` slabs concatenated
    (:func:`parallel.halo.exchange_axis`)."""
    if ghosts is None:
        return pad_axis(u, axis, r, bc)
    return torch.cat([ghosts[0], u, ghosts[1]], dim=axis)


def flux_divergence_axis_reference(u: torch.Tensor, axis: int, dx: float,
                                   flux: Flux, variant: str = "js",
                                   order: int = 5, *, bc: Boundary = None,
                                   ghosts=None, acc=None,
                                   negate: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel's entry on unpadded ``u``: the
    ghosts formed (:func:`_padded`), :func:`flux_divergence_reference`,
    then ``acc + div`` and the negation, in the kernel's order. Returns a
    new tensor (the wrappers write it into ``acc`` where one is given)."""
    div = flux_divergence_reference(_padded(u, axis, HALO[order], bc, ghosts),
                                    axis, dx, flux, variant, order)
    if acc is not None:
        div = acc + div
    return -div if negate else div


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE, NVCC_EXTRA).path))
    fn = lib.weno_axis
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    fn.argtypes = [p, p, p, ll, i, ll, i, f, p, p, i, i, i, f, i, i, f, p, p]
    fn.restype = ctypes.c_int
    return lib


def _check_ghosts(u, axis, r, bc, ghosts):
    if (bc is None) == (ghosts is None):
        raise ValueError("give exactly one ghost source: bc or ghosts")
    if ghosts is None:
        if bc.kind == "periodic" and u.shape[axis] < r:
            raise ValueError(f"a periodic axis of {u.shape[axis]} cells "
                             f"cannot wrap {r} ghosts")
        return
    shape = list(u.shape)
    shape[axis] = r
    for name, g in zip(("lo", "hi"), ghosts):
        if tuple(g.shape) != tuple(shape) or g.dtype != u.dtype or \
                g.device != u.device:
            raise ValueError(f"ghost slab {name}: {tuple(g.shape)} "
                             f"{g.dtype} on {g.device}, expected "
                             f"{tuple(shape)} {u.dtype} on {u.device}")


def _launch(counter, ndim, u, axis, dx, flux, variant, order, bc, ghosts,
            acc, negate, chunk, plan=None):
    """Check the operands, then run the twin (a CPU tensor) or launch the
    kernel and count the launch in ``counter.launches``."""
    if u.dim() != ndim:
        raise ValueError(f"{ndim}-D array expected, got {tuple(u.shape)}")
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim}-D")
    axis %= ndim
    if not supported(ndim, order, variant, dtype=u.dtype):
        raise ValueError(f"no WENO kernel for order {order}, variant "
                         f"{variant!r}, {u.dtype}")
    if flux.name not in FLUX_CODES:
        raise ValueError(f"no WENO kernel for flux {flux.name!r}")
    r = HALO[order]
    _check_ghosts(u, axis, r, bc, ghosts)
    if negate and acc is None:
        raise ValueError("negate stores -(acc + div): give acc")
    if acc is not None and (acc.shape != u.shape or acc.dtype != u.dtype
                            or acc.device != u.device):
        raise ValueError(f"acc: {tuple(acc.shape)} {acc.dtype} on "
                         f"{acc.device}, expected u's")
    if u.device.type == "cpu":
        out = flux_divergence_axis_reference(
            u, axis, dx, flux, variant, order, bc=bc, ghosts=ghosts, acc=acc,
            negate=negate)
        return out if acc is None else acc.copy_(out)
    if u.device.type != "cuda":
        raise ValueError(f"no WENO kernel for device {u.device}")
    operands = [("u", u)] + ([] if acc is None else [("acc", acc)]) + (
        [] if ghosts is None else [("lo", ghosts[0]), ("hi", ghosts[1])])
    for name, t in operands:
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if acc is not None and acc.data_ptr() == u.data_ptr():
        raise ValueError("acc must not be u: the kernel reads u's "
                         "neighbours after it writes a cell")
    out = torch.empty_like(u) if acc is None else acc
    outer = math.prod(u.shape[:axis])
    inner = math.prod(u.shape[axis + 1:])
    c = flux.c if flux.c is not None else 0.0
    if ghosts is None:
        kind, value, lo, hi = (GHOST_KINDS[bc.kind],
                               float(np.float32(bc.value)), None, None)
    else:
        kind, value = GHOST_SLABS, 0.0
        lo, hi = ghosts[0].data_ptr(), ghosts[1].data_ptr()
    planned = (ctypes.c_int * 2)()
    with torch.cuda.device(u.device):
        rc = library().weno_axis(
            u.data_ptr(), None if acc is None else acc.data_ptr(),
            out.data_ptr(), outer, u.shape[axis], inner, kind, value, lo, hi,
            int(bool(negate)), int(chunk or 0), FLUX_CODES[flux.name],
            float(c), int(order), int(variant == "z"),
            float(np.float32(1.0 / dx)),
            torch.cuda.current_stream(u.device).cuda_stream, planned)
    if rc != 0:
        raise RuntimeError(f"weno_axis launch failed: CUDA error {rc}")
    build.count_launch(counter)
    if plan is not None:
        plan.update(zip(("segment", "segments") if inner == 1
                        else ("chunk", "chunks"), planned))
    return out


def flux_divergence_3d(u: torch.Tensor, axis: int, dx: float, flux: Flux,
                       variant: str = "js", order: int = 5, *,
                       bc: Boundary | None = None, ghosts=None,
                       acc: torch.Tensor | None = None, negate: bool = False,
                       chunk: int | None = None,
                       plan: dict | None = None) -> torch.Tensor:
    """``d f(u)/dx`` along ``axis`` of an unpadded 3-D float32 array, its
    ghosts from the boundary ``bc`` or the ``ghosts = (lo, hi)`` slabs of
    a halo exchange (each ``r`` cells deep on ``axis``); with ``acc`` the
    store adds the running sum (into ``acc``, in place), with ``negate``
    it negates what it stores. Launches K12 on the current stream (no
    synchronisation) and counts the launch in
    ``flux_divergence_3d.launches``; a CPU tensor runs
    :func:`flux_divergence_axis_reference`. ``chunk`` (cells a thread
    marches along a column axis; the row segment along the last)
    overrides the kernel's plan, which ``plan`` (a dict) receives."""
    return _launch(flux_divergence_3d, 3, u, axis, dx, flux, variant, order,
                   bc, ghosts, acc, negate, chunk, plan)


flux_divergence_3d.launches = 0


def flux_divergence_2d(u: torch.Tensor, axis: int, dx: float, flux: Flux,
                       variant: str = "js", order: int = 5, *,
                       bc: Boundary | None = None, ghosts=None,
                       acc: torch.Tensor | None = None, negate: bool = False,
                       chunk: int | None = None,
                       plan: dict | None = None) -> torch.Tensor:
    """The 2-D counterpart (K12b), counted in
    ``flux_divergence_2d.launches``."""
    return _launch(flux_divergence_2d, 2, u, axis, dx, flux, variant, order,
                   bc, ghosts, acc, negate, chunk, plan)


flux_divergence_2d.launches = 0


def flux_divergence_kernel(u: torch.Tensor, axis: int, dx: float,
                           flux: Flux, variant: str = "js", order: int = 5,
                           **kw) -> torch.Tensor:
    """K12 for a 3-D array, K12b for a 2-D one (the JAX package's
    ``flux_divergence_pallas``, on unpadded ``u``)."""
    fn = flux_divergence_2d if u.dim() == 2 else flux_divergence_3d
    return fn(u, axis, dx, flux, variant, order, **kw)
