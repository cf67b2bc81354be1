"""Shared slicing helpers, wall masks and the overlapped
interior/boundary schedule (JAX ``ops/stencils.py``)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# padder(u, axis, halo) -> u padded with `halo` ghost cells on both ends.
Padder = Callable[[torch.Tensor, int, int], torch.Tensor]


def slice_axis(a: torch.Tensor, axis: int, start: int, stop: int):
    """View of ``a[start:stop]`` along ``axis``."""
    return a.narrow(axis, start, stop - start)


def shifted(a_padded: torch.Tensor, axis: int, offset: int, length: int):
    """View of length ``length`` at ``offset`` into the padded axis."""
    return a_padded.narrow(axis, offset, length)


def _index(shape, axis: int, device):
    """Index along ``axis``, shaped to broadcast against ``shape``."""
    shp = [1] * len(shape)
    shp[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).reshape(shp)


def boundary_band_mask(
    shape: Sequence[int],
    band: int,
    global_shape: Sequence[int] | None = None,
    offsets: Sequence[int] | None = None,
    axes: Sequence[int] | None = None,
    device=None,
) -> torch.Tensor:
    """Boolean mask, True on cells >= ``band`` away from every global face.

    Mirrors the reference Laplacian's interior guard
    (``Matlab_Prototipes/DiffusionNd/Laplace3d.m:21``).
    """
    ndim = len(shape)
    global_shape = global_shape or shape
    offsets = offsets or [0] * ndim
    axes = range(ndim) if axes is None else axes
    mask = torch.ones(tuple(shape), dtype=torch.bool, device=device)
    for axis in axes:
        idx = _index(shape, axis, device) + offsets[axis]
        mask = mask & (idx >= band) & (idx < global_shape[axis] - band)
    return mask


def face_mask(
    shape: Sequence[int],
    axes: Sequence[int],
    global_shape: Sequence[int] | None = None,
    offsets: Sequence[int] | None = None,
    device=None,
) -> torch.Tensor:
    """True on cells lying on a global face of any of the given axes.

    Mirrors the MATLAB Dirichlet clamp (``heat3d.m:65-67``).
    """
    ndim = len(shape)
    global_shape = global_shape or shape
    offsets = offsets or [0] * ndim
    mask = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for axis in axes:
        idx = _index(shape, axis, device) + offsets[axis]
        mask = mask | (idx == 0) | (idx == global_shape[axis] - 1)
    return mask


# ghost_fn(u, axis, halo) -> (lo, hi) ghost slabs for sharded axes, or
# None where the axis is local (plain BC padding applies).
GhostFn = Callable[[torch.Tensor, int, int], "tuple | None"]


def split_axis_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                     u: torch.Tensor, axis: int, r: int, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """Overlapped interior/boundary schedule for a 1-axis stencil op.

    ``fn`` maps an array padded by ``r`` along ``axis`` to the stencil
    result (``2r`` shorter). The interior cells ``[r, n-r)`` are computed
    from local data alone and the two ``r``-wide boundary bands from
    ``ghost + 2r`` edge cells (the reference's boundary-first order,
    ``MultiGPU/Diffusion3d_Baseline/main.c:203-260``). Every cell sees
    the same stencil over the same values as on the padded path, and the
    port evaluates it eagerly in the same order, so the result equals
    ``fn(cat([lo, u, hi]))`` to the bit."""
    n = u.shape[axis]
    if n < 2 * r:
        # bands would overlap; tiny shards take the unsplit path
        return fn(torch.cat([lo, u, hi], dim=axis))
    interior = fn(u)  # cells [r, n-r): u itself is their padded input
    lo_in = torch.cat([lo, slice_axis(u, axis, 0, 2 * r)], dim=axis)
    hi_in = torch.cat([slice_axis(u, axis, n - 2 * r, n), hi], dim=axis)
    return torch.cat([fn(lo_in), interior, fn(hi_in)], dim=axis)
