"""Shared slicing helpers and wall masks (JAX ``ops/stencils.py``)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# padder(u, axis, halo) -> u padded with `halo` ghost cells on both ends.
Padder = Callable[[torch.Tensor, int, int], torch.Tensor]


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
