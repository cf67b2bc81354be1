"""Structured node-centered grids (counterpart of the JAX ``core/grid.py``).

Fields are stored C-order with **x innermost**: a 3-D field has shape
``(nz, ny, nx)``, which matches the reference's flat index
``o = i + nx*j + nx*ny*k`` and so its binary file layout.
``Grid.make`` takes physical-order sizes ``nx, ny, nz``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform node-centered grid.

    Attributes:
      shape: number of nodes per array axis, e.g. ``(nz, ny, nx)``.
      bounds: ``(lo, hi)`` physical bounds per array axis.
    """

    shape: Tuple[int, ...]
    bounds: Tuple[Tuple[float, float], ...]

    def __post_init__(self):
        if len(self.shape) != len(self.bounds):
            raise ValueError(
                f"shape {self.shape} and bounds {self.bounds} rank mismatch"
            )
        if not 1 <= len(self.shape) <= 3:
            raise ValueError("only 1-D/2-D/3-D grids are supported")
        for n in self.shape:
            if n < 2:
                raise ValueError(
                    f"need at least 2 nodes per axis, got {self.shape}"
                )

    @staticmethod
    def make(
        nx: int,
        ny: int | None = None,
        nz: int | None = None,
        lengths: Sequence[float] | float | None = None,
        bounds: Sequence[Tuple[float, float]] | None = None,
    ) -> "Grid":
        """Build a grid from physical-order sizes ``nx, ny, nz``.

        ``lengths`` are physical-order extents; the domain is centered at
        the origin. Alternatively pass explicit physical-order ``bounds``.
        """
        sizes = [n for n in (nx, ny, nz) if n is not None]
        ndim = len(sizes)
        if bounds is None:
            if lengths is None:
                lengths = [2.0] * ndim
            if isinstance(lengths, (int, float)):
                lengths = [float(lengths)] * ndim
            if len(lengths) != ndim:
                raise ValueError("lengths rank mismatch")
            bounds = [(-L / 2.0, L / 2.0) for L in lengths]
        if len(bounds) != ndim:
            raise ValueError("bounds rank mismatch")
        shape = tuple(reversed(sizes))
        bnds = tuple(tuple(map(float, b)) for b in reversed(bounds))
        return Grid(shape=shape, bounds=bnds)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spacing(self) -> Tuple[float, ...]:
        """Node spacing per array axis, ``dx = (hi-lo)/(n-1)``."""
        return tuple(
            (hi - lo) / (n - 1) for n, (lo, hi) in zip(self.shape, self.bounds)
        )

    @property
    def num_cells(self) -> int:
        return math.prod(self.shape)

    def coords(self, axis: int, dtype=torch.float32, device=None):
        """Node coordinates along ``axis``.

        Evaluated as ``lo*(1-s) + hi*s`` with ``s = i/(n-1)`` in
        ``dtype`` and the last node set to ``hi`` — the formula
        ``jnp.linspace`` uses, so both packages give the same nodes
        (``torch.linspace`` rounds its second half differently).
        """
        lo, hi = self.bounds[axis]
        n = self.shape[axis]
        s = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
        head = lo * (1 - s) + hi * s
        return torch.cat([head, torch.full((1,), hi, dtype=dtype,
                                           device=device)])

    def radius_sq(self, dtype=torch.float32, device=None):
        """``x^2 + y^2 + z^2`` about the domain center."""
        r2 = torch.zeros(self.shape, dtype=dtype, device=device)
        for axis in range(self.ndim):
            lo, hi = self.bounds[axis]
            c = self.coords(axis, dtype, device) - 0.5 * (lo + hi)
            shp = [1] * self.ndim
            shp[axis] = self.shape[axis]
            r2 = r2 + torch.reshape(c * c, shp)
        return r2

    @property
    def shape_xyz(self) -> Tuple[int, ...]:
        return tuple(reversed(self.shape))
