"""Boundary conditions and halo padding (JAX ``core/bc.py`` counterpart)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

_KINDS = ("dirichlet", "edge", "periodic")


@dataclasses.dataclass(frozen=True)
class Boundary:
    """Per-axis boundary condition (same on both faces of the axis).

    kind:
      * ``dirichlet`` — ghost cells hold ``value`` (reference heat walls).
      * ``edge``      — ghost cells replicate the face value.
      * ``periodic``  — wrap-around.
    """

    kind: str = "dirichlet"
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown boundary kind {self.kind!r}; use {_KINDS}"
            )

    @staticmethod
    def parse(spec) -> "Boundary":
        if isinstance(spec, Boundary):
            return spec
        if isinstance(spec, str):
            return Boundary(kind=spec)
        raise TypeError(f"cannot interpret boundary spec {spec!r}")


def pad_axis(u: torch.Tensor, axis: int, halo: int, bc: Boundary):
    """Pad ``u`` with ``halo`` ghost cells on both ends of one axis."""
    if halo == 0:
        return u
    n = u.shape[axis]
    if bc.kind == "periodic":
        return torch.cat(
            [u.narrow(axis, n - halo, halo), u, u.narrow(axis, 0, halo)],
            dim=axis,
        )
    if bc.kind == "edge":
        lo = u.narrow(axis, 0, 1).expand(
            *[halo if a == axis else s for a, s in enumerate(u.shape)]
        )
        hi = u.narrow(axis, n - 1, 1).expand_as(lo)
        return torch.cat([lo, u, hi], dim=axis)
    # F.pad lists (left, right) pairs from the LAST axis backwards
    pw = [0, 0] * u.ndim
    k = 2 * (u.ndim - 1 - axis)
    pw[k] = pw[k + 1] = halo
    return F.pad(u, pw, mode="constant", value=bc.value)


def boundary_halo(u: torch.Tensor, axis: int, halo: int, bc: Boundary,
                  side: str) -> torch.Tensor:
    """The ghost block a *global* domain edge would receive (no wrap):
    what the halo exchange hands the global-edge shards of a
    non-periodic axis in place of the cyclic ``ppermute`` result."""
    if bc.kind == "periodic":
        raise ValueError("periodic axes take their halo from the ppermute")
    n = u.shape[axis]
    if bc.kind == "edge":
        face = u.narrow(axis, 0 if side == "left" else n - 1, 1)
        return torch.repeat_interleave(face, halo, dim=axis)
    shape = list(u.shape)
    shape[axis] = halo
    return torch.full(shape, bc.value, dtype=u.dtype, device=u.device)
