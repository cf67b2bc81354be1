"""Solver states (JAX ``models/state.py`` counterpart).

``u`` is a tensor on the solver's device; ``t`` and ``it`` live on the
host — ``t`` as a numpy scalar of the state's precision (float32 for a
float32 field, as in the JAX package) and ``it`` as a Python int — so
the time loop advances them without a device sync per step. An
:class:`EnsembleState` batches B members: ``u`` is ``(B, *grid)`` on
the device, ``t`` and ``it`` are ``(B,)`` numpy arrays. Under a device
mesh ``u`` is a :class:`ShardedArray`, one tensor a shard (the
counterpart of a sharded ``jax.Array``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
    Decomposition,
    Mesh,
)


def time_dtype(u_dtype: torch.dtype):
    """The numpy scalar type that carries ``t`` for a field of ``u_dtype``."""
    return np.float64 if u_dtype == torch.float64 else np.float32


class ShardedArray:
    """A global field held as one tensor per shard of a mesh, each on its
    shard's device: ``shards[rank]`` is the block of shard ``rank``
    (shards that differ only along mesh axes the decomposition does not
    use hold the same block). :meth:`assemble` gathers the global
    tensor; :meth:`scatter` cuts one."""

    def __init__(self, shards, mesh: Mesh, decomp: Decomposition,
                 global_shape):
        self.shards = list(shards)
        self.mesh = mesh
        self.decomp = decomp
        self.shape = tuple(int(n) for n in global_shape)
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{mesh.size}")

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _block(self, rank: int):
        """The global index box of shard ``rank``'s block."""
        local = self.decomp.local_shape(self.mesh, self.shape)
        idx = self.decomp.block_index(self.mesh, rank, self.ndim)
        return tuple(slice(i * n, (i + 1) * n) for i, n in zip(idx, local))

    @staticmethod
    def scatter(u: torch.Tensor, mesh: Mesh,
                decomp: Decomposition) -> "ShardedArray":
        """Cut the global tensor ``u`` into the mesh's blocks, each copied
        onto its shard's device."""
        decomp.validate(mesh, u.shape)
        out = ShardedArray([None] * mesh.size, mesh, decomp, u.shape)
        for rank, dev in enumerate(mesh.device_list()):
            out.shards[rank] = u[out._block(rank)].to(
                dev, copy=True).contiguous()
        return out

    def assemble(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: shard 0's)."""
        device = torch.device(device) if device else self.shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for rank, block in enumerate(self.shards):
            out[self._block(rank)] = block.to(device)
        return out

    def numpy(self) -> np.ndarray:
        return self.assemble("cpu").numpy()

    def __repr__(self) -> str:
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"mesh={self.mesh})")


class SolverState(NamedTuple):
    """The evolving solution plus simulated time and iteration count."""

    u: "torch.Tensor | ShardedArray"
    t: np.floating
    it: int

    @staticmethod
    def create(u, t: float = 0.0) -> "SolverState":
        return SolverState(u=u, t=time_dtype(u.dtype)(t), it=0)


class EnsembleState(NamedTuple):
    """A batch of B independent solver states advanced by one dispatch.

    The member axis leads every field: ``u`` is ``(B, *grid.shape)`` on
    the device, ``t`` a ``(B,)`` numpy array in the time dtype and
    ``it`` a ``(B,)`` int32 array — members may sit at different
    simulated times (member-varying dt) and, in ``advance_to`` mode,
    different step counts.
    """

    u: torch.Tensor  # (B, *grid.shape)
    t: np.ndarray    # (B,)
    it: np.ndarray   # (B,) int32

    @property
    def members(self) -> int:
        return int(self.u.shape[0])

    @staticmethod
    def stack(states) -> "EnsembleState":
        """Batch B single-member states into one ensemble state."""
        states = list(states)
        if not states:
            raise ValueError("an ensemble needs at least one member")
        u = torch.stack([s.u for s in states])
        return EnsembleState(
            u=u,
            t=np.array([s.t for s in states], dtype=time_dtype(u.dtype)),
            it=np.array([int(s.it) for s in states], dtype=np.int32),
        )

    def member(self, i: int) -> SolverState:
        """Member ``i`` as a plain :class:`SolverState` view."""
        return SolverState(u=self.u[i], t=self.t[i], it=int(self.it[i]))
