"""Distributed halo exchange (JAX ``parallel/halo.py`` counterpart).

The reference's five-stream MPI choreography
(``MultiGPU/Diffusion3d_Baseline/main.c:203-297``: pack, copy out,
``MPI_Isend``/``Irecv``, copy in, unpack, per RK stage) is two
``ppermute`` shifts per sharded axis here (one round of the shards'
rendezvous, :func:`parallel.mesh.ppermute_many`), run on every shard
inside :func:`parallel.mesh.shard_map`. As in the JAX package the *state* is
exchanged before computing (not the RHS), and any subset of axes may be
decomposed.

``exchange_ghosts.bytes_per_execution`` counts the bytes every exchange
sends (the two ghost slabs of a site, summed over shards and calls, at
the wire's type): the JAX package's ``halo.bytes_per_execution``
counter, kept as a plain count until the telemetry sink is ported
(ROADMAP queue 1 item 11). Under ``precision="bf16"`` the generic loop's
slabs cross a bf16 wire (``wire_dtype``), half the bytes; the fused
rungs' buffers are bf16 themselves, so their refresh moves bf16 as is.
The in-kernel exchange of the slab rung's ``exchange="dma"`` (K4, which
moves the ghost rows inside its one launch for every shard of the card)
has no exchange site here: :func:`remote_dma_spec` declares it and
:func:`record_remote_dma` counts its bytes
(``record_remote_dma.bytes_per_execution``, the JAX package's
``halo.dma_bytes_per_execution``, a plain count like the one above).
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence

import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import (
    Boundary,
    boundary_halo,
    pad_axis,
)
from multigpu_advectiondiffusion_tpu_torch.ops.stencils import (
    Padder,
    slice_axis,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
    Decomposition,
    axis_extent,
    axis_index,
    ppermute_many,
)


class _Count:
    """A byte count several shard threads add to."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.value += int(n)


def exchange_spec() -> dict:
    """Queryable exchange metadata: one exchange site is two ``ppermute``
    shifts per sharded axis; the JAX package's counters, of which the
    port keeps ``halo.bytes_per_execution``
    (``exchange_ghosts.bytes_per_execution``)."""
    return {
        "ppermute_shifts": 2,
        "counters": (
            "halo.exchanges_traced",
            "halo.bytes_per_execution",
        ),
    }


def remote_dma_spec() -> dict:
    """Queryable metadata of the in-kernel halo exchange (the JAX
    package's, for ``fused_slab_run._whole_run_dma_kernel``, K4 in the
    port): its traffic is counted by ``halo.dma_bytes_per_execution``
    (:func:`record_remote_dma`) in place of the ``ppermute`` pair."""
    return {
        "kernel": "fused-whole-run-slab",
        "counters": ("halo.dma_bytes_per_execution",),
        "events": (("halo", "in_kernel"),),
    }


def record_remote_dma(kernel: str, plane_shape, itemsize: int,
                      window_rows: int, blocks: int, mesh_axis) -> int:
    """Count one shard's in-kernel exchange of a run: two
    ``window_rows``-deep windows of the padded trailing plane pushed per
    block, ``blocks`` blocks (the initial push included: ``ceil(num_iters
    / k)``), the JAX package's ``2 * window_rows * plane * itemsize *
    blocks``. Added to ``record_remote_dma.bytes_per_execution`` (summed
    over shards and runs) and returned. ``kernel`` and ``mesh_axis``
    label the JAX package's telemetry event, which waits with the
    telemetry sink (ROADMAP queue 1 item 11)."""
    del kernel, mesh_axis
    plane = int(itemsize)
    for n in plane_shape:
        plane *= int(n)
    nbytes = 2 * int(window_rows) * plane * int(blocks)
    record_remote_dma.bytes_per_execution.add(nbytes)
    return nbytes


def exchange_ghosts(u: torch.Tensor, axis: int, halo: int, mesh_axis,
                    num_shards: int, bc: Boundary, repeats: int = 1,
                    wire_dtype=None):
    """The two ``ppermute`` shifts of a halo exchange, returned as the
    ``(lo, hi)`` ghost slabs without concatenating onto ``u``: ``lo``
    is the left neighbour's last ``halo`` cells along ``axis``, ``hi``
    the right neighbour's first, wrapped around on a periodic axis; on
    the global-edge shards of a non-periodic axis the boundary's ghosts
    (:func:`core.bc.boundary_halo`) instead. ``halo`` is the exchange
    depth (``k * G`` for the k-step schedule). ``repeats`` is the JAX
    package's telemetry hint and changes nothing here: the port counts
    every call. ``wire_dtype``, where it differs from ``u.dtype``, is the
    JAX package's bf16 wire: only the two sent slabs, and the edge
    shards' boundary ghosts, are cast to it, and cast back on receipt;
    the count is the wire's bytes."""
    del repeats
    wire = None if wire_dtype in (None, u.dtype) else wire_dtype
    n_local = u.shape[axis]
    if n_local < halo:
        raise ValueError(
            f"shard of {n_local} cells can't serve a halo of {halo} on axis "
            f"{axis}")
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [((i + 1) % num_shards, i) for i in range(num_shards)]
    # left halo <- left neighbour's rightmost cells; right halo <- right
    # neighbour's leftmost cells (tags 1/5 pair messaging, main.c:218,234)
    send_hi = slice_axis(u, axis, n_local - halo, n_local)
    send_lo = slice_axis(u, axis, 0, halo)
    if wire is not None:
        send_hi, send_lo = send_hi.to(wire), send_lo.to(wire)
    from_left, from_right = ppermute_many([send_hi, send_lo], mesh_axis,
                                          [fwd, bwd])
    if bc.kind != "periodic":
        idx = axis_index(mesh_axis)
        if idx == 0:
            from_left = boundary_halo(u, axis, halo, bc, "left")
        if idx == num_shards - 1:
            from_right = boundary_halo(u, axis, halo, bc, "right")
        if wire is not None:
            # the global edges' ghosts take the wire's rounding too
            from_left, from_right = from_left.to(wire), from_right.to(wire)
    if wire is not None:
        from_left, from_right = from_left.to(u.dtype), from_right.to(u.dtype)
    exchange_ghosts.bytes_per_execution.add(
        send_hi.numel() * send_hi.element_size()
        + send_lo.numel() * send_lo.element_size())
    return from_left, from_right


exchange_ghosts.bytes_per_execution = _Count()
record_remote_dma.bytes_per_execution = _Count()


def exchange_axis(u: torch.Tensor, axis: int, halo: int, mesh_axis,
                  num_shards: int, bc: Boundary,
                  wire_dtype=None) -> torch.Tensor:
    """Pad one axis of a shard-local block with neighbour (or BC) ghost
    cells. Runs inside ``shard_map``."""
    from_left, from_right = exchange_ghosts(
        u, axis, halo, mesh_axis, num_shards, bc, wire_dtype=wire_dtype)
    return torch.cat([from_left, u, from_right], dim=axis)


def make_padder(decomp: Decomposition, mesh_axis_sizes: Dict[str, int],
                bcs: Sequence[Boundary], wire_dtype=None) -> Padder:
    """Padder closure for use inside ``shard_map``: ppermute on sharded
    axes, plain BC padding on local axes."""

    def padder(u: torch.Tensor, axis: int, halo: int) -> torch.Tensor:
        name = decomp.mesh_axis(axis)
        if name is None or axis_extent(mesh_axis_sizes, name) == 1:
            return pad_axis(u, axis, halo, bcs[axis])
        return exchange_axis(
            u, axis, halo, name, axis_extent(mesh_axis_sizes, name),
            bcs[axis], wire_dtype=wire_dtype)

    return padder


def make_ghost_fn(decomp: Decomposition, mesh_axis_sizes: Dict[str, int],
                  bcs: Sequence[Boundary], wire_dtype=None):
    """Ghost-slab closure for the overlapped schedule: ``(lo, hi)`` for
    sharded axes, ``None`` for local axes (plain BC padding, nothing to
    overlap)."""

    def ghost_fn(u: torch.Tensor, axis: int, halo: int):
        name = decomp.mesh_axis(axis)
        if name is None or axis_extent(mesh_axis_sizes, name) == 1:
            return None
        return exchange_ghosts(
            u, axis, halo, name, axis_extent(mesh_axis_sizes, name),
            bcs[axis], wire_dtype=wire_dtype)

    return ghost_fn


def make_ghost_refresh(decomp: Decomposition,
                       mesh_axis_sizes: Dict[str, int],
                       bcs: Sequence[Boundary], halo: int,
                       interior_local: Sequence[int],
                       core_offsets: Sequence[int] | None = None):
    """Refresh the ghost slabs of a persistent padded buffer IN PLACE.

    The fused steppers keep the state padded; under a mesh the ghosts of
    a sharded axis are neighbour data and go stale after every stage (or
    step): this closure exchanges the buffer's core window and writes the
    fresh slabs into the ghost rows (the JAX package writes them with
    ``dynamic_update_slice``; the port overwrites the buffer, so no
    padded copy is made). ``interior_local`` is the shard-local interior
    shape, ``core_offsets`` the interior origin in the padded layout per
    axis (default ``halo``), ``halo`` the refresh depth (``k * G`` for
    the k-step schedule). Axes of extent 1 keep their frozen ghosts.
    Runs inside ``shard_map``; the closure takes the JAX package's
    optional ``repeats`` hint and ignores it."""
    offs = (tuple(core_offsets) if core_offsets is not None
            else (halo,) * len(interior_local))
    sharded = [
        (ax, decomp.mesh_axis(ax))
        for ax in range(len(interior_local))
        if decomp.mesh_axis(ax) is not None
        and axis_extent(mesh_axis_sizes, decomp.mesh_axis(ax)) > 1
    ]

    def refresh(P: torch.Tensor, repeats: int = 1) -> torch.Tensor:
        del repeats
        for ax, name in sharded:
            n_loc = interior_local[ax]
            off = offs[ax]
            core = P.narrow(ax, off, n_loc)
            lo, hi = exchange_ghosts(
                core, ax, halo, name, axis_extent(mesh_axis_sizes, name),
                bcs[ax])
            P.narrow(ax, off - halo, halo).copy_(lo)
            P.narrow(ax, off + n_loc, halo).copy_(hi)
        return P

    return refresh


def axis_offsets(decomp: Decomposition, local_shape: Sequence[int]):
    """Global index offset of this shard's block, per array axis:
    ``axis_index * local_n`` (the analog of ``k + rank*_Nz`` in
    ``Tools.c:192``). Runs inside ``shard_map``."""
    offs = []
    for ax in range(len(local_shape)):
        name = decomp.mesh_axis(ax)
        offs.append(0 if name is None else axis_index(name) * local_shape[ax])
    return offs
