"""Whole-step fused SSP-RK3 diffusion: all three RK stages of a step in
ONE kernel launch (JAX ``ops/pallas/fused_diffusion_step.py``
counterpart; kernel K10, ``csrc/fused_step_diffusion.cu``).

A step reads the state once and writes it once, 8 B a cell, where the
per-stage path (K1) moves at least 32: each block recomputes the ghost
region of its tile for stages 1 and 2 (temporal blocking over the RK
stages) instead of writing the stages out.

* A block of the kernel owns a 32x32 (y, x) output tile and a chunk of
  z planes (``csrc/fused_step_diffusion.cu``, the body of K10, K2, K2b,
  K3 and K4); :func:`diffusion_schedule` plans the chunk of every form
  (:func:`diffusion_zchunk`, once a shape), and :func:`ops_issued`
  counts the f32 operations the body issues.
* The state is K1's padded layout, ``(nz+4, ny+4, nx+4)`` float32 with a
  2-deep ghost ring at the wall value (:class:`fused_diffusion.
  PaddedDiffusionState`). The TPU's 8-deep z ghosts, which kept the edge
  blocks' stage windows inside frozen rows, are gone: the kernel reads
  every position outside the domain as the wall value.
* Blocks write cells other blocks still read, so a step cannot run in
  place: two buffers alternate, one launch a step (``:19-21``).
* :func:`fused_step` launches K10 for a CUDA tensor and raises if it
  cannot; for a CPU tensor — and only then — it runs
  :func:`step_reference`, the plain twin: three K1-twin stages
  (:func:`fused_diffusion.stage_reference`, ``_stage_rows``' term
  order), which the kernel equals to the bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    R,
    STAGES,
    PaddedDiffusionState,
    _check,
    stage_reference,
)

SOURCE = "fused_step_diffusion.cu"
# the body's output tile edge in y and x (T in the source); stage s
# evaluates a window R(3-s) cells wider a side (t1 40, t2 36, out 32)
TILE = 32
# f32 operations a stage issues an evaluated cell: 15 products and 14
# sums of taps, dt*acc and v + (stage 1, b = 1), then b*, a*u and +
STAGE_OPS = (31, 34, 34)
# resident blocks of the body an SM (MIN_BLOCKS in the source; 105,600 B
# of shared memory a block)
BLOCKS_PER_SM = 2
# diffusion_schedule's cost of a step, fitted to the z-chunk sweeps of
# every form on an H100 (examples/diffusion_zchunk_sweep.py, PERF.md): a
# z chunk's two ends (8 planes of t1 and 4 of t2 recomputed, 12 of S
# loaded, the pipeline's fill) cost as much as CHUNK_COST more planes,
# COOPERATIVE_CHUNK_COST in the cooperative launches (K2, K2b, K4: jobs
# from a counter, a grid barrier a step), and a job alone on its SM
# takes ALONE_TIME of the time it takes beside another
CHUNK_COST = 5
COOPERATIVE_CHUNK_COST = 6
ALONE_TIME = 0.6
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def step_reference(S, out, dt, *, taps, band, bc_value):
    """The plain twin of one fused step on the padded layout: ``out``'s
    interior ``<- s3(s2(s1(S), S), S)``, three K1-twin stages, ``S``
    unchanged; returns ``out``. ``out``'s ghost ring must hold
    ``bc_value``, as ``S``'s does."""
    kw = dict(taps=taps, band=band, bc_value=bc_value)
    (a1, b1), (a2, b2), (a3, b3) = STAGES
    T1 = stage_reference(S, None, S.clone(), dt, a=a1, b=b1, **kw)
    T2 = stage_reference(T1, S, S.clone(), dt, a=a2, b=b2, **kw)
    return stage_reference(T2, S, out, dt, a=a3, b=b3, **kw)


def library():
    """The built K10 kernel (compiled at first use; its source also holds
    K2, :mod:`fused_slab_run`)."""
    return wr.library(SOURCE, "fused_step_diffusion",
                      (_P, _P, _I, _I, _I, _P, _F, _I, _F, _I, _P))


def check_padded(S, out, dtype=torch.float32) -> None:
    """``S`` and ``out``: two different contiguous padded 3-D buffers of
    ``dtype`` (float32 by default) and one shape on one device."""
    _check("out", out, S.shape, S.device, dtype)
    _check("S", S, S.shape, S.device, dtype)
    if S.dim() != 3 or min(S.shape) <= 2 * R:
        raise ValueError(f"padded 3-D state expected, got {tuple(S.shape)}")
    if S.data_ptr() == out.data_ptr():
        raise ValueError("S and out must be different buffers")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused-step kernel for device {S.device}")


def ops_issued(shape, zchunk: int, window=None) -> int:
    """f32 operations the body issues in one step over the output window
    ``window = (z_lo, z_hi)`` (global planes; the whole grid by default)
    of an ``(nz, ny, nx)`` grid in jobs of ``zchunk`` planes, recompute
    included: every tile and chunk evaluates stage s (1, 2, 3) on every
    cell of its window, ``R(3-s)`` cells wider a side than the tile in y
    and x (cells outside the domain too: the masks select after), on the
    in-domain planes of the chunk widened as much in z,
    ``STAGE_OPS[s-1]`` operations each."""
    nz, ny, nx = shape
    z_lo, z_hi = (0, nz) if window is None else window
    tiles = -(-ny // TILE) * -(-nx // TILE)

    def span(a, b, n):  # planes of [a, b) inside [0, n)
        return max(0, min(b, n) - max(a, 0))

    total = 0
    for s, ops in enumerate(STAGE_OPS, start=1):
        w = R * (3 - s)
        planes = sum(span(k - w, min(k + zchunk, z_hi) + w, nz)
                     for k in range(z_lo, z_hi, zchunk))
        total += ops * tiles * (TILE + 2 * w) ** 2 * planes
    return total


def plan_jobs(window: int, tiles: int, blocks: int, units: int,
              zchunk: int | None, cost) -> dict:
    """One step's jobs on a ``window``-plane output window of ``tiles``
    tiles a plane and ``units`` members or shards over ``blocks``
    resident blocks: a job marches ``zchunk`` planes (the last chunk the
    rest); with None, of the splits of the window into n = 1..16
    near-equal chunks the one for which ``cost(planes, jobs)`` is the
    least (the first found of equal ones). The slab Burgers kernels'
    planner (``fused_slab_run.burgers_schedule``) shares it."""
    window = int(window)
    planes = zchunk
    if planes is None:
        best = None
        for n in range(1, min(16, window) + 1):
            size = -(-window // n)
            total = cost(size, tiles * units * -(-window // size))
            if best is None or total < best[0]:
                best = (total, size)
        planes = best[1]
    chunks = -(-window // int(planes))
    jobs = tiles * units * chunks
    return {"tiles": tiles, "chunk_planes": int(planes), "chunks": chunks,
            "jobs": jobs, "waves": jobs / blocks}


def diffusion_schedule(window: int, ny: int, nx: int, blocks: int,
                       units: int = 1, zchunk: int | None = None,
                       cooperative: bool = False) -> dict:
    """One step's jobs of the body (K10, K3; with ``cooperative`` K2,
    K2b with ``units`` members, K4 with ``units`` shards) on a
    ``window``-plane output window of ``TILE`` x ``TILE`` tiles over
    ``blocks`` resident blocks, ``BLOCKS_PER_SM`` an SM, in the counts
    of :func:`plan_jobs`. With None, the split whose step costs the
    least: its jobs in rounds of ``blocks``, each costing a chunk's
    planes plus the chunk cost, a last partial round that leaves each SM
    at most one job costing ``ALONE_TIME`` of one."""
    tiles = -(-ny // TILE) * -(-nx // TILE)
    chunk_cost = COOPERATIVE_CHUNK_COST if cooperative else CHUNK_COST
    sms = blocks // BLOCKS_PER_SM

    def cost(size, jobs):
        rounds, rest = divmod(jobs, blocks)
        tail = 0 if rest == 0 else ALONE_TIME if rest <= sms else 1
        return (rounds + tail) * (size + chunk_cost)

    return plan_jobs(window, tiles, blocks, units, zchunk, cost)


def diffusion_zchunk(window: int, ny: int, nx: int, units: int, device,
                     cooperative: bool = False) -> int:
    """The z planes of a job that the body's wrappers launch with when no
    ``zchunk`` is given: :func:`diffusion_schedule`'s plan for
    ``BLOCKS_PER_SM`` resident blocks an SM of the CUDA ``device``,
    worked out once a shape, form and card."""
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return _planned_zchunk(int(window), int(ny), int(nx), int(units),
                           bool(cooperative), index)


@functools.lru_cache(maxsize=256)
def _planned_zchunk(window: int, ny: int, nx: int, units: int,
                    cooperative: bool, index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return diffusion_schedule(window, ny, nx, BLOCKS_PER_SM * sms, units,
                              cooperative=cooperative)["chunk_planes"]


def fused_step(S, out, dt, *, taps, band, bc_value, zchunk=None):
    """One fused SSP-RK3 step: ``out``'s interior ``<-`` the step of
    ``S`` (padded buffers; ``S`` is not written). ``dt`` is rounded to
    float32 and passed by value. Launches K10 on the current stream (no
    synchronisation), each block marching ``zchunk`` z planes of a 32x32
    tile (None: :func:`diffusion_zchunk`'s plan for the card), and counts the launch in ``fused_step.launches``; a CPU tensor
    runs :func:`step_reference`."""
    check_padded(S, out)
    if S.device.type == "cpu":
        return step_reference(S, out, dt, taps=taps, band=band,
                              bc_value=bc_value)
    nz, ny, nx = (n - 2 * R for n in S.shape)
    zchunk = zchunk or diffusion_zchunk(nz, ny, nx, 1, S.device)
    host_taps = np.asarray(taps, dtype=np.float32)
    with torch.cuda.device(S.device):
        rc = library().fused_step_diffusion(
            S.data_ptr(), out.data_ptr(), nz, ny, nx, host_taps.ctypes.data,
            float(np.float32(dt)), int(band), float(bc_value), int(zchunk),
            wr.stream_of(S))
    if rc != 0:
        raise RuntimeError(f"fused_step_diffusion launch failed: CUDA error {rc}")
    build.count_launch(fused_step)
    return out


fused_step.launches = 0


class StepFusedDiffusionStepper(PaddedDiffusionState):
    """Whole-step runner for one (grid, dt) configuration on one device:
    one K10 launch a step, two padded buffers alternating. As in the JAX
    package it has no ``run_to``: ``advance_to`` runs the generic loop."""

    engaged_label = "fused-step"

    def run(self, u, t, num_iters: int):
        """``num_iters`` fused steps; returns ``(u, t)``, ``t`` advanced
        by ``dt`` once a step in its own precision (``:248-253``)."""
        S = self.embed(u)
        T = S.clone()
        for _ in range(int(num_iters)):
            fused_step(S, T, self.dt, taps=self.taps, band=self.band,
                       bc_value=self.bc_value)
            S, T = T, S
        return self.extract(S), wr.accumulate_t(t, np.float32(self.dt),
                                                num_iters)
