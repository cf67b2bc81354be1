"""Whole-run SSP-RK3 stepping for 2-D diffusion: one kernel launch per
run (JAX ``ops/pallas/fused_diffusion2d.py`` counterpart; kernel K7,
diffusion body, ``csrc/whole_run_diffusion2d.cu``).

A reference-scale 2-D grid (1001², ``SingleGPU/Diffusion2d/Run.m``) is
4 MB in float32, so the three padded buffers of a step fit the H100's
50 MB L2 four times over: the state is read from device memory once,
every stage of every step runs in one cooperative launch
(:mod:`whole_run`), and the result is written once.

* The state lives padded, ``(ny+4, nx+4)`` float32, the K1 layout in one
  dimension fewer (the TPU's (8, 128) rounding is gone). The 2-deep
  ghost ring holds the Dirichlet wall value and is never written: with
  reference-parity walls the RHS is zero on the boundary band
  (``Laplace3d.m:21``) and faces are clamped after every stage
  (``heat3d.m:65-67``).
* The plain stage is K1's twin (:func:`fused_diffusion.stage_reference`),
  which is dimension-generic: the 2-D body is K1's stage with the z axis
  gone, the same taps, combine, mask and clamp, rounded alike.
* :func:`whole_run_diffusion2d` launches K7 for a CUDA tensor and raises
  if it cannot; for a CPU tensor — and only then — the plain twin runs.
  The kernel cuts the interior into tiles, a job each, that keep their
  three stages in shared memory and exchange only the state, one
  grid-wide barrier a step; :func:`diffusion2d_schedule` plans the tiles
  on the host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    R,
    PaddedDiffusionState,
    stage_reference as _stage_nd,
)

SOURCE = "whole_run_diffusion2d.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _I, _I, _P, _F, _I, _F, _I, _I, _I, _I, _P, _P, _P)
# the kernel's geometry (THREADS, V and HALO in the source): a block's
# threads, the rows of a thread's patch (its columns: 4), and the cells a
# job's window reaches past its tile (3 stages of R)
THREADS = 640
PATCH_ROWS = 4
HALO = 3 * R
# the granularity (bytes) in which an SM hands out shared memory to a
# resident block, as the CUDA occupancy calculator rounds on Hopper
SMEM_GRANULE = 128
# diffusion2d_schedule's cost of a job that reloads its whole window and
# writes its whole tile every step (more jobs than blocks), in rounds of
# a block's threads: examples/k7_tiling_sweep.py fits 0.93 on an H100
# over 12 tilings of 1001^2 and 1474^2 (PERF.md §6)
RELOAD_ROUNDS = 1


def library():
    """The built K7 diffusion kernel (compiled at first use)."""
    return wr.library(SOURCE, "whole_run_diffusion2d", _ARGTYPES)


def card_limits(device) -> dict:
    """The numbers of the CUDA ``device`` that :func:`diffusion2d_schedule`
    takes, as the kernel's C entry reads them (``whole_run_diffusion2d_
    card``): ``sms``; ``blocks_per_sm``, what K7's threads and registers
    allow; ``smem_block``, the dynamic shared memory a block may opt into;
    ``smem_sm``, an SM's; ``smem_reserved``, what a resident block holds
    besides (the runtime's reserve, the kernel's static shared memory).
    Read once a card."""
    device = torch.device(device)
    return _card_limits(torch.cuda.current_device() if device.index is None
                        else device.index)


@functools.lru_cache(maxsize=None)
def _card_limits(index: int) -> dict:
    fn = library().whole_run_diffusion2d_card
    fn.argtypes, fn.restype = [_P], _I
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(index):
        rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"whole_run_diffusion2d_card: CUDA error {rc}")
    return dict(zip(("sms", "blocks_per_sm", "smem_block", "smem_sm",
                     "smem_reserved"), out))


def stage_reference(v, u, out, dt, *, taps, a, b, band, bc_value):
    """The plain K7 diffusion stage on a padded ``(ny+4, nx+4)`` state:
    ``out``'s interior ``<- where(interior, a*u + b*(v + dt*acc),
    where(face, bc_value, v))``, the taps summed y then x — K1's twin in
    two dimensions (``fused_diffusion2d.py:45-62``)."""
    if v.dim() != 2:
        raise ValueError(f"padded 2-D state expected, got {tuple(v.shape)}")
    return _stage_nd(v, u, out, dt, taps=taps, a=a, b=b, band=band,
                     bc_value=bc_value)


@functools.lru_cache(maxsize=4096)
def _axis(n: int, m: int) -> tuple:
    """Along an axis of ``n`` cells cut into ``m`` near-equal tiles (tile
    t spans ``[t n // m, (t+1) n // m)``, as in the source): for stages
    1, 2, 3 the most cells a tile evaluates and the most 4-cell quads of
    its window they span."""
    cells, quads = [0, 0, 0], [0, 0, 0]
    for t in range(m):
        a, b = t * n // m, (t + 1) * n // m
        off = 4 - max(a - HALO, -R)  # shared column of cell 0
        for s in range(3):
            reach = 2 * (2 - s)
            lo, hi = max(a - reach, 0), min(b + reach, n)
            cells[s] = max(cells[s], hi - lo)
            quads[s] = max(quads[s],
                           ((hi - 1 + off) >> 2) - ((lo + off) >> 2) + 1)
    return tuple(cells), tuple(quads)


def _tiles_plan(ny: int, nx: int, my: int, mx: int, card: dict) -> dict:
    """The counts of K7's launch on ``my`` x ``mx`` tiles (see
    :func:`diffusion2d_schedule`); ``blocks`` 0 where a block's shared
    memory does not fit the card."""
    jobs = my * mx
    h = min(-(-ny // my) + 2 * HALO, ny + 2 * R)
    w = min(-(-nx // mx) + 2 * HALO, nx + 2 * R)
    pitch = 4 * ((w + 3) // 4 + 3)
    smem = 3 * (h + PATCH_ROWS) * pitch * 4
    held = -(-(smem + card["smem_reserved"]) // SMEM_GRANULE) * SMEM_GRANULE
    per_sm = (min(card["blocks_per_sm"], card["smem_sm"] // held)
              if smem <= card["smem_block"] else 0)
    blocks = min(jobs, per_sm * card["sms"])
    rows, _ = _axis(ny, my)
    _, quads = _axis(nx, mx)
    patches = tuple(-(-rows[s] // PATCH_ROWS) * quads[s] for s in range(3))
    resident = jobs <= blocks
    rounds = -(-jobs // max(blocks, 1))
    shared = -(-blocks // card["sms"])  # blocks that take turns on an SM
    cost = rounds * shared * (sum(-(-p // THREADS) for p in patches)
                              + (0 if resident else RELOAD_ROUNDS))
    return {"tiles": (my, mx), "tile": (-(-ny // my), -(-nx // mx)),
            "jobs": jobs, "blocks": blocks, "resident": resident,
            "rounds": rounds, "patches": patches, "cost": cost,
            "smem_bytes": smem}


def _allowed(n: int, m: int) -> bool:
    """Whether ``m`` tiles along an axis of ``n`` cells are allowed: every
    side ``HALO`` cells or more where there is more than one."""
    return 1 <= m <= n and (m == 1 or n // m >= HALO)


def diffusion2d_tilings(ny: int, nx: int, *, sms: int, blocks_per_sm: int,
                        smem_block: int, smem_sm: int,
                        smem_reserved: int) -> list:
    """The plans (:func:`diffusion2d_schedule`'s counts) of every allowed
    tiling of an ``(ny, nx)`` interior with at most four jobs a block the
    card could keep resident, that fits the card's shared memory."""
    ny, nx = int(ny), int(nx)
    card = dict(sms=int(sms), blocks_per_sm=int(blocks_per_sm),
                smem_block=int(smem_block), smem_sm=int(smem_sm),
                smem_reserved=int(smem_reserved))
    most = card["sms"] * card["blocks_per_sm"]
    plans = []
    for my in range(1, (ny // HALO if ny >= 2 * HALO else 1) + 1):
        for mx in range(1, min(nx // HALO if nx >= 2 * HALO else 1,
                               4 * most // my) + 1):
            plan = _tiles_plan(ny, nx, my, mx, card)
            if plan["blocks"] > 0:
                plans.append(plan)
    return plans


def diffusion2d_schedule(ny: int, nx: int, *, sms: int, blocks_per_sm: int,
                         smem_block: int, smem_sm: int, smem_reserved: int,
                         tiles: tuple | None = None) -> dict:
    """K7's plan for an ``(ny, nx)`` interior on a card of ``sms`` SMs
    (the numbers of :func:`card_limits`): the interior cut into ``tiles =
    (my, mx)`` near-equal tiles, a job each, every side at least ``HALO``
    cells where an axis has more than one tile. Counts: the longest tile
    sides, the jobs, the blocks of the cooperative grid (as many as the
    card keeps resident with the plan's shared memory, as the C entry's
    occupancy query finds, and at most one a job), whether each job keeps
    its window resident (a block each), the rounds of jobs a block runs,
    a job's most 4 x ``PATCH_ROWS`` patches a stage, the shared memory a
    block uses, and the cost: the rounds of a block's ``THREADS`` the
    patches of a step take (``RELOAD_ROUNDS`` more a step for a job that
    is not resident), times the rounds of jobs and the blocks that share
    an SM. With ``tiles`` None, the plan of :func:`diffusion2d_tilings`
    that costs the least, of equal ones the one with the fewest patches,
    then the fewest jobs."""
    ny, nx = int(ny), int(nx)
    card = dict(sms=int(sms), blocks_per_sm=int(blocks_per_sm),
                smem_block=int(smem_block), smem_sm=int(smem_sm),
                smem_reserved=int(smem_reserved))
    if tiles is not None:
        my, mx = (int(t) for t in tiles)
        if not (_allowed(ny, my) and _allowed(nx, mx)):
            raise ValueError(f"tiles {tuple(tiles)} of a {(ny, nx)} interior:"
                             f" a tile side must span {HALO} cells or more")
        plan = _tiles_plan(ny, nx, my, mx, card)
        if plan["blocks"] == 0:
            raise ValueError(f"tiles {tuple(tiles)} need "
                             f"{plan['smem_bytes']} B of shared memory")
        return plan
    plans = diffusion2d_tilings(ny, nx, **card)
    if not plans:
        raise ValueError(f"no tiling of a {(ny, nx)} interior fits "
                         f"{card['smem_block']} B of shared memory")
    return min(plans, key=lambda p: (p["cost"],
                                     p["rounds"] * sum(p["patches"]),
                                     p["jobs"]))


def planned_tiles(ny: int, nx: int, device) -> tuple:
    """The tiles K7's wrapper launches with when none are given:
    :func:`diffusion2d_schedule`'s plan for the CUDA ``device``, worked
    out once a shape and card."""
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return _planned_tiles(int(ny), int(nx), index)


@functools.lru_cache(maxsize=256)
def _planned_tiles(ny: int, nx: int, index: int) -> tuple:
    return diffusion2d_schedule(ny, nx, **_card_limits(index))["tiles"]


def whole_run_diffusion2d(S, T1, T2, num_iters: int, dt, *, taps, band,
                          bc_value, sync_floor: bool = False,
                          grid_blocks: list | None = None,
                          tiles: tuple | None = None,
                          schedule: dict | None = None):
    """``num_iters`` SSP-RK3 steps on the padded state ``S`` in place,
    ``T1``/``T2`` scratch with ``S``'s ghost ring (T1 holds the state of
    odd steps, T2 only its ghost ring is read); returns ``S``. A CUDA
    tensor launches K7 once (counted in ``whole_run.whole_run.launches``)
    on ``tiles = (my, mx)`` tiles (None: :func:`planned_tiles`); with
    ``sync_floor`` the same grid runs only its grid-wide barriers, one a
    step. ``dt`` is rounded to float32. ``grid_blocks``, a list, receives
    the grid's block count, and ``schedule``, a dict, the launch's plan
    (:func:`diffusion2d_schedule` on the card), blocks and shared
    memory."""
    if S.dim() != 2 or min(S.shape) <= 2 * R:
        raise ValueError(f"padded 2-D state expected, got {tuple(S.shape)}")
    ny, nx = (n - 2 * R for n in S.shape)
    dt32 = float(np.float32(dt))
    host_taps = np.asarray(taps, dtype=np.float32)
    if host_taps.size != 10:
        raise ValueError(f"10 taps expected, got {host_taps.size}")
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)

    def kernel(S, T1, T2, n):
        plan = diffusion2d_schedule(
            ny, nx, **card_limits(S.device),
            tiles=tiles or planned_tiles(ny, nx, S.device))
        my, mx = plan["tiles"]
        rc = library().whole_run_diffusion2d(
            S.data_ptr(), T1.data_ptr(), T2.data_ptr(), ny, nx,
            host_taps.ctypes.data, dt32, int(band), float(bc_value), n, my,
            mx, int(not sync_floor), ctypes.byref(blocks),
            ctypes.byref(smem), wr.stream_of(S))
        if grid_blocks is not None:
            grid_blocks.append(blocks.value)
        if schedule is not None:
            schedule.update(plan, grid_blocks=blocks.value,
                            smem_bytes=smem.value)
        return rc

    def stage(v, u, out, dt_, a, b):
        return stage_reference(v, u, out, dt_, taps=taps, a=a, b=b,
                               band=band, bc_value=bc_value)

    return wr.whole_run(kernel, stage, S, T1, T2, num_iters, dt32)


class FusedDiffusion2DStepper(PaddedDiffusionState):
    """Whole-run stepper for one (grid, dt) configuration on one device.
    It has no ``run_to``: ``advance_to`` runs the generic loop, as in the
    JAX package."""

    engaged_label = "fused-whole-run"

    def stencil_spec(self) -> dict:
        """Stencil metadata, the JAX stepper's keys: whole-run residency
        with an ``R``-deep frozen Dirichlet pad, no exchange."""
        return {
            "kernel": self.engaged_label,
            "stage_radius": R,
            "fused_stages": 1,
            "ghost_depth": R,
            "exchange_depth": None,
            "steps_per_exchange": 1,
            "storage_dtype": "float32",
            "bytes_per_cell": 4,
        }

    @staticmethod
    def supported(interior_shape, dtype) -> bool:
        """Float32, and the three padded buffers fit the L2 gate
        (:func:`whole_run.fits_l2`)."""
        return dtype == torch.float32 and wr.fits_l2(
            [n + 2 * R for n in interior_shape])

    def run(self, u, t, num_iters: int):
        """``num_iters`` steps in one launch; returns ``(u, t)``, ``t``
        advanced on the host in its own precision."""
        if num_iters == 0:
            return u, t
        S = self.embed(u)
        whole_run_diffusion2d(S, S.clone(), S.clone(), num_iters, self.dt,
                              taps=self.taps, band=self.band,
                              bc_value=self.bc_value)
        return self.extract(S), wr.accumulate_t(t, np.float32(self.dt),
                                                num_iters)
