"""Whole-run SSP-RK3 stepping for 2-D Burgers/WENO5 and WENO7-JS: one
kernel launch per run (JAX ``ops/pallas/fused_burgers2d.py`` counterpart;
kernels K7, Burgers body, and K7a, adaptive dt, both
``csrc/whole_run_burgers2d.cu``, each at order 5 and 7).

A reference-scale 2-D grid (400×406, ``MultiGPU/Burgers2d_Baseline``)
is under 1 MB in float32: the state is read from device memory once,
every WENO sweep of every stage of every step runs in one cooperative
launch (:mod:`whole_run`), and the result is written once.

* The state is kept **unpadded**, ``(ny, nx)`` float32, as K5 keeps it:
  edge boundaries are replicated ghosts, so the twin clamps every
  neighbour index into the grid and the TPU body's ghost re-synthesis
  after each stage (``fused_burgers2d.py:60-67``) becomes, in the
  kernel, the edge cells writing their own replicas.
* dt modes, as in the JAX stepper: fixed (CUDA parity,
  ``main.c:193``) or adaptive — ``dt = f32(cfl min dx) / max(max|f'(u)|,
  1e-12)`` from the state at the start of every step, taken inside the
  kernel (K7a), and the float32 sum of the steps' dt read back once.
* The plain stage is K5's twin (:func:`fused_burgers.stage_reference`),
  which is dimension-generic: its Lax–Friedrichs split
  (``fused_burgers._split``), e-form WENO5 (``ops/weno._weno5_side_nd_e``;
  at order 7 ``_weno7_side_nd_e``) and O4 taps, two axes instead of
  three. K7 is built with ``-fmad=false``, as K5 is, so kernel and twin
  round alike.
* The kernel cuts the grid into tiles, a job each, that keep their window
  and three stages in shared memory, compute each split and face once a
  stage, and exchange only the state, one grid-wide barrier a step;
  :func:`burgers2d_schedule` plans the tiles on the host. The window
  reaches ``3r`` cells past a tile, ``r = HALO[order]``: 9 at order 5,
  12 at order 7, whose instance has its own registers and shared memory
  (``card_limits`` keys on the order).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_burgers import (
    FLUX_CODES,
    NVCC_EXTRA,
    SPLIT_OPS,
    R,
    StageParams,
    run_ops,
    stage_params,
    stage_reference as _stage_nd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion2d import (
    SMEM_GRANULE,
)
from multigpu_advectiondiffusion_tpu_torch.ops.weno import HALO as REACH
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import (
    advective_dt,
)

SOURCE = "whole_run_burgers2d.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _F, _F, _P, _P, _I,
             _I, _I, _I, _P, _P, _P)
# the kernel's geometry (THREADS, HALO, RUN, SPARE and PLANES in the
# source): a block's threads, the cells a job's window reaches past its
# tile (3 stages of R; at order 7 3 * REACH[7] = 12, halo_of), the faces
# a thread computes at once, the rows and columns the last run of a line
# reads past a window, and the shared planes of a block (S, t1, t2, f+,
# f-, the x and y faces)
THREADS = 768
HALO = 3 * R
RUN = 3
SPARE = 2
PLANES = 7


def halo_of(order: int = 5) -> int:
    """The cells a job's window reaches past its tile at ``order``."""
    return 3 * REACH[order]


def library():
    """The built K7/K7a Burgers kernel (compiled at first use)."""
    return wr.library(SOURCE, "whole_run_burgers2d", _ARGTYPES, NVCC_EXTRA)


def _device_index(device) -> int:
    device = torch.device(device)
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def _instance(params: StageParams, adaptive: bool) -> tuple:
    return (FLUX_CODES[params.flux.name], int(params.variant == "z"),
            int(adaptive), int(params.order))


def card_limits(device, params: StageParams, adaptive: bool) -> dict:
    """The numbers of the CUDA ``device`` that :func:`burgers2d_schedule`
    takes for the kernel instance of ``params``' flux, variant and order
    and the dt mode, as the C entry reads them
    (``whole_run_burgers2d_card``):
    ``sms``; ``blocks_per_sm``, what the instance's threads and registers
    allow; ``smem_block``, the dynamic shared memory a block may opt into;
    ``smem_sm``, an SM's; ``smem_reserved``, what a resident block holds
    besides (the runtime's reserve, the kernel's static shared memory).
    Read once a card and instance."""
    return _card_limits(_device_index(device), *_instance(params, adaptive))


@functools.lru_cache(maxsize=None)
def _card_limits(index: int, flux: int, weno_z: int, adaptive: int,
                 order: int = 5) -> dict:
    fn = library().whole_run_burgers2d_card
    fn.argtypes, fn.restype = [_I, _I, _I, _I, _P], _I
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(index):
        rc = fn(flux, weno_z, adaptive, order, out)
    if rc != 0:
        raise RuntimeError(f"whole_run_burgers2d_card: CUDA error {rc}")
    return dict(zip(("sms", "blocks_per_sm", "smem_block", "smem_sm",
                     "smem_reserved"), out))


def stage_reference(v, u, out, dt, *, params: StageParams, a: float,
                    b: float):
    """The plain K7 Burgers stage on an unpadded ``(ny, nx)`` state:
    ``out <- a*u + b*(v + dt*rhs)``, ``rhs = -(div_y + div_x) [+ lap]`` —
    K5's twin in two dimensions (``fused_burgers2d.py:79-94``)."""
    if v.dim() != 2:
        raise ValueError(f"2-D state expected, got {tuple(v.shape)}")
    return _stage_nd(v, u, out, dt, params=params, a=a, b=b)


@functools.lru_cache(maxsize=4096)
def _axis(n: int, m: int, r: int = R) -> tuple:
    """Along an axis of ``n`` cells cut into ``m`` near-equal tiles (tile
    t spans ``[t n // m, (t+1) n // m)``, as in the source), for each
    tile: the cells stages 1, 2, 3 evaluate (the tile and 2r, r, 0 cells
    a side, clipped to the axis), its window's cells (3r a side, clipped
    to ``[-r, n + r)``) and its own cells; ``r`` the reach."""
    tiles = []
    for t in range(m):
        a, b = t * n // m, (t + 1) * n // m
        tiles.append((tuple(min(b + e, n) - max(a - e, 0)
                            for e in (2 * r, r, 0)),
                      min(b + 3 * r, n + r) - max(a - 3 * r, -r), b - a))
    return tuple(tiles)


def _cell_ops(stage: int, *, viscous: bool, adaptive: bool,
              split: bool) -> int:
    """f32 operations the body issues on an evaluated cell of stage 1, 2
    or 3 after its faces (the source's note, Burgers flux): the two
    divergences 4, their sum and negation 2, the Laplacian 20, the combine
    2 (stages 2-3: 5), the split of the result 6 (``split``), |f'| and
    its max 2 (stage 3, adaptive)."""
    return (6 + (20 if viscous else 0) + (2 if stage == 1 else 5)
            + (SPLIT_OPS if split else 0)
            + (2 if adaptive and stage == 3 else 0))


def _job_ops(ay: tuple, ax: tuple, resident: bool, *, viscous: bool = False,
             variant: str = "js", adaptive: bool = False,
             order: int = 5) -> int:
    """f32 operations a job of tile (``ay``, ``ax``, entries of
    :func:`_axis`) issues in a step: the splits of the cells it loads
    (its halo when resident, else its window), and on each stage's
    evaluated cells the runs of three x faces of every row and y faces of
    every column (``nc // 3 + 1`` runs for ``nc + 1`` faces) and the
    cells' own work (:func:`_cell_ops`; stage 3 splits its result only
    when resident)."""
    (rows, wrows, trows), (cols, wcols, tcols) = ay, ax
    ops = SPLIT_OPS * (wrows * wcols - (trows * tcols if resident else 0))
    for s in range(3):
        nr, nc = rows[s], cols[s]
        runs = nr * (nc // RUN + 1) + nc * (nr // RUN + 1)
        ops += runs * run_ops(variant, order) + nr * nc * _cell_ops(
            s + 1, viscous=viscous, adaptive=adaptive,
            split=s < 2 or resident)
    return ops


def _tiles_plan(ny: int, nx: int, my: int, mx: int, card: dict,
                order: int = 5) -> dict:
    """The counts of K7's launch on ``my`` x ``mx`` tiles (see
    :func:`burgers2d_schedule`); ``blocks`` 0 where a block's shared
    memory does not fit the card."""
    jobs = my * mx
    r = REACH[order]
    h = min(-(-ny // my) + 6 * r, ny + 2 * r)
    w = min(-(-nx // mx) + 6 * r, nx + 2 * r)
    smem = PLANES * (h + SPARE) * (w + SPARE) * 4
    held = -(-(smem + card["smem_reserved"]) // SMEM_GRANULE) * SMEM_GRANULE
    per_sm = (min(card["blocks_per_sm"], card["smem_sm"] // held)
              if smem <= card["smem_block"] else 0)
    blocks = min(jobs, per_sm * card["sms"])
    resident = jobs <= blocks
    rounds = -(-jobs // max(blocks, 1))
    shared = -(-blocks // card["sms"])  # blocks that take turns on an SM
    # the job of the most stage-1 cells along each axis
    ay = max(_axis(ny, my, r), key=lambda t: (t[0][0], t[2]))
    ax = max(_axis(nx, mx, r), key=lambda t: (t[0][0], t[2]))
    return {"tiles": (my, mx), "tile": (-(-ny // my), -(-nx // mx)),
            "window": (h, w), "jobs": jobs, "blocks": blocks,
            "resident": resident, "rounds": rounds,
            "cost": rounds * shared * _job_ops(ay, ax, resident,
                                               order=order),
            "smem_bytes": smem}


def _allowed(n: int, m: int, order: int = 5) -> bool:
    """Whether ``m`` tiles along an axis of ``n`` cells are allowed: every
    side :func:`halo_of` cells or more where there is more than one."""
    return 1 <= m <= n and (m == 1 or n // m >= halo_of(order))


def _card(sms, blocks_per_sm, smem_block, smem_sm, smem_reserved) -> dict:
    return dict(sms=int(sms), blocks_per_sm=int(blocks_per_sm),
                smem_block=int(smem_block), smem_sm=int(smem_sm),
                smem_reserved=int(smem_reserved))


def burgers2d_tilings(ny: int, nx: int, *, sms: int, blocks_per_sm: int,
                      smem_block: int, smem_sm: int,
                      smem_reserved: int, order: int = 5) -> list:
    """The plans (:func:`burgers2d_schedule`'s counts) of every allowed
    tiling of an ``(ny, nx)`` grid with at most four jobs a block the
    card could keep resident, that fits the card's shared memory."""
    ny, nx = int(ny), int(nx)
    card = _card(sms, blocks_per_sm, smem_block, smem_sm, smem_reserved)
    most = card["sms"] * card["blocks_per_sm"]
    halo = halo_of(order)
    plans = []
    for my in range(1, (ny // halo if ny >= 2 * halo else 1) + 1):
        for mx in range(1, min(nx // halo if nx >= 2 * halo else 1,
                               4 * most // my) + 1):
            plan = _tiles_plan(ny, nx, my, mx, card, order)
            if plan["blocks"] > 0:
                plans.append(plan)
    return plans


def burgers2d_schedule(ny: int, nx: int, *, sms: int, blocks_per_sm: int,
                       smem_block: int, smem_sm: int, smem_reserved: int,
                       tiles: tuple | None = None, order: int = 5) -> dict:
    """K7 Burgers' plan at WENO ``order`` (reach ``r``: 3 at order 5, 4
    at order 7) for an ``(ny, nx)`` grid on a card of ``sms`` SMs (the
    numbers of :func:`card_limits` for that order's instance): the grid
    cut into ``tiles = (my, mx)`` near-equal tiles, a job each, every
    side at least ``3r`` cells (:func:`halo_of`) where an axis has more
    than one tile. Counts: the longest tile sides, the widest window (the
    tile and ``3r`` cells a side, clipped to ``r`` past the grid), the
    jobs, the blocks of the cooperative grid
    (as many as the card keeps resident with the plan's shared memory, as
    the C entry's occupancy query finds, and at most one a job), whether
    each job keeps its window resident (a block each), the rounds of jobs
    a block runs, the shared memory a block uses (``PLANES`` planes of the
    widest window and ``SPARE`` rows and columns), and the cost: the f32
    operations a step of the busiest SM issues (:func:`_job_ops` of the
    largest job, WENO5-JS or WENO7-JS, inviscid, times the rounds of
    jobs and the blocks that share an SM). With ``tiles`` None, the plan
    of :func:`burgers2d_tilings` that costs the least, of equal ones the
    one with the fewest jobs."""
    ny, nx = int(ny), int(nx)
    card = _card(sms, blocks_per_sm, smem_block, smem_sm, smem_reserved)
    if tiles is not None:
        my, mx = (int(t) for t in tiles)
        if not (_allowed(ny, my, order) and _allowed(nx, mx, order)):
            raise ValueError(f"tiles {tuple(tiles)} of a {(ny, nx)} grid: a "
                             f"tile side must span {halo_of(order)} cells "
                             f"or more")
        plan = _tiles_plan(ny, nx, my, mx, card, order)
        if plan["blocks"] == 0:
            raise ValueError(f"tiles {tuple(tiles)} need "
                             f"{plan['smem_bytes']} B of shared memory")
        return plan
    plans = burgers2d_tilings(ny, nx, **card, order=order)
    if not plans:
        raise ValueError(f"no tiling of a {(ny, nx)} grid fits "
                         f"{card['smem_block']} B of shared memory")
    return min(plans, key=lambda p: (p["cost"], p["jobs"]))


@functools.lru_cache(maxsize=256)
def _plan(ny: int, nx: int, tiles, *key) -> dict:
    """:func:`burgers2d_schedule`'s plan for ``tiles`` (None: the
    planner's) on the card and kernel instance ``key`` (its last entry
    the order), worked out once a shape, card and instance; not to be
    changed."""
    return burgers2d_schedule(ny, nx, **_card_limits(*key), tiles=tiles,
                              order=key[-1])


def ops_issued(ny: int, nx: int, plan: dict, *, viscous: bool,
               variant: str, adaptive: bool, order: int = 5) -> int:
    """f32 operations one step of a K7 run on ``plan`` (a
    :func:`burgers2d_schedule` plan of the same order) issues with the
    Burgers flux, past its first step: :func:`_job_ops` of every job."""
    my, mx = plan["tiles"]
    r = REACH[order]
    return sum(_job_ops(ay, ax, plan["resident"], viscous=viscous,
                        variant=variant, adaptive=adaptive, order=order)
               for ay in _axis(ny, my, r) for ax in _axis(nx, mx, r))


def whole_run_burgers2d(S, T1, T2, num_iters: int, *, params: StageParams,
                        dt=None, spacing=None, cfl=None,
                        sync_floor: bool = False,
                        grid_blocks: list | None = None,
                        tiles: tuple | None = None,
                        schedule: dict | None = None):
    """``num_iters`` SSP-RK3 steps on the ``(ny, nx)`` state ``S`` in
    place, ``T1``/``T2`` scratch (T1 holds the state of odd steps on the
    card). Exactly one of ``dt`` (fixed, rounded to float32; returns
    ``S``) and ``spacing`` with ``cfl`` (adaptive; returns ``(S,
    t_sum)``) is given. A CUDA tensor launches the kernel once (counted
    in ``whole_run.whole_run.launches`` or
    ``whole_run.whole_run_adaptive.launches``) on ``tiles = (my, mx)``
    tiles (None: the planner's choice); with ``sync_floor`` the same grid
    runs only its grid-wide barriers, one a step. ``grid_blocks``, a list,
    receives the grid's block count, and ``schedule``, a dict, the
    launch's plan (:func:`burgers2d_schedule` on the card), blocks and
    shared memory."""
    adaptive = dt is None
    if adaptive == (spacing is None or cfl is None):
        raise ValueError("give exactly one of dt and (spacing, cfl)")
    if S.dim() != 2:
        raise ValueError(f"2-D state expected, got {tuple(S.shape)}")
    if len(params.inv_dx) != 2:
        raise ValueError("2-D stage parameters expected")
    ny, nx = S.shape
    inv_dx = np.asarray(params.inv_dx, dtype=np.float32)
    taps = (None if params.lap_taps is None
            else np.asarray(params.lap_taps, dtype=np.float32))
    c = params.flux.c if params.flux.c is not None else 0.0
    dt32 = 0.0 if adaptive else float(np.float32(dt))
    cfl_dx = float(np.float32(cfl * min(spacing))) if adaptive else 0.0
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)

    def kernel(S, T1, T2, n, wmax=None, t_sum=None):
        key = (_device_index(S.device), *_instance(params, adaptive))
        plan = _plan(ny, nx, tuple(tiles) if tiles else None, *key)
        my, mx = plan["tiles"]
        rc = library().whole_run_burgers2d(
            S.data_ptr(), T1.data_ptr(), T2.data_ptr(), ny, nx,
            FLUX_CODES[params.flux.name], float(c),
            int(params.variant == "z"), int(params.order), inv_dx.ctypes.data,
            None if taps is None else taps.ctypes.data, dt32, cfl_dx,
            None if wmax is None else wmax.data_ptr(),
            None if t_sum is None else t_sum.data_ptr(), n, my, mx,
            int(not sync_floor), ctypes.byref(blocks), ctypes.byref(smem),
            wr.stream_of(S))
        if grid_blocks is not None:
            grid_blocks.append(blocks.value)
        if schedule is not None:
            schedule.update(plan, grid_blocks=blocks.value,
                            smem_bytes=smem.value)
        return rc

    def stage(v, u, out, dt_, a, b):
        return stage_reference(v, u, out, dt_, params=params, a=a, b=b)

    if not adaptive:
        return wr.whole_run(kernel, stage, S, T1, T2, num_iters, dt32)
    flux = params.flux
    return wr.whole_run_adaptive(
        kernel, stage, lambda u: advective_dt(u, flux.df, spacing, cfl),
        S, T1, T2, num_iters)


class FusedBurgers2DStepper:
    """Whole-run WENO5 / WENO7-JS stepper for one (grid, flux, dt mode,
    order) configuration on one device. Exactly one of ``dt`` (fixed,
    CUDA parity) and ``cfl`` (adaptive) is given, as the JAX stepper takes
    exactly one of ``dt`` and ``dt_fn`` (``fused_burgers2d.py:126-127``).
    It has no ``run_to``: ``advance_to`` runs the generic loop."""

    engaged_label = "fused-whole-run"

    def __init__(self, interior_shape, spacing, flux: Flux, variant: str,
                 nu: float, device, dt: float | None = None,
                 cfl: float | None = None, order: int = 5):
        if (dt is None) == (cfl is None):
            raise ValueError("provide exactly one of dt/cfl")
        self.interior_shape = tuple(interior_shape)
        self.dtype = torch.float32
        self.device = torch.device(device)
        self.params = stage_params(flux, variant, spacing, nu, order)
        self.halo = self.params.r
        self.spacing = tuple(spacing)
        self.dt = None if dt is None else float(dt)
        self.cfl = None if cfl is None else float(cfl)

    def stencil_spec(self) -> dict:
        """Stencil metadata, the JAX stepper's keys: whole-run residency
        with an ``r``-deep edge pad (clamped indices here), no
        exchange."""
        return {
            "kernel": self.engaged_label,
            "stage_radius": self.halo,
            "fused_stages": 1,
            "ghost_depth": self.halo,
            "exchange_depth": None,
            "steps_per_exchange": 1,
            "storage_dtype": "float32",
            "bytes_per_cell": 4,
        }

    @staticmethod
    def supported(interior_shape, dtype) -> bool:
        """Float32, and the three buffers fit the L2 gate
        (:func:`whole_run.fits_l2`)."""
        return dtype == torch.float32 and wr.fits_l2(interior_shape)

    def embed(self, u):
        return u.to(device=self.device, dtype=self.dtype,
                    copy=True).contiguous()

    def extract(self, S):
        return S

    def run(self, u, t, num_iters: int):
        """``num_iters`` steps in one launch; returns ``(u, t)``. Fixed
        dt advances ``t`` on the host; adaptive reads the float32 sum of
        the steps' dt back once and adds it in ``t``'s precision
        (``fused_burgers2d.py:201-204``)."""
        if num_iters == 0:
            return u, t
        S = self.embed(u)
        T1, T2 = torch.empty_like(S), torch.empty_like(S)
        if self.dt is not None:
            whole_run_burgers2d(S, T1, T2, num_iters, params=self.params,
                                dt=self.dt)
            return S, wr.accumulate_t(t, np.float32(self.dt), num_iters)
        S, t_sum = whole_run_burgers2d(S, T1, T2, num_iters,
                                       params=self.params,
                                       spacing=self.spacing, cfl=self.cfl)
        tdt = type(t)
        return S, t + tdt(t_sum.item())  # the one read-back of the run
