"""Whole-run slab SSP-RK3 stepping for 3-D diffusion and Burgers: every
fused step of a run in ONE cooperative kernel launch (JAX
``ops/pallas/fused_slab_run.py`` counterpart, its single-device parts;
kernels K2, diffusion, ``csrc/fused_step_diffusion.cu``, and K6,
Burgers/WENO5 and WENO7-JS, ``csrc/slab_run_burgers.cu``).

On the TPU the Pallas grid is ``(timestep, z-slab)`` and runs in order:
each slab, loaded with ``G = 3h`` ghost rows a side, fuses the three RK
stages of a step in VMEM, and the state ping-pongs between two buffers
across steps. On Hopper the counterpart is one cooperative launch a run:
a grid of co-resident blocks walks the step's jobs (a 32x32 (y, x) tile
and a chunk of z planes each, the ghost region recomputed in y and x as
in z), and a grid-wide barrier after each step takes the place of the
sequential grid axis. Step ``k`` reads buffer ``k % 2`` and writes the
other, so the result lies in buffer ``num_iters % 2``. The cooperative
kernels (K2, K6, K2b, K4) take their jobs from an atomic counter, last z
chunks last; :func:`burgers_schedule` and
``fused_diffusion_step.diffusion_schedule`` plan the z chunks of every
slab kernel (K10's and K3's too) so that a window splits evenly and the
jobs spread well over the resident blocks, and count them.

* :func:`slab_run_diffusion` (K2) and :func:`slab_run_burgers` (K6)
  launch the kernel for a CUDA tensor (raising if it cannot) and count
  the launch; for a CPU tensor — and only then — they run the plain
  twin, the fused step looped on the two buffers: for K2
  :func:`fused_diffusion_step.step_reference` (three K1-twin stages), for
  K6 :func:`burgers_step_reference` (three K5-twin stages, whose clamped
  reads are the TPU kernel's edge fill after every stage).
* :func:`slab_run_diffusion_batched` and :func:`slab_run_burgers_batched`
  (K2b) are K2 and K6 with a member axis: B independent members' runs in
  one cooperative launch (``run_batched``, ``fused_slab_run.py:902-945``;
  the TPU grid ``(B, N, n_slabs)`` over a ``(B, 2, pz, Y, X)`` stack).
  The two buffers are ``(B, *layout)``, each member's slice the single
  kernel's layout; the grid walks the flattened (member, tile, z-chunk)
  work list and one grid barrier a step covers every member. Members
  share no cell (``member_halo = 0``), so member ``i`` equals the single
  run of member ``i`` to the bit. Their plain twins are the single twins'
  ``ping_pong`` per member.
* K3 (:func:`slab_step_diffusion`, :func:`slab_step_burgers`) is the
  sharded rung: on a shard of a z-slab mesh a step is ONE launch over an
  output window (the TPU's ``_step_call_kernel``, ``:508``, built by
  ``_make_call``, ``:949-1017``), the same ``step_tile`` as K2's/K6's,
  so a sharded step is their step to the bit. The shard keeps its block
  between ``depth = k*G`` ghost planes a side; planes are read by global
  z from the buffer or, for the split schedule's edge calls, from the
  exchanged operands; outside the global domain diffusion reads the wall
  value and Burgers clamps. Their plain twins assemble the window's
  input box the same way and run three K1-/K5-twin stages on it.
* The steppers have the JAX classes' names, labels, ``run``,
  ``run_batched`` and the ``member_halo`` declaration, and on a shard
  the JAX schedules (``fused_slab_run.py:1024-1202``): a G-deep refresh
  and one call a step; the split schedule's three calls (interior, then
  bottom and top from the exchanged slabs); and with
  ``steps_per_exchange = k > 1`` one ``k*G``-deep exchange per k steps,
  call ``j`` of a block writing the core widened by ``(k-1-j)*G`` planes
  a side. The member count declaration and its check wait for
  member-sharded meshes. Neither has ``run_to``, as in JAX.
* K4 (:func:`slab_run_dma_diffusion`, :func:`slab_run_dma_burgers`) is
  the sharded rung with ``exchange="dma"`` (the TPU's
  ``_whole_run_dma_kernel``, ``:327``, one program a shard that pushes
  its ghost rows to its neighbours over ICI): on one card ONE cooperative
  launch runs the whole run of every shard, K3's ``step_tile`` over the
  k-step schedule's windows, and at each block start pushes every
  shard's core edge windows into its neighbours' landing buffers and
  splices them into the ghost rows, between grid barriers (the TPU
  kernel's data contract, ``csrc/slab_dma.cuh``). So a K4 run is the
  collective K3 run, and K2's/K6's unsharded run, to the bit. Each shard
  of a mesh posts its live buffers to the mesh's launch group
  (:func:`parallel.mesh.launch_group`), whose leader launches once. Its
  plain twin, :func:`slab_run_dma_reference`, runs the same schedule
  over K3's twins; the steppers declare the JAX ``remote_dma`` windows
  in ``stencil_spec()``.
* :func:`slab_run_diffusion_bf16` and :func:`slab_run_burgers_bf16` are
  K2's and K6's instances on bfloat16 buffers, one device (the JAX
  steppers' ``dtype=bfloat16``, ``fused_slab_run.py:1345-1354`` and
  ``:1632-1641``): each step upcasts its planes once, runs the three
  stages in float32 and rounds each output cell to bf16 once. Their
  twin is the float32 step on the upcast buffer, rounded once a step
  (:func:`rounded_step`). On a z-slab shard the same rule gives the bf16
  instances of K3 (:func:`slab_step_diffusion_bf16`,
  :func:`slab_step_burgers_bf16`; bf16 exchanged operands, the twin
  :func:`rounded_window`) and K4 (:func:`slab_run_dma_diffusion_bf16`,
  :func:`slab_run_dma_burgers_bf16`; bf16 landing buffers, so the
  in-kernel exchange moves half the bytes): a sharded bf16 run is the
  unsharded bf16 run to the bit.
* ``supported``/``profitable`` are the port's gates, for the H100, in
  place of the JAX package's TPU VMEM model (PERF.md lists the shapes
  where the two disagree).
* WENO7-JS (``params.order == 7``, reach 4, ``G = 12``) runs every
  Burgers slab kernel, K6, K2b, K3 and K4, on 24x24 tiles
  (``BURGERS_TILE7``: the three stages' windows of 32x32 tiles would need
  322 KB of shared memory); a shard keeps ``k*G = 12k`` ghost planes a
  side.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import fused_burgers as fb
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion_step as fds,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    R,
    STAGES,
    PaddedDiffusionState,
    _check,
    bf16_value,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    stage_reference as k1_stage_reference,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.stepper_base import (
    chunk_counts,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.halo import (
    record_remote_dma,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
    launch_group,
    wait_exchange,
)

BURGERS_SOURCE = "slab_run_burgers.cu"
# K6/K3/K4/K2b: 32x32 output tiles (csrc/slab_run_burgers.cu; 20x20 and
# 17x17 tiles at two blocks an SM were slower), one block an SM (its
# shared memory). A z chunk's two ends cost about as much as
# BURGERS_CHUNK_COST more planes (its windows' recompute and the
# pipeline's fill), which burgers_schedule weighs against rounding the
# jobs up to whole waves of resident blocks: chip_smoke.py phase 14 timed
# K6 at 400x400x406 on 132 blocks at 8.855, 8.946, 9.414, 8.504, 9.387 and
# 12.209 ms a step for chunks of 58, 68, 102, 136, 203 and 406 planes
# (H100 80GB HBM3, 700 W), which waves x (planes + 8.3) fits; the plan
# takes 136 there
BURGERS_TILE = 32
# the WENO7-JS instance's tiles (csrc/slab_run_burgers.cu, Reach<4>): the
# largest edge whose three stage windows fit a block's shared memory
BURGERS_TILE7 = 24
BURGERS_CHUNK_COST = 10
# the kernels index the state with 32-bit integers
MAX_CELLS = 2**31 - 1
# the largest grid (cells) on which K2 beat the K1 path beyond the spread
# (SlabRunDiffusionStepper.profitable)
K2_PROFITABLE_CELLS = 64 * 64 * 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# one entry a source for K2/K6 and K2b: the member count follows S1
_K2_ARGTYPES = (_P, _P, _I, _I, _I, _I, _P, _F, _I, _F, _I, _I, _P, _P,
                _P)
_K6_ARGTYPES = (_P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _F, _I, _I,
                _P, _P, _P)
# the bf16 instances' entries: K2's (one member, the pad value) and K6's
# (one member; its source built with K6_BF16 defined, a library of its own)
_K2H_ARGTYPES = (_P, _P, _I, _I, _I, _P, _F, _I, _F, _F, _I, _I, _P, _P, _P)
_K6H_ARGTYPES = (_P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _F, _I, _I, _P,
                 _P, _P)
K6_BF16_FLAGS = ("-DK6_BF16",)
_K3D_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                 _F, _I, _P)
_K3B_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                 _I, _P, _P, _F, _I, _P)
_K4D_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _F, _I, _I, _P,
                 _P, _P)
_K4B_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _F,
                 _I, _I, _P, _P, _P)
# the bf16 instances of K3 and K4, diffusion: the pad value after bc_value
# (Burgers' take the float32 entries' arguments)
_K3DH_ARGTYPES = _K3D_ARGTYPES[:16] + (_F,) + _K3D_ARGTYPES[16:]
_K4DH_ARGTYPES = _K4D_ARGTYPES[:12] + (_F,) + _K4D_ARGTYPES[12:]
# shards one K4 launch takes (DMA_MAX_SHARDS, csrc/slab_dma.cuh)
DMA_MAX_SHARDS = 64


def job_counters(device) -> torch.Tensor:
    """The two job counters (one a step parity) of a K2, K6, K2b or K4
    launch: zeroed device ints the kernel claims its jobs from."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def burgers_schedule(window: int, ny: int, nx: int, blocks: int,
                     units: int = 1, zchunk: int | None = None,
                     order: int = 5) -> dict:
    """One step's jobs of K6, K2b (``units`` members), K4 (``units``
    shards) or K3 on a ``window``-plane output window of an ``(ny, nx)``
    plane over ``blocks`` resident blocks: the 32x32 tiles (24x24 at
    order 7), a job's z planes, the chunks, the jobs and the waves (jobs
    a block). A job
    marches ``zchunk`` planes (the last chunk the rest); with None, the
    planned count: of the splits of the window into n = 1..16 near-equal
    chunks, the one whose jobs, rounded up to whole waves of ``blocks``,
    cost the least, a chunk costing its planes plus
    ``BURGERS_CHUNK_COST``."""
    edge = BURGERS_TILE7 if order == 7 else BURGERS_TILE
    tiles = -(-ny // edge) * -(-nx // edge)
    return fds.plan_jobs(window, tiles, blocks, units, zchunk,
                         lambda size, jobs: -(-jobs // blocks)
                         * (size + BURGERS_CHUNK_COST))


def burgers_zchunk(window: int, ny: int, nx: int, units: int,
                   device, order: int = 5) -> int:
    """The z planes of a job that the Burgers wrappers launch with when
    no ``zchunk`` is given: :func:`burgers_schedule`'s plan for one
    resident block an SM of ``device`` (both orders' instances hold one
    block an SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return burgers_schedule(window, ny, nx, sms, units,
                            order=order)["chunk_planes"]


def ping_pong(step, S0, S1, num_iters: int):
    """The plain twin of a slab run: ``step(src, dst)`` ``num_iters``
    times, alternating the buffers; returns the one that holds the
    result."""
    src, dst = S0, S1
    for _ in range(int(num_iters)):
        step(src, dst)
        src, dst = dst, src
    return src


def _launch_diffusion(S0, S1, num_iters: int, dt, taps, band, bc_value,
                      zchunk, grid_blocks):
    """Launch K2/K2b once on two ``(B, nz+4, ny+4, nx+4)`` CUDA buffers
    (K2 is the kernel at B = 1); ``grid_blocks``, a list, receives the
    grid's block count."""
    B = S0.shape[0]
    nz, ny, nx = (n - 2 * R for n in S0.shape[1:])
    host_taps = np.asarray(taps, dtype=np.float32)
    planes = zchunk or fds.diffusion_zchunk(nz, ny, nx, B, S0.device,
                                            cooperative=True)
    blocks = ctypes.c_int(0)
    counters = job_counters(S0.device)

    def kernel(S0, S1):
        return wr.library(fds.SOURCE, "slab_run_diffusion", _K2_ARGTYPES
                          ).slab_run_diffusion(
            S0.data_ptr(), S1.data_ptr(), B, nz, ny, nx,
            host_taps.ctypes.data, float(np.float32(dt)), int(band),
            float(bc_value), int(planes), int(num_iters),
            counters.data_ptr(), ctypes.byref(blocks), wr.stream_of(S0))

    wr.launch(kernel, S0, S1)
    if grid_blocks is not None:
        grid_blocks.append(blocks.value)


def slab_run_diffusion(S0, S1, num_iters: int, dt, *, taps, band, bc_value,
                       zchunk=None, grid_blocks: list | None = None):
    """``num_iters`` fused diffusion steps on two padded buffers (K1's
    layout, ghost rings at ``bc_value``), ``S0`` holding the initial
    state; returns the buffer that holds the result (``S0`` after an even
    count, ``S1`` after an odd one). ``dt`` is rounded to float32. A CUDA
    tensor launches K2 once on the current stream (no synchronisation),
    counted in ``slab_run_diffusion.launches``; ``grid_blocks``, a list,
    receives the grid's block count; a job marches ``zchunk`` z planes
    (None: ``fused_diffusion_step.diffusion_zchunk``'s plan for the
    card; the same for K2b, K3 and K4). A CPU tensor runs the twin."""
    fds.check_padded(S0, S1)
    if S0.device.type == "cpu":
        return ping_pong(lambda src, dst: fds.step_reference(
            src, dst, dt, taps=taps, band=band, bc_value=bc_value),
            S0, S1, num_iters)
    _launch_diffusion(S0[None], S1[None], num_iters, dt, taps, band,
                      bc_value, zchunk, grid_blocks)
    build.count_launch(slab_run_diffusion)
    return S1 if num_iters % 2 else S0


slab_run_diffusion.launches = 0


def rounded_step(step, src, dst):
    """The plain twin of one step of a bf16-buffer slab kernel: the float32
    ``step(src, dst)`` on the buffers' float32 values, ``dst`` rounded to
    bf16 once (cells the step leaves alone keep their bits)."""
    f = dst.float()
    step(src.float(), f)
    dst.copy_(f)


def slab_run_diffusion_bf16(S0, S1, num_iters: int, dt, *, taps, band,
                            bc_value, zchunk=None,
                            grid_blocks: list | None = None):
    """:func:`slab_run_diffusion` on bfloat16 buffers (K2's bf16
    instance): each step the float32 step of K2 on the upcast planes, its
    output rounded to bf16 once. A CUDA tensor launches the kernel once on
    the current stream, counted in ``slab_run_diffusion_bf16.launches``;
    a CPU tensor runs the twin, :func:`rounded_step` of
    ``fused_diffusion_step.step_reference``."""
    fds.check_padded(S0, S1, torch.bfloat16)
    if S0.device.type == "cpu":
        return ping_pong(lambda src, dst: rounded_step(
            lambda a, b: fds.step_reference(a, b, dt, taps=taps, band=band,
                                            bc_value=bc_value), src, dst),
            S0, S1, num_iters)
    nz, ny, nx = (n - 2 * R for n in S0.shape)
    host_taps = np.asarray(taps, dtype=np.float32)
    planes = zchunk or fds.diffusion_zchunk(nz, ny, nx, 1, S0.device,
                                            cooperative=True)
    blocks = ctypes.c_int(0)
    counters = job_counters(S0.device)

    def kernel(S0, S1):
        return wr.library(fds.SOURCE, "slab_run_diffusion_bf16",
                          _K2H_ARGTYPES).slab_run_diffusion_bf16(
            S0.data_ptr(), S1.data_ptr(), nz, ny, nx, host_taps.ctypes.data,
            float(np.float32(dt)), int(band), float(bc_value),
            bf16_value(bc_value), int(planes), int(num_iters),
            counters.data_ptr(), ctypes.byref(blocks), wr.stream_of(S0))

    wr.launch(kernel, S0, S1)
    if grid_blocks is not None:
        grid_blocks.append(blocks.value)
    build.count_launch(slab_run_diffusion_bf16)
    return S1 if num_iters % 2 else S0


slab_run_diffusion_bf16.launches = 0


def _check_batched(S0, S1, min_dim: int) -> None:
    """``S0`` and ``S1``: two different contiguous float32 buffers of one
    ``(B, ...)`` shape on one device, B >= 1."""
    _check("S1", S1, S0.shape, S0.device)
    _check("S0", S0, S0.shape, S0.device)
    if S0.dim() != 4 or S0.shape[0] < 1 or min(S0.shape[1:]) < min_dim:
        raise ValueError(f"(B, nz, ny, nx) buffers expected, got "
                         f"{tuple(S0.shape)}")
    if S0.data_ptr() == S1.data_ptr():
        raise ValueError("S0 and S1 must be different buffers")
    if S0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no slab kernel for device {S0.device}")


def ping_pong_members(step, S0, S1, num_iters: int):
    """The plain twin of a batched slab run: :func:`ping_pong` on every
    member's slices ``S0[i]``, ``S1[i]`` in turn; returns the buffer that
    holds every member's result."""
    for i in range(S0.shape[0]):
        ping_pong(step, S0[i], S1[i], num_iters)
    return S1 if num_iters % 2 else S0


def slab_run_diffusion_batched(S0, S1, num_iters: int, dt, *, taps, band,
                               bc_value, zchunk=None,
                               grid_blocks: list | None = None):
    """K2b, diffusion: :func:`slab_run_diffusion` for B members at once.
    ``S0``/``S1`` are ``(B, nz+4, ny+4, nx+4)``, every member's slice K1's
    padded layout with its ghost ring at ``bc_value``; ``S0`` holds the
    initial states. Returns the buffer that holds every member's result
    (``S0`` after an even count, ``S1`` after an odd one). A CUDA tensor
    launches the kernel once on the current stream for the whole batch,
    counted in ``slab_run_diffusion_batched.launches``; a CPU tensor runs
    the twin, K2's twin per member."""
    _check_batched(S0, S1, 2 * R + 1)
    if S0.device.type == "cpu":
        return ping_pong_members(lambda src, dst: fds.step_reference(
            src, dst, dt, taps=taps, band=band, bc_value=bc_value),
            S0, S1, num_iters)
    _launch_diffusion(S0, S1, num_iters, dt, taps, band, bc_value, zchunk,
                      grid_blocks)
    build.count_launch(slab_run_diffusion_batched)
    return S1 if num_iters % 2 else S0


slab_run_diffusion_batched.launches = 0


def burgers_step_reference(S, out, dt, *, params: fb.StageParams):
    """The plain twin of one fused Burgers step: ``out <- s3(s2(s1(S),
    S), S)``, three K5-twin stages (each reads its input clamped into the
    domain, the TPU kernel's edge fill); ``S`` unchanged; returns
    ``out``."""
    (a1, b1), (a2, b2), (a3, b3) = STAGES
    T1 = fb.stage_reference(S, None, torch.empty_like(S), dt, params=params,
                            a=a1, b=b1)
    T2 = fb.stage_reference(T1, S, torch.empty_like(S), dt, params=params,
                            a=a2, b=b2)
    return fb.stage_reference(T2, S, out, dt, params=params, a=a3, b=b3)


def _burgers_args(params: fb.StageParams):
    """K6's/K2b's host arguments for ``params``: the flux code, the
    linear speed, the variant flag, ``inv_dx`` and the viscous taps (or
    ``None``), the arrays kept alive by the caller."""
    inv_dx = np.asarray(params.inv_dx, dtype=np.float32)
    taps = (None if params.lap_taps is None
            else np.asarray(params.lap_taps, dtype=np.float32))
    c = params.flux.c if params.flux.c is not None else 0.0
    return (fb.FLUX_CODES[params.flux.name], float(c),
            int(params.variant == "z"), inv_dx, taps)


def _launch_burgers(S0, S1, num_iters: int, dt, params, zchunk,
                    grid_blocks):
    """Launch K6/K2b once on two ``(B, nz, ny, nx)`` CUDA buffers (K6 is
    the kernel at B = 1); ``grid_blocks``, a list, receives the grid's
    block count."""
    B, nz, ny, nx = S0.shape
    code, c, weno_z, inv_dx, taps = _burgers_args(params)
    planes = zchunk or burgers_zchunk(nz, ny, nx, B, S0.device,
                                      params.order)
    blocks = ctypes.c_int(0)
    counters = job_counters(S0.device)

    def kernel(S0, S1):
        return wr.library(BURGERS_SOURCE, "slab_run_burgers", _K6_ARGTYPES,
                          fb.NVCC_EXTRA).slab_run_burgers(
            S0.data_ptr(), S1.data_ptr(), B, nz, ny, nx, code, c, weno_z,
            params.order, inv_dx.ctypes.data,
            None if taps is None else taps.ctypes.data,
            float(np.float32(dt)), planes, int(num_iters),
            counters.data_ptr(), ctypes.byref(blocks), wr.stream_of(S0))

    wr.launch(kernel, S0, S1)
    if grid_blocks is not None:
        grid_blocks.append(blocks.value)


def slab_run_burgers(S0, S1, num_iters: int, dt, *, params: fb.StageParams,
                     zchunk=None,
                     grid_blocks: list | None = None):
    """``num_iters`` fused fixed-dt WENO steps (``params.order`` 5 or 7)
    on two unpadded ``(nz, ny, nx)`` buffers, ``S0`` holding the initial
    state; returns
    the buffer that holds the result (``S0`` after an even count, ``S1``
    after an odd one). ``dt`` is rounded to float32. A CUDA tensor
    launches K6 once on the current stream (no synchronisation), counted
    in ``slab_run_burgers.launches``; ``grid_blocks``, a list, receives
    the grid's block count; a job marches ``zchunk`` z planes (None:
    :func:`burgers_zchunk`'s plan for the card; the same for K2b, K3 and
    K4). A CPU tensor runs the twin."""
    _check("S1", S1, S0.shape, S0.device)
    _check("S0", S0, S0.shape, S0.device)
    if S0.dim() != 3:
        raise ValueError(f"3-D state expected, got {tuple(S0.shape)}")
    if S0.data_ptr() == S1.data_ptr():
        raise ValueError("S0 and S1 must be different buffers")
    if S0.device.type == "cpu":
        return ping_pong(lambda src, dst: burgers_step_reference(
            src, dst, dt, params=params), S0, S1, num_iters)
    if S0.device.type != "cuda":
        raise ValueError(f"no slab kernel for device {S0.device}")
    _launch_burgers(S0[None], S1[None], num_iters, dt, params, zchunk,
                    grid_blocks)
    build.count_launch(slab_run_burgers)
    return S1 if num_iters % 2 else S0


slab_run_burgers.launches = 0


def slab_run_burgers_bf16(S0, S1, num_iters: int, dt, *,
                          params: fb.StageParams, zchunk=None,
                          grid_blocks: list | None = None):
    """:func:`slab_run_burgers` on bfloat16 buffers (K6's bf16 instance,
    either order): each step the float32 step of K6 on the upcast planes,
    its output rounded to bf16 once. A CUDA tensor launches the kernel
    once on the current stream, counted in
    ``slab_run_burgers_bf16.launches``; a CPU tensor runs the twin,
    :func:`rounded_step` of :func:`burgers_step_reference`."""
    _check("S1", S1, S0.shape, S0.device, torch.bfloat16)
    _check("S0", S0, S0.shape, S0.device, torch.bfloat16)
    if S0.dim() != 3:
        raise ValueError(f"3-D state expected, got {tuple(S0.shape)}")
    if S0.data_ptr() == S1.data_ptr():
        raise ValueError("S0 and S1 must be different buffers")
    if S0.device.type == "cpu":
        return ping_pong(lambda src, dst: rounded_step(
            lambda a, b: burgers_step_reference(a, b, dt, params=params),
            src, dst), S0, S1, num_iters)
    if S0.device.type != "cuda":
        raise ValueError(f"no slab kernel for device {S0.device}")
    nz, ny, nx = S0.shape
    code, c, weno_z, inv_dx, taps = _burgers_args(params)
    planes = zchunk or burgers_zchunk(nz, ny, nx, 1, S0.device,
                                      params.order)
    blocks = ctypes.c_int(0)
    counters = job_counters(S0.device)

    def kernel(S0, S1):
        return wr.library(BURGERS_SOURCE, "slab_run_burgers_bf16",
                          _K6H_ARGTYPES, fb.NVCC_EXTRA + K6_BF16_FLAGS
                          ).slab_run_burgers_bf16(
            S0.data_ptr(), S1.data_ptr(), nz, ny, nx, code, c, weno_z,
            params.order, inv_dx.ctypes.data,
            None if taps is None else taps.ctypes.data,
            float(np.float32(dt)), planes, int(num_iters),
            counters.data_ptr(), ctypes.byref(blocks), wr.stream_of(S0))

    wr.launch(kernel, S0, S1)
    if grid_blocks is not None:
        grid_blocks.append(blocks.value)
    build.count_launch(slab_run_burgers_bf16)
    return S1 if num_iters % 2 else S0


slab_run_burgers_bf16.launches = 0


def slab_run_burgers_batched(S0, S1, num_iters: int, dt, *,
                             params: fb.StageParams,
                             zchunk=None,
                             grid_blocks: list | None = None):
    """K2b, Burgers: :func:`slab_run_burgers` for B members at once.
    ``S0``/``S1`` are ``(B, nz, ny, nx)``, every member's slice K6's
    unpadded layout; ``S0`` holds the initial states. Returns the buffer
    that holds every member's result (``S0`` after an even count, ``S1``
    after an odd one). A CUDA tensor launches the kernel once on the
    current stream for the whole batch, counted in
    ``slab_run_burgers_batched.launches``; a CPU tensor runs the twin,
    K6's twin per member. Member ``i`` is K6's run of member ``i`` alone
    at either order."""
    _check_batched(S0, S1, 1)
    if S0.device.type == "cpu":
        return ping_pong_members(lambda src, dst: burgers_step_reference(
            src, dst, dt, params=params), S0, S1, num_iters)
    _launch_burgers(S0, S1, num_iters, dt, params, zchunk, grid_blocks)
    build.count_launch(slab_run_burgers_batched)
    return S1 if num_iters % 2 else S0


slab_run_burgers_batched.launches = 0


# --------------------------------------------------------------------- #
# K3: one step over an output window of a shard
# --------------------------------------------------------------------- #
def _check_window(S, out, lo, hi, *, depth, window, global_nz, oz, reach,
                  dtype=torch.float32):
    """Check a K3 call and return its global window and the buffer row of
    global plane 0. ``S``/``out``: a shard's ``(lz + 2 depth, ...)``
    buffers of ``dtype``; ``window``, ``(z_lo, z_hi)`` in block planes;
    ``reach``, the input box's planes a side (G)."""
    _check("out", out, S.shape, S.device, dtype)
    _check("S", S, S.shape, S.device, dtype)
    if S.dim() != 3 or S.data_ptr() == out.data_ptr():
        raise ValueError("two different 3-D buffers expected")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no slab kernel for device {S.device}")
    pz = S.shape[0]
    lz = pz - 2 * depth
    z_lo, z_hi = (int(w) for w in window)
    g_lo, g_hi = oz + z_lo, oz + z_hi
    row_off = depth - oz
    first = max(g_lo - reach, 0) + row_off
    last = min(g_hi + reach, global_nz) - 1 + row_off
    if (depth < 0 or lz < 1 or z_lo >= z_hi or not 0 <= oz <= global_nz - lz
            or first < 0 or last >= pz):
        raise ValueError(
            f"window {window} (box {reach} planes a side) of a block of {lz} "
            f"planes at {oz} of {global_nz} does not fit its buffer of {pz}")
    for name, t in (("lo", lo), ("hi", hi)):
        if t is not None:
            _check(name, t, (depth,) + tuple(S.shape[1:]), S.device, dtype)
    return g_lo, g_hi, row_off


def _upcast(t):
    return None if t is None else t.float()


def rounded_window(reference, S, out, lo=None, hi=None, **kw):
    """The plain twin of a bf16-buffer K3 call: ``reference`` (K3's
    float32 twin) on the buffers' and operands' float32 values, the
    window it writes rounded to bf16 once (other cells keep their
    bits); returns ``out``."""
    rounded_step(lambda a, b: reference(a, b, lo=_upcast(lo),
                                        hi=_upcast(hi), **kw), S, out)
    return out


def _with_operands(S, lo, hi, depth: int):
    """``S`` with its first/last ``depth`` planes replaced by ``lo``/``hi``
    (a copy when either is given)."""
    if lo is None and hi is None:
        return S
    S = S.clone()
    if lo is not None:
        S[:depth] = lo
    if hi is not None:
        S[S.shape[0] - depth:] = hi
    return S


def slab_step_diffusion_reference(S, out, dt, *, taps, band, bc_value,
                                  global_nz, oz, depth, window, lo=None,
                                  hi=None, pad_value=None):
    """The plain twin of K3, diffusion: the window's input box assembled
    by global z (planes outside the global domain at ``pad_value``,
    default ``bc_value``), three K1-twin stages with global masks, the
    window's in-domain planes written to ``out``; returns ``out``."""
    g_lo, g_hi, row_off = _check_window(
        S, out, lo, hi, depth=depth, window=window, global_nz=global_nz,
        oz=oz, reach=3 * R)
    Sv = _with_operands(S, lo, hi, depth)
    g = torch.arange(g_lo - 3 * R, g_hi + 3 * R, device=S.device)
    inside = (g >= 0) & (g < global_nz)
    rows = (g + row_off).clamp_(0, S.shape[0] - 1)
    B = Sv.index_select(0, rows)
    B[~inside] = bc_value if pad_value is None else pad_value
    L = g_hi - g_lo
    gshape = (global_nz, S.shape[1] - 2 * R, S.shape[2] - 2 * R)
    kw = dict(taps=taps, band=band, bc_value=bc_value, global_shape=gshape)
    (a1, b1), (a2, b2), (a3, b3) = STAGES
    T1 = k1_stage_reference(B, None, B.clone(), dt, a=a1, b=b1,
                            offsets=(g_lo - 2 * R, 0, 0), **kw)
    v2, u2 = T1[R:L + 5 * R], B[R:L + 5 * R]
    T2 = k1_stage_reference(v2, u2, u2.clone(), dt, a=a2, b=b2,
                            offsets=(g_lo - R, 0, 0), **kw)
    v3, u3 = T2[R:L + 3 * R], B[2 * R:L + 4 * R]
    O = k1_stage_reference(v3, u3, u3.clone(), dt, a=a3, b=b3,
                           offsets=(g_lo, 0, 0), **kw)
    d_lo, d_hi = max(g_lo, 0), min(g_hi, global_nz)
    out[d_lo + row_off:d_hi + row_off, R:-R, R:-R] = (
        O[R + d_lo - g_lo:R + d_hi - g_lo, R:-R, R:-R])
    return out


def slab_step_diffusion(S, out, dt, *, taps, band, bc_value, global_nz, oz,
                        depth, window, lo=None, hi=None, zchunk=None):
    """K3, diffusion: one fused step over the block planes ``window =
    (z_lo, z_hi)`` of a shard (``oz``: its global z offset, of
    ``global_nz``), ``S`` -> ``out``; both ``(lz + 2 depth, ny+4, nx+4)``
    with the block at row ``depth``. The window may reach into the ghost
    rows (the k-step schedule); ``lo``/``hi`` (``(depth, ny+4, nx+4)``)
    stand in for the first/last ``depth`` rows (the split schedule's edge
    calls). ``dt`` is rounded to float32. A CUDA tensor launches the
    kernel once on the current stream (no synchronisation), counted in
    ``slab_step_diffusion.launches``; a CPU tensor runs the twin."""
    kw = dict(depth=depth, window=window, global_nz=global_nz, oz=oz)
    if S.device.type == "cpu":
        return slab_step_diffusion_reference(
            S, out, dt, taps=taps, band=band, bc_value=bc_value, lo=lo,
            hi=hi, **kw)
    _launch_step_diffusion(S, out, lo, hi, dt, taps, band, bc_value,
                           zchunk, torch.float32, **kw)
    build.count_launch(slab_step_diffusion)
    return out


slab_step_diffusion.launches = 0


def _launch_step_diffusion(S, out, lo, hi, dt, taps, band, bc_value, zchunk,
                           dtype, *, depth, window, global_nz, oz):
    """Check a diffusion K3 call on CUDA buffers of ``dtype`` and launch
    its entry (the bf16 one takes the pad value ``bf16(bc_value)`` too)
    on the current stream."""
    g_lo, g_hi, row_off = _check_window(
        S, out, lo, hi, depth=depth, window=window, global_nz=global_nz,
        oz=oz, reach=3 * R, dtype=dtype)
    host_taps = np.asarray(taps, dtype=np.float32)
    ny, nx = S.shape[1] - 2 * R, S.shape[2] - 2 * R
    planes = zchunk or fds.diffusion_zchunk(g_hi - g_lo, ny, nx, 1,
                                            S.device)
    bf16 = dtype == torch.bfloat16
    symbol = "slab_step_diffusion_bf16" if bf16 else "slab_step_diffusion"
    fn = getattr(wr.library(fds.SOURCE, symbol,
                            _K3DH_ARGTYPES if bf16 else _K3D_ARGTYPES),
                 symbol)
    pad = (bf16_value(bc_value),) if bf16 else ()

    def kernel(S, out):
        return fn(
            S.data_ptr(), out.data_ptr(),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), S.shape[0], int(depth),
            int(global_nz), ny, nx, row_off, g_lo, g_hi,
            host_taps.ctypes.data, float(np.float32(dt)), int(band),
            float(bc_value), *pad, int(planes), wr.stream_of(S))

    wr.launch(kernel, S, out)


def slab_step_diffusion_bf16(S, out, dt, *, taps, band, bc_value, global_nz,
                             oz, depth, window, lo=None, hi=None,
                             zchunk=None):
    """:func:`slab_step_diffusion` on bfloat16 buffers and operands (K3's
    bf16 instance): the float32 step on the upcast planes, each written
    cell rounded to bf16 once; planes outside the global domain read
    ``bf16(bc_value)``, the unsharded bf16 ghost ring's value, so a
    window is K2's bf16 step to the bit. A CUDA tensor launches the kernel
    once on the current stream, counted in
    ``slab_step_diffusion_bf16.launches``; a CPU tensor runs the twin,
    :func:`rounded_window` of :func:`slab_step_diffusion_reference`."""
    kw = dict(depth=depth, window=window, global_nz=global_nz, oz=oz)
    if S.device.type == "cpu":
        _check_window(S, out, lo, hi, reach=3 * R, dtype=torch.bfloat16,
                      **kw)
        return rounded_window(
            slab_step_diffusion_reference, S, out, lo, hi, dt=dt, taps=taps,
            band=band, bc_value=bc_value, pad_value=bf16_value(bc_value),
            **kw)
    _launch_step_diffusion(S, out, lo, hi, dt, taps, band, bc_value,
                           zchunk, torch.bfloat16, **kw)
    build.count_launch(slab_step_diffusion_bf16)
    return out


slab_step_diffusion_bf16.launches = 0


def slab_step_burgers_reference(S, out, dt, *, params: fb.StageParams,
                                global_nz, oz, depth, window, lo=None,
                                hi=None):
    """The plain twin of K3, Burgers: three K5-twin stages on the
    window's planes, each over the global planes its successor reads,
    every z neighbour clamped into the global domain; the window's
    in-domain planes written to ``out``; returns ``out``. The reach ``r``
    and the box's ``G = 3r`` planes a side follow ``params.order``."""
    r = params.r
    G = 3 * r
    g_lo, g_hi, row_off = _check_window(
        S, out, lo, hi, depth=depth, window=window, global_nz=global_nz,
        oz=oz, reach=G)
    Sv = _with_operands(S, lo, hi, depth)

    def span(a, b):
        return max(a, 0), min(b, global_nz)

    def zpadded(src, src_lo, a, b):
        # planes [a, b) of a stage's input with r clamped neighbours a
        # side: rows of ``src``, whose first row is global plane src_lo
        g = torch.arange(a - r, b + r, device=S.device)
        return fb._edge_pad_trailing(
            src.index_select(0, g.clamp_(0, global_nz - 1) - src_lo), r)

    a0, b0 = span(g_lo - G, g_hi + G)
    src, src_lo = Sv[a0 + row_off:b0 + row_off], a0
    (a1, b1), (a2, b2), (a3, b3) = STAGES
    for (a, b), (lo_g, hi_g) in (((a1, b1), span(g_lo - 2 * r, g_hi + 2 * r)),
                                 ((a2, b2), span(g_lo - r, g_hi + r)),
                                 ((a3, b3), span(g_lo, g_hi))):
        v = src[lo_g - src_lo:hi_g - src_lo]
        u = None if a == 0.0 else Sv[lo_g + row_off:hi_g + row_off]
        src = fb._stage_rk(zpadded(src, src_lo, lo_g, hi_g), v, u, dt,
                           params, a, b)
        src_lo = lo_g
    out[src_lo + row_off:src_lo + row_off + src.shape[0]] = src
    return out


def _launch_step_burgers(symbol, flags, S, out, lo, hi, dt, params, depth,
                         global_nz, window, oz, zchunk, dtype):
    """Check a Burgers K3 call on CUDA buffers of ``dtype`` and launch
    ``symbol`` of the source built with ``flags`` on the current
    stream."""
    g_lo, g_hi, row_off = _check_window(
        S, out, lo, hi, depth=depth, window=window, global_nz=global_nz,
        oz=oz, reach=3 * params.r, dtype=dtype)
    code, c, weno_z, inv_dx, taps = _burgers_args(params)
    planes = zchunk or burgers_zchunk(g_hi - g_lo, *S.shape[1:], 1,
                                      S.device, params.order)
    fn = getattr(wr.library(BURGERS_SOURCE, symbol, _K3B_ARGTYPES, flags),
                 symbol)

    def kernel(S, out):
        return fn(
            S.data_ptr(), out.data_ptr(),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), S.shape[0], int(depth),
            int(global_nz), S.shape[1], S.shape[2], row_off, g_lo, g_hi,
            code, c, weno_z, params.order, inv_dx.ctypes.data,
            None if taps is None else taps.ctypes.data,
            float(np.float32(dt)), planes, wr.stream_of(S))

    wr.launch(kernel, S, out)


def slab_step_burgers(S, out, dt, *, params: fb.StageParams, global_nz, oz,
                      depth, window, lo=None, hi=None,
                      zchunk=None):
    """K3, Burgers: one fixed-dt fused step (``params.order`` 5 or 7) over
    the block planes ``window`` of a shard, ``S`` -> ``out``, both ``(lz +
    2 depth, ny, nx)`` with the block at row ``depth`` (arguments as
    :func:`slab_step_diffusion`'s; the input box reaches ``G = 3r``
    planes past the window, 9 or 12). A CUDA tensor launches the kernel
    once on the current stream, counted in ``slab_step_burgers.launches``;
    a CPU tensor runs the twin."""
    kw = dict(depth=depth, window=window, global_nz=global_nz, oz=oz)
    if S.device.type == "cpu":
        return slab_step_burgers_reference(S, out, dt, params=params, lo=lo,
                                           hi=hi, **kw)
    _launch_step_burgers("slab_step_burgers", fb.NVCC_EXTRA, S, out, lo, hi,
                         dt, params, zchunk=zchunk, dtype=torch.float32,
                         **kw)
    build.count_launch(slab_step_burgers)
    return out


slab_step_burgers.launches = 0


def slab_step_burgers_bf16(S, out, dt, *, params: fb.StageParams, global_nz,
                           oz, depth, window, lo=None, hi=None, zchunk=None):
    """:func:`slab_step_burgers` on bfloat16 buffers and operands (K3's
    bf16 instance, either order, in the source built with
    ``K6_BF16_FLAGS``): the float32 step on the upcast planes, each
    written cell rounded to bf16 once, so a window is K6's bf16 step to
    the bit. A CUDA tensor launches the kernel once on the current
    stream, counted in ``slab_step_burgers_bf16.launches``; a CPU tensor
    runs the twin, :func:`rounded_window` of
    :func:`slab_step_burgers_reference`."""
    kw = dict(depth=depth, window=window, global_nz=global_nz, oz=oz)
    if S.device.type == "cpu":
        _check_window(S, out, lo, hi, reach=3 * params.r,
                      dtype=torch.bfloat16, **kw)
        return rounded_window(slab_step_burgers_reference, S, out, lo, hi,
                              dt=dt, params=params, **kw)
    _launch_step_burgers("slab_step_burgers_bf16",
                         fb.NVCC_EXTRA + K6_BF16_FLAGS, S, out, lo, hi, dt,
                         params, zchunk=zchunk, dtype=torch.bfloat16, **kw)
    build.count_launch(slab_step_burgers_bf16)
    return out


slab_step_burgers_bf16.launches = 0


# --------------------------------------------------------------------- #
# K4: the whole sharded run of every shard of a card, ghost rows moved
# inside the kernel
# --------------------------------------------------------------------- #
def _check_dma(S0s, S1s, lands, k: int, G: int,
               dtype=torch.float32) -> int:
    """Check a K4 call and return the shards' core planes ``lz``: one
    list entry a shard, in z order, every shard's two state buffers of
    one ``(lz + 2 depth, ...)`` shape (``depth = k*G``, ``lz >= depth``)
    and its landing buffer ``(2, 2, depth, ...)``, contiguous ``dtype``
    on one device."""
    n = len(S0s)
    if not 1 <= n <= DMA_MAX_SHARDS or len(S1s) != n or len(lands) != n:
        raise ValueError(f"one S0, S1 and landing buffer a shard, 1 to "
                         f"{DMA_MAX_SHARDS} shards")
    S = S0s[0]
    depth = int(k) * G
    if S.dim() != 3 or k < 1:
        raise ValueError(f"3-D shard buffers expected, got {tuple(S.shape)}")
    lz = S.shape[0] - 2 * depth
    if lz < depth:
        raise ValueError(
            f"local z extent {lz} cannot serve the {depth}-deep in-kernel "
            "exchange")
    land_shape = (2, 2, depth) + tuple(S.shape[1:])
    for i in range(n):
        _check("S0", S0s[i], S.shape, S.device, dtype)
        _check("S1", S1s[i], S.shape, S.device, dtype)
        _check("land", lands[i], land_shape, S.device, dtype)
    if len({t.data_ptr() for t in (*S0s, *S1s, *lands)}) != 3 * n:
        raise ValueError("every buffer of a K4 call must be its own")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no slab kernel for device {S.device}")
    return lz


def slab_run_dma_reference(step, S0s, S1s, lands, num_iters: int, *, k: int,
                           G: int):
    """The plain twin of K4 (``fused_slab_run.py:327-505``): the TPU
    kernel's schedule over every shard, ``step(src, dst, window, oz)``
    being K3's twin over a window of shard ``i`` (``oz = i*lz``). At the
    start of each block of ``k`` steps, in the read parity's buffers,
    every shard pushes its top core window (rows ``[pz-2d, pz-d)``, ``d =
    k*G``) into the ``+z`` neighbour's landing slot ``(b % 2, 0)`` and
    its bottom one (rows ``[d, 2d)``) into the ``-z`` neighbour's ``(b %
    2, 1)``, a ring; then each shard splices its landed rows into its
    ghost rows, the wall sides excepted. Step ``j`` of a block writes the
    core widened by ``(k-1-j)*G`` planes a side. Returns the list of
    buffers that holds the result (``S0s`` after an even count)."""
    n = len(S0s)
    depth = k * G
    pz = S0s[0].shape[0]
    lz = pz - 2 * depth
    bufs = (S0s, S1s)
    for s in range(int(num_iters)):
        j, b = s % k, s // k
        src, dst = bufs[s % 2], bufs[1 - s % 2]
        if j == 0:
            slot = b % 2
            for i in range(n):
                lands[(i + 1) % n][slot, 0].copy_(
                    src[i][pz - 2 * depth:pz - depth])
                lands[(i - 1) % n][slot, 1].copy_(src[i][depth:2 * depth])
            for i in range(n):
                if i > 0:
                    src[i][:depth].copy_(lands[i][slot, 0])
                if i < n - 1:
                    src[i][pz - depth:].copy_(lands[i][slot, 1])
        w = (k - 1 - j) * G
        for i in range(n):
            step(src[i], dst[i], (-w, lz + w), i * lz)
    return bufs[int(num_iters) % 2]


def _ptrs(ts) -> np.ndarray:
    """The device pointers of ``ts``, a host array the launch reads."""
    return np.asarray([t.data_ptr() for t in ts], dtype=np.uint64)


def _launch_dma(source, symbol, argtypes, extra, S0s, S1s, lands, lz, k,
                grid_blocks, *args):
    """Launch K4 once through ``symbol`` of ``source``: the shards'
    pointer tables and shape, then ``args``; ``grid_blocks``, a list,
    receives the grid's block count."""
    tables = [_ptrs(x) for x in (S0s, S1s, lands)]
    blocks = ctypes.c_int(0)
    counters = job_counters(S0s[0].device)
    fn = getattr(wr.library(source, symbol, argtypes, extra), symbol)

    def kernel(S):
        return fn(*(t.ctypes.data for t in tables), len(S0s), lz, k, *args,
                  counters.data_ptr(), ctypes.byref(blocks),
                  wr.stream_of(S))

    wr.launch(kernel, S0s[0])
    if grid_blocks is not None:
        grid_blocks.append(blocks.value)


def slab_run_dma_diffusion(S0s, S1s, lands, num_iters: int, dt, *, taps,
                           band, bc_value, k: int = 1, zchunk=None,
                           grid_blocks: list | None = None):
    """K4, diffusion: ``num_iters`` fused steps of every shard of a
    z-slab mesh at once. One list entry a shard, in z order: its two
    ``(lz + 2 depth, ny+4, nx+4)`` state buffers (``depth = 6k``, the
    core at row ``depth``, the ghost ring at ``bc_value``; ``S0s`` holds
    the initial states) and its ``(2, 2, depth, ny+4, nx+4)`` landing
    buffer; ``k`` steps a ghost exchange. Returns the list that holds
    the result (``S0s`` after an even count, ``S1s`` after an odd one).
    A CUDA tensor launches the kernel once on the current stream for
    every shard (no synchronisation), counted in
    ``slab_run_dma_diffusion.launches``; ``grid_blocks``, a list,
    receives the grid's block count. A CPU tensor runs the twin,
    :func:`slab_run_dma_reference` over K3's."""
    G = 3 * R
    lz = _check_dma(S0s, S1s, lands, k, G)
    if S0s[0].device.type == "cpu":
        gnz = len(S0s) * lz
        return slab_run_dma_reference(
            lambda S, out, window, oz: slab_step_diffusion_reference(
                S, out, dt, taps=taps, band=band, bc_value=bc_value,
                global_nz=gnz, oz=oz, depth=k * G, window=window),
            S0s, S1s, lands, num_iters, k=k, G=G)
    _launch_dma_diffusion("slab_run_dma_diffusion", _K4D_ARGTYPES, (),
                          S0s, S1s, lands, lz, num_iters, dt, taps, band,
                          bc_value, k, zchunk, grid_blocks)
    build.count_launch(slab_run_dma_diffusion)
    return S1s if num_iters % 2 else S0s


slab_run_dma_diffusion.launches = 0


def _launch_dma_diffusion(symbol, argtypes, pad, S0s, S1s, lands, lz,
                          num_iters, dt, taps, band, bc_value, k, zchunk,
                          grid_blocks):
    """Launch a diffusion K4 entry, ``pad`` the bf16 one's pad value (or
    nothing) after ``bc_value``."""
    ny, nx = (n - 2 * R for n in S0s[0].shape[1:])
    host_taps = np.asarray(taps, dtype=np.float32)
    _launch_dma(fds.SOURCE, symbol, argtypes, (), S0s, S1s, lands, lz,
                int(k), grid_blocks, ny, nx, host_taps.ctypes.data,
                float(np.float32(dt)), int(band), float(bc_value), *pad,
                zchunk or fds.diffusion_zchunk(lz, ny, nx, len(S0s),
                                               S0s[0].device,
                                               cooperative=True),
                int(num_iters))


def slab_run_dma_diffusion_bf16(S0s, S1s, lands, num_iters: int, dt, *,
                                taps, band, bc_value, k: int = 1,
                                zchunk=None,
                                grid_blocks: list | None = None):
    """:func:`slab_run_dma_diffusion` on bfloat16 state and landing
    buffers (K4's bf16 instance): each step K3's bf16 step, the in-kernel
    exchange moving bf16 rows (half the bytes). A CUDA tensor launches
    the kernel once on the current stream for every shard, counted in
    ``slab_run_dma_diffusion_bf16.launches``; a CPU tensor runs the twin,
    :func:`slab_run_dma_reference` over K3's bf16 twin."""
    G = 3 * R
    lz = _check_dma(S0s, S1s, lands, k, G, torch.bfloat16)
    if S0s[0].device.type == "cpu":
        gnz = len(S0s) * lz
        return slab_run_dma_reference(
            lambda S, out, window, oz: rounded_window(
                slab_step_diffusion_reference, S, out, dt=dt, taps=taps,
                band=band, bc_value=bc_value,
                pad_value=bf16_value(bc_value), global_nz=gnz, oz=oz,
                depth=k * G, window=window),
            S0s, S1s, lands, num_iters, k=k, G=G)
    _launch_dma_diffusion("slab_run_dma_diffusion_bf16", _K4DH_ARGTYPES,
                          (bf16_value(bc_value),), S0s, S1s, lands, lz,
                          num_iters, dt, taps, band, bc_value, k, zchunk,
                          grid_blocks)
    build.count_launch(slab_run_dma_diffusion_bf16)
    return S1s if num_iters % 2 else S0s


slab_run_dma_diffusion_bf16.launches = 0


def slab_run_dma_burgers(S0s, S1s, lands, num_iters: int, dt, *,
                         params: fb.StageParams, k: int = 1,
                         zchunk=None,
                         grid_blocks: list | None = None):
    """K4, Burgers: :func:`slab_run_dma_diffusion` for fixed-dt WENO steps
    (``params.order`` 5 or 7) on K3's unpadded shard layout, state
    buffers ``(lz + 2 depth, ny, nx)`` and landing buffers ``(2, 2, depth,
    ny, nx)``, ``depth = kG`` (``G = 3r``: 9 at order 5, 12 at order 7);
    counted in ``slab_run_dma_burgers.launches``."""
    G = 3 * params.r
    lz = _check_dma(S0s, S1s, lands, k, G)
    if S0s[0].device.type == "cpu":
        gnz = len(S0s) * lz
        return slab_run_dma_reference(
            lambda S, out, window, oz: slab_step_burgers_reference(
                S, out, dt, params=params, global_nz=gnz, oz=oz,
                depth=k * G, window=window),
            S0s, S1s, lands, num_iters, k=k, G=G)
    _launch_dma_burgers("slab_run_dma_burgers", fb.NVCC_EXTRA, S0s, S1s,
                        lands, lz, num_iters, dt, params, k, zchunk,
                        grid_blocks)
    build.count_launch(slab_run_dma_burgers)
    return S1s if num_iters % 2 else S0s


slab_run_dma_burgers.launches = 0


def _launch_dma_burgers(symbol, flags, S0s, S1s, lands, lz, num_iters, dt,
                        params, k, zchunk, grid_blocks):
    """Launch a Burgers K4 entry of the source built with ``flags``."""
    code, c, weno_z, inv_dx, taps = _burgers_args(params)
    _launch_dma(BURGERS_SOURCE, symbol, _K4B_ARGTYPES, flags, S0s, S1s,
                lands, lz, int(k), grid_blocks, S0s[0].shape[1],
                S0s[0].shape[2], code, c, weno_z, params.order,
                inv_dx.ctypes.data,
                None if taps is None else taps.ctypes.data,
                float(np.float32(dt)),
                zchunk or burgers_zchunk(lz, *S0s[0].shape[1:], len(S0s),
                                         S0s[0].device, params.order),
                int(num_iters))


def slab_run_dma_burgers_bf16(S0s, S1s, lands, num_iters: int, dt, *,
                              params: fb.StageParams, k: int = 1,
                              zchunk=None,
                              grid_blocks: list | None = None):
    """:func:`slab_run_dma_burgers` on bfloat16 state and landing buffers
    (K4's bf16 instance, either order, in the source built with
    ``K6_BF16_FLAGS``): each step K3's bf16 step; counted in
    ``slab_run_dma_burgers_bf16.launches``; a CPU tensor runs
    :func:`slab_run_dma_reference` over K3's bf16 twin."""
    G = 3 * params.r
    lz = _check_dma(S0s, S1s, lands, k, G, torch.bfloat16)
    if S0s[0].device.type == "cpu":
        gnz = len(S0s) * lz
        return slab_run_dma_reference(
            lambda S, out, window, oz: rounded_window(
                slab_step_burgers_reference, S, out, dt=dt, params=params,
                global_nz=gnz, oz=oz, depth=k * G, window=window),
            S0s, S1s, lands, num_iters, k=k, G=G)
    _launch_dma_burgers("slab_run_dma_burgers_bf16",
                        fb.NVCC_EXTRA + K6_BF16_FLAGS, S0s, S1s, lands, lz,
                        num_iters, dt, params, k, zchunk, grid_blocks)
    build.count_launch(slab_run_dma_burgers_bf16)
    return S1s if num_iters % 2 else S0s


slab_run_dma_burgers_bf16.launches = 0


class _SlabRunStepper:
    """What the two slab steppers share: the label, the unsharded
    ``run`` (``fused_slab_run.py:1080-1098``), the B-folded
    ``run_batched`` (``:902-945``) and, on a shard, the per-step, split
    and k-step schedules over K3 (``:1024-1202``)."""

    engaged_label = "fused-whole-run-slab"
    # the member axis of run_batched has no stencil reach: members share
    # no cell (the JAX steppers' declaration, ``:650-657``)
    members = 1
    member_halo = 0
    sharded = False
    overlap_split = False
    k = steps_per_exchange = 1
    # all three RK stages recompute per ghost exchange: G = 3h
    fused_stages = 3
    stencil_radius = None  # h: the subclasses declare it
    # the halo transport of a shard (``:658-667``): "collective" (the
    # K3 schedules, the exchange between launches) or "dma" (K4, the
    # exchange inside the kernel, declared in ``remote_dma``);
    # ``_init_exchange`` arms it
    exchange = "collective"
    remote_dma = None
    mesh_axis = None
    num_shards = None

    def stencil_spec(self) -> dict:
        """The slab rung's stencil and halo contract, the JAX steppers'
        keys and values (``:669-699``): ``ghost_depth`` is ``G = 3h``,
        the exchange moves ``k*G`` rows, ``remote_dma`` is the in-kernel
        exchange's declared windows (``None`` under the collective
        exchange)."""
        return {
            "kernel": self.engaged_label,
            "stage_radius": int(self.stencil_radius),
            "fused_stages": int(self.fused_stages),
            "ghost_depth": int(self.halo),
            "exchange_depth": int(self.exchange_depth),
            "steps_per_exchange": int(self.steps_per_exchange),
            "members": int(self.members),
            "member_halo": int(self.member_halo),
            "exchange": self.exchange,
            "remote_dma": self.remote_dma,
            "storage_dtype": str(self.dtype).replace("torch.", ""),
            "bytes_per_cell": int(self.dtype.itemsize),
        }

    def _init_exchange(self, exchange, mesh_axis, num_shards) -> None:
        """Check and arm the halo transport (``:704-767``, the JAX checks
        and texts): ``"dma"`` needs a z-slab shard, no split schedule, a
        single mesh axis with its shard count, and a core at least one
        exchange deep; it declares the ``remote_dma`` windows. The JAX
        package's TPU z-block choice has no counterpart: K4 tiles a
        window as K3 does."""
        exchange = str(exchange)
        if exchange not in ("collective", "dma"):
            raise ValueError(
                f"unknown exchange mode {exchange!r}; "
                "'collective' (XLA ppermute) or 'dma' (in-kernel)")
        self.exchange = exchange
        if exchange != "dma":
            return
        if not self.sharded:
            raise ValueError(
                "exchange='dma' serves sharded (z-slab) slab instances "
                "only — an unsharded run has no neighbor to push to")
        if self.overlap_split:
            raise ValueError(
                "exchange='dma' replaces the XLA exchange entirely; "
                "the split-overlap schedule does not compose with it")
        if not isinstance(mesh_axis, str) or num_shards is None:
            raise ValueError(
                "exchange='dma' needs the z mesh axis name and shard "
                "count (a compound/multihost mesh axis cannot host the "
                "ICI remote-DMA ring)")
        self.mesh_axis = mesh_axis
        self.num_shards = int(num_shards)
        depth = self.exchange_depth
        lz = self.interior_shape[0]
        if lz < depth:
            raise ValueError(
                f"local z extent {lz} cannot serve the {depth}-deep "
                "in-kernel exchange (the pushed core edge windows "
                "would leave the shard's own rows)")
        pz = self.padded_shape[0]
        self.remote_dma = {
            "axis": 0,
            "window_rows": depth,
            "buffers": 2,
            # pushed rows: the freshly computed core edge windows...
            "send_windows": ((depth, 2 * depth),
                             (pz - 2 * depth, pz - depth)),
            # ...landing outside the neighbour's core: first in the
            # dedicated landing buffer, spliced into these ghost rows
            "recv_windows": ((0, depth), (pz - depth, pz)),
            "semaphores": ("send", "recv"),
            "landing": "dedicated",
        }

    def _run_dma(self, u, t, num_iters: int):
        """The whole sharded run in ONE K4 launch for every shard of the
        card (``_run_dma``, ``:769-842``): this shard embeds its block
        and posts its live buffers to the mesh's launch group
        (:func:`parallel.mesh.launch_group`), whose leader launches K4
        (or, on the CPU, runs its twin) once for all of them."""
        full, rem = chunk_counts(int(num_iters), self.k)
        record_remote_dma(
            kernel=self.engaged_label, plane_shape=self.padded_shape[1:],
            itemsize=self.dtype.itemsize, window_rows=self.exchange_depth,
            blocks=full + (1 if rem else 0), mesh_axis=self.mesh_axis)
        S = self.embed(u)
        T = S.clone()
        land = torch.zeros((2, 2, self.exchange_depth)
                           + tuple(self.padded_shape[1:]),
                           dtype=self.dtype, device=S.device)

        def launch(shards):
            S0s, S1s, lands = (list(ts) for ts in zip(*shards))
            self._whole_run_dma(S0s, S1s, lands, num_iters)

        launch_group([S, T, land], launch)
        return self.extract(T if num_iters % 2 else S), wr.accumulate_t(
            t, self.dt, num_iters)

    def _init_sharded(self, global_shape, overlap_split: bool,
                      steps_per_exchange: int) -> None:
        """The shard-local mode (``global_shape`` differs from
        ``interior_shape``) and its schedule, with the JAX package's
        checks and split conditions."""
        self.global_shape = tuple(global_shape or self.interior_shape)
        self.sharded = self.global_shape != self.interior_shape
        G, lz = self.halo, self.interior_shape[0]
        k = int(steps_per_exchange)
        if k < 1:
            raise ValueError(f"steps_per_exchange must be >= 1, got {k}")
        if k > 1 and not self.sharded:
            raise ValueError(
                "the k-step communication-avoiding schedule applies to "
                "sharded (z-slab) runs only")
        if k > 1 and lz < k * G:
            raise ValueError(
                f"local z extent {lz} cannot serve the k-step schedule's "
                f"{k * G}-deep exchange (steps_per_exchange={k}, G={G})")
        self.k = self.steps_per_exchange = k
        self.exchange_depth = k * G
        # the split schedule's interior call reads no ghost row: per step
        # a window [G, lz - G) of at least G planes; the k-step block's
        # first call any non-empty one
        self.overlap_split = bool(
            overlap_split and self.sharded
            and (lz > 2 * G if k > 1 else lz >= 3 * G))

    def run(self, u, t, num_iters: int, refresh=None, offsets=None,
            exch=None):
        """``num_iters`` fused steps; returns ``(u, t)``, ``t`` advanced
        by ``dt`` once a step in its own precision. Unsharded: one launch
        (K2/K6). On a shard: one K3 call a step after a G-deep
        ``refresh`` — or the split schedule on ``exch``'s slabs — or, with
        ``k > 1``, the k-step blocks."""
        if num_iters == 0:
            return u, t
        if not self.sharded:
            S0 = self.embed(u)
            S = self._whole_run(S0, S0.clone(), num_iters)
            return self.extract(S), wr.accumulate_t(t, self.dt, num_iters)
        if offsets is None:
            raise ValueError("sharded slab stepper needs offsets")
        if self.exchange == "dma":
            # the exchange runs inside K4: no refresh or exch
            return self._run_dma(u, t, num_iters)
        if self.overlap_split and exch is None:
            raise ValueError("split-overlap slab stepper needs exch")
        if not self.overlap_split and refresh is None:
            raise ValueError("sharded slab stepper needs a ghost refresh")
        S = self.embed(u)
        T = S.clone()
        oz = offsets[0]
        full, rem = chunk_counts(int(num_iters), self.k)
        for nsteps in [self.k] * full + ([rem] if rem else []):
            S, T = self._block(S, T, nsteps, oz, refresh, exch)
        return self.extract(S), wr.accumulate_t(t, self.dt, num_iters)

    def _block(self, S, T, nsteps: int, oz: int, refresh, exch):
        """One exchange and ``nsteps`` steps (``nsteps <= k``); call ``j``
        writes the core widened by ``(k-1-j)*G`` planes a side."""
        G, k, lz = self.halo, self.k, self.interior_shape[0]
        wide = (k - 1) * G
        if self.overlap_split:
            lo, hi = exch(S)
            self._call(S, T, (G, lz - G), oz)
            wait_exchange(lo, hi)
            self._call(S, T, (-wide, G), oz, lo=lo)
            self._call(S, T, (lz - G, lz + wide), oz, hi=hi)
        else:
            refresh(S)
            self._call(S, T, (-wide, lz + wide), oz)
        S, T = T, S
        for j in range(1, nsteps):
            w = (k - 1 - j) * G
            self._call(S, T, (-w, lz + w), oz)
            S, T = T, S
        return S, T

    def run_batched(self, us, ts, num_iters: int, consume=None):
        """Advance B independent members ``num_iters`` fused steps in ONE
        launch (K2b): ``us`` is ``(B, *grid)``, ``ts`` the members'
        ``(B,)`` numpy times. Both buffers are ``(B, *layout)``, built
        from ``us`` once; every member's result is read from buffer
        ``num_iters % 2``. ``consume``, when given, is called once ``us``
        has been copied in and is no longer needed (the ensemble's
        donation). Returns ``(us, ts)`` advanced."""
        if num_iters == 0:
            return us, ts
        S0 = self.embed_batched(us)
        if consume is not None:
            consume()
        S = self._whole_run_batched(S0, S0.clone(), num_iters)
        out = self.extract_batched(S)
        del S0, S
        return out, accumulate_ts(ts, self.dt, num_iters)


def jax_bf16_slab_fits(ny: int, nx: int, order: int = 5) -> bool:
    """Whether the JAX package's Burgers slab stepper takes a bf16 grid
    with ``(ny, nx)`` planes at WENO ``order``: its TPU VMEM model
    (``fused_slab_run.py:1417-1452``; this port keeps a copy, it imports
    nothing of that package) — the live full-width rows of a one-plane
    z block, each ``(round8(ny + 2r), round128(nx + 2r))`` bf16 values,
    within 72 MiB. A block of one plane divides every ``nz`` and is the
    smallest, so the JAX slab takes the grid iff it fits."""
    r = fb.HALO[order]
    bz, G = 1, 3 * r
    sweep = 20 if order == 7 else 14
    rows = (2 * (bz + 2 * G) + 2 * bz + (bz + 4 * r) + (bz + 2 * r)
            + sweep * (bz + 4 * r))
    row_bytes = -(-(ny + 2 * r) // 8) * 8 * (-(-(nx + 2 * r) // 128) * 128) * 2
    return rows * row_bytes <= 72 * 1024 * 1024


def accumulate_ts(ts, dt, num_iters: int):
    """The members' ``(B,)`` times advanced by ``dt`` ``num_iters`` times
    in their own precision, each element as :func:`whole_run.
    accumulate_t` rounds a scalar."""
    ts = np.asarray(ts)
    step = ts.dtype.type(dt)
    for _ in range(int(num_iters)):
        ts = ts + step
    return ts


class SlabRunDiffusionStepper(PaddedDiffusionState, _SlabRunStepper):
    """Whole-run slab diffusion stepper (K2) for one (grid, dt)
    configuration on one device, K1's padded layout; on a shard of a
    z-slab mesh (``global_shape``) the sharded schedules over K3, the
    block between ``k*G`` ghost planes a side, ``(lz + 2kG, ny+4,
    nx+4)``. ``dtype=torch.bfloat16`` runs the bf16 instances
    (:func:`slab_run_diffusion_bf16`; on a shard K3's and K4's);
    ``storage_dtype`` is
    the state it faces (a float64 state on the float32 kernel, a float32
    state on the bf16 one)."""

    halo = 3 * R  # G: three O4 stages of redundant recompute
    stencil_radius = R

    def __init__(self, interior_shape, spacing, diffusivity, dt, band,
                 bc_value, device, global_shape=None,
                 overlap_split: bool = False, steps_per_exchange: int = 1,
                 exchange: str = "collective", mesh_axis=None,
                 num_shards=None, dtype=torch.float32, storage_dtype=None):
        super().__init__(interior_shape, spacing, diffusivity, dt, band,
                         bc_value, device, dtype, storage_dtype)
        self._init_sharded(global_shape, overlap_split, steps_per_exchange)
        if self.sharded:
            d = self.exchange_depth
            lz, ny, nx = self.interior_shape
            self.padded_shape = (lz + 2 * d, ny + 2 * R, nx + 2 * R)
            self.core_offsets = (d, R, R)
        self._init_exchange(exchange, mesh_axis, num_shards)
        bf16 = self.dtype == torch.bfloat16
        self._step_fn = (slab_step_diffusion_bf16 if bf16
                         else slab_step_diffusion)
        self._run_fn = slab_run_diffusion_bf16 if bf16 else slab_run_diffusion
        self._dma_fn = (slab_run_dma_diffusion_bf16 if bf16
                        else slab_run_dma_diffusion)

    def embed(self, u):
        if not self.sharded:
            return super().embed(u)
        S = torch.full(self.padded_shape, self.bc_value, dtype=self.dtype,
                       device=self.device)
        d = self.exchange_depth
        S[d:S.shape[0] - d, R:-R, R:-R].copy_(u)
        return S

    def extract(self, S):
        if not self.sharded:
            return super().extract(S)
        d = self.exchange_depth
        return S[d:S.shape[0] - d, R:-R, R:-R].contiguous().to(
            self.storage_dtype)

    def _call(self, S, T, window, oz, lo=None, hi=None):
        self._step_fn(S, T, self.dt, taps=self.taps, band=self.band,
                      bc_value=self.bc_value, global_nz=self.global_shape[0],
                      oz=oz, depth=self.exchange_depth, window=window, lo=lo,
                      hi=hi)

    def _whole_run(self, S0, S1, num_iters: int):
        return self._run_fn(S0, S1, num_iters, self.dt, taps=self.taps,
                            band=self.band, bc_value=self.bc_value)

    def _whole_run_dma(self, S0s, S1s, lands, num_iters: int):
        return self._dma_fn(S0s, S1s, lands, num_iters, self.dt,
                            taps=self.taps, band=self.band,
                            bc_value=self.bc_value, k=self.k)

    def embed_batched(self, us):
        """``(B, *padded)``: every member's padded layout, the ghost ring
        at the wall value."""
        S = torch.full((us.shape[0], *self.padded_shape), self.bc_value,
                       dtype=self.dtype, device=self.device)
        S[(slice(None),) + (slice(R, -R),) * 3].copy_(us)
        return S

    def extract_batched(self, S):
        return S[(slice(None),) + (slice(R, -R),) * 3].contiguous().to(
            self.storage_dtype)

    def _whole_run_batched(self, S0, S1, num_iters: int):
        return slab_run_diffusion_batched(
            S0, S1, num_iters, self.dt, taps=self.taps, band=self.band,
            bc_value=self.bc_value)

    @staticmethod
    def supported(interior_shape, dtype, depth: int = R) -> bool:
        """What K2 (and K3, on a shard's block with ``depth`` ghost
        planes a side) takes: a 3-D float32 or bf16 grid
        whose padded state has at most 2^31 - 1 cells (32-bit indices). A
        block's shared memory is fixed (105,600 bytes for any grid, the
        rings float32 at either buffer type), so a cooperative grid of at
        least one block an SM always fits; tiling y and x removes the
        JAX package's row-size limit."""
        if dtype not in (torch.float32, torch.bfloat16) or len(
                interior_shape) != 3:
            return False
        lz, ny, nx = interior_shape
        return (lz + 2 * depth) * (ny + 2 * R) * (nx + 2 * R) <= MAX_CELLS

    @staticmethod
    def profitable(interior_shape, dtype) -> bool:
        """Whether plain ``impl="pallas"`` prefers K2 to the per-stage
        path (K1): on grids of at most ``K2_PROFITABLE_CELLS`` cells.

        Measured by ``chip_smoke.py`` phase 15 (NVIDIA H100 80GB HBM3,
        700.00 W; ms/step of ``run(101)``, K2 against the K1 path, whose
        three host launches a step vary from run to run): in one run,
        medians of three, 0.0290 / 0.1666 on 24x16x16 (6,144 cells),
        0.0310 / 0.1994 on 32^3, 0.0408 / 0.1217 on 64^3 (262,144),
        0.0831 / 0.1834 on 128^3; in a second, five rounds of the paths
        in turn, [min, max], [0.0261, 0.0274] / [0.1299, 0.1583],
        [0.0299, 0.0308] / [0.1162, 0.1582], [0.0365, 0.0380] /
        [0.1106, 0.1314], and on 128^3 [0.0804, 0.0821] / [0.0330,
        0.1468], no winner beyond the spread. On 400x200x206 K1 won in
        both (0.4457 / 0.2817; [0.4473, 0.4504] / [0.2753, 0.2804]). The
        threshold is the largest grid on which K2 won beyond the spread;
        between 262,144 and 2,097,152 cells nothing was measured. The bf16
        instances (``precision="bf16"``) take the same threshold: their
        shared rings and arithmetic are the float32 ones', and only the
        bytes, which bound neither path at these sizes, halve."""
        return (dtype in (torch.float32, torch.bfloat16)
                and math.prod(interior_shape) <= K2_PROFITABLE_CELLS)


class SlabRunBurgersStepper(_SlabRunStepper):
    """Whole-run slab Burgers stepper (K6, fixed dt) for one (grid, flux,
    dt, WENO order) configuration on one device, K5's unpadded layout; on
    a shard of a z-slab mesh (``global_shape``) the sharded schedules over
    K3, the block between ``k*G`` ghost planes a side, ``(lz + 2kG, ny,
    nx)``; ``G = 3r`` is 9 at ``order=5`` and 12 at ``order=7``, the
    JAX stepper's ``halo`` at either order. ``dtype=torch.bfloat16`` runs
    the bf16 instances (:func:`slab_run_burgers_bf16`; on a shard K3's and
    K4's) on a float32 state (``storage_dtype``) cast at ``embed`` and
    ``extract``."""

    # G: three WENO5 stages of redundant recompute (an order-7 instance
    # sets its own, 12, and reach 4)
    halo = 3 * fb.R
    stencil_radius = fb.R

    def __init__(self, interior_shape, spacing, flux: Flux, variant: str,
                 nu: float, dt: float, device, order: int = 5,
                 global_shape=None, overlap_split: bool = False,
                 steps_per_exchange: int = 1, exchange: str = "collective",
                 mesh_axis=None, num_shards=None, dtype=torch.float32,
                 storage_dtype=None):
        self.interior_shape = tuple(interior_shape)
        self.dtype = dtype
        self.storage_dtype = storage_dtype or dtype
        self.device = torch.device(device)
        self.params = fb.stage_params(flux, variant, spacing, nu, order)
        self.stencil_radius = self.params.r
        self.halo = 3 * self.params.r
        self.dt = float(dt)
        self._init_sharded(global_shape, overlap_split, steps_per_exchange)
        d = self.exchange_depth if self.sharded else 0
        self.core_offsets = (d, 0, 0)
        lz, ny, nx = self.interior_shape
        self.padded_shape = (lz + 2 * d, ny, nx)
        self._init_exchange(exchange, mesh_axis, num_shards)
        bf16 = dtype == torch.bfloat16
        self._step_fn = slab_step_burgers_bf16 if bf16 else slab_step_burgers
        self._run_fn = slab_run_burgers_bf16 if bf16 else slab_run_burgers
        self._dma_fn = (slab_run_dma_burgers_bf16 if bf16
                        else slab_run_dma_burgers)

    def embed(self, u):
        u = u.to(device=self.device, dtype=self.dtype, copy=True)
        if not self.sharded:
            return u.contiguous()
        # ghost planes start as edge replicas (as the JAX embed pads);
        # the exchange replaces the ones inside the domain
        d = self.exchange_depth
        idx = torch.arange(-d, u.shape[0] + d, device=u.device)
        return u.index_select(0, idx.clamp_(0, u.shape[0] - 1)).contiguous()

    def extract(self, S):
        if not self.sharded:
            return S.to(self.storage_dtype)
        d = self.exchange_depth
        return S[d:S.shape[0] - d].contiguous().to(self.storage_dtype)

    def _call(self, S, T, window, oz, lo=None, hi=None):
        self._step_fn(S, T, self.dt, params=self.params,
                      global_nz=self.global_shape[0], oz=oz,
                      depth=self.exchange_depth, window=window, lo=lo, hi=hi)

    # the layout is unpadded, so a batch embeds as a copy too
    def embed_batched(self, us):
        return us.to(device=self.device, dtype=self.dtype,
                     copy=True).contiguous()

    def extract_batched(self, S):
        return S.to(self.storage_dtype)

    def _whole_run(self, S0, S1, num_iters: int):
        return self._run_fn(S0, S1, num_iters, self.dt, params=self.params)

    def _whole_run_dma(self, S0s, S1s, lands, num_iters: int):
        return self._dma_fn(S0s, S1s, lands, num_iters, self.dt,
                            params=self.params, k=self.k)

    def _whole_run_batched(self, S0, S1, num_iters: int):
        return slab_run_burgers_batched(S0, S1, num_iters, self.dt,
                                        params=self.params)

    @staticmethod
    def supported(interior_shape, dtype, depth: int = 0,
                  order: int = 5) -> bool:
        """What K6 (and K3, on a shard's block with ``depth`` ghost
        planes a side) takes: a 3-D float32 grid of at most 2^31 - 1
        cells with its ghost planes (32-bit indices). A block's shared
        memory is fixed (219 KiB for any grid), so a cooperative grid of
        one block an SM always fits; tiling y and x removes the JAX
        package's row-size limit. The bf16 instances take only the
        (local) planes the JAX package's slab takes in bf16
        (:func:`jax_bf16_slab_fits`): on larger grids its once-a-step
        rounding left the bf16 band on the H100 (PERF.md §6), and
        the JAX package's carried generic loop runs them."""
        if dtype not in (torch.float32, torch.bfloat16) or len(
                interior_shape) != 3:
            return False
        lz, ny, nx = interior_shape
        if dtype == torch.bfloat16 and not jax_bf16_slab_fits(ny, nx,
                                                              order):
            return False
        return (lz + 2 * depth) * ny * nx <= MAX_CELLS

    @staticmethod
    def profitable(interior_shape, dtype) -> bool:
        """Whether plain ``impl="pallas"`` at fixed dt prefers K6 to the
        per-stage path (K5): nowhere, as measured.

        Measured by ``chip_smoke.py`` phase 15 (NVIDIA H100 80GB HBM3,
        700.00 W; ms/step of ``run(20)``, five rounds of the two paths in
        turn, [min, max] of the rounds, K6 against the K5 path, three
        runs): 24x16x16 (6,144 cells) [0.1103, 0.1133] / [0.1794,
        0.2068], [0.1082, 0.1093] / [0.0805, 0.1471] and [0.1070,
        0.1093] / [0.0812, 0.0986]: K6 won beyond the spread in the
        first run only and lost beyond it in the third (the K5 path's
        three host launches a step vary from run to run); 64^3 [0.1931,
        0.2068] / [0.1723, 0.2373], [0.1986, 0.2037] / [0.1690, 0.1840]
        and [0.1996, 0.2053] / [0.1695, 0.1870]; 160x160x162,
        400x400x406 and 512^3 K5 beyond the spread in all three
        (400x400x406 [8.471, 8.490] / [6.292, 6.356], 512^3 [15.516,
        15.584] / [12.407, 12.420] in the third). ``impl="pallas_slab"``
        pins K6."""
        del interior_shape, dtype
        return False
