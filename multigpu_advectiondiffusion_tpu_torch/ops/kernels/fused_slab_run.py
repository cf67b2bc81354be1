"""Whole-run slab SSP-RK3 stepping for 3-D diffusion and Burgers: every
fused step of a run in ONE cooperative kernel launch (JAX
``ops/pallas/fused_slab_run.py`` counterpart, its single-device parts;
kernels K2, diffusion, ``csrc/fused_step_diffusion.cu``, and K6,
Burgers/WENO5, ``csrc/slab_run_burgers.cu``).

On the TPU the Pallas grid is ``(timestep, z-slab)`` and runs in order:
each slab, loaded with ``G = 3h`` ghost rows a side, fuses the three RK
stages of a step in VMEM, and the state ping-pongs between two buffers
across steps. On Hopper the counterpart is one cooperative launch a run:
a grid of co-resident blocks walks the step's tiles (a 32x32 (y, x) tile
and a chunk of z planes each, the ghost region recomputed in y and x as
in z), and a grid-wide barrier after each step takes the place of the
sequential grid axis. Step ``k`` reads buffer ``k % 2`` and writes the
other, so the result lies in buffer ``num_iters % 2``.

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
* The steppers have the JAX classes' names, labels, ``run``,
  ``run_batched`` and the ``member_halo`` declaration; the member count
  declaration and its check wait for member-sharded meshes, and the
  sharded roles, the k-step schedule and the in-kernel DMA exchange are
  not ported. Neither has ``run_to``, as in JAX.
* ``supported``/``profitable`` are the port's gates, for the H100, in
  place of the JAX package's TPU VMEM model (PERF.md lists the shapes
  where the two disagree).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
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
)

BURGERS_SOURCE = "slab_run_burgers.cu"
# z planes a block marches (each chunk recomputes 12 planes at its ends
# for K2, 18 for K6): the fastest of those chip_smoke.py times at the
# main configurations (PERF.md)
DIFFUSION_Z_CHUNK = 16
BURGERS_Z_CHUNK = 64
# the kernels index the state with 32-bit integers
MAX_CELLS = 2**31 - 1
# the largest grid (cells) on which K2 beat the K1 path (SlabRunDiffusion-
# Stepper.profitable)
K2_PROFITABLE_CELLS = 24 * 16 * 16
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# one entry a source for K2/K6 and K2b: the member count follows S1
_K2_ARGTYPES = (_P, _P, _I, _I, _I, _I, _P, _F, _I, _F, _I, _I, _P, _P)
_K6_ARGTYPES = (_P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _F, _I, _I, _P,
                _P)


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
    blocks = ctypes.c_int(0)

    def kernel(S0, S1):
        return wr.library(fds.SOURCE, "slab_run_diffusion", _K2_ARGTYPES
                          ).slab_run_diffusion(
            S0.data_ptr(), S1.data_ptr(), B, nz, ny, nx,
            host_taps.ctypes.data, float(np.float32(dt)), int(band),
            float(bc_value), int(zchunk), int(num_iters),
            ctypes.byref(blocks), wr.stream_of(S0))

    wr.launch(kernel, S0, S1)
    if grid_blocks is not None:
        grid_blocks.append(blocks.value)


def slab_run_diffusion(S0, S1, num_iters: int, dt, *, taps, band, bc_value,
                       zchunk=DIFFUSION_Z_CHUNK,
                       grid_blocks: list | None = None):
    """``num_iters`` fused diffusion steps on two padded buffers (K1's
    layout, ghost rings at ``bc_value``), ``S0`` holding the initial
    state; returns the buffer that holds the result (``S0`` after an even
    count, ``S1`` after an odd one). ``dt`` is rounded to float32. A CUDA
    tensor launches K2 once on the current stream (no synchronisation),
    counted in ``slab_run_diffusion.launches``; ``grid_blocks``, a list,
    receives the grid's block count. A CPU tensor runs the twin."""
    fds.check_padded(S0, S1)
    if S0.device.type == "cpu":
        return ping_pong(lambda src, dst: fds.step_reference(
            src, dst, dt, taps=taps, band=band, bc_value=bc_value),
            S0, S1, num_iters)
    _launch_diffusion(S0[None], S1[None], num_iters, dt, taps, band,
                      bc_value, zchunk, grid_blocks)
    slab_run_diffusion.launches += 1
    return S1 if num_iters % 2 else S0


slab_run_diffusion.launches = 0


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
                               bc_value, zchunk=DIFFUSION_Z_CHUNK,
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
    slab_run_diffusion_batched.launches += 1
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
    blocks = ctypes.c_int(0)

    def kernel(S0, S1):
        return wr.library(BURGERS_SOURCE, "slab_run_burgers", _K6_ARGTYPES,
                          fb.NVCC_EXTRA).slab_run_burgers(
            S0.data_ptr(), S1.data_ptr(), B, nz, ny, nx, code, c, weno_z,
            inv_dx.ctypes.data, None if taps is None else taps.ctypes.data,
            float(np.float32(dt)), int(zchunk), int(num_iters),
            ctypes.byref(blocks), wr.stream_of(S0))

    wr.launch(kernel, S0, S1)
    if grid_blocks is not None:
        grid_blocks.append(blocks.value)


def slab_run_burgers(S0, S1, num_iters: int, dt, *, params: fb.StageParams,
                     zchunk=BURGERS_Z_CHUNK,
                     grid_blocks: list | None = None):
    """``num_iters`` fused fixed-dt WENO5 steps on two unpadded
    ``(nz, ny, nx)`` buffers, ``S0`` holding the initial state; returns
    the buffer that holds the result (``S0`` after an even count, ``S1``
    after an odd one). ``dt`` is rounded to float32. A CUDA tensor
    launches K6 once on the current stream (no synchronisation), counted
    in ``slab_run_burgers.launches``; ``grid_blocks``, a list, receives
    the grid's block count. A CPU tensor runs the twin."""
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
    slab_run_burgers.launches += 1
    return S1 if num_iters % 2 else S0


slab_run_burgers.launches = 0


def slab_run_burgers_batched(S0, S1, num_iters: int, dt, *,
                             params: fb.StageParams,
                             zchunk=BURGERS_Z_CHUNK,
                             grid_blocks: list | None = None):
    """K2b, Burgers/WENO5: :func:`slab_run_burgers` for B members at once.
    ``S0``/``S1`` are ``(B, nz, ny, nx)``, every member's slice K6's
    unpadded layout; ``S0`` holds the initial states. Returns the buffer
    that holds every member's result (``S0`` after an even count, ``S1``
    after an odd one). A CUDA tensor launches the kernel once on the
    current stream for the whole batch, counted in
    ``slab_run_burgers_batched.launches``; a CPU tensor runs the twin,
    K6's twin per member."""
    _check_batched(S0, S1, 1)
    if S0.device.type == "cpu":
        return ping_pong_members(lambda src, dst: burgers_step_reference(
            src, dst, dt, params=params), S0, S1, num_iters)
    _launch_burgers(S0, S1, num_iters, dt, params, zchunk, grid_blocks)
    slab_run_burgers_batched.launches += 1
    return S1 if num_iters % 2 else S0


slab_run_burgers_batched.launches = 0


class _SlabRunStepper:
    """What the two slab steppers share: the label, the unsharded
    ``run`` (``fused_slab_run.py:1080-1098``) and the B-folded
    ``run_batched`` (``:902-945``)."""

    engaged_label = "fused-whole-run-slab"
    # the member axis of run_batched has no stencil reach: members share
    # no cell (the JAX steppers' declaration, ``:650-657``)
    member_halo = 0

    def run(self, u, t, num_iters: int):
        """``num_iters`` fused steps in one launch; returns ``(u, t)``,
        ``t`` advanced by ``dt`` once a step in its own precision."""
        if num_iters == 0:
            return u, t
        S0 = self.embed(u)
        S = self._whole_run(S0, S0.clone(), num_iters)
        return self.extract(S), wr.accumulate_t(t, np.float32(self.dt),
                                                num_iters)

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


def accumulate_ts(ts, dt, num_iters: int):
    """The members' ``(B,)`` times advanced by ``dt`` ``num_iters`` times
    in their own precision, each element as :func:`whole_run.
    accumulate_t` rounds a scalar."""
    ts = np.asarray(ts)
    step = ts.dtype.type(np.float32(dt))
    for _ in range(int(num_iters)):
        ts = ts + step
    return ts


class SlabRunDiffusionStepper(PaddedDiffusionState, _SlabRunStepper):
    """Whole-run slab diffusion stepper (K2) for one (grid, dt)
    configuration on one device, K1's padded layout."""

    def _whole_run(self, S0, S1, num_iters: int):
        return slab_run_diffusion(S0, S1, num_iters, self.dt, taps=self.taps,
                                  band=self.band, bc_value=self.bc_value)

    def embed_batched(self, us):
        """``(B, *padded)``: every member's padded layout, the ghost ring
        at the wall value."""
        S = torch.full((us.shape[0], *self.padded_shape), self.bc_value,
                       dtype=self.dtype, device=self.device)
        S[(slice(None),) + (slice(R, -R),) * 3].copy_(us)
        return S

    def extract_batched(self, S):
        return S[(slice(None),) + (slice(R, -R),) * 3].contiguous()

    def _whole_run_batched(self, S0, S1, num_iters: int):
        return slab_run_diffusion_batched(
            S0, S1, num_iters, self.dt, taps=self.taps, band=self.band,
            bc_value=self.bc_value)

    @staticmethod
    def supported(interior_shape, dtype) -> bool:
        """What K2 takes: a 3-D float32 grid whose padded state has at
        most 2^31 - 1 cells (32-bit indices). A block's shared memory is
        fixed (112 KB for any grid), so a cooperative grid of at least
        one block an SM always fits; tiling y and x removes the JAX
        package's row-size limit."""
        return (dtype == torch.float32 and len(interior_shape) == 3
                and math.prod(n + 2 * R for n in interior_shape) <= MAX_CELLS)

    @staticmethod
    def profitable(interior_shape, dtype) -> bool:
        """Whether plain ``impl="pallas"`` prefers K2 to the per-stage
        path (K1): on grids of at most ``K2_PROFITABLE_CELLS`` cells.

        Measured by ``chip_smoke.py`` phase 15 (NVIDIA H100 80GB HBM3,
        700.00 W, two runs): K2's ``run(101)`` took 0.0709 and 0.0712
        ms/step on 24x16x16 (6,144 cells), where the K1 path's three
        host launches a step took 0.1115 and 0.0962; on 32^3 (32,768
        cells) K2 took 0.1060 against K1's 0.0820, and K1 won on every
        larger grid (64^3, 128^3, 400x200x206: K2 0.73 against 0.28
        ms/step). The threshold is the largest grid on which K2 won;
        between 6,144 and 32,768 cells nothing was measured."""
        return (dtype == torch.float32
                and math.prod(interior_shape) <= K2_PROFITABLE_CELLS)


class SlabRunBurgersStepper(_SlabRunStepper):
    """Whole-run slab Burgers/WENO5 stepper (K6, fixed dt) for one (grid,
    flux, dt) configuration on one device, K5's unpadded layout. WENO7
    raises: its order-7 instance is not ported."""

    def __init__(self, interior_shape, spacing, flux: Flux, variant: str,
                 nu: float, dt: float, device, order: int = 5):
        if order != 5:
            raise NotImplementedError(
                "K6's WENO7 instance is not ported yet")
        self.interior_shape = tuple(interior_shape)
        self.dtype = torch.float32
        self.device = torch.device(device)
        self.params = fb.stage_params(flux, variant, spacing, nu)
        self.dt = float(dt)

    def embed(self, u):
        return u.to(device=self.device, dtype=self.dtype,
                    copy=True).contiguous()

    def extract(self, S):
        return S

    # the layout is unpadded, so a batch embeds as a copy too
    embed_batched = embed
    extract_batched = extract

    def _whole_run(self, S0, S1, num_iters: int):
        return slab_run_burgers(S0, S1, num_iters, self.dt,
                                params=self.params)

    def _whole_run_batched(self, S0, S1, num_iters: int):
        return slab_run_burgers_batched(S0, S1, num_iters, self.dt,
                                        params=self.params)

    @staticmethod
    def supported(interior_shape, dtype) -> bool:
        """What K6 takes: a 3-D float32 grid of at most 2^31 - 1 cells
        (32-bit indices). A block's shared memory is fixed (195 KB for
        any grid), so a cooperative grid of one block an SM always fits;
        tiling y and x removes the JAX package's row-size limit."""
        return (dtype == torch.float32 and len(interior_shape) == 3
                and math.prod(interior_shape) <= MAX_CELLS)

    @staticmethod
    def profitable(interior_shape, dtype) -> bool:
        """Whether plain ``impl="pallas"`` at fixed dt prefers K6 to the
        per-stage path (K5): nowhere, as written.

        Measured by ``chip_smoke.py`` phase 15 (NVIDIA H100 80GB HBM3,
        700.00 W, two runs): K6 was slower than the K5 path on every
        grid tried, 2.4-9.3x (ms/step K6 against K5: 24x16x16 0.375 /
        0.088, 64^3 1.628 / 0.176, 160x160x162 1.841 / 0.477,
        400x400x406 15.52 / 6.31, 512^3 30.01 / 12.41). ``impl=
        "pallas_slab"`` pins it."""
        del interior_shape, dtype
        return False
