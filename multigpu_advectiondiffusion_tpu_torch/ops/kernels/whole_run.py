"""Whole-run SSP-RK3 driver: every stage of every step in ONE kernel
launch (JAX ``ops/pallas/whole_run.py`` counterpart; kernels K7 and K7a).

On the TPU the Pallas grid is the iteration counter: the state is
copied into VMEM once, the grid runs its steps in order with the state
held in scratch, and the result is copied out once. On Hopper blocks run
in parallel, so the counterpart is one *cooperative* launch per run: a
grid of at most the blocks that can be resident at once, with grid-wide
barriers (``cooperative_groups::this_grid().sync()``) in place of the
sequential grid axis: both bodies keep a tile of the grid a block in
shared memory, recompute the halo of its three stages and need one
barrier a step. A 2-D state of the reference's size (1001², 4 MB) stays
in the 50 MB L2 for the run.

The kernels are ``csrc/whole_run_diffusion2d.cu`` and
``csrc/whole_run_burgers2d.cu``; their modules
(:mod:`fused_diffusion2d`, :mod:`fused_burgers2d`) hand this one a
launch and a plain stage. What they share is here:

* :func:`whole_run` / :func:`whole_run_adaptive` launch the kernel for a
  CUDA tensor (raising if it cannot) and count the launch in
  ``whole_run.launches`` / ``whole_run_adaptive.launches``; for a CPU
  tensor — and only then — they run the plain twin;
* :func:`plain_run` / :func:`plain_run_adaptive`, the plain twin: the
  body's plain stage looped three times a step on the same buffers,
  ``T1 = s(S)``, ``T2 = s(T1, S)``, ``S = s(T2, S)`` in place
  (``whole_run.py:37-41``), and in adaptive mode dt from the state at the
  start of each step, the f32 sum of the steps' dt returned;
* :func:`library`, the ctypes binding of a body's cooperative launch,
  and :func:`launch`, which calls it and raises on a CUDA error (the 3-D
  slab kernels, :mod:`fused_slab_run`, use both);
* :func:`accumulate_t`, the fixed-dt time, iterated on the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable

import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build

# SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
STAGES = ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))

# The port's gate for the whole-run steppers: the share of the H100's
# 50 MB L2 that the three float32 state buffers may fill. Under it the
# state stays in L2 for the whole run; over it every stage streams the
# state through device memory and one launch a run buys nothing (the
# kernels themselves are right at any size). The JAX package's gate is
# its TPU VMEM model (fits_vmem(..., 8 or 24 live buffers, 64 MiB));
# PERF.md lists the grids where the two disagree.
L2_BYTES = 50 * 1024 * 1024
L2_SHARE = 0.5


def fits_l2(shape) -> bool:
    """Whether three float32 buffers of ``shape`` fit ``L2_SHARE`` of
    the L2."""
    return 3 * 4 * math.prod(shape) <= L2_SHARE * L2_BYTES


# stage(v, u, out, dt, a, b): one plain stage, out <- s(v, u); u is None
# for the first stage and may be out for the last
Stage = Callable[..., torch.Tensor]
# kernel(S, T1, T2, num_iters, ...) -> CUDA error code: one launch
Kernel = Callable[..., int]


@functools.lru_cache(maxsize=None)
def library(source: str, symbol: str, argtypes: tuple,
            nvcc_extra: tuple = ()) -> ctypes.CDLL:
    """``csrc/<source>`` built (at first use) and loaded, with
    ``symbol``'s argument types set; it returns a CUDA error code."""
    lib = ctypes.CDLL(str(build.build(source, nvcc_extra).path))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _plain_step(stage: Stage, S, T1, T2, dt) -> None:
    (a1, b1), (a2, b2), (a3, b3) = STAGES
    stage(S, None, T1, dt, a1, b1)  # u1 = u + dt L(u)
    stage(T1, S, T2, dt, a2, b2)    # 3/4 u + 1/4 (...)
    stage(T2, S, S, dt, a3, b3)     # 1/3 u + 2/3 (...), in place


def plain_run(stage: Stage, S, T1, T2, num_iters: int, dt) -> torch.Tensor:
    """The plain twin of a fixed-dt whole-run kernel, on any device:
    ``num_iters`` steps on ``S`` in place; returns ``S``."""
    for _ in range(int(num_iters)):
        _plain_step(stage, S, T1, T2, dt)
    return S


def plain_run_adaptive(stage: Stage, dt_fn, S, T1, T2, num_iters: int):
    """The plain twin of an adaptive whole-run kernel, on any device:
    ``dt = dt_fn(S)`` (a float32 0-d tensor) before every step; returns
    ``(S, t_sum)``, ``t_sum`` the float32 sum of the steps' dt from 0
    (``whole_run.py:89-97``)."""
    t_sum = torch.zeros((), dtype=torch.float32, device=S.device)
    for _ in range(int(num_iters)):
        dt = dt_fn(S)
        _plain_step(stage, S, T1, T2, dt)
        t_sum = t_sum + dt
    return S, t_sum


def _check(S, T1, T2) -> None:
    for name, t in (("T1", T1), ("T2", T2)):
        if (t.shape != S.shape or t.dtype != S.dtype
                or t.device != S.device):
            raise ValueError(f"{name} must match S: {tuple(S.shape)} "
                             f"{S.dtype} on {S.device}")
    ptrs = {t.data_ptr() for t in (S, T1, T2)}
    if len(ptrs) != 3:
        raise ValueError("S, T1 and T2 must be three different buffers")
    if S.dtype != torch.float32:
        raise TypeError(f"float32 only, got {S.dtype}")
    if not all(t.is_contiguous() for t in (S, T1, T2)):
        raise ValueError("S, T1 and T2 must be contiguous")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no whole-run kernel for device {S.device}")


def launch(kernel: Kernel, *args) -> None:
    """``kernel(*args)`` on ``args[0]``'s device; raises on a CUDA error
    code."""
    with torch.cuda.device(args[0].device):
        rc = kernel(*args)
    if rc != 0:
        raise RuntimeError(f"whole-run kernel launch failed: CUDA error {rc}")


def whole_run(kernel: Kernel, stage: Stage, S, T1, T2, num_iters: int,
              dt) -> torch.Tensor:
    """``num_iters`` fixed-dt steps on ``S`` in place, ``T1``/``T2``
    scratch; returns ``S``. A CUDA tensor goes to ``kernel(S, T1, T2,
    num_iters)`` — one launch on the current stream, no synchronisation,
    counted in ``whole_run.launches``; a CPU tensor to :func:`plain_run`
    with ``stage`` and ``dt``."""
    _check(S, T1, T2)
    if S.device.type == "cpu":
        return plain_run(stage, S, T1, T2, num_iters, dt)
    launch(kernel, S, T1, T2, int(num_iters))
    build.count_launch(whole_run)
    return S


whole_run.launches = 0


def whole_run_adaptive(kernel: Kernel, stage: Stage, dt_fn, S, T1, T2,
                       num_iters: int):
    """Adaptive-dt :func:`whole_run` (K7a): returns ``(S, t_sum)``, the
    float32 sum of the steps' dt as a 0-d tensor on ``S``'s device. A
    CUDA tensor goes to ``kernel(S, T1, T2, num_iters, mx, t_sum)``
    (``mx`` three words of scratch), counted in
    ``whole_run_adaptive.launches``; a CPU tensor to
    :func:`plain_run_adaptive` with ``stage`` and ``dt_fn``."""
    _check(S, T1, T2)
    if S.device.type == "cpu":
        return plain_run_adaptive(stage, dt_fn, S, T1, T2, num_iters)
    mx = torch.empty(3, dtype=torch.float32, device=S.device)
    t_sum = torch.empty((), dtype=torch.float32, device=S.device)
    launch(kernel, S, T1, T2, int(num_iters), mx, t_sum)
    build.count_launch(whole_run_adaptive)
    return S, t_sum


whole_run_adaptive.launches = 0


def accumulate_t(t, dt, num_iters: int):
    """``t`` advanced by ``dt`` ``num_iters`` times in ``t``'s precision,
    the generic loop's rounding (``whole_run.py:141-143``); no device
    work."""
    tdt = type(t)
    step = tdt(dt)
    for _ in range(int(num_iters)):
        t = t + step
    return t
