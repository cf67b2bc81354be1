"""Whole-step fused SSP-RK3 diffusion: all three RK stages of a step in
ONE kernel launch (JAX ``ops/pallas/fused_diffusion_step.py``
counterpart; kernel K10, ``csrc/fused_step_diffusion.cu``).

A step reads the state once and writes it once, 8 B a cell, where the
per-stage path (K1) moves at least 32: each block recomputes the ghost
region of its tile for stages 1 and 2 (temporal blocking over the RK
stages) instead of writing the stages out.

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
# z planes a block marches; each chunk recomputes 12 planes at its ends
Z_CHUNK = 32
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


def check_padded(S, out) -> None:
    """``S`` and ``out``: two different contiguous float32 padded 3-D
    buffers of one shape on one device."""
    _check("out", out, S.shape, S.device)
    _check("S", S, S.shape, S.device)
    if S.dim() != 3 or min(S.shape) <= 2 * R:
        raise ValueError(f"padded 3-D state expected, got {tuple(S.shape)}")
    if S.data_ptr() == out.data_ptr():
        raise ValueError("S and out must be different buffers")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused-step kernel for device {S.device}")


def fused_step(S, out, dt, *, taps, band, bc_value, zchunk=Z_CHUNK):
    """One fused SSP-RK3 step: ``out``'s interior ``<-`` the step of
    ``S`` (padded buffers; ``S`` is not written). ``dt`` is rounded to
    float32 and passed by value. Launches K10 on the current stream (no
    synchronisation), each block marching ``zchunk`` z planes of a 32x32
    tile, and counts the launch in ``fused_step.launches``; a CPU tensor
    runs :func:`step_reference`."""
    check_padded(S, out)
    if S.device.type == "cpu":
        return step_reference(S, out, dt, taps=taps, band=band,
                              bc_value=bc_value)
    nz, ny, nx = (n - 2 * R for n in S.shape)
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
