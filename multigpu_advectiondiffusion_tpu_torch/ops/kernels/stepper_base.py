"""Execution driver for the fused per-stage steppers (JAX
``ops/pallas/stepper_base.py`` counterpart).

* :meth:`FusedStepperBase.run` — a fixed step count (the CUDA drivers'
  ``max_iters`` mode, ``MultiGPU/Diffusion3d_Baseline/main.c:189``);
* :meth:`FusedStepperBase.run_to` — ``while t < t_end`` with the last
  step trimmed (``heat3d.m:48-77``), same eps guard as the generic loop.

The loop runs on the host with host scalars: ``dt`` is a numpy float32
(the kernels take it by value) and ``t`` keeps the state's precision,
so the step count and landing time equal the JAX package's, and no
step waits on the device.

Subclasses provide ``embed``/``extract``, ``_step(S, T1, T2, dt)`` and
``_dt_value()``.
"""

from __future__ import annotations

import numpy as np


class FusedStepperBase:
    engaged_label = "fused-stage"  # what engaged_path() reports

    def _dt_value(self) -> np.float32:
        raise NotImplementedError

    def _buffers(self, u):
        """The padded state ``S`` and two scratch buffers whose ghost
        rings already hold the wall value (the kernels never write
        ghosts)."""
        S = self.embed(u)
        return S, S.clone(), S.clone()

    def run(self, u, t, num_iters: int):
        """``num_iters`` fused SSP-RK3 steps; returns ``(u, t)``."""
        S, T1, T2 = self._buffers(u)
        tdt = type(t)
        dt = self._dt_value()
        for _ in range(int(num_iters)):
            S, T1, T2 = self._step(S, T1, T2, dt)
            t = t + tdt(dt)
        return self.extract(S), t

    def run_to(self, u, t, t_end):
        """March fused steps until ``t_end``; returns ``(u, t, steps)``."""
        S, T1, T2 = self._buffers(u)
        tdt = type(t)
        te = tdt(t_end)
        eps = tdt(1e-12) * max(tdt(1.0), abs(te))
        steps = 0
        while t < te - eps:
            dt = min(self._dt_value(), np.float32(te - t))
            S, T1, T2 = self._step(S, T1, T2, dt)
            t = t + tdt(dt)
            steps += 1
        return self.extract(S), t, steps
