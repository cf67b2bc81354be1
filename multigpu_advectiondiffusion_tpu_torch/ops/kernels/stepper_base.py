"""Execution driver for the fused per-stage steppers (JAX
``ops/pallas/stepper_base.py`` counterpart).

* :meth:`FusedStepperBase.run` — a fixed step count (the CUDA drivers'
  ``max_iters`` mode, ``MultiGPU/Diffusion3d_Baseline/main.c:189``);
* :meth:`FusedStepperBase.run_to` — ``while t < t_end`` with the last
  step trimmed (``heat3d.m:48-77``), same eps guard as the generic loop.

Two modes for the scalars ``dt`` and ``t``:

* host scalars (``device_scalars = False``, the diffusion stepper):
  ``dt`` is a numpy float32 the kernels take by value and ``t`` keeps
  the state's precision on the host, so no step waits on the device;
* device scalars (``device_scalars = True``, the Burgers stepper):
  ``dt`` depends on the previous step's ``max|f'(u)|``, which the last
  stage kernel emits on the device. ``m``, ``dt`` and ``t`` stay 0-d
  tensors on the device — ``m0 = max|f'(u0)|``, each step ``dt`` from
  ``m`` (``_dt_of``), then ``t += dt`` in ``t``'s precision — the JAX
  package's ``_loop_pieces`` (``stepper_base.py:236-264``). ``run``
  reads ``t`` back once, at the end; ``run_to`` reads it once a step
  for the ``t < t_end - eps`` test, which the JAX package's
  ``while_loop`` makes on the device.

Either way the step count and landing time equal the JAX package's.
Subclasses provide ``embed``/``extract`` and ``_step``; host-scalar
ones ``_dt_value()``, device-scalar ones ``_initial_max(u)`` and
``_dt_of(m)``.
"""

from __future__ import annotations

import numpy as np
import torch


class FusedStepperBase:
    engaged_label = "fused-stage"  # what engaged_path() reports
    device_scalars = False

    def _dt_value(self) -> np.float32:
        raise NotImplementedError

    def _initial_max(self, u) -> torch.Tensor:
        raise NotImplementedError

    def _dt_of(self, m) -> torch.Tensor:
        raise NotImplementedError

    def _buffers(self, u):
        """The padded state ``S`` and two scratch buffers whose ghost
        rings already hold the wall value (the kernels never write
        ghosts)."""
        S = self.embed(u)
        return S, S.clone(), S.clone()

    def _time(self, t, device) -> torch.Tensor:
        """``t`` as a 0-d tensor of its own precision on ``device``."""
        dtype = torch.float64 if isinstance(t, np.float64) else torch.float32
        return torch.full((), t, dtype=dtype, device=device)

    def run(self, u, t, num_iters: int):
        """``num_iters`` fused SSP-RK3 steps; returns ``(u, t)``."""
        S, T1, T2 = self._buffers(u)
        tdt = type(t)
        if self.device_scalars:
            m = self._initial_max(u)
            tt = self._time(t, S.device)
            for _ in range(int(num_iters)):
                dt = self._dt_of(m)
                S, T1, T2 = self._step(S, T1, T2, dt, m)
                tt = tt + dt.to(tt.dtype)
            return self.extract(S), tdt(tt.item())
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
        if self.device_scalars:
            m = self._initial_max(u)
            tt = self._time(t, S.device)
            te_t = self._time(te, S.device)
            while t < te - eps:
                dt = torch.minimum(self._dt_of(m),
                                   (te_t - tt).to(torch.float32))
                S, T1, T2 = self._step(S, T1, T2, dt, m)
                tt = tt + dt.to(tt.dtype)
                t = tdt(tt.item())  # the one read-back a step
                steps += 1
            return self.extract(S), t, steps
        while t < te - eps:
            dt = min(self._dt_value(), np.float32(te - t))
            S, T1, T2 = self._step(S, T1, T2, dt)
            t = t + tdt(dt)
            steps += 1
        return self.extract(S), t, steps
