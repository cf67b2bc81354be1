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

Sharded (a shard of a device mesh, ``sharded = True``): ``run`` and
``run_to`` take the JAX package's ``refresh`` (the in-place ghost
refresh after every stage), ``offsets`` (this shard's global offsets)
and, for the split schedule, ``exch`` (the exchanged z slabs), and pass
them to ``_step``; a device-scalar ``run`` then returns ``t`` as a 0-d
tensor, which the solver reads once, from one shard.
"""

from __future__ import annotations

import numpy as np
import torch


def chunk_counts(num_iters: int, steps_per_exchange: int):
    """``(full_blocks, remainder)`` of the k-step schedule: whole blocks
    of ``steps_per_exchange`` steps (one deep halo exchange each) and
    one partial block of the remainder (which still pays a full-depth
    exchange), the JAX package's one definition."""
    if steps_per_exchange < 1:
        raise ValueError(
            f"steps_per_exchange must be >= 1, got {steps_per_exchange}")
    return num_iters // steps_per_exchange, num_iters % steps_per_exchange


class FusedStepperBase:
    engaged_label = "fused-stage"  # what engaged_path() reports
    device_scalars = False
    sharded = False
    overlap_split = False
    # the halo transport and the declared in-kernel exchange (JAX
    # ``stepper_base.py:87``): the per-stage steppers exchange between
    # launches; only the slab rung moves ghost rows inside a kernel (K4)
    exchange = "collective"
    remote_dma = None

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

    def _sharded_kw(self, refresh, offsets, exch) -> dict:
        """What ``_step`` takes on a shard (nothing unsharded); raises on
        a sharded run missing what its schedule needs (the JAX package's
        ``_check_sharded_args``)."""
        if not self.sharded:
            return {}
        if offsets is None:
            raise ValueError("sharded fused stepper needs offsets")
        if self.overlap_split and exch is None:
            raise ValueError("split-overlap fused stepper needs exch")
        if not self.overlap_split and refresh is None:
            raise ValueError("sharded fused stepper needs a ghost refresh")
        return {"refresh": refresh, "offsets": offsets, "exch": exch}

    def _start(self, u, refresh):
        """The buffers, ``S`` refreshed on a shard (non-split: every
        sharded axis; split: the serialized non-z axes of a pencil)."""
        S, T1, T2 = self._buffers(u)
        if refresh is not None:
            refresh(S)
        return S, T1, T2

    def run(self, u, t, num_iters: int, refresh=None, offsets=None,
            exch=None):
        """``num_iters`` fused SSP-RK3 steps; returns ``(u, t)``."""
        kw = self._sharded_kw(refresh, offsets, exch)
        S, T1, T2 = self._start(u, refresh)
        tdt = type(t)
        if self.device_scalars:
            m = self._initial_max(u)
            tt = self._time(t, S.device)
            for _ in range(int(num_iters)):
                dt = self._dt_of(m)
                S, T1, T2 = self._step(S, T1, T2, dt, m, **kw)
                tt = tt + dt.to(tt.dtype)
            return self.extract(S), tt if self.sharded else tdt(tt.item())
        dt = self._dt_value()
        for _ in range(int(num_iters)):
            S, T1, T2 = self._step(S, T1, T2, dt, **kw)
            t = t + tdt(dt)
        return self.extract(S), t

    def run_to(self, u, t, t_end, refresh=None, offsets=None, exch=None):
        """March fused steps until ``t_end``; returns ``(u, t, steps)``."""
        kw = self._sharded_kw(refresh, offsets, exch)
        S, T1, T2 = self._start(u, refresh)
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
                S, T1, T2 = self._step(S, T1, T2, dt, m, **kw)
                tt = tt + dt.to(tt.dtype)
                t = tdt(tt.item())  # the one read-back a step
                steps += 1
            return self.extract(S), t, steps
        while t < te - eps:
            dt = min(self._dt_value(), np.float32(te - t))
            S, T1, T2 = self._step(S, T1, T2, dt, **kw)
            t = t + tdt(dt)
            steps += 1
        return self.extract(S), t, steps
