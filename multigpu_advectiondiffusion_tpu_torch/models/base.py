"""Shared solver machinery, single device (JAX ``models/base.py`` core).

Each concrete solver implements :meth:`SolverBase.build_local` — the
physics (RHS, dt rule, post-step fix-up) — and may offer a fused
stepper through :meth:`SolverBase._fused_stepper`. The base class runs
either: the fused stepper when the config engages one, else the
generic loop of :meth:`SolverBase._local_step`, whose operators run
the per-axis kernels (K11/K12) where :meth:`SolverBase._op_impl` says
``"pallas"`` and plain PyTorch otherwise.

The loops run eagerly on the host, with ``t`` as a host scalar of the
state's precision and the same dt rounding, trim and eps guard as the
JAX package, so both packages take the same steps and land on the same
times.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary, pad_axis
from multigpu_advectiondiffusion_tpu_torch.core.dtypes import canonicalize
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.state import SolverState
from multigpu_advectiondiffusion_tpu_torch.ops import (
    is_fused_impl,
    is_pallas_impl,
    op_impl,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    laplacian as klap,
)
from multigpu_advectiondiffusion_tpu_torch.ops.stencils import Padder
from multigpu_advectiondiffusion_tpu_torch.timestepping.integrators import (
    INTEGRATORS,
)
from multigpu_advectiondiffusion_tpu_torch.utils.ic import initial_condition


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a GPU that is absent is an error, never a
    silent move to the CPU (the caller asks for ``"cpu"`` explicitly)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class StepContext:
    """What the local physics may depend on (single device)."""

    padder: Padder
    offsets: Sequence[int]
    local_shape: Tuple[int, ...]
    global_shape: Tuple[int, ...]
    device: torch.device


@dataclasses.dataclass
class LocalPhysics:
    """Product of :meth:`SolverBase.build_local`."""

    rhs: Callable[[torch.Tensor], torch.Tensor]
    static_dt: Optional[float] = None
    post: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # adaptive dt: u -> 0-d tensor (e.g. the advective CFL bound)
    dt_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class SolverBase:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = canonicalize(cfg.dtype)
        self._cache = {}
        self._fused_fallback = None
        self._op_fallback = None

    # ------------------------------------------------------------------ #
    # Config plumbing
    # ------------------------------------------------------------------ #
    @property
    def grid(self) -> Grid:
        return self.cfg.grid

    @property
    def bcs(self) -> Tuple[Boundary, ...]:
        spec = self.cfg.bc
        if isinstance(spec, (list, tuple)):
            out = tuple(Boundary.parse(s) for s in spec)
            if len(out) != self.grid.ndim:
                raise ValueError("per-axis bc list rank mismatch")
            return out
        return (Boundary.parse(spec),) * self.grid.ndim

    @property
    def integrator(self):
        return INTEGRATORS[self.cfg.integrator]

    def build_local(self, ctx: StepContext) -> LocalPhysics:
        raise NotImplementedError

    def ic_spec(self):
        return self.cfg.ic, {}

    # ------------------------------------------------------------------ #
    # State creation
    # ------------------------------------------------------------------ #
    def initial_state(self, t: float | None = None) -> SolverState:
        name, defaults = self.ic_spec()
        params = {**defaults, **dict(self.cfg.ic_params)}
        u0 = initial_condition(name, self.grid, dtype=self.dtype,
                               device=self.device, **params)
        t0 = t if t is not None else getattr(self.cfg, "t0", 0.0)
        return SolverState.create(u0, t=t0)

    # ------------------------------------------------------------------ #
    # Generic step
    # ------------------------------------------------------------------ #
    def _context(self) -> StepContext:
        gshape = self.grid.shape
        return StepContext(
            padder=lambda x, axis, halo: pad_axis(x, axis, halo,
                                                  self.bcs[axis]),
            offsets=[0] * self.grid.ndim,
            local_shape=gshape,
            global_shape=gshape,
            device=self.device,
        )

    def _physics(self) -> LocalPhysics:
        if "physics" not in self._cache:
            self._cache["physics"] = self.build_local(self._context())
        return self._cache["physics"]

    def _local_step(self, u, t, t_end=None):
        """One generic time step; ``t``/``t_end`` are host scalars of the
        state's precision. dt is rounded to that precision, trimmed to
        ``t_end - t``, and fed to the integrator as that value. An
        adaptive dt (``dt_fn``) is computed on the device and read back
        once a step: this loop is the yardstick, not the timed path."""
        phys = self._physics()
        tdt = type(t)
        if phys.dt_fn is not None:
            dt = tdt(phys.dt_fn(u).item())
        else:
            dt = tdt(phys.static_dt)
        if t_end is not None:
            dt = min(dt, tdt(t_end - t))
        u = self.integrator(phys.rhs, u, float(dt), phys.post)
        return u, t + dt

    def step(self, state: SolverState) -> SolverState:
        """One generic step (the JAX package's ``step`` is generic too)."""
        u, t = self._local_step(state.u, state.t)
        return SolverState(u=u, t=t, it=state.it + 1)

    # ------------------------------------------------------------------ #
    # Fused path bookkeeping
    # ------------------------------------------------------------------ #
    def _fused_stepper(self, mode: str = "iters"):
        """Solver-specific fused fast path, or ``None`` (generic)."""
        del mode
        return None

    def _decline(self, reason: str):
        """Record why the fused path was declined (read by
        :meth:`engaged_path`) and return ``None``."""
        self._fused_fallback = reason
        return None

    def _pallas_f32_gate(self, impl: str) -> str:
        """Route non-f32 dtypes off the per-axis kernels, which are
        float32-only (the JAX package's gate, with its reason)."""
        if impl == "pallas" and self.dtype != torch.float32:
            self._op_fallback = (
                "per-axis Pallas kernels are float32-only; XLA runs"
            )
            return "xla"
        return impl

    def _op_impl(self) -> str:
        """Per-op kernel strategy of the generic loop: ``"pallas"`` (the
        per-axis kernels) or ``"xla"``; a decline's reason lands in
        ``_op_fallback``. Solvers add their own rules."""
        self._op_fallback = None
        return self._pallas_f32_gate(op_impl(self.cfg.impl))

    def _laplacian_impl(self, impl: str, order: int) -> str:
        """What ``laplacian`` runs under the per-op strategy ``impl``:
        K11 computes the O4 stencil only, so another order runs the
        plain sum, and ``_op_fallback`` says so (the JAX package falls
        back inside the operator without a word)."""
        if impl == "pallas" and not klap.supported(self.grid.shape, order):
            self._op_fallback = (
                f"K11 computes the O4 Laplacian only; the order-{order} "
                "Laplacian runs in plain PyTorch"
            )
            return "xla"
        return impl

    def engaged_path(self, mode: str = "iters") -> dict:
        """Which kernel strategy executes for this config.

        Keys as in the JAX package: ``impl`` (requested), ``stepper``
        (``fused-stage``, ``fused-step``, ``fused-whole-run``,
        ``fused-whole-run-slab``, ``per-axis-pallas`` or
        ``generic-xla``), ``overlap``, ``steps_per_exchange``,
        ``exchange``, ``storage_dtype``, ``precision``, and ``fallback``
        — why a requested rung did not run, or ``None``: the fused
        decline, then ``"; "`` and the per-op reason, as in the JAX
        package. Unlike the JAX package, a fused run may carry a
        ``fallback`` too (the reason a rung the JAX package would pick
        instead is not available here), and so may a per-axis run where
        one operator's kernel declines and that operator runs in plain
        PyTorch (the JAX package falls back inside the operator and
        does not say so).

        ``mode="t_end"`` mirrors :meth:`advance_to`: a fused stepper
        without ``run_to`` (the whole-run steppers) leaves it to the
        generic loop, and ``fallback`` says so.
        """
        impl = self.cfg.impl
        fused = self._fused_stepper(mode)
        if fused is not None and mode == "t_end" and not hasattr(
            fused, "run_to"
        ):
            self._fused_fallback = (
                f"{fused.engaged_label} stepper has no run_to; "
                "t_end mode runs the generic loop"
            )
            fused = None
        if fused is not None:
            stepper = fused.engaged_label
            storage = fused.dtype
            fallback = self._fused_fallback
        else:
            op = self._op_impl()
            stepper = "per-axis-pallas" if op == "pallas" else "generic-xla"
            storage = self.dtype
            fallback = None
            if is_fused_impl(impl):
                fallback = self._fused_fallback or "config not fused-eligible"
                if self._op_fallback:
                    fallback += "; " + self._op_fallback
            elif is_pallas_impl(impl):
                # the per-axis rung pinned: why it or one of its
                # operators does not run its kernel
                fallback = self._op_fallback
        return {
            "impl": impl,
            "stepper": stepper,
            "overlap": None,
            "steps_per_exchange": 1,
            "exchange": "collective",
            "storage_dtype": str(storage).replace("torch.", ""),
            "precision": "native",
            "fallback": fallback,
        }

    # ------------------------------------------------------------------ #
    # Execution
    # ------------------------------------------------------------------ #
    def run(self, state: SolverState, num_iters: int) -> SolverState:
        """Fixed-count loop (the CUDA drivers' ``max_iters`` mode,
        ``MultiGPU/Diffusion3d_Baseline/main.c:189``)."""
        return self._run_impl(state, num_iters)

    def _run_impl(self, state: SolverState, num_iters: int) -> SolverState:
        fused = self._fused_stepper()
        if fused is not None:
            u, t = fused.run(state.u, state.t, num_iters)
            return SolverState(u=u, t=t, it=state.it + int(num_iters))
        u, t = state.u, state.t
        for _ in range(int(num_iters)):
            u, t = self._local_step(u, t)
        return SolverState(u=u, t=t, it=state.it + int(num_iters))

    def advance_to(self, state: SolverState, t_end: float) -> SolverState:
        """March until ``t_end`` with the last step trimmed to land exactly
        (the corrected MATLAB driver loop, heat3d.m:48-77)."""
        return self._advance_impl(state, t_end)

    def _advance_impl(self, state: SolverState, t_end: float) -> SolverState:
        fused = self._fused_stepper(mode="t_end")
        if fused is not None and hasattr(fused, "run_to"):
            u, t, steps = fused.run_to(state.u, state.t, t_end)
            return SolverState(u=u, t=t, it=state.it + steps)
        tdt = type(state.t)
        te = tdt(t_end)
        eps = tdt(1e-12) * max(tdt(1.0), abs(te))
        u, t, steps = state.u, state.t, 0
        while t < te - eps:
            u, t = self._local_step(u, t, t_end=te)
            steps += 1
        return SolverState(u=u, t=t, it=state.it + steps)
