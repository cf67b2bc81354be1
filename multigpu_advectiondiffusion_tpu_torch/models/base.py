"""Shared solver machinery (JAX ``models/base.py`` core): one device, or
a device mesh driven from this process.

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

Under a device mesh (``mesh=``/``decomp=``, :mod:`parallel.mesh`) ``u``
is a :class:`~models.state.ShardedArray` and ``run``/``advance_to`` run
the JAX package's per-shard program on every shard through the port's
``shard_map``: the generic loop with a padder that exchanges ghosts
(``parallel/halo.py``) and a cross-shard ``pmax`` in adaptive dt, or a
fused stepper's ``run`` with the ghost ``refresh``, the split
schedule's ``exch`` and this shard's global ``offsets``
(:meth:`SolverBase._fused_sharded_ctx`).

The batched ensemble engine (JAX ``models/base.py:1191-1657``, front
end in ``models/ensemble.py``) advances B members of an
:class:`EnsembleState` per dispatch on one of three rungs:

* ``ensemble-fold[fused-whole-run-slab]``: uniform physics on the slab
  rung, B folded into one cooperative launch (K2b);
* ``ensemble-vmap[fused-stage]``: uniform physics on the per-stage rung,
  the JAX package's ``vmap`` of the stage kernel lowered to K1, K5 or K9
  launched once per member per stage;
* ``ensemble-vmap[generic-xla]``: the generic loop per member, with the
  member-varying scalars (``operands``) as 0-d float32 tensors in place
  of the JAX package's traced operands — dt derives from them in float32
  (``timestepping/cfl.py``) and ``t`` is carried as a 0-d tensor, so the
  loop is differentiable with respect to them (``torch.autograd``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary, pad_axis
from multigpu_advectiondiffusion_tpu_torch.core.dtypes import canonicalize
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.state import (
    EnsembleState,
    ShardedArray,
    SolverState,
)
from multigpu_advectiondiffusion_tpu_torch.ops import (
    is_fused_impl,
    is_pallas_impl,
    op_impl,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    laplacian as klap,
)
from multigpu_advectiondiffusion_tpu_torch.ops.stencils import Padder
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh
from multigpu_advectiondiffusion_tpu_torch.parallel.halo import (
    axis_offsets,
    exchange_ghosts,
    make_ghost_fn,
    make_ghost_refresh,
    make_padder,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
    MEMBER_AXIS,
    Decomposition,
    axis_extent,
    reduce_axis_names,
)
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


class _Donated(torch.Tensor):
    """The class a donated ensemble state's ``u`` takes once consumed:
    every later use raises."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(
            "this tensor was donated to an ensemble dispatch and consumed; "
            "use the state the dispatch returned"
        )


def _consume_donated(*tensors) -> None:
    """Donation semantics on every device (JAX ``_consume_donated``): a
    donated tensor drops its storage (freed once no view holds it) and
    any later use raises ``RuntimeError``. Views taken before, and the
    dispatch's outputs, are separate tensors and stay valid."""
    for t in tensors:
        if isinstance(t, _Donated):
            continue
        with torch.no_grad():
            t.set_()
        t.__class__ = _Donated


def ensemble_cfg_gate(cfg) -> None:
    """The config-level declines of the batched ensemble engine (the JAX
    package's ``_ensemble_gate``, with its texts), checked before a
    solver is built, since the port's solvers refuse these configs at
    construction."""
    if int(getattr(cfg, "steps_per_exchange", 1) or 1) > 1:
        raise ValueError(
            "steps_per_exchange > 1 rides the spatially sharded "
            "slab rung, whose k-step deep-halo schedule does not "
            "fold a member axis — run ensembles at the per-step "
            "exchange cadence"
        )
    if str(getattr(cfg, "exchange", "collective")) == "dma":
        raise ValueError(
            "exchange='dma' rides the spatially sharded slab "
            "rung, whose in-kernel remote-DMA ring does not fold "
            "a member axis — the batched ensemble engine keeps "
            "the collective exchange"
        )
    if str(getattr(cfg, "precision", "native")) == "bf16":
        raise ValueError(
            "precision='bf16' is a single-run rung: neither the "
            "vmapped fused stepper nor the B-folded slab grid "
            "threads the bf16 storage split (and its compensation "
            "carry) through the member axis — run ensembles at "
            "native precision"
        )


@dataclasses.dataclass
class StepContext:
    """What the shard-local physics may depend on."""

    padder: Padder
    offsets: Sequence[int]  # global index offset of this block, per axis
    local_shape: Tuple[int, ...]
    global_shape: Tuple[int, ...]
    device: torch.device
    reduce_max: Callable = lambda x: x  # noqa: E731  (cross-shard pmax)
    # (lo, hi) ghost slabs for sharded axes (None per-axis when local;
    # None entirely when unsharded): the overlapped interior/boundary
    # schedule (ops.stencils.split_axis_apply)
    ghost_fn: Optional[Callable] = None


@dataclasses.dataclass
class LocalPhysics:
    """Product of :meth:`SolverBase.build_local`."""

    rhs: Callable[[torch.Tensor], torch.Tensor]
    static_dt: Optional[float] = None
    post: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # adaptive dt: u -> 0-d tensor (e.g. the advective CFL bound)
    dt_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def global_field(u) -> torch.Tensor:
    """``u`` as one tensor: a sharded field assembled."""
    return u.assemble() if isinstance(u, ShardedArray) else u


class SolverBase:
    def __init__(self, cfg, device=None, mesh=None,
                 decomp: Decomposition | None = None):
        self.cfg = cfg
        self.mesh = mesh
        self.decomp = decomp
        if mesh is None:
            if decomp is not None:
                raise ValueError("a decomposition needs a mesh")
            self.device = resolve_device(device)
        else:
            if device is not None:
                raise ValueError(
                    "a mesh names its devices; pass device=None")
            if MEMBER_AXIS in mesh.shape:
                raise NotImplementedError(
                    "member-sharded ensemble meshes (a 'members' axis) are "
                    "not ported yet (ROADMAP queue 1 item 8f)")
            for dev in mesh.device_list():
                resolve_device(dev)
            self.device = mesh.device_list()[0]
            if decomp is None:
                self.decomp = Decomposition.slab(tuple(mesh.shape)[0])
            self.decomp.validate(mesh, cfg.grid.shape)
        self.dtype = canonicalize(cfg.dtype)
        self._cache = {}
        self._fused_fallback = None
        self._op_fallback = None
        self._ensemble_last = None
        self._validate_steps_per_exchange()
        self._validate_exchange()

    # ------------------------------------------------------------------ #
    # Mesh knobs, gated at construction as the JAX package gates them
    # ------------------------------------------------------------------ #
    def _validate_steps_per_exchange(self) -> None:
        """A config that cannot honor ``steps_per_exchange > 1`` fails at
        construction (the JAX package's gate and texts); deeper
        eligibility raises at dispatch (``_select_slab``)."""
        k = int(getattr(self.cfg, "steps_per_exchange", 1) or 1)
        if k == 1:
            return
        if self.grid.ndim != 3:
            raise ValueError(
                "steps_per_exchange > 1 rides the 3-D slab stepper only"
            )
        if self.mesh is None:
            raise ValueError(
                "steps_per_exchange > 1 needs a device mesh — it trades "
                "deeper halo exchanges for fewer of them"
            )
        if any(ax != 0 for ax in self._sharded_axes()):
            raise ValueError(
                "steps_per_exchange > 1 serves z-slab decompositions only"
            )
        if self.cfg.impl not in ("pallas", "pallas_slab"):
            raise ValueError(
                f"steps_per_exchange={k} needs the sharded slab rung "
                f"(impl='pallas'/'pallas_slab'/'auto'), not "
                f"impl={self.cfg.impl!r}"
            )

    def _exchange_mode(self) -> str:
        return str(getattr(self.cfg, "exchange", "collective")
                   or "collective")

    def _validate_exchange(self) -> None:
        """``exchange='dma'`` (the in-kernel exchange of the sharded slab
        rung, K4): the JAX package's construction gate and texts. Its
        process-count check has no counterpart (one process drives every
        shard); eligibility at dispatch is ``_select_slab``'s, which
        raises where ``dma`` is asked for."""
        if self._exchange_mode() != "dma":
            return
        if self.grid.ndim != 3:
            raise ValueError(
                "exchange='dma' rides the 3-D sharded slab rung only"
            )
        if self.mesh is None:
            raise ValueError(
                "exchange='dma' pushes ghost rows between z neighbors "
                "— it needs a device mesh (an unsharded run has no "
                "neighbor to push to)"
            )
        if any(ax != 0 for ax in self._sharded_axes()):
            raise ValueError(
                "exchange='dma' serves z-slab decompositions only"
            )
        if self.cfg.impl not in ("pallas", "pallas_slab"):
            raise ValueError(
                "exchange='dma' needs the sharded slab rung "
                "(impl='pallas'/'pallas_slab'/'auto'), not "
                f"impl={self.cfg.impl!r}"
            )
        if getattr(self.cfg, "overlap", None) == "split":
            raise ValueError(
                "exchange='dma' replaces the XLA exchange entirely — "
                "the split-overlap schedule does not compose with it "
                "(drop overlap='split')"
            )
        name = self.decomp.mesh_axis(0)
        if not isinstance(name, str):
            raise ValueError(
                "exchange='dma' cannot ride a compound (multihost) "
                "mesh axis — remote DMA moves over ICI, not DCN"
            )
        if len(dict(self.mesh.shape)) != 1:
            raise ValueError(
                "exchange='dma' serves single-axis z-slab meshes: the "
                "remote-DMA ring addresses logical device ids along "
                "ONE mesh axis"
            )

    def _dma_stepper_kwargs(self) -> dict:
        """What arms a slab stepper's in-kernel exchange: the (checked,
        single, string) z mesh axis and its shard count."""
        sizes = dict(self.mesh.shape)
        name = self.decomp.mesh_axis(0)
        return {
            "exchange": "dma",
            "mesh_axis": name,
            "num_shards": axis_extent(sizes, name),
        }

    def _sharded_axes(self):
        """Array axes that are actually decomposed: listed in the
        decomposition AND backed by a mesh extent > 1 (compound axes by
        their product)."""
        if self.mesh is None:
            return []
        sizes = dict(self.mesh.shape)
        return [ax for ax, name in self.decomp.axes
                if axis_extent(sizes, name) > 1]

    def _split_overlap_requested(self) -> bool:
        """``overlap='split'`` with a decomposition the fused steppers'
        three-call schedule serves: axis 0 alone sharded (z slabs in 3-D,
        y slabs in 2-D), and in 3-D z with y and/or x as well (their
        ghosts then take the serialized per-stage refresh)."""
        if self.mesh is None or getattr(self.cfg, "overlap", None) != "split":
            return False
        sharded = self._sharded_axes()
        if sharded == [0]:
            return True
        return self.grid.ndim == 3 and bool(sharded) and sharded[0] == 0

    def local_shape(self):
        """This solver's shard-local interior shape (the grid's when
        unsharded)."""
        if self.mesh is None:
            return self.grid.shape
        return self.decomp.local_shape(self.mesh, self.grid.shape)

    def mesh_reduce_max(self):
        """Cross-shard max over the decomposition's reduction axes
        (``parallel.mesh.reduce_axis_names``), or ``None`` when unsharded
        or every extent is 1. Runs inside ``shard_map``."""
        if self.mesh is None:
            return None
        names = reduce_axis_names(self.decomp, self.mesh.shape)
        if not names:
            return None
        return lambda x: pmesh.pmax(x, names)

    def mesh_reduce_sum(self):
        """Cross-shard sum over the same axis set as
        :meth:`mesh_reduce_max`, or ``None``."""
        if self.mesh is None:
            return None
        names = reduce_axis_names(self.decomp, self.mesh.shape)
        if not names:
            return None
        return lambda x: pmesh.psum(x, names)

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

    def build_local(self, ctx: StepContext, overrides=None) -> LocalPhysics:
        """The local physics. ``overrides`` (ensemble mode only) maps
        member-varying scalar names — the keys of
        :meth:`ensemble_operands` — to 0-d float32 tensors that enter the
        step as operands, dt derived from them."""
        raise NotImplementedError

    def ensemble_operands(self) -> dict:
        """The member-varying scalars of the batched ensemble engine:
        ``{name: default}`` for every scalar :meth:`build_local` takes as
        an override. The base class supports none."""
        return {}

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
        if self.mesh is not None:
            # the IC is computed globally and cut into the shards, as the
            # reference computes it on every rank (main.c:112-130)
            u0 = ShardedArray.scatter(u0, self.mesh, self.decomp)
        t0 = t if t is not None else getattr(self.cfg, "t0", 0.0)
        return SolverState.create(u0, t=t0)

    # ------------------------------------------------------------------ #
    # Generic step
    # ------------------------------------------------------------------ #
    def _context(self) -> StepContext:
        """The step context of this shard (inside ``shard_map``) or of the
        single device."""
        gshape = self.grid.shape
        if self.mesh is None:
            return StepContext(
                padder=lambda x, axis, halo: pad_axis(x, axis, halo,
                                                      self.bcs[axis]),
                offsets=[0] * self.grid.ndim,
                local_shape=gshape,
                global_shape=gshape,
                device=self.device,
            )
        sizes = dict(self.mesh.shape)
        reduce = self.mesh_reduce_max()
        lshape = self.local_shape()
        return StepContext(
            padder=make_padder(self.decomp, sizes, self.bcs),
            offsets=axis_offsets(self.decomp, lshape),
            local_shape=lshape,
            global_shape=gshape,
            device=pmesh.current_shard().device,
            reduce_max=reduce if reduce is not None else (lambda x: x),
            ghost_fn=make_ghost_fn(self.decomp, sizes, self.bcs),
        )

    def _physics(self, overrides=None) -> LocalPhysics:
        """The local physics: cached (per shard under a mesh) for the
        config's own scalars, built afresh for ensemble ``overrides``."""
        if overrides:
            return self.build_local(self._context(), overrides=overrides)
        shard = pmesh.current_shard()
        key = "physics" if shard is None else ("physics", shard.rank)
        if key not in self._cache:
            self._cache[key] = self.build_local(self._context())
        return self._cache[key]

    def _local_step(self, u, t, t_end=None, overrides=None, phys=None):
        """One generic time step; ``t``/``t_end`` are host scalars of the
        state's precision. dt is rounded to that precision, trimmed to
        ``t_end - t``, and fed to the integrator as that value. An
        adaptive dt (``dt_fn``) is computed on the device and read back
        once a step: this loop is the yardstick, not the timed path.

        ``overrides`` threads member-varying operands into
        :meth:`build_local` (``phys``, the physics already built with
        them); then ``t`` and ``t_end`` are 0-d CPU tensors of the
        time dtype (:meth:`_operand_step`)."""
        if phys is None:
            phys = self._physics(overrides)
        if isinstance(t, torch.Tensor):
            return self._operand_step(phys, u, t, t_end)
        tdt = type(t)
        if phys.dt_fn is not None:
            dt = tdt(phys.dt_fn(u).item())
        else:
            dt = tdt(phys.static_dt)
        if t_end is not None:
            dt = min(dt, tdt(t_end - t))
        u = self.integrator(phys.rhs, u, float(dt), phys.post)
        return u, t + dt

    def _operand_step(self, phys: LocalPhysics, u, t, t_end=None):
        """The generic step with ensemble operands, as the JAX package
        traces it (``models/base.py:512-524``): dt a 0-d float32 tensor
        from the operands (an adaptive one read back from the device),
        ``min(dt, t_end - t)`` in the promoted dtype, cast to ``t``'s
        dtype; ``t`` a 0-d CPU tensor, so the step stays differentiable
        in the operands and the ``t < t_end`` test reads no device."""
        if phys.dt_fn is not None:
            dt = phys.dt_fn(u).to("cpu")
        else:
            dt = phys.static_dt
            if not isinstance(dt, torch.Tensor):
                dt = torch.full((), dt, dtype=t.dtype)
        if t_end is not None:
            dt = torch.minimum(dt, t_end - t)
        dt = dt.to(t.dtype)
        u = self.integrator(phys.rhs, u, dt.to(u.dtype), phys.post)
        return u, t + dt

    def step(self, state: SolverState) -> SolverState:
        """One generic step (the JAX package's ``step`` is generic too)."""
        if self.mesh is not None:
            u, t = self._sharded(self._local_step)(state.u, state.t)
        else:
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
        :meth:`engaged_path`) and return ``None``; under
        ``steps_per_exchange > 1`` or ``exchange='dma'``, which only the
        sharded slab rung serves, raise the JAX package's error instead
        (in its order: the exchange cadence first)."""
        self._fused_fallback = reason
        if int(getattr(self.cfg, "steps_per_exchange", 1) or 1) > 1:
            raise ValueError(
                "steps_per_exchange > 1 needs the sharded slab rung; "
                f"this config declined fusion: {reason}"
            )
        if self._exchange_mode() == "dma":
            raise ValueError(
                "exchange='dma' needs the sharded slab rung; "
                f"this config declined fusion: {reason}"
            )
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
        ``generic-xla``), ``overlap`` (the sharded halo schedule in
        effect: a fused stepper's ``"split"`` or
        ``"serialized-refresh"``, the generic loop's ``cfg.overlap``,
        ``None`` unsharded), ``steps_per_exchange``, ``exchange``,
        ``storage_dtype``, ``precision``, and ``fallback`` — why a
        requested rung did not run, or ``None``: the fused decline, then
        ``"; "`` and the per-op reason, as in the JAX package. Unlike the
        JAX package, a fused run may carry a ``fallback`` too (the reason
        a rung the JAX package would pick instead is not available
        here), and so may a per-axis run where one operator's kernel
        declines and that operator runs in plain PyTorch (the JAX
        package falls back inside the operator and does not say so). The
        mesh itself is ``self.mesh`` (``mesh.shape``), as in the JAX
        package.

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
            # the whole-step and whole-run steppers are single-device only
            overlap = None
            exchange = getattr(fused, "exchange", "collective")
            if getattr(fused, "sharded", False):
                if exchange == "dma":
                    # the exchange runs inside K4: no schedule around it
                    overlap = "in-kernel"
                else:
                    overlap = ("split" if fused.overlap_split
                               else "serialized-refresh")
            k = getattr(fused, "steps_per_exchange", 1)
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
            overlap = self.cfg.overlap if self.mesh is not None else None
            k = self.cfg.steps_per_exchange
            exchange = self._exchange_mode()
        return {
            "impl": impl,
            "stepper": stepper,
            "overlap": overlap,
            "steps_per_exchange": int(k),
            "exchange": exchange,
            "storage_dtype": str(storage).replace("torch.", ""),
            "precision": "native",
            "fallback": fallback,
        }

    def _fused_sharded_ctx(self, fused):
        """``(refresh, offsets, exch)`` for running a fused stepper on a
        shard (the JAX package's ``_fused_sharded_ctx``): ghosts
        refreshed in place after every RK stage (or step), this shard's
        global offsets for the kernels' global wall masks, and, when the
        stepper runs the split schedule (``fused.overlap_split``),
        ``exch`` in place of ``refresh``: the ``(lo, hi)`` exchanged
        slabs of axis 0 (z in 3-D, y in 2-D) of the padded buffer's core,
        issued on the shard's exchange stream
        (:func:`parallel.mesh.exchange_stream`) so the interior call runs
        while they are in flight; the stepper joins the streams
        (:func:`parallel.mesh.wait_exchange`) before the edge calls
        consume them. On 3-D pencil meshes the non-z sharded axes keep
        the serialized refresh. Both exchange at the stepper's
        ``exchange_depth`` (the stencil halo, or ``k * G`` for the
        k-step slab schedule). A slab stepper with the in-kernel exchange
        (``exchange == "dma"``, K4) takes the offsets alone. All ``None``
        when unsharded. Runs inside ``shard_map``."""
        if self.mesh is None or not fused.sharded:
            return None, None, None
        offsets = tuple(axis_offsets(self.decomp, fused.interior_shape))
        if getattr(fused, "exchange", "collective") == "dma":
            return None, offsets, None
        sizes = dict(self.mesh.shape)
        depth = int(getattr(fused, "exchange_depth", fused.halo))
        core_offsets = getattr(fused, "core_offsets", None)
        if getattr(fused, "overlap_split", False):
            name = self.decomp.mesh_axis(0)
            nsh = axis_extent(sizes, name)
            off = (core_offsets or (fused.halo,))[0]
            lz = fused.interior_shape[0]

            def exch(P, repeats: int = 1):
                del repeats
                with pmesh.exchange_stream():
                    return exchange_ghosts(P.narrow(0, off, lz), 0, depth,
                                           name, nsh, self.bcs[0])

            others = {ax: nm for ax, nm in self.decomp.axes
                      if ax != 0 and axis_extent(sizes, nm) > 1}
            refresh = None
            if others:
                refresh = make_ghost_refresh(
                    Decomposition.of(others), sizes, self.bcs, fused.halo,
                    fused.interior_shape, core_offsets=core_offsets)
            return refresh, offsets, exch
        refresh = make_ghost_refresh(
            self.decomp, sizes, self.bcs, depth, fused.interior_shape,
            core_offsets=core_offsets)
        return refresh, offsets, None

    def _sharded(self, fn, n_in: int = 1, n_out: int = 1):
        """``fn(u, *scalars) -> (u, *scalars)`` run on every shard of the
        mesh: ``u`` sharded by the decomposition, scalars shared."""
        d = self.decomp
        return pmesh.shard_map(fn, self.mesh, (d,) + (None,) * n_in,
                               (d,) + (None,) * n_out)

    @staticmethod
    def _host_t(t, tdt):
        """A shard's time as the host scalar of the state's precision (a
        device-scalar stepper returns a 0-d tensor: read once, here)."""
        return tdt(t.item()) if isinstance(t, torch.Tensor) else t

    # ------------------------------------------------------------------ #
    # Execution
    # ------------------------------------------------------------------ #
    def run(self, state: SolverState, num_iters: int) -> SolverState:
        """Fixed-count loop (the CUDA drivers' ``max_iters`` mode,
        ``MultiGPU/Diffusion3d_Baseline/main.c:189``)."""
        return self._run_impl(state, num_iters)

    def _run_impl(self, state: SolverState, num_iters: int) -> SolverState:
        fused = self._fused_stepper()
        n = int(num_iters)
        if self.mesh is not None:
            u, t = self._sharded(
                lambda u, t: self._run_block(fused, u, t, n))(state.u,
                                                              state.t)
            return SolverState(u=u, t=self._host_t(t, type(state.t)),
                               it=state.it + n)
        u, t = self._run_block(fused, state.u, state.t, n)
        return SolverState(u=u, t=t, it=state.it + n)

    def _run_block(self, fused, u, t, n: int):
        """``n`` steps of the block program (one shard's, under a mesh):
        the fused stepper's ``run`` or the generic loop."""
        if fused is not None:
            refresh, offsets, exch = self._fused_sharded_ctx(fused)
            if refresh is None and offsets is None and exch is None:
                return fused.run(u, t, n)
            return fused.run(u, t, n, refresh=refresh, offsets=offsets,
                             exch=exch)
        for _ in range(n):
            u, t = self._local_step(u, t)
        return u, t

    def advance_to(self, state: SolverState, t_end: float) -> SolverState:
        """March until ``t_end`` with the last step trimmed to land exactly
        (the corrected MATLAB driver loop, heat3d.m:48-77)."""
        return self._advance_impl(state, t_end)

    def _advance_impl(self, state: SolverState, t_end: float) -> SolverState:
        fused = self._fused_stepper(mode="t_end")
        if fused is not None and not hasattr(fused, "run_to"):
            fused = None
        if self.mesh is not None:
            u, t, steps = self._sharded(
                lambda u, t: self._advance_block(fused, u, t, t_end),
                n_out=2)(state.u, state.t)
            return SolverState(u=u, t=t, it=state.it + steps)
        u, t, steps = self._advance_block(fused, state.u, state.t, t_end)
        return SolverState(u=u, t=t, it=state.it + steps)

    def _advance_block(self, fused, u, t, t_end):
        """March the block program (one shard's, under a mesh) until
        ``t_end``: the fused stepper's ``run_to`` or the generic loop;
        returns ``(u, t, steps)``."""
        if fused is not None:
            refresh, offsets, exch = self._fused_sharded_ctx(fused)
            if refresh is None and offsets is None and exch is None:
                return fused.run_to(u, t, t_end)
            return fused.run_to(u, t, t_end, refresh=refresh,
                                offsets=offsets, exch=exch)
        tdt = type(t)
        te = tdt(t_end)
        eps = tdt(1e-12) * max(tdt(1.0), abs(te))
        steps = 0
        while t < te - eps:
            u, t = self._local_step(u, t, t_end=te)
            steps += 1
        return u, t, steps

    # ------------------------------------------------------------------ #
    # Ensemble (leading-member-axis) execution: B members per dispatch
    # (JAX models/base.py:1191-1657; front end in models/ensemble.py)
    # ------------------------------------------------------------------ #
    def _ensemble_gate(self, operand_names=()) -> None:
        """Loud eligibility gate of the batched dispatch, the JAX
        package's declines and texts: the config-level ones
        (:func:`ensemble_cfg_gate`), the slab pin with member-varying
        operands, and unknown operand names. A solver on a device mesh
        raises: member-sharded ensemble meshes are not ported."""
        if self.mesh is not None:
            raise NotImplementedError(
                "ensembles on a device mesh (a 'members' axis) are not "
                "ported yet (ROADMAP queue 1 item 8f); the port's ensemble "
                "runs on one device")
        ensemble_cfg_gate(self.cfg)
        if getattr(self.cfg, "impl", "xla") == "pallas_slab" and (
            operand_names
        ):
            raise ValueError(
                "the B-folded slab grid bakes uniform physics "
                "(fixed dt, closure coefficients); member-varying "
                f"operand(s) {sorted(operand_names)} ride the "
                "generic rung — drop the impl='pallas_slab' pin"
            )
        supported = set(self.ensemble_operands())
        unknown = sorted(set(operand_names) - supported)
        if unknown:
            raise ValueError(
                f"{type(self).__name__} has no member-varying operand(s) "
                f"{unknown}; supported: {sorted(supported) or 'none'}"
            )

    def _ensemble_fused(self):
        """The fused stepper the batched dispatch rides, or ``None``
        (the generic rung, reason recorded): the per-stage rung, launched
        per member, and the whole-run slab rung, B folded into one launch
        (K2b). Other fused rungs decline with the JAX package's reason."""
        fused = self._fused_stepper(mode="iters")
        if fused is None:
            return None
        if fused.engaged_label in ("fused-stage", "fused-whole-run-slab"):
            return fused
        return self._decline(
            f"ensemble batching serves the fused-stage (vmap) and "
            f"whole-run-slab (B-fold) rungs; {fused.engaged_label} "
            f"declines batching"
        )

    def _ensemble_pack(self, operands, members: int):
        """``{name: (B,) values}`` -> ``(names, (B, P) float32 CPU
        tensor)`` in sorted column order, as the JAX package packs them
        (float32). A tensor operand keeps its autograd history. No
        operands pack to a zero-width matrix (uniform physics). The
        dispatch's gate runs here, once, before any value is read."""
        names = tuple(sorted(operands or ()))
        self._ensemble_gate(names)
        if not names:
            return (), torch.zeros((members, 0), dtype=torch.float32)
        cols = []
        for n in names:
            v = operands[n]
            if isinstance(v, torch.Tensor):
                col = v.to(device="cpu", dtype=torch.float32).reshape(-1)
            else:
                col = torch.from_numpy(
                    np.asarray(v, dtype=np.float32).reshape(-1).copy())
            if col.shape[0] != members:
                raise ValueError(
                    f"operand {n!r} has {col.shape[0]} values for "
                    f"{members} members"
                )
            cols.append(col)
        return names, torch.stack(cols, dim=1)

    def _ensemble_record(self, members, stepper, mode, names) -> None:
        """Record the dispatch facts ``EnsembleSolver.engaged_path``
        reads (the JAX package's keys; one device, no mesh). The JAX
        package also emits them as a telemetry event; the port's
        telemetry is not ported yet."""
        self._ensemble_last = {
            "members": int(members),
            "stepper": stepper,
            "mode": mode,
            "operands": list(names),
            "devices": 1,
            "member_sharding": 1,
            "mesh": None,
        }

    @staticmethod
    def _member_overrides(names, ops, i):
        return {n: ops[i, j] for j, n in enumerate(names)} or None

    def _generic_member_run(self, u, t, num_iters: int, overrides):
        """``num_iters`` generic steps of one member: the host-scalar loop
        for uniform physics (the single run's), the operand loop with
        ``t`` as a 0-d tensor otherwise."""
        if overrides is None:
            for _ in range(int(num_iters)):
                u, t = self._local_step(u, t)
            return u, t
        phys = self._physics(overrides)
        tt = torch.tensor(t)
        for _ in range(int(num_iters)):
            u, tt = self._local_step(u, tt, phys=phys)
        return u, type(t)(tt.item())

    def run_ensemble(self, estate: EnsembleState, num_iters: int,
                     operands=None, donate: bool = False) -> EnsembleState:
        """Advance every member ``num_iters`` steps in one dispatch.

        Uniform physics (no ``operands``) rides the fused rung the config
        engages — K2b for the slab rung, the stage kernel per member for
        the per-stage rung — each member equal to its single run to the
        bit; member-varying scalars (``{name: (B,) values}`` for the
        names in :meth:`ensemble_operands`) ride the generic rung.

        ``donate=True`` consumes ``estate.u``: the slab fold drops it
        once its buffers hold the batch (so no second ``(B, *grid)``
        copy lives through the run), the other rungs after the dispatch;
        any later use of ``estate.u`` raises ``RuntimeError``."""
        B = estate.members
        names, ops = self._ensemble_pack(operands, B)
        if names:
            # operands ride the generic rung; the fused rung's own
            # decline, if any, is still what engaged_path reports
            self._fused_stepper(mode="iters")
            fused = None
        else:
            fused = self._ensemble_fused()
        slab_fold = (fused is not None
                     and fused.engaged_label == "fused-whole-run-slab")
        if slab_fold:
            label = "ensemble-fold[fused-whole-run-slab]"
        elif fused is not None:
            label = f"ensemble-vmap[{fused.engaged_label}]"
        else:
            label = "ensemble-vmap[generic-xla]"
        self._ensemble_record(B, label, "iters", names)
        n = int(num_iters)
        if slab_fold:
            consume = (lambda: _consume_donated(estate.u)) if donate else None
            u, t = fused.run_batched(estate.u, estate.t, n, consume=consume)
            if u is estate.u:  # no step: a fresh tensor on the same data
                u = u.view_as(u)
        else:
            outs, ts = [], []
            for i in range(B):
                ui, ti = estate.u[i], estate.t[i]
                if fused is not None:
                    ui, ti = fused.run(ui, ti, n)
                else:
                    ui, ti = self._generic_member_run(
                        ui, ti, n, self._member_overrides(names, ops, i))
                outs.append(ui)
                ts.append(ti)
            u = torch.stack(outs)
            t = np.array(ts, dtype=estate.t.dtype)
        if donate:
            _consume_donated(estate.u)
        return EnsembleState(u=u, t=np.asarray(t, dtype=estate.t.dtype),
                             it=estate.it + np.int32(n))

    def _advance_member(self, u, t, te, max_steps, overrides):
        """One member of :meth:`advance_to_ensemble`: march until ``te``
        (the last step trimmed to land), at most ``max_steps`` steps when
        given (a finished member freezes, as the JAX package's masked
        updates freeze it: no step past ``te`` changes anything).
        Returns ``(u, t, steps)``."""
        tdt = type(t)
        te = tdt(te)
        eps = tdt(1e-12) * max(tdt(1.0), abs(te))
        limit = float("inf") if max_steps is None else int(max_steps)
        steps = 0
        if overrides is None:
            while steps < limit and t < te - eps:
                u, t = self._local_step(u, t, t_end=te)
                steps += 1
            return u, t, steps
        phys = self._physics(overrides)
        tt, te_t = torch.tensor(t), torch.tensor(te)
        stop = te - eps
        while steps < limit and tdt(tt.item()) < stop:
            u, tt = self._local_step(u, tt, t_end=te_t, phys=phys)
            steps += 1
        return u, tdt(tt.item()), steps

    def advance_to_ensemble(self, estate: EnsembleState, t_end,
                            operands=None, max_steps: int | None = None,
                            donate: bool = False) -> EnsembleState:
        """March every member to ``t_end`` in one dispatch, each member
        stopping at its own step count (smaller member dt, more steps).
        The generic rung only, as in the JAX package.

        ``t_end`` is a scalar or a ``(B,)`` sequence, one horizon per
        member. ``max_steps`` bounds every member's step count — the JAX
        package's differentiable ``fori_loop`` mode; the port's loop is
        differentiable either way (``torch.autograd`` through the
        operands), and stops a member once it lands. ``donate=True``
        consumes ``estate.u`` after the dispatch."""
        B = estate.members
        names, ops = self._ensemble_pack(operands, B)
        te_host = np.asarray(t_end, dtype=np.float64)
        if te_host.ndim > 0 and te_host.reshape(-1).shape[0] != B:
            raise ValueError(
                f"t_end has {te_host.reshape(-1).shape[0]} values for "
                f"{B} members — pass a scalar or one horizon per member"
            )
        te_all = np.broadcast_to(te_host.reshape(-1) if te_host.ndim
                                 else te_host, (B,))
        self._ensemble_record(B, "ensemble-vmap[generic-xla]", "t_end",
                              names)
        outs, ts, steps = [], [], []
        for i in range(B):
            ui, ti, ni = self._advance_member(
                estate.u[i], estate.t[i], te_all[i], max_steps,
                self._member_overrides(names, ops, i))
            outs.append(ui)
            ts.append(ti)
            steps.append(ni)
        u = torch.stack(outs)
        if donate:
            _consume_donated(estate.u)
        return EnsembleState(
            u=u, t=np.array(ts, dtype=estate.t.dtype),
            it=estate.it + np.asarray(steps, dtype=np.int32))
