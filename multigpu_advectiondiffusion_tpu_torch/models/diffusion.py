"""Heat / diffusion equation solver ``u_t = K lap(u) + S(u)``
(JAX ``models/diffusion.py`` counterpart: 2-D and 3-D Cartesian, one
device or a device mesh).

Reference-parity behavior (on by default): the Laplacian is zeroed on
the 2-cell boundary band (``Laplace3d.m:21``) and Dirichlet faces are
re-clamped after every stage (``heat3d.m:65-67``).

Kernel rungs (``impl``), each a hand-written CUDA kernel:

* ``"xla"`` — the generic plain-PyTorch path, no kernel;
* 3-D ``"pallas_stage"`` — the fused per-stage stepper, one launch per
  RK stage (:mod:`ops.kernels.fused_diffusion`, K1);
* 3-D ``"pallas_step"`` — the whole-step stepper, one launch per step
  fusing its three stages (:mod:`ops.kernels.fused_diffusion_step`,
  K10);
* 3-D ``"pallas_slab"`` — the whole-run slab stepper, one cooperative
  launch per ``run`` (:mod:`ops.kernels.fused_slab_run`, K2); in
  ``t_end`` mode (it has no ``run_to``) and where the kernel cannot take
  the grid it declines to K1 with the JAX package's reason;
* 3-D ``"pallas"`` — K2 where the port's gate, measured on the H100,
  says it beats K1 (``SlabRunDiffusionStepper.profitable``), else K1;
* 2-D ``"pallas"``, ``"pallas_stage"``, ``"pallas_step"`` and
  ``"pallas_slab"`` — the whole-run stepper, one cooperative CUDA launch
  per ``run`` (:mod:`ops.kernels.fused_diffusion2d`, K7), as every fused
  flavor runs the whole-run stepper in 2-D in the JAX package; on a
  mesh the per-stage stepper of :mod:`ops.kernels.fused2d_sharded` (K8,
  or K8b's two launches a stage under ``overlap="split"``), but
  ``"pallas_step"``, which declines there as in 3-D;
* ``"pallas_axis"``, and every kernel flavor whose fused rung declines
  the config — the generic loop with the per-axis stencil kernel
  (:mod:`ops.kernels.laplacian`, K11 in 3-D, K11b in 2-D), one launch
  per RK stage, float32 only;
* ``"auto"`` — not ported: construction raises
  ``NotImplementedError``, as it does for 1-D grids and the axisymmetric
  geometry.

Storage precision, in the JAX package's branches and texts (its
``_fused_stepper``/``_select_slab``): a float64 state runs K1 or K2
with float32 buffers on one device (``embed`` rounds it, ``extract``
restores float64, ``t`` stays float64); ``precision="bf16"`` runs K1's
or K2's bf16 instance on a float32 state (K10 declines), and the
generic loop, where a rung declines, keeps the state packed in bf16
with its compensation carry (``models/base.py``); ``dtype="bfloat16"``
runs K1's bf16 instance on a bf16 state (the slab declines to it) and
the generic path in bf16 elsewhere. On a mesh the same configs run the
sharded bf16 instances: K1 on every layout (split roles too), and where
the slab is pinned on z slabs K3, or K4 under ``exchange="dma"``.

On a device mesh (``mesh=``/``decomp=``) every rung runs shard-local as
in the JAX package: the generic and per-axis rungs on any decomposition
(ghosts exchanged by the padder, ``overlap="split"`` computing the
interior while they travel), K1 with global wall masks and a ghost
refresh after every stage (the split schedule's three launches a stage
on z), and — only where pinned (``impl="pallas_slab"``,
``steps_per_exchange > 1`` or ``exchange="dma"``) and on z slabs — the
slab rung as one K3 launch over an output window a step, or the k-step
schedule, or under ``exchange="dma"`` one K4 launch a run for every
shard of the card, the ghost rows moved inside the kernel; in 2-D
K8 a stage with global walls, or K8b under the split schedule. K10
declines under a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.diagnostics import physics
from multigpu_advectiondiffusion_tpu_torch.models.base import (
    LocalPhysics,
    SolverBase,
    StepContext,
    global_field,
)
from multigpu_advectiondiffusion_tpu_torch.models.registry import (
    ModelSpec,
    register_model,
    resolve_bc,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import SolverState
from multigpu_advectiondiffusion_tpu_torch.ops import IMPLS, is_fused_impl
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused2d_sharded import (
    ShardedFusedDiffusion2DStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    R,
    FusedDiffusionStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion2d import (
    FusedDiffusion2DStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion_step import (
    StepFusedDiffusionStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_slab_run import (
    SlabRunDiffusionStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.laplacian import (
    D2_STENCILS,
    laplacian,
)
from multigpu_advectiondiffusion_tpu_torch.ops.stencils import (
    boundary_band_mask,
    face_mask,
)
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import diffusive_dt
from multigpu_advectiondiffusion_tpu_torch.utils import metrics

# The JAX rungs whose kernels are not ported yet, with the kernel each
# needs (ids as in PERF.md's kernel table).
_UNPORTED_IMPLS = {
    "auto": "the measured tuner that resolves impl='auto'",
}


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """The JAX ``DiffusionConfig``: same fields, defaults and ``impl``
    strings, so one field dict builds both solvers."""

    grid: Grid
    diffusivity: float = 1.0  # K, "heat conduction" arg (main.c:38)
    order: int = 4
    integrator: str = "ssp_rk3"
    dtype: str = "float32"
    safety: float = 0.8  # dt stability factor (main.c:64)
    ic: object = "heat_kernel"
    ic_params: Tuple = ()
    bc: object = "dirichlet"
    t0: float = 0.1  # initial time of the analytic Gaussian (heat3d.m:15)
    reference_parity: bool = True
    boundary_band: int = 2  # width of the skipped band (Laplace3d.m:21)
    source: Optional[Callable] = None  # S(u) hook (heat3d.m:26-30)
    geometry: str = "cartesian"
    impl: str = "xla"
    overlap: str = "padded"
    steps_per_exchange: int = 1
    exchange: str = "collective"
    precision: str = "native"

    def __post_init__(self):
        if self.precision not in ("native", "bf16"):
            raise ValueError(
                f"unknown precision {self.precision!r}; 'native' or 'bf16'"
            )
        if self.geometry not in ("cartesian", "axisymmetric"):
            raise ValueError(f"unknown geometry {self.geometry!r}")
        if self.overlap not in ("padded", "split"):
            raise ValueError(f"unknown overlap {self.overlap!r}")
        if self.impl not in IMPLS:
            raise ValueError(
                f"unknown impl {self.impl!r}; ladder rungs: {IMPLS}"
            )
        if not isinstance(self.steps_per_exchange, int) or (
            self.steps_per_exchange < 1
        ):
            raise ValueError(
                "steps_per_exchange must be an int >= 1, got "
                f"{self.steps_per_exchange!r}"
            )
        if self.exchange not in ("collective", "dma"):
            raise ValueError(
                f"unknown exchange {self.exchange!r}; 'collective' or 'dma'"
            )


class DiffusionSolver(SolverBase):
    cfg: DiffusionConfig

    def __init__(self, cfg: DiffusionConfig, device=None, mesh=None,
                 decomp=None):
        super().__init__(cfg, device=device, mesh=mesh, decomp=decomp)
        self._check_ported()
        self.dt = diffusive_dt(cfg.diffusivity, cfg.grid.spacing, cfg.safety)

    def _check_ported(self):
        """Raise on a config whose JAX path the port cannot run yet,
        rather than run something else under its name."""
        cfg = self.cfg
        if cfg.impl in _UNPORTED_IMPLS:
            raise NotImplementedError(
                f"impl={cfg.impl!r} needs {_UNPORTED_IMPLS[cfg.impl]}, "
                "which is not ported yet"
            )
        if self.grid.ndim == 1:
            raise NotImplementedError("1-D diffusion is not ported yet")
        if cfg.geometry != "cartesian":
            raise NotImplementedError(
                "axisymmetric diffusion is not ported yet"
            )

    def _op_impl(self) -> str:
        """Per-op kernel strategy: kernel flavors map to the per-axis
        stencil kernel for float32 (``SolverBase._pallas_f32_gate``);
        an order K11 does not compute is named
        (``SolverBase._laplacian_impl``)."""
        impl = super()._op_impl()
        self._laplacian_impl(impl, self.cfg.order)
        return impl

    def ic_spec(self):
        """Thread diffusivity/t0 into the analytic IC so the initial
        state matches :meth:`exact_solution` at ``t = t0``."""
        if self.cfg.ic == "heat_kernel":
            return "heat_kernel", {"t0": self.cfg.t0,
                                   "diffusivity": self.cfg.diffusivity}
        return self.cfg.ic, {}

    # ------------------------------------------------------------------ #
    # Registration contract (models/registry.REQUIRED_SOLVER_CONTRACT)
    # ------------------------------------------------------------------ #
    def stencil_spec(self) -> dict:
        """Family stencil metadata: the diffusive tap radius of the
        configured Laplacian order."""
        r = D2_STENCILS[self.cfg.order][1]
        return {
            "family": "diffusion",
            "diffusive_radius": r,
            "stage_radius": r,
        }

    def cfl_rule(self) -> dict:
        """The time-step contract: the diffusive stability bound
        ``safety / (2 K sum 1/dx^2)`` computed at construction."""
        return {
            "kind": "diffusive",
            "dt": float(self.dt),
            "safety": float(self.cfg.safety),
        }

    def diagnostics_spec(self) -> dict:
        """Physics rules (``diagnostics/physics.py``): pure diffusion (no
        source) on a Cartesian grid satisfies the discrete maximum
        principle; the heat-kernel workload's amplitude decays at the
        analytic rate ``-d/2`` in ``log max u`` against ``log t``."""
        spec = {"rules": [], "meta": {}}
        if self.cfg.source is None and self.cfg.geometry == "cartesian":
            spec["rules"].append(physics.max_principle_rule())
        if self.cfg.ic == "heat_kernel" and self.cfg.geometry == "cartesian":
            spec["meta"]["decay_rate_analytic"] = -self.grid.ndim / 2.0
        return spec

    def ensemble_operands(self) -> dict:
        """Member-varying scalars of the batched ensemble engine: the
        diffusivity K (which also moves the stability dt)."""
        return {"diffusivity": float(self.cfg.diffusivity)}

    def build_local(self, ctx: StepContext, overrides=None) -> LocalPhysics:
        cfg = self.cfg
        grid = cfg.grid
        bcs = self.bcs
        # ensemble mode: a member-varying K (a 0-d float32 tensor) enters
        # as an operand, and the stability dt is derived from it in float32
        K = cfg.diffusivity
        dt = self.dt
        operand = bool(overrides) and "diffusivity" in overrides
        if operand:
            K = overrides["diffusivity"]
            dt = diffusive_dt(K, grid.spacing, cfg.safety)

        impl = self._laplacian_impl(self._op_impl(), cfg.order)
        if impl == "pallas" and operand:
            # the JAX package's per-axis Pallas kernels bake their
            # coefficients and reject a traced K, so it runs the plain
            # stencils here, and so does the port (parity of the
            # engaged path; K11 could take K by value: ROADMAP)
            self._op_fallback = (
                "member-varying diffusivity is a traced operand; "
                "per-axis Pallas kernels bake constants — XLA runs"
            )
            impl = "xla"

        ghost_fn = ctx.ghost_fn if cfg.overlap == "split" else None

        def operator(u):
            return laplacian(u, grid.spacing, ctx.padder,
                             diffusivity=[K] * grid.ndim, order=cfg.order,
                             impl=impl, ghost_fn=ghost_fn)

        walled_axes = [a for a, b in enumerate(bcs) if b.kind != "periodic"]
        band = (
            boundary_band_mask(ctx.local_shape, cfg.boundary_band,
                               ctx.global_shape, ctx.offsets,
                               axes=walled_axes, device=ctx.device)
            if cfg.reference_parity and walled_axes else None
        )

        def rhs(u):
            lu = operator(u)
            if cfg.source is not None:
                lu = lu + cfg.source(u)
            if band is not None:
                lu = torch.where(band, lu, torch.zeros_like(lu))
            return lu

        post = None
        if cfg.reference_parity and walled_axes:
            dir_axes = [a for a in walled_axes if bcs[a].kind == "dirichlet"]
            edge_axes = [a for a in walled_axes if bcs[a].kind == "edge"]
            clamps = [
                (face_mask(ctx.local_shape, [a], ctx.global_shape,
                           ctx.offsets, device=ctx.device), bcs[a].value)
                for a in dir_axes
            ]
            sources = {}
            for a in edge_axes:
                # zero-gradient walls: the frozen band copies the first
                # evolving row (heat2d_axisymmetric.m:64-66); the local
                # index of the source row, clipped into this shard
                n_loc, n = ctx.local_shape[a], ctx.global_shape[a]
                gidx = torch.arange(n_loc, device=ctx.device) + ctx.offsets[a]
                tgt = torch.clamp(gidx, cfg.boundary_band,
                                  n - 1 - cfg.boundary_band)
                sources[a] = torch.clamp(tgt - ctx.offsets[a], 0, n_loc - 1)

            def post(u):
                for faces, value in clamps:
                    u = torch.where(
                        faces, torch.full((), value, dtype=u.dtype,
                                          device=u.device), u)
                for a, src in sources.items():
                    u = torch.index_select(u, a, src)
                return u

        return LocalPhysics(rhs=rhs, static_dt=dt, post=post)

    # ------------------------------------------------------------------ #
    # Fused fast paths (one device, reference-parity walls)
    # ------------------------------------------------------------------ #
    def _fused_reason(self):
        """Why the fused rung cannot serve this config, or ``None``: the
        JAX package's eligibility (``models/diffusion.py``
        ``_fused_stepper``) for one device, in its order: float64 and bf16
        storage ride the 3-D per-stage and slab rungs only (float64 on
        one device), ``precision="bf16"`` the 3-D ones but the whole-step
        rung."""
        cfg = self.cfg
        if not is_fused_impl(cfg.impl):
            return f"impl={cfg.impl!r} does not request fusion"
        if cfg.order != 4:
            return "fused kernels bake in the O4 Laplacian"
        if cfg.integrator != "ssp_rk3":
            return "fused kernels bake in SSP-RK3"
        if cfg.source is not None:
            return "source-term hook needs the generic path"
        if not cfg.reference_parity or cfg.boundary_band < 1:
            return "fused walls need reference_parity with boundary_band >= 1"
        if self._precision_mode() == "bf16":
            if self.grid.ndim != 3:
                return ("precision='bf16' fused kernels are 3-D only "
                        "(2-D whole-run/whole-shard variants lack the "
                        "split-dtype machinery)")
            if cfg.impl == "pallas_step":
                return ("precision='bf16' has no whole-step rung; use the "
                        "per-stage or slab stepper")
        if self.dtype == torch.bfloat16:
            if self.grid.ndim != 3 or cfg.impl == "pallas_step":
                return "bf16 storage exists only for the 3-D per-stage stepper"
        elif self.dtype == torch.float64 and (
            self.grid.ndim != 3 or cfg.impl == "pallas_step"
            or self.mesh is not None
        ):
            return "f64 storage rides the 3-D fused steppers, single-chip only"
        bcs = self.bcs
        if not all(b.kind == "dirichlet" for b in bcs) or not all(
            b.value == bcs[0].value for b in bcs
        ):
            return "fused walls need uniform Dirichlet BCs on every axis"
        if self.mesh is not None:
            if cfg.impl == "pallas_step":
                return ("whole-step temporal blocking crosses ghost-refresh "
                        "points; single-chip only")
            lshape = self.local_shape()
            if any(lshape[ax] < R for ax, _ in self.decomp.axes):
                return f"a sharded axis is thinner than the O4 halo ({R})"
        return None

    def _fused_stepper(self, mode: str = "iters"):
        """The fused SSP-RK3 stepper when this config is eligible, else
        ``None`` (generic path, reason recorded): the whole-run stepper
        (K7) on a 2-D grid, the per-stage K8 stepper on a 2-D mesh; on a
        3-D one the slab stepper (K2) where
        :meth:`_select_slab` engages it, else the whole-step (K10, for
        ``impl="pallas_step"``) or the per-stage stepper (K1).
        Eligibility mirrors what the kernels bake in: frozen Dirichlet
        ghosts and boundary band, static dt, Cartesian O4, float32
        arithmetic on the buffers of :meth:`_kernel_dtype`. The
        whole-run and whole-step steppers have no ``run_to``, so
        ``advance_to`` runs the generic loop (``models/base.py``)."""
        cfg = self.cfg
        self._fused_fallback = None
        reason = self._fused_reason()
        if reason is not None:
            return self._decline(reason)
        bcs = self.bcs
        if self.grid.ndim == 2:
            if self.mesh is not None:
                return self._sharded_2d_stepper()
            return self._whole_run_stepper()
        slab = self._select_slab(mode)
        if slab is not None:
            return slab
        if cfg.impl == "pallas_step":
            key, cls = "fused_step", StepFusedDiffusionStepper
        else:
            key, cls = "fused", FusedDiffusionStepper
        if key not in self._cache:
            kwargs = self._storage_kwargs()
            if self.mesh is not None:
                kwargs.update(global_shape=self.grid.shape,
                              overlap_split=self._split_overlap_requested())
            self._cache[key] = cls(
                self.local_shape(),
                self.grid.spacing,
                [cfg.diffusivity] * 3,
                self.dt,
                cfg.boundary_band,
                bcs[0].value,
                self.device,
                **kwargs,
            )
        return self._cache[key]

    def _kernel_dtype(self) -> torch.dtype:
        """The fused kernels' buffer dtype (the JAX package's
        ``kernel_dtype``): float32 for a float32 or float64 state, bf16
        under ``precision="bf16"`` or ``dtype="bfloat16"``."""
        if self.dtype == torch.float64:
            return torch.float32
        return self.storage_dtype

    def _storage_kwargs(self) -> dict:
        """What a 3-D fused stepper takes for the storage split: its
        buffers' dtype, and the state's where the two differ."""
        kernel = self._kernel_dtype()
        if kernel == self.dtype:
            return {} if kernel == torch.float32 else {"dtype": kernel}
        return {"dtype": kernel, "storage_dtype": self.dtype}

    def _select_slab(self, mode: str):
        """The slab stepper when this 3-D config engages it, else ``None``
        and the per-stage selection proceeds (the JAX package's
        ``_select_slab``). ``impl="pallas_slab"`` pins the rung: where it
        declines, the per-stage stepper runs, as in the JAX package, and
        ``fallback`` carries the JAX package's reason;
        ``steps_per_exchange > 1`` and ``exchange="dma"`` pin it too
        and turn every decline into an error. ``impl="pallas"`` follows
        the port's measured gate (``SlabRunDiffusionStepper.profitable``)
        on one device; under a mesh the rung engages only when pinned, on
        z slabs (K3; K4 under ``exchange="dma"``)."""
        cfg = self.cfg
        k = int(cfg.steps_per_exchange)
        if cfg.impl not in ("pallas", "pallas_slab"):
            return None
        dma = self._exchange_mode() == "dma"
        pinned = cfg.impl == "pallas_slab" or k > 1 or dma

        def decline(reason):
            if dma:
                raise ValueError(
                    f"exchange='dma' needs the sharded slab rung: "
                    f"{reason}")
            if k > 1:
                raise ValueError(
                    f"steps_per_exchange={k} needs the sharded slab "
                    f"rung: {reason}")
            if pinned:
                self._fused_fallback = reason
            return None

        if mode == "t_end":
            return decline("the slab stepper has no run_to (use --iters)")
        if self.dtype == torch.bfloat16:
            return decline("bf16 storage rides the per-stage stepper")
        shape = self.local_shape()
        kernel = self._kernel_dtype()
        G = SlabRunDiffusionStepper.halo
        if self.mesh is not None:
            if not pinned:
                return None
            if any(ax != 0 for ax in self._sharded_axes()):
                return decline("z-slab decompositions only")
            if shape[0] < k * G:
                return decline(
                    f"local z extent {shape[0]} cannot serve the "
                    f"{k * G}-deep exchange")
        depth = k * G if self._sharded_axes() else R
        if not SlabRunDiffusionStepper.supported(shape, kernel, depth):
            return decline("local shape exceeds the slab kernel's 32-bit "
                           "indices")
        if not pinned and not SlabRunDiffusionStepper.profitable(
            shape, kernel
        ):
            return None
        if "fused_slab" not in self._cache:
            kwargs = self._storage_kwargs()
            if self.mesh is not None:
                kwargs.update(global_shape=self.grid.shape,
                              overlap_split=(
                                  not dma
                                  and self._split_overlap_requested()),
                              steps_per_exchange=k)
                if dma:
                    kwargs.update(self._dma_stepper_kwargs())
            self._cache["fused_slab"] = SlabRunDiffusionStepper(
                shape,
                self.grid.spacing,
                [cfg.diffusivity] * 3,
                self.dt,
                cfg.boundary_band,
                self.bcs[0].value,
                self.device,
                **kwargs,
            )
        return self._cache["fused_slab"]

    def _sharded_2d_stepper(self):
        """The 2-D stepper of a mesh shard (K8, or K8b under the split
        schedule): one launch per RK stage and shard with the ghost
        refresh between stages, as the JAX package runs its 2-D kernels
        under a mesh (``models/diffusion.py:455-480``). The JAX package's
        VMEM gate (``supported()``) has no counterpart: K8 takes any
        shard."""
        cfg = self.cfg
        if "fused" not in self._cache:
            self._cache["fused"] = ShardedFusedDiffusion2DStepper(
                self.local_shape(),
                self.grid.spacing,
                [cfg.diffusivity] * 2,
                self.dt,
                cfg.boundary_band,
                self.bcs[0].value,
                self.device,
                global_shape=self.grid.shape,
                overlap_split=self._split_overlap_requested(),
            )
        return self._cache["fused"]

    def _whole_run_stepper(self):
        """The 2-D whole-run stepper (K7), or ``None`` where the state
        would not stay in L2 (the port's gate, in place of the JAX
        package's TPU VMEM budget)."""
        if not FusedDiffusion2DStepper.supported(self.grid.shape,
                                                 self.dtype):
            return self._decline("2-D grid exceeds the whole-run L2 budget")
        cfg = self.cfg
        if "fused" not in self._cache:
            self._cache["fused"] = FusedDiffusion2DStepper(
                self.grid.shape,
                self.grid.spacing,
                [cfg.diffusivity] * 2,
                self.dt,
                cfg.boundary_band,
                self.bcs[0].value,
                self.device,
            )
        return self._cache["fused"]

    # ------------------------------------------------------------------ #
    # Analytic solution (heat3d.m:36)
    # ------------------------------------------------------------------ #
    def exact_solution(self, t: float) -> torch.Tensor:
        cfg = self.cfg
        r2 = cfg.grid.radius_sq(self.dtype, self.device)
        power = cfg.grid.ndim / 2.0
        return ((cfg.t0 / t) ** power
                * torch.exp(-r2 / (4.0 * cfg.diffusivity * t))).to(self.dtype)

    def error_norms(self, state: SolverState, t: float | None = None):
        t_val = float(state.t) if t is None else t
        return metrics.error_norms(
            global_field(state.u), self.exact_solution(t_val),
            self.cfg.grid.spacing
        )


# --------------------------------------------------------------------- #
# Registration: the family as a declarative plugin descriptor
# (models/registry.py; the CLI generates the diffusion{2,3}d verbs)
# --------------------------------------------------------------------- #
def _cli_configure(p, ndim):
    p.add_argument("--K", type=float, default=1.0,
                   help="diffusivity (main.c arg 1)")


def _cli_build(args, grid, ndim):
    return DiffusionConfig(
        grid=grid,
        diffusivity=args.K,
        integrator=getattr(args, "integrator", "ssp_rk3"),
        dtype=args.dtype,
        ic=getattr(args, "ic", None) or "heat_kernel",
        bc=resolve_bc(args, "dirichlet"),
        impl=args.impl,
        precision=getattr(args, "precision", "native"),
    )


def _stage_radius(cfg) -> int:
    """Fused per-stage stencil radius: the O4 layout's, whatever the
    generic path's order."""
    return 2


def _key_extras(cfg):
    return [
        f"order={getattr(cfg, 'order', 4)}",
        f"geom={getattr(cfg, 'geometry', 'cartesian')}",
    ]


def _cost_kwargs(cfg):
    return {"order": getattr(cfg, "order", 4)}


def _bench_build(grid, dtype, impl, case):
    return DiffusionConfig(
        grid=grid, diffusivity=1.0, dtype=dtype, impl=impl
    )


register_model(ModelSpec(
    name="diffusion",
    config_cls=DiffusionConfig,
    solver_cls=DiffusionSolver,
    description="heat/diffusion equation u_t = K lap(u) + S(u)",
    check_error=True,
    sweep_aliases={"K": "diffusivity"},
    cli_configure=_cli_configure,
    cli_build=_cli_build,
    stage_radius=_stage_radius,
    key_extras=_key_extras,
    cost_kwargs=_cost_kwargs,
    bench_build=_bench_build,
))
