"""Burgers / scalar conservation-law solver
``u_t + sum_axis d f(u)/dx_axis = nu lap(u)`` (JAX ``models/burgers.py``
counterpart: 2-D and 3-D Cartesian, one device or a device mesh).

* WENO5-JS (``Matlab_Prototipes/InviscidBurgersNd/LFWENO5FDM3d.m``,
  ``MultiGPU/Burgers3d_Baseline``), WENO5-Z
  (``SingleGPU/Burgers3d_WENO5_SharedMem``) and WENO7 (``LFWENO7FDM*``).
* Viscous option ``nu > 0`` with the O4 Laplacian (the single-GPU
  Burgers runs use ``nu = 1e-5``, ``SingleGPU/Burgers3d_WENO5/main.cpp:56``).
* Selectable flux: burgers / linear / buckley (``LFWENO5FDM3d.m:30-40``).
* Adaptive dt ``CFL min dx / max|f'(u)|`` (``LFWENO5FDM3d.m:71``) by
  default; ``adaptive_dt=False`` is the CUDA drivers' hard-coded unit
  wave speed (``MultiGPU/Burgers3d_Baseline/main.c:193``).

Kernel rungs (``impl``), each a hand-written CUDA kernel:

* ``"xla"`` — the generic plain-PyTorch path, no kernel: WENO5-JS/Z and
  WENO7, every flux, viscous or not, fixed or adaptive dt;
* 3-D ``"pallas_stage"`` — the fused per-stage stepper, one launch (K5)
  per RK stage (:mod:`ops.kernels.fused_burgers`), WENO5-JS/Z and
  WENO7-JS;
* 3-D ``"pallas_slab"`` — at fixed dt the whole-run slab stepper, one
  cooperative launch (K6) per ``run`` (:mod:`ops.kernels.fused_slab_run`),
  WENO5-JS/Z and WENO7-JS; adaptive dt, ``t_end`` mode and grids the
  kernel cannot take decline to K5 with the JAX package's reason;
* 3-D ``"pallas"`` — K5; at fixed dt it would take K6 where the port's
  gate says K6 beats K5 (``SlabRunBurgersStepper.profitable``), which,
  measured on the H100, is on no grid;
* 2-D ``"pallas"``, ``"pallas_stage"``, ``"pallas_step"`` and
  ``"pallas_slab"`` — the whole-run stepper, one cooperative CUDA launch
  per ``run`` (:mod:`ops.kernels.fused_burgers2d`: K7 at fixed dt, K7a
  adaptive), WENO5-JS/Z and WENO7-JS, as every fused flavor runs the
  whole-run stepper in 2-D in the JAX package; on a mesh the per-stage
  stepper
  of :mod:`ops.kernels.fused2d_sharded` (K8, or K8b's two launches a
  stage under ``overlap="split"``), both dt modes, with ``run_to``;
* 3-D ``"pallas_step"`` — K5, as ``"pallas"`` (Burgers has no
  whole-step kernel; the JAX package dispatches the flavor the same
  way);
* ``"pallas_axis"``, and every kernel flavor whose fused rung declines
  the config — the generic loop with the per-axis kernels
  (:mod:`ops.kernels.weno`, K12 in 3-D, K12b in 2-D, one launch per
  axis and RK stage, WENO5-JS/Z and WENO7-JS; the viscous term on
  K11/K11b), float32 only; WENO7 under a fused flavor whose fused rung
  declines runs the plain generic path, with the JAX package's reason;
* ``"auto"`` — not ported: construction raises
  ``NotImplementedError``, as it does for 1-D grids.

``precision="bf16"`` (the JAX package's gates and texts): 3-D fixed-dt
``"pallas"``/``"pallas_slab"`` run K6's bf16 instance, the slab pinned,
on a z-slab mesh K3's (K4's under ``exchange="dma"``), where the JAX
slab's bf16 plane gate takes the local plane; every other config
declines to the generic loop, whose state stays packed in bf16 with its
compensation carry (``models/base.py``), its ghosts on bf16 wires.
``dtype="bfloat16"`` runs the generic path in bf16 (the fused kernels
are float32-only).

On a device mesh (``mesh=``/``decomp=``) the generic and per-axis rungs
run on every decomposition (adaptive dt the max over the shards), and
on z slabs the fused rungs, WENO5 and WENO7 alike: K5 with ``r`` z-ghost
planes (the reach, 3 or 4) refreshed after every stage (the split
schedule's three launches a stage), dt from the
shards' emitted maxima kept on the card, and on y or x slabs, pencils
and blocks the same K5 with ``r`` ghosts on each cut axis (its YX
instance; the y/x ghosts of a pencil or block take the serialized
refresh under the split schedule); and, where pinned
(``impl="pallas_slab"``, ``steps_per_exchange > 1`` or
``exchange="dma"``, fixed dt), one K3 launch over an output window a
step, or the k-step schedule, or under ``exchange="dma"`` one K4 launch
a run for every shard of the card; on 2-D meshes of any layout K8 a
stage (K8b under the split schedule). The batched ensemble
engine runs a 3-D fused config at either order on K2b (the slab rung)
or K5 a member (the per-stage rung).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.diagnostics import physics
from multigpu_advectiondiffusion_tpu_torch.models.base import (
    LocalPhysics,
    SolverBase,
    StepContext,
)
from multigpu_advectiondiffusion_tpu_torch.models.registry import (
    ModelSpec,
    register_model,
    resolve_bc,
)
from multigpu_advectiondiffusion_tpu_torch.ops import IMPLS, is_fused_impl
from multigpu_advectiondiffusion_tpu_torch.ops import flux as flux_lib
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused2d_sharded import (
    ShardedFusedBurgers2DStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_burgers import (
    FusedBurgersStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_burgers2d import (
    FusedBurgers2DStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_slab_run import (
    SlabRunBurgersStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.laplacian import laplacian
from multigpu_advectiondiffusion_tpu_torch.ops.weno import HALO, flux_divergence
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import advective_dt

# The JAX rungs whose kernels are not ported yet, with what each needs
# (ids as in PERF.md's kernel table).
_UNPORTED_IMPLS = {
    "auto": "the measured tuner that resolves impl='auto'",
}


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    """The JAX ``BurgersConfig``: same fields, defaults and ``impl``
    strings, so one field dict builds both solvers."""

    grid: Grid
    flux: str = "burgers"
    flux_params: Tuple = ()
    weno_order: int = 5
    weno_variant: str = "js"
    cfl: float = 0.4  # LFWENO5FDM3d.m:25
    nu: float = 0.0  # viscosity; 1e-5 in SingleGPU Burgers (main.cpp:56)
    laplacian_order: int = 4
    adaptive_dt: bool = True
    integrator: str = "ssp_rk3"
    dtype: str = "float32"
    ic: object = "gaussian"
    ic_params: Tuple = ()
    bc: object = "edge"
    t0: float = 0.0
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


class BurgersSolver(SolverBase):
    cfg: BurgersConfig

    def __init__(self, cfg: BurgersConfig, device=None, mesh=None,
                 decomp=None):
        super().__init__(cfg, device=device, mesh=mesh, decomp=decomp)
        self.flux = flux_lib.get(cfg.flux, **dict(cfg.flux_params))
        # the CUDA-parity fixed step (Burgers3d_Baseline/main.c:193), or
        # None in adaptive mode
        self.dt = None if cfg.adaptive_dt else cfg.cfl * min(cfg.grid.spacing)
        self._check_ported()

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
            raise NotImplementedError("1-D Burgers is not ported yet")

    def _op_impl(self) -> str:
        """Per-op kernel strategy of the generic loop (the JAX package's
        rule): kernel flavors map to the per-axis kernels for float32
        (``SolverBase._pallas_f32_gate``), except WENO7 under a fused
        flavor, which runs plain PyTorch with the JAX package's reason
        (its per-axis WENO7 kernel measured slower than XLA on the TPU);
        ``impl="pallas_axis"`` pins K12 for WENO7 too. A viscous
        Laplacian of an order K11 does not compute is named
        (``SolverBase._laplacian_impl``)."""
        impl = super()._op_impl()
        cfg = self.cfg
        if impl == "pallas" and cfg.weno_order == 7 and is_fused_impl(
            cfg.impl
        ):
            self._op_fallback = (
                "per-axis WENO7 measured slower than XLA; pin with "
                "impl='pallas_axis'"
            )
            return "xla"
        if cfg.nu:
            self._laplacian_impl(impl, cfg.laplacian_order)
        return impl

    def stencil_spec(self) -> dict:
        """Family stencil metadata: the WENO reconstruction radius of the
        configured order (the viscous O4 Laplacian's radius 2 never
        exceeds it)."""
        r = HALO[self.cfg.weno_order]
        return {
            "family": "burgers",
            "advective_radius": r,
            "diffusive_radius": 2 if self.cfg.nu else 0,
            "stage_radius": r,
        }

    def cfl_rule(self) -> dict:
        """The time-step contract: the advective CFL bound
        ``cfl dx / max|f'(u)|`` — adaptive (a global wave-speed reduction
        per step) or the CUDA-parity fixed step."""
        return {
            "kind": "advective",
            "cfl": float(self.cfg.cfl),
            "adaptive": bool(self.cfg.adaptive_dt),
            "dt": None if self.dt is None else float(self.dt),
        }

    def diagnostics_spec(self) -> dict:
        """Physics rules (``diagnostics/physics.py``): WENO on the convex
        Burgers flux is essentially non-oscillatory, so total variation
        stays bounded by the initial data's."""
        spec = {"rules": [], "meta": {}}
        if self.cfg.flux == "burgers":
            spec["rules"].append(physics.tv_monotone_rule())
        return spec

    def ensemble_operands(self) -> dict:
        """Member-varying scalars of the batched ensemble engine: the CFL
        number."""
        return {"cfl": float(self.cfg.cfl)}

    def build_local(self, ctx: StepContext, overrides=None) -> LocalPhysics:
        cfg = self.cfg
        spacing = cfg.grid.spacing
        fx = self.flux
        # ensemble mode: a member-varying CFL (a 0-d float32 tensor)
        # enters as an operand; a fixed dt is derived from it in float32
        cfl = cfg.cfl
        fixed_dt = self.dt
        if overrides and "cfl" in overrides:
            cfl = overrides["cfl"]
            if not cfg.adaptive_dt:
                fixed_dt = cfl * min(spacing)
        impl = self._op_impl()
        lap_impl = self._laplacian_impl(impl, cfg.laplacian_order)
        ghost_fn = ctx.ghost_fn if cfg.overlap == "split" else None

        def ghosts(axis):
            # K12/K12b form the ghosts: the boundary's on a local axis,
            # the exchanged slabs on a sharded one (ctx.ghost_fn)
            if impl == "pallas":
                return {"bc": self.bcs[axis], "ghost_fn": ctx.ghost_fn}
            return {"padder": ctx.padder, "ghost_fn": ghost_fn}

        def rhs(u):
            # -(div_z + div_y + div_x), summed in that order; on the
            # kernel path the sum and its sign ride the sweeps' stores
            out = None
            for axis in range(u.ndim):
                out = flux_divergence(
                    u, axis, spacing[axis], fx, order=cfg.weno_order,
                    variant=cfg.weno_variant, impl=impl, acc=out,
                    negate=axis == u.ndim - 1, **ghosts(axis),
                )
            if cfg.nu:
                out = out + laplacian(u, spacing, ctx.padder,
                                      diffusivity=cfg.nu,
                                      order=cfg.laplacian_order,
                                      impl=lap_impl, ghost_fn=ghost_fn)
            return out

        if cfg.adaptive_dt:
            return LocalPhysics(
                rhs=rhs,
                dt_fn=lambda u: advective_dt(u, fx.df, spacing, cfl,
                                             reduce_max=ctx.reduce_max),
            )
        # CUDA-parity fixed dt: CFL * dx / 1.0 (Burgers3d_Baseline/main.c:193)
        return LocalPhysics(rhs=rhs, static_dt=fixed_dt)

    # ------------------------------------------------------------------ #
    # Fused fast paths (edge BCs, WENO5-JS/Z and WENO7-JS)
    # ------------------------------------------------------------------ #
    def _fused_reason(self):
        """Why the fused rung cannot serve this config, or ``None``: the
        JAX package's eligibility (``models/burgers.py``
        ``_fused_stepper``), its texts and its branches: on a mesh every
        sharded axis must hold the order's halo (3 or 4 cells). Its TPU
        VMEM gates become the card's: none for K5 and K8, which need no
        block to fit a fast memory, and for the 2-D whole-run stepper
        (K7) the state fitting the L2
        (:meth:`FusedBurgers2DStepper.supported`). So a y-sharded 3-D
        shard whose ``ly`` is not a multiple of 8, which the JAX
        package declines for its sublane tiling ("no viable VMEM block
        tiling for this local shape"), runs K5 here: a recorded
        difference (``tests/test_torch_burgers_yx_mesh.py``)."""
        cfg = self.cfg
        if (cfg.weno_order, cfg.weno_variant) not in {
            (5, "js"), (5, "z"), (7, "js")
        }:
            return "fused kernels implement WENO5-JS/Z and WENO7-JS only"
        if cfg.integrator != "ssp_rk3":
            return "fused kernels bake in SSP-RK3"
        if cfg.nu != 0.0 and cfg.laplacian_order != 4:
            return "fused viscous term is the O4 Laplacian"
        if self.dtype != torch.float32:
            return "fused kernels are float32-only"
        # precision="bf16": the only fused bf16 rung is the slab (K6's bf16
        # instance); what cannot ride it declines to the generic loop
        if self._precision_mode() == "bf16" and self.grid.ndim != 3:
            return ("precision='bf16' Burgers rides the 3-D slab stepper "
                    "(or the generic path); 2-D has no split-dtype rung")
        if self._precision_mode() == "bf16" and cfg.adaptive_dt:
            return ("precision='bf16' Burgers needs --fixed-dt: the "
                    "adaptive-dt per-stage stepper has no split-dtype "
                    "machinery")
        if not all(b.kind == "edge" for b in self.bcs):
            return "fused ghost discipline needs edge BCs"
        if self.mesh is not None:
            halo = HALO[cfg.weno_order]
            lshape = self.local_shape()
            if any(lshape[ax] < halo for ax, _ in self.decomp.axes):
                return (f"a sharded axis is thinner than the "
                        f"WENO{cfg.weno_order} halo ({halo})")
        elif self.grid.ndim == 2 and not FusedBurgers2DStepper.supported(
            self.grid.shape, self.dtype
        ):
            return "2-D grid exceeds the whole-run L2 budget"
        return None

    def _fused_stepper(self, mode: str = "iters"):
        """The fused SSP-RK3 stepper when this config is eligible, else
        ``None`` (generic path, reason recorded): the whole-run stepper
        (K7/K7a) on a 2-D grid, which has no ``run_to`` (``advance_to``
        runs the generic loop), and on a 2-D mesh the per-stage K8
        stepper; on a 3-D one the slab stepper (K6) where
        :meth:`_select_slab` engages it, else the per-stage stepper
        (K5)."""
        cfg = self.cfg
        self._fused_fallback = None
        if not is_fused_impl(cfg.impl):
            return self._decline(f"impl={cfg.impl!r} does not request fusion")
        reason = self._fused_reason()
        if reason is not None:
            return self._decline(reason)
        if self.grid.ndim == 2 and self.mesh is not None:
            return self._sharded_2d_stepper()
        if self.grid.ndim == 2:
            if "fused" not in self._cache:
                self._cache["fused"] = FusedBurgers2DStepper(
                    self.grid.shape, self.grid.spacing, self.flux,
                    cfg.weno_variant, cfg.nu, self.device, dt=self.dt,
                    cfl=cfg.cfl if cfg.adaptive_dt else None,
                    order=cfg.weno_order,
                )
            return self._cache["fused"]
        slab = self._select_slab(mode)
        if slab is not None:
            return slab
        if self._precision_mode() == "bf16":
            return self._decline(
                "precision='bf16' Burgers engages only the slab "
                "whole-run rung (per-stage WENO has no split-dtype "
                "machinery); the slab declined for this config")
        if "fused" not in self._cache:
            kwargs = {}
            if self.mesh is not None:
                # a y- or x-cut mesh stores ghosts on those axes too (the
                # JAX package's y_sharded/x_sharded, extent-1 mesh axes
                # filtered out)
                sharded_axes = self._sharded_axes()
                kwargs = dict(interior_shape=self.local_shape(),
                              global_shape=self.grid.shape,
                              overlap_split=self._split_overlap_requested(),
                              reduce_max=self.mesh_reduce_max(),
                              y_sharded=1 in sharded_axes,
                              x_sharded=2 in sharded_axes)
            self._cache["fused"] = FusedBurgersStepper(
                self.grid.spacing, self.flux,
                cfg.weno_variant, cfg.nu, cfg.cfl, self.device, dt=self.dt,
                order=cfg.weno_order, **kwargs,
            )
        return self._cache["fused"]

    def _sharded_2d_stepper(self):
        """The 2-D stepper of a mesh shard (K8, or K8b under the split
        schedule), both dt modes, as the JAX package runs its 2-D kernels
        under a mesh (``models/burgers.py:350-369``); adaptive dt from the
        shards' emitted maxima, reduced on the card. The JAX package's
        VMEM gate (``supported()``) has no counterpart: K8 takes any
        shard."""
        cfg = self.cfg
        if "fused" not in self._cache:
            self._cache["fused"] = ShardedFusedBurgers2DStepper(
                self.local_shape(), self.grid.spacing, self.flux,
                cfg.weno_variant, cfg.nu, cfg.cfl, self.device,
                dt=self.dt, global_shape=self.grid.shape,
                overlap_split=self._split_overlap_requested(),
                reduce_max=self.mesh_reduce_max(), order=cfg.weno_order)
        return self._cache["fused"]

    def _select_slab(self, mode: str):
        """The slab stepper when this fixed-dt 3-D config engages it, else
        ``None`` and the per-stage stepper (K5) runs (the JAX package's
        ``_select_slab``; the shared eligibility has passed).
        ``impl="pallas_slab"`` pins the rung: where it declines, K5 runs,
        as in the JAX package, and ``fallback`` carries the JAX package's
        reason; ``steps_per_exchange > 1`` and ``exchange="dma"`` pin
        it too and turn every decline into an error. ``impl="pallas"``
        follows the port's measured gate
        (``SlabRunBurgersStepper.profitable``) on one device; under a
        mesh the rung engages only when pinned, on z slabs (K3; K4 under
        ``exchange="dma"``)."""
        cfg = self.cfg
        k = int(cfg.steps_per_exchange)
        if cfg.impl not in ("pallas", "pallas_slab"):
            return None
        dma = self._exchange_mode() == "dma"
        # precision="bf16": the slab is Burgers' only fused bf16 rung, so
        # it is pinned (no profitability gate) as in the JAX package
        kernel = self.storage_dtype
        pinned = (cfg.impl == "pallas_slab" or k > 1 or dma
                  or kernel == torch.bfloat16)

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
        if cfg.adaptive_dt:
            return decline("adaptive dt rides the per-stage stepper")
        shape = self.local_shape()
        G = 3 * HALO[cfg.weno_order]
        if self.mesh is not None:
            if not pinned:
                return None
            if any(ax != 0 for ax in self._sharded_axes()):
                return decline("z-slab decompositions only")
        depth = k * G if self._sharded_axes() else 0
        if not SlabRunBurgersStepper.supported(shape, kernel, depth,
                                               cfg.weno_order):
            return decline("local shape exceeds the slab kernel's 32-bit "
                           "indices" if kernel == torch.float32 else
                           "local shape exceeds the slab VMEM budget")
        if not pinned and not SlabRunBurgersStepper.profitable(
            shape, kernel
        ):
            return None
        if self.mesh is not None and shape[0] < k * G:
            return decline(
                f"local z extent {shape[0]} cannot serve the "
                f"{k * G}-deep exchange")
        if "fused_slab" not in self._cache:
            kwargs = {}
            if kernel != self.dtype:
                kwargs = dict(dtype=kernel, storage_dtype=self.dtype)
            if self.mesh is not None:
                kwargs.update(global_shape=self.grid.shape,
                              overlap_split=(
                                  not dma
                                  and self._split_overlap_requested()),
                              steps_per_exchange=k)
                if dma:
                    kwargs.update(self._dma_stepper_kwargs())
            self._cache["fused_slab"] = SlabRunBurgersStepper(
                shape, self.grid.spacing, self.flux, cfg.weno_variant,
                cfg.nu, self.dt, self.device, order=cfg.weno_order,
                **kwargs,
            )
        return self._cache["fused_slab"]


# --------------------------------------------------------------------- #
# Registration: the family as a declarative plugin descriptor
# (models/registry.py; the CLI generates the burgers{2,3}d verbs)
# --------------------------------------------------------------------- #
def _cli_configure(p, ndim):
    p.add_argument("--flux", default="burgers",
                   choices=["burgers", "linear", "buckley"])
    p.add_argument("--weno-order", type=int, default=5, choices=[5, 7])
    p.add_argument("--weno-variant", default="js", choices=["js", "z"])
    p.add_argument("--cfl", type=float, default=0.4)
    p.add_argument("--nu", type=float, default=0.0,
                   help="viscosity (1e-5 in SingleGPU Burgers)")
    p.add_argument("--fixed-dt", action="store_true",
                   help="reference-parity dt = CFL*dx (hard-coded "
                        "max|u|=1, Burgers3d_Baseline/main.c:193)")


def _cli_build(args, grid, ndim):
    return BurgersConfig(
        grid=grid,
        flux=args.flux,
        weno_order=args.weno_order,
        weno_variant=args.weno_variant,
        cfl=args.cfl,
        nu=args.nu,
        adaptive_dt=not args.fixed_dt,
        integrator=getattr(args, "integrator", "ssp_rk3"),
        dtype=args.dtype,
        ic=getattr(args, "ic", None) or "gaussian",
        bc=resolve_bc(args, "edge"),
        impl=args.impl,
        precision=getattr(args, "precision", "native"),
    )


def _stage_radius(cfg) -> int:
    """Fused per-stage stencil radius: the WENO reconstruction halo of
    the configured order."""
    return HALO[getattr(cfg, "weno_order", 5)]


def _key_extras(cfg):
    return [
        f"weno={cfg.weno_order}-{cfg.weno_variant}",
        f"adaptive={bool(cfg.adaptive_dt)}",
        f"viscous={bool(getattr(cfg, 'nu', 0.0))}",
    ]


def _cost_kwargs(cfg):
    return {
        "weno_order": getattr(cfg, "weno_order", 5),
        "viscous": bool(getattr(cfg, "nu", 0.0)),
    }


def _bench_build(grid, dtype, impl, case):
    return BurgersConfig(
        grid=grid,
        weno_order=getattr(case, "weno_order", 5),
        cfl=0.4,
        adaptive_dt=not getattr(case, "fixed_dt", True),
        nu=getattr(case, "nu", 0.0),
        dtype=dtype,
        ic="gaussian",
        impl=impl,
    )


register_model(ModelSpec(
    name="burgers",
    config_cls=BurgersConfig,
    solver_cls=BurgersSolver,
    description="scalar conservation law u_t + div f(u) = nu lap(u), "
                "WENO5/7 + Lax–Friedrichs",
    check_error=False,
    cli_configure=_cli_configure,
    cli_build=_cli_build,
    stage_radius=_stage_radius,
    key_extras=_key_extras,
    cost_kwargs=_cost_kwargs,
    bench_build=_bench_build,
))
