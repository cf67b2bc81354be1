"""Advection–diffusion–reaction solver, the repo's title workload (JAX
``models/adr.py`` counterpart: 2-D and 3-D Cartesian, one device or a
device mesh).

``u_t + div(a u) = K(x) lap(u) - lambda u`` with

* constant advection velocity ``a`` (one value per physical axis),
  discretized by the monotone first-order **upwind** flux (the fused
  kernel K9's scheme, matched term for term on the generic path) or by
  **WENO5** linear advection through ``ops/weno.flux_divergence`` with
  ``ops/flux.linear`` (generic path only);
* spatially varying diffusivity ``K(x) = K0 (1 + eps prod_i cos(pi
  x̂_i))``, ``x̂ = g/(n-1) - 1/2`` in global cell indices, applied as
  ``K(x) lap(u)`` over the O2/O4 Laplacian taps (:func:`kappa_profile`;
  ``|eps| < 1`` keeps K positive);
* linear decay ``-lambda u`` (``reaction_rate``).

Reference-parity walls follow the diffusion family's discipline (RHS
zeroed on the boundary band, Dirichlet faces re-clamped).

Kernel rungs (``impl``), as the JAX package dispatches them:

* ``"xla"`` — the generic plain-PyTorch path, no kernel;
* 3-D ``"pallas"``/``"pallas_stage"`` with upwind advection, O4,
  SSP-RK3, float32, reference-parity walls and uniform Dirichlet BCs —
  the fused per-stage stepper, one launch of K9 per RK stage
  (:mod:`ops.kernels.fused_adr`);
* ``"pallas_step"``/``"pallas_slab"`` decline (ADR ships the per-stage
  rung only), as every other config a fused flavor asks for does, with
  the JAX package's reason; then, and under ``"pallas_axis"``, the
  generic loop runs the Laplacian on the per-axis kernel (K11 in 3-D,
  K11b in 2-D) in float32, while the advective sweep stays plain
  PyTorch, as the JAX package keeps it in XLA;
* ``"auto"`` — not ported: construction raises ``NotImplementedError``,
  as it does for 1-D grids.

``precision="bf16"`` runs K9's bf16 instance where the fused rung
engages (its sharded instance on a mesh), and elsewhere the generic loop
with the state packed in bf16 and its compensation carry
(``models/base.py``), its ghosts on bf16 wires;
``dtype="bfloat16"`` runs the generic path in bf16 (K9 is float32-only).

On a device mesh (``mesh=``/``decomp=``) the generic and per-axis rungs
run on every decomposition (``K(x)`` and the walls in global indices,
``overlap="split"`` overlapping the ghost exchange), and the fused rung
as K9's sharded instance: global wall masks, the ``K(x)`` factors of the
global grid at the shard's offsets, the ghosts refreshed after every
stage. As in the JAX package, ``overlap="split"`` and a sharded axis
thinner than the O4 halo decline to the generic rung.

Analytic solution (constant coefficients, ``eps = 0``): the advecting,
decaying heat kernel ``u(x, t) = (t0/t)^{d/2} exp(-|x - a (t-t0)|^2 /
(4 K t)) exp(-lambda (t-t0))``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

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
from multigpu_advectiondiffusion_tpu_torch.ops import flux as flux_lib
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_adr import (
    R,
    FusedADRStepper,
)
from multigpu_advectiondiffusion_tpu_torch.ops.laplacian import (
    D2_STENCILS,
    laplacian,
)
from multigpu_advectiondiffusion_tpu_torch.ops.stencils import (
    boundary_band_mask,
    face_mask,
    shifted,
)
from multigpu_advectiondiffusion_tpu_torch.ops.weno import HALO, flux_divergence
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import (
    advection_diffusion_dt,
)
from multigpu_advectiondiffusion_tpu_torch.utils import metrics

# The JAX rungs the port cannot run yet, with what each needs.
_UNPORTED_IMPLS = {
    "auto": "the measured tuner that resolves impl='auto'",
}


@dataclasses.dataclass(frozen=True)
class ADRConfig:
    """The JAX ``ADRConfig``: same fields, defaults and checks."""

    grid: Grid
    diffusivity: float = 1.0  # K0, the base (mean) diffusivity
    # a scalar (broadcast to every axis) or one value per PHYSICAL axis
    # in x [y [z]] order
    velocity: object = 0.5
    kappa_variation: float = 0.0  # eps of K(x); |eps| < 1
    reaction_rate: float = 0.0  # lambda >= 0; R(u) = -lambda u
    advect: str = "upwind"  # "upwind" (K9's scheme) or "weno5"
    order: int = 4  # diffusive Laplacian order (2 | 4)
    cfl: float = 0.4  # advective share of the combined dt bound
    safety: float = 0.8  # diffusive/reaction share of the dt bound
    integrator: str = "ssp_rk3"
    dtype: str = "float32"
    ic: object = "heat_kernel"
    ic_params: Tuple = ()
    bc: object = "dirichlet"
    t0: float = 0.1  # initial time of the analytic kernel
    reference_parity: bool = True
    boundary_band: int = 2
    impl: str = "xla"
    overlap: str = "padded"
    # accepted for config uniformity; ADR serves the per-step exchange
    # cadence and the collective transport only, as in the JAX package
    steps_per_exchange: int = 1
    exchange: str = "collective"
    precision: str = "native"

    def __post_init__(self):
        if self.precision not in ("native", "bf16"):
            raise ValueError(
                f"unknown precision {self.precision!r}; "
                "'native' or 'bf16'"
            )
        if self.impl not in IMPLS:
            raise ValueError(
                f"unknown impl {self.impl!r}; ladder rungs: {IMPLS}"
            )
        if self.overlap not in ("padded", "split"):
            raise ValueError(f"unknown overlap {self.overlap!r}")
        if self.advect not in ("upwind", "weno5"):
            raise ValueError(
                f"unknown advect {self.advect!r}; 'upwind' or 'weno5'"
            )
        if self.order not in D2_STENCILS:
            raise ValueError(
                f"unknown diffusive order {self.order}; use "
                f"{sorted(D2_STENCILS)}"
            )
        if not -1.0 < float(self.kappa_variation) < 1.0:
            raise ValueError(
                "kappa_variation must satisfy |eps| < 1 (K(x) must "
                f"stay positive), got {self.kappa_variation!r}"
            )
        if float(self.reaction_rate) < 0.0:
            raise ValueError(
                "reaction_rate is a linear DECAY rate (lambda >= 0); "
                f"got {self.reaction_rate!r}"
            )
        if int(self.steps_per_exchange or 1) != 1:
            raise ValueError(
                "ADR serves the per-step exchange cadence only "
                "(steps_per_exchange=1): the k-step deep-halo schedule "
                "rides the slab rung, which this family does not ship"
            )
        if self.exchange != "collective":
            raise ValueError(
                "ADR serves the XLA collective halo exchange only: "
                "the in-kernel remote-DMA transport rides the slab "
                "rung, which this family does not ship"
            )
        if not isinstance(self.velocity, (int, float)):
            vel = tuple(self.velocity)
            if len(vel) != self.grid.ndim:
                raise ValueError(
                    f"velocity has {len(vel)} components for a "
                    f"{self.grid.ndim}-D grid (x [y [z]] order, or one "
                    "scalar broadcast to every axis)"
                )


def kappa_profile(shape_global, local_shape, offsets, eps: float, dtype,
                  device=None):
    """The dimensionless K-variation profile ``1 + eps prod_i
    cos(pi x̂_i)`` on a window, ``x̂ = g/(n-1) - 1/2`` in GLOBAL cell
    indices; ``None`` when ``eps == 0`` (constant coefficient). The
    generic path's field; K9 forms the same product per cell from
    :func:`ops.kernels.fused_adr.kappa_axes`."""
    if not eps:
        return None
    prof = None
    ndim = len(shape_global)
    for ax in range(ndim):
        g = torch.arange(local_shape[ax], dtype=dtype, device=device) + \
            offsets[ax]
        c = torch.cos(math.pi * (torch.div(g, g.new_tensor(
            shape_global[ax] - 1)) - 0.5))
        shp = [1] * ndim
        shp[ax] = -1
        c = torch.reshape(c, shp)
        prof = c if prof is None else prof * c
    return (1.0 + eps * prof).to(dtype)


class ADRSolver(SolverBase):
    cfg: ADRConfig

    def __init__(self, cfg: ADRConfig, device=None, mesh=None, decomp=None):
        super().__init__(cfg, device=device, mesh=mesh, decomp=decomp)
        self._check_ported()
        kmax = float(cfg.diffusivity) * (
            1.0 + abs(float(cfg.kappa_variation))
        )
        self.dt = advection_diffusion_dt(
            self._velocity_zyx(), kmax, cfg.grid.spacing, cfl=cfg.cfl,
            safety=cfg.safety, reaction=float(cfg.reaction_rate),
        )

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
            raise NotImplementedError("1-D ADR is not ported yet")

    # ------------------------------------------------------------------ #
    # Registration contract (models/registry.REQUIRED_SOLVER_CONTRACT)
    # ------------------------------------------------------------------ #
    def stencil_spec(self) -> dict:
        """Family stencil metadata: the per-stage radius is the larger
        of the advective and diffusive tap reaches (upwind 1 / WENO5 3
        against O2 1 / O4 2)."""
        cfg = self.cfg
        adv_r = 1 if cfg.advect == "upwind" else HALO[5]
        diff_r = D2_STENCILS[cfg.order][1]
        return {
            "family": "adr",
            "advective_radius": adv_r,
            "diffusive_radius": diff_r,
            "stage_radius": max(adv_r, diff_r),
        }

    def diagnostics_spec(self) -> dict:
        """Physics rules: ADR transports and spreads but creates no new
        extremum (monotone upwind flux, K(x) > 0), and nonnegative data
        stays nonnegative (decay only shrinks it). The analytic decay
        rate ``-d/2`` is recorded only for the constant-coefficient,
        reaction-free heat-kernel workload."""
        cfg = self.cfg
        spec = {"rules": [], "meta": {}}
        spec["rules"].append(physics.max_principle_rule())
        spec["rules"].append(physics.positivity_rule())
        if (
            cfg.ic == "heat_kernel"
            and not cfg.kappa_variation
            and not cfg.reaction_rate
        ):
            spec["meta"]["decay_rate_analytic"] = -self.grid.ndim / 2.0
        return spec

    def ensemble_operands(self) -> dict:
        """Member-varying scalars of the batched ensemble engine: the
        base diffusivity K0 and the decay rate lambda (both move the
        stability dt)."""
        return {
            "diffusivity": float(self.cfg.diffusivity),
            "reaction_rate": float(self.cfg.reaction_rate),
        }

    def cfl_rule(self) -> dict:
        """The time-step contract: the combined advective / diffusive /
        reaction bound (``timestepping.cfl.advection_diffusion_dt``)."""
        cfg = self.cfg
        return {
            "kind": "advection-diffusion-reaction",
            "dt": float(self.dt),
            "cfl": float(cfg.cfl),
            "safety": float(cfg.safety),
            "terms": {
                "advective": any(self._velocity_zyx()),
                "diffusive": True,
                "reaction": bool(cfg.reaction_rate),
            },
        }

    # ------------------------------------------------------------------ #
    # Config plumbing
    # ------------------------------------------------------------------ #
    def _velocity_zyx(self) -> Tuple[float, ...]:
        """Velocity per ARRAY axis (z, y, x order): a scalar broadcasts,
        a tuple arrives in physical x [y [z]] order and flips."""
        v = self.cfg.velocity
        if isinstance(v, (int, float)):
            return (float(v),) * self.grid.ndim
        return tuple(float(c) for c in reversed(tuple(v)))

    def _op_impl(self) -> str:
        """Per-op kernel strategy: kernel flavors send the Laplacian to
        the per-axis kernels for float32 (``SolverBase._pallas_f32_gate``;
        an order K11 does not compute is named,
        ``SolverBase._laplacian_impl``); the advective sweep always runs
        plain PyTorch, as the JAX package keeps it in XLA."""
        impl = super()._op_impl()
        self._laplacian_impl(impl, self.cfg.order)
        return impl

    def ic_spec(self):
        """Thread t0/K0 into the heat-kernel IC so the initial state
        matches :meth:`exact_solution` at ``t = t0``."""
        if self.cfg.ic == "heat_kernel":
            return "heat_kernel", {"t0": self.cfg.t0,
                                   "diffusivity": self.cfg.diffusivity}
        return self.cfg.ic, {}

    # ------------------------------------------------------------------ #
    # Local physics (one device, or one shard of a mesh)
    # ------------------------------------------------------------------ #
    def build_local(self, ctx: StepContext, overrides=None) -> LocalPhysics:
        cfg = self.cfg
        bcs = self.bcs
        spacing = cfg.grid.spacing
        vel = self._velocity_zyx()
        # ensemble mode: member-varying K0 / lambda (0-d float32 tensors)
        # enter as operands, and the stability dt is derived from them in
        # float32
        K0 = cfg.diffusivity
        lam = cfg.reaction_rate
        has_react = bool(cfg.reaction_rate)
        dt = self.dt
        if overrides and (
            "diffusivity" in overrides or "reaction_rate" in overrides
        ):
            if "diffusivity" in overrides:
                K0 = overrides["diffusivity"]
            if "reaction_rate" in overrides:
                lam = overrides["reaction_rate"]
                has_react = True
            dt = advection_diffusion_dt(
                vel, K0 * (1.0 + abs(float(cfg.kappa_variation))), spacing,
                cfl=cfg.cfl, safety=cfg.safety, reaction=lam,
            )
        impl = self._laplacian_impl(self._op_impl(), cfg.order)
        ghost_fn = ctx.ghost_fn if cfg.overlap == "split" else None
        prof = kappa_profile(ctx.global_shape, ctx.local_shape, ctx.offsets,
                             float(cfg.kappa_variation), self.dtype,
                             ctx.device)

        def diffusive(u):
            lap = laplacian(u, spacing, ctx.padder, diffusivity=1.0,
                            order=cfg.order, impl=impl, ghost_fn=ghost_fn)
            return K0 * lap if prof is None else (K0 * prof) * lap

        if cfg.advect == "weno5":
            fluxes = [flux_lib.linear(c=a) if a else None for a in vel]

            def advective(u):
                acc = None
                for axis in range(u.ndim):
                    if fluxes[axis] is None:
                        continue
                    div = flux_divergence(
                        u, axis, spacing[axis], fluxes[axis], order=5,
                        variant="js", padder=ctx.padder, ghost_fn=ghost_fn,
                    )
                    acc = div if acc is None else acc + div
                return acc

        else:

            def advective(u):
                acc = None
                for axis, a in enumerate(vel):
                    if a == 0.0:
                        continue
                    up = ctx.padder(u, axis, 1)
                    n = u.shape[axis]
                    lo = shifted(up, axis, 0, n)   # u_{i-1}
                    mid = shifted(up, axis, 1, n)  # u_i
                    hi = shifted(up, axis, 2, n)   # u_{i+1}
                    cp = max(a, 0.0) / spacing[axis]
                    cm = min(a, 0.0) / spacing[axis]
                    term = cp * (mid - lo) + cm * (hi - mid)
                    acc = term if acc is None else acc + term
                return acc

        walled_axes = [a for a, b in enumerate(bcs) if b.kind != "periodic"]
        band = (
            boundary_band_mask(ctx.local_shape, cfg.boundary_band,
                               ctx.global_shape, ctx.offsets,
                               axes=walled_axes, device=ctx.device)
            if cfg.reference_parity and walled_axes else None
        )

        def rhs(u):
            out = diffusive(u)
            adv = advective(u)
            if adv is not None:
                out = out - adv
            if has_react:
                out = out - lam * u
            if band is not None:
                out = torch.where(band, out, torch.zeros_like(out))
            return out

        post = None
        if cfg.reference_parity and walled_axes:
            clamps = [
                (face_mask(ctx.local_shape, [a], ctx.global_shape,
                           ctx.offsets, device=ctx.device), bcs[a].value)
                for a in walled_axes if bcs[a].kind == "dirichlet"
            ]
            if clamps:

                def post(u):
                    # Dirichlet walls re-imposed each step
                    for faces, value in clamps:
                        u = torch.where(
                            faces, torch.full((), value, dtype=u.dtype,
                                              device=u.device), u)
                    return u

        return LocalPhysics(rhs=rhs, static_dt=dt, post=post)

    # ------------------------------------------------------------------ #
    # Fused per-stage fast path (K9)
    # ------------------------------------------------------------------ #
    def _fused_stepper(self, mode: str = "iters"):
        """The fused ADR SSP-RK3 per-stage stepper (K9) when eligible,
        else ``None`` (generic path, reason recorded). Eligibility and
        reasons are the JAX package's (``models/adr.py:493-534``): 3-D
        Cartesian, upwind advection, O4, SSP-RK3, float32, uniform frozen
        Dirichlet walls; no whole-step or slab variant; on a mesh no
        split overlap and no sharded axis thinner than the O4 halo (then
        K9's sharded instance on the shard). The stepper has ``run_to``,
        so ``advance_to`` runs it too."""
        del mode
        cfg = self.cfg
        self._fused_fallback = None
        if not is_fused_impl(cfg.impl):
            return self._decline(f"impl={cfg.impl!r} does not request fusion")
        if cfg.impl in ("pallas_step", "pallas_slab"):
            return self._decline(
                "ADR ships a per-stage fused rung only (no whole-step/"
                "slab variant)"
            )
        if self.grid.ndim != 3:
            return self._decline("fused ADR kernel is 3-D only")
        if cfg.advect != "upwind":
            return self._decline(
                "fused ADR bakes the monotone upwind advective flux; "
                "WENO5 advection rides the generic rung"
            )
        if cfg.order != 4:
            return self._decline("fused ADR bakes the O4 diffusive taps")
        if cfg.integrator != "ssp_rk3":
            return self._decline("fused kernels bake in SSP-RK3")
        if self.dtype != torch.float32:
            return self._decline("fused ADR kernel is float32-only")
        if not cfg.reference_parity or cfg.boundary_band < 1:
            return self._decline(
                "fused walls need reference_parity with boundary_band >= 1"
            )
        bcs = self.bcs
        if not all(b.kind == "dirichlet" for b in bcs) or not all(
            b.value == bcs[0].value for b in bcs
        ):
            return self._decline(
                "fused walls need uniform Dirichlet BCs on every axis"
            )
        if self.mesh is not None:
            if self._split_overlap_requested():
                return self._decline(
                    "fused ADR runs the serialized per-stage ghost "
                    "refresh; overlap='split' rides the generic rung"
                )
            if any(self.local_shape()[ax] < R for ax, _ in self.decomp.axes):
                return self._decline(
                    f"a sharded axis is thinner than the O4 halo ({R})"
                )
        if "fused" not in self._cache:
            kwargs = {}
            if self.mesh is not None:
                kwargs["global_shape"] = self.grid.shape
            if self.storage_dtype != self.dtype:
                # precision="bf16": K9's bf16 instance on the float32
                # state (its sharded instance on a mesh)
                kwargs.update(dtype=self.storage_dtype,
                              storage_dtype=self.dtype)
            self._cache["fused"] = FusedADRStepper(
                self.local_shape(),
                self.grid.spacing,
                cfg.diffusivity,
                self._velocity_zyx(),
                cfg.reaction_rate,
                self.dt,
                cfg.boundary_band,
                bcs[0].value,
                self.device,
                kappa_variation=cfg.kappa_variation,
                **kwargs,
            )
        return self._cache["fused"]

    # ------------------------------------------------------------------ #
    # Analytic solution (constant coefficients)
    # ------------------------------------------------------------------ #
    def exact_solution(self, t: float) -> torch.Tensor:
        """The advecting, decaying heat kernel (module docstring),
        defined only for constant coefficients (``kappa_variation ==
        0``)."""
        cfg = self.cfg
        if cfg.kappa_variation:
            raise ValueError(
                "no closed-form solution with spatially varying K"
            )
        d = cfg.diffusivity
        vel = self._velocity_zyx()
        tau = t - cfg.t0
        ndim = cfg.grid.ndim
        r2 = None
        for ax in range(ndim):
            c = cfg.grid.coords(ax, self.dtype, self.device) - vel[ax] * tau
            shp = [1] * ndim
            shp[ax] = -1
            term = torch.reshape(c * c, shp)
            r2 = term if r2 is None else r2 + term
        amp = (cfg.t0 / t) ** (ndim / 2.0) * math.exp(
            -float(cfg.reaction_rate) * tau
        )
        return (amp * torch.exp(-r2 / (4.0 * d * t))).to(self.dtype)

    def error_norms(self, state: SolverState, t: float | None = None):
        t_val = float(state.t) if t is None else t
        return metrics.error_norms(
            global_field(state.u), self.exact_solution(t_val),
            self.cfg.grid.spacing
        )


# --------------------------------------------------------------------- #
# Registration: the family as a declarative plugin descriptor
# --------------------------------------------------------------------- #
def _cli_configure(p, ndim):
    p.add_argument("--K", type=float, default=1.0,
                   help="base diffusivity K0 of K(x)")
    p.add_argument("--velocity", type=float, nargs="+", default=[0.5],
                   help="advection velocity: one value (broadcast) or "
                        "one per physical axis (x [y [z]])")
    p.add_argument("--kappa-variation", type=float, default=0.0,
                   metavar="EPS",
                   help="spatial variation amplitude of K(x) = K0 (1 + "
                        "EPS prod cos(pi x̂)); |EPS| < 1 (0 = constant)")
    p.add_argument("--reaction", type=float, default=0.0,
                   metavar="LAMBDA",
                   help="linear decay rate; R(u) = -LAMBDA u")
    p.add_argument("--advect", default="upwind",
                   choices=["upwind", "weno5"],
                   help="advective flux: monotone upwind (fused-rung "
                        "eligible) or WENO5 linear advection (generic)")
    p.add_argument("--order", type=int, default=4, choices=[2, 4],
                   help="diffusive Laplacian order")
    p.add_argument("--cfl", type=float, default=0.4)
    p.add_argument("--t0", type=float, default=0.1)


def _cli_build(args, grid, ndim):
    vel = list(args.velocity)
    if len(vel) not in (1, ndim):
        raise ValueError(
            f"--velocity wants 1 or {ndim} values for a {ndim}-D grid, "
            f"got {len(vel)}"
        )
    velocity = vel[0] if len(vel) == 1 else tuple(vel)
    return ADRConfig(
        grid=grid,
        diffusivity=args.K,
        velocity=velocity,
        kappa_variation=args.kappa_variation,
        reaction_rate=args.reaction,
        advect=args.advect,
        order=args.order,
        cfl=args.cfl,
        integrator=getattr(args, "integrator", "ssp_rk3"),
        dtype=args.dtype,
        ic=getattr(args, "ic", None) or "heat_kernel",
        bc=resolve_bc(args, "dirichlet"),
        t0=args.t0,
        impl=args.impl,
        precision=getattr(args, "precision", "native"),
    )


def _stage_radius(cfg) -> int:
    """Fused per-stage stencil radius: K9 shares the O4 layout (R = 2)."""
    return 2


def _key_extras(cfg):
    return [
        f"advect={cfg.advect}",
        f"order={cfg.order}",
        f"kvar={bool(cfg.kappa_variation)}",
        f"react={bool(cfg.reaction_rate)}",
    ]


def _cost_kwargs(cfg):
    return {
        "order": cfg.order,
        "advect": cfg.advect,
        "reaction": bool(cfg.reaction_rate),
        "variable_k": bool(cfg.kappa_variation),
    }


def _bench_build(grid, dtype, impl, case):
    # the full family: variable K, advection on every axis, decay
    return ADRConfig(
        grid=grid, dtype=dtype, impl=impl, velocity=0.5,
        kappa_variation=0.2, reaction_rate=0.25, ic="heat_kernel",
    )


register_model(ModelSpec(
    name="adr",
    config_cls=ADRConfig,
    solver_cls=ADRSolver,
    description="advection–diffusion–reaction with spatially varying "
                "K(x) — the title workload",
    check_error=True,
    sweep_aliases={"K": "diffusivity", "lambda": "reaction_rate"},
    cli_configure=_cli_configure,
    cli_build=_cli_build,
    stage_radius=_stage_radius,
    key_extras=_key_extras,
    cost_kwargs=_cost_kwargs,
    bench_build=_bench_build,
))
