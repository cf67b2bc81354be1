"""Solver-plugin registry: a PDE family is one declarative descriptor
(JAX ``models/registry.py`` counterpart).

A family registers ONE :class:`ModelSpec` naming its config and solver
classes and the hooks the generic layers need: the CLI generates its
``<name>{2,3}d`` verbs from ``cli_configure``/``cli_build``, and a bench
constructs its configs through ``bench_build``. The tuner and cost-model
hooks (``stage_radius``, ``key_extras``, ``cost_kwargs``) are carried for
the layers that will read them.

The registration contract: every registered solver class DECLARES the
four methods of :data:`REQUIRED_SOLVER_CONTRACT` in its own body (not
merely inherits them); :func:`register_model` refuses a half-wired
solver, so it fails at import and not at dispatch.

Built-in families register at the bottom of their modules
(``models/diffusion.py``, ``models/burgers.py``, ``models/adr.py``);
:func:`_ensure_builtins` imports them lazily, so lookups see the same
registry whichever model was imported first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

#: contract methods every registered solver class must declare in its
#: own body
REQUIRED_SOLVER_CONTRACT = (
    "stencil_spec",
    "diagnostics_spec",
    "ensemble_operands",
    "cfl_rule",
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One solver family's declarative descriptor, the JAX package's
    fields.

    ``cli_configure(parser, ndim)`` adds the family's flags to a
    generated ``<name><ndim>d`` verb; ``cli_build(args, grid, ndim)``
    turns parsed args into the family config. ``stage_radius(cfg)`` is
    the fused per-stage stencil radius, ``key_extras(cfg)`` the
    family-specific tuning-cache key parts, ``cost_kwargs(cfg)`` the
    cost model's kwargs, ``bench_build(grid, dtype, impl, case)`` the
    bench config constructor."""

    name: str
    config_cls: type
    solver_cls: type
    description: str
    kind: Optional[str] = None  # cost-model family key; defaults to name
    # the port's solvers take 2-D and 3-D grids; 1-D is not ported yet
    # (the JAX package's default is (1, 2, 3))
    cli_dims: Tuple[int, ...] = (2, 3)
    check_error: bool = False  # solver has an analytic error_norms
    sweep_aliases: Mapping[str, str] = dataclasses.field(
        default_factory=dict
    )
    cli_configure: Optional[Callable] = None
    cli_build: Optional[Callable] = None
    stage_radius: Optional[Callable] = None
    key_extras: Optional[Callable] = None
    cost_kwargs: Optional[Callable] = None
    bench_build: Optional[Callable] = None

    @property
    def family_kind(self) -> str:
        return self.kind or self.name


_REGISTRY: Dict[str, ModelSpec] = {}
_BUILTINS_LOADED = False


def register_model(spec: ModelSpec) -> ModelSpec:
    """Register one family; a solver class missing any contract method
    in its own body raises ``ValueError``."""
    missing = [
        m for m in REQUIRED_SOLVER_CONTRACT
        if m not in vars(spec.solver_cls)
    ]
    if missing:
        raise ValueError(
            f"solver {spec.solver_cls.__name__} cannot register as "
            f"{spec.name!r}: contract method(s) {missing} are not "
            "declared in the class body (REQUIRED_SOLVER_CONTRACT — "
            "a half-wired plugin must fail at registration, not at "
            "dispatch)"
        )
    if spec.name in _REGISTRY and _REGISTRY[spec.name] is not spec:
        existing = _REGISTRY[spec.name]
        if (
            existing.solver_cls.__name__ != spec.solver_cls.__name__
            or existing.config_cls.__name__ != spec.config_cls.__name__
        ):
            raise ValueError(
                f"model name {spec.name!r} already registered for "
                f"{existing.solver_cls.__name__}"
            )
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_builtins() -> None:
    """Import the built-in family modules (idempotent): each registers
    itself at its module bottom."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from multigpu_advectiondiffusion_tpu_torch.models import (  # noqa: F401
        adr,
        burgers,
        diffusion,
    )


def names() -> Tuple[str, ...]:
    """Registered family names, in registration order."""
    _ensure_builtins()
    return tuple(_REGISTRY)


def specs() -> Tuple[ModelSpec, ...]:
    _ensure_builtins()
    return tuple(_REGISTRY.values())


def get(name: str) -> ModelSpec:
    _ensure_builtins()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(
            f"unknown model {name!r}; registered models: {list(_REGISTRY)}"
        )
    return spec


def spec_for_config(cfg) -> Optional[ModelSpec]:
    """The spec whose config class ``cfg`` is an instance of (exact
    class first, then subclasses); ``None`` for unregistered configs."""
    _ensure_builtins()
    cls = type(cfg)
    for spec in _REGISTRY.values():
        if spec.config_cls is cls:
            return spec
    for spec in _REGISTRY.values():
        if isinstance(cfg, spec.config_cls):
            return spec
    return None


def family_of_run_name(run_name: str) -> Optional[str]:
    """Longest registered family name prefixing ``run_name`` (run names
    follow the ``<family><ndim>d...`` convention)."""
    _ensure_builtins()
    best = None
    for name in _REGISTRY:
        if run_name.startswith(name) and (
            best is None or len(name) > len(best)
        ):
            best = name
    return best


def solver_for_run_name(run_name: str) -> type:
    fam = family_of_run_name(run_name)
    if fam is None:
        raise KeyError(
            f"run name {run_name!r} matches no registered model family "
            f"({list(_REGISTRY)})"
        )
    return _REGISTRY[fam].solver_cls


def resolve_bc(args, default):
    """Shared CLI ``--bc`` resolution (one value or one per axis,
    reversed to array order); ``default`` where the verb has no
    ``--bc`` flag or it is empty."""
    bc = getattr(args, "bc", None)
    if not bc:
        return default
    return bc[0] if len(bc) == 1 else tuple(reversed(bc))
