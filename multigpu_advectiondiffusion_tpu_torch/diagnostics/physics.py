"""Physics violation rules, the host-side part (JAX
``diagnostics/physics.py`` counterpart).

A :class:`ViolationRule` is a host-side tolerance check of a stats dict
(``{"max": ..., "min": ..., "tv": ...}``) against the baseline taken on
the initial state; :func:`check_violations` evaluates a solver's rules
(``diagnostics_spec()["rules"]``) and returns one record per breach.
Plain Python: the fused on-device observables that fill the stats dict
come with the telemetry layer, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ViolationRule:
    """Host-side tolerance check of finalized stats vs the baseline.
    ``check(stats, baseline, tolerance)`` returns a violation message,
    or ``None`` when the invariant holds."""

    name: str
    tolerance: float
    check: Callable


def max_principle_rule(tolerance: float = 1e-3) -> ViolationRule:
    """Pure diffusion with clamped/zero-gradient boundaries satisfies
    the discrete maximum principle up to the 4th-order stencil's
    non-monotone wiggle: no new global extremum beyond the initial
    field's, within ``tolerance`` of the initial range."""

    def check(stats, baseline, tol):
        scale = max(
            1.0, abs(baseline.get("max", 0.0)), abs(baseline.get("min", 0.0))
        )
        band = tol * scale
        if stats["max"] > baseline["max"] + band:
            return (
                f"maximum principle: max {stats['max']:.6g} exceeds "
                f"initial max {baseline['max']:.6g} + {band:.3g}"
            )
        if stats["min"] < baseline["min"] - band:
            return (
                f"maximum principle: min {stats['min']:.6g} undercuts "
                f"initial min {baseline['min']:.6g} - {band:.3g}"
            )
        return None

    return ViolationRule("max_principle", tolerance, check)


def positivity_rule(tolerance: float = 1e-3) -> ViolationRule:
    """Nonnegative initial data stays nonnegative under
    advection–diffusion with a monotone advective flux and K(x) > 0
    (linear decay only shrinks it), up to the O4 stencil's wiggle.
    Vacuous for signed initial data."""

    def check(stats, baseline, tol):
        if baseline.get("min", 0.0) < 0.0:
            return None  # signed data: positivity is not a property
        scale = max(1.0, abs(baseline.get("max", 0.0)))
        if stats["min"] < -tol * scale:
            return (
                f"positivity: min {stats['min']:.6g} fell below "
                f"-{tol * scale:.3g} from nonnegative initial data"
            )
        return None

    return ViolationRule("positivity", tolerance, check)


def tv_monotone_rule(tolerance: float = 0.05) -> ViolationRule:
    """WENO on a scalar conservation law is essentially non-oscillatory:
    total variation stays bounded by the initial data's. Growth past
    ``tolerance`` (relative) means spurious oscillation."""

    def check(stats, baseline, tol):
        tv0 = baseline.get("tv")
        tv = stats.get("tv")
        if tv0 is None or tv is None:
            return None
        bound = tv0 * (1.0 + tol) + 1e-12
        if tv > bound:
            return (
                f"TV monotonicity: total variation {tv:.6g} grew past "
                f"the initial {tv0:.6g} (+{100 * tol:.1f}% tolerance)"
            )
        return None

    return ViolationRule("tv_monotone", tolerance, check)


def check_violations(
    rules: Sequence[ViolationRule], stats: dict, baseline: Optional[dict]
) -> List[dict]:
    """Evaluate every rule; returns violation records (empty = clean)."""
    if not baseline:
        return []
    out = []
    for rule in rules:
        msg = rule.check(stats, baseline, rule.tolerance)
        if msg:
            out.append(
                {"rule": rule.name, "message": msg,
                 "tolerance": rule.tolerance}
            )
    return out
