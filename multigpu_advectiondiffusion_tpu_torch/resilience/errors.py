"""Structured divergence errors (JAX ``resilience/errors.py``
counterpart: the two classes the ensemble engine raises, with the JAX
package's attributes and messages)."""

from __future__ import annotations


class SolverDivergedError(RuntimeError):
    """The divergence check found a non-finite field or a norm past the
    growth bound. Carries the global step, the simulated time and the
    offending max-norm."""

    def __init__(self, step: int, t: float, norm: float,
                 reason: str = "non-finite field"):
        self.step = int(step)
        self.t = float(t)
        self.norm = float(norm)
        self.reason = reason
        super().__init__(
            f"solver diverged at step {self.step} (t={self.t:.6g}): "
            f"{reason} (max|u| = {self.norm:.6g})"
        )


class EnsembleMemberDivergedError(SolverDivergedError):
    """One or more members of a batched ensemble run diverged.

    The ensemble probe reduces per member, so one member's NaN or norm
    blow-up names its index instead of poisoning the whole batch's
    verdict. Carries ``members`` (offending indices) and
    ``member_norms`` (their max-norms); ``norm`` is the worst one."""

    def __init__(self, step: int, t: float, members, norms,
                 reason: str = "non-finite field"):
        self.members = [int(m) for m in members]
        self.member_norms = [float(n) for n in norms]
        worst = max(
            (n for n in self.member_norms), default=float("nan")
        )
        super().__init__(
            step, t, worst,
            reason=(
                f"{reason} in ensemble member(s) "
                f"{self.members} of the batch"
            ),
        )
