"""Batched ensemble engine, one device (JAX ``models/ensemble.py``
counterpart).

A parameter sweep is one batched dispatch instead of B serialized runs:
:class:`EnsembleSolver` builds a ``(B, *grid)`` initial state from
per-member overrides (initial conditions and/or the solver's
member-varying scalars — diffusivity K, CFL, decay rate) and advances
all B members per dispatch through ``SolverBase.run_ensemble`` /
``advance_to_ensemble`` (``models/base.py``):

* uniform-physics ensembles on the slab rung fold B into one
  cooperative launch (K2b, ``ops/kernels/fused_slab_run.py``);
* uniform-physics ensembles on the per-stage rung launch the stage
  kernel (K1, K5 or K9) once per member per stage — the JAX package's
  ``vmap`` of the stage kernel;
* scalar sweeps ride the generic loop with the member scalars as
  operands, never baked constants.

Every uniform-physics member equals its looped single run to the bit.
Divergence stays member-attributed: the probe reduces per member, so one
blown-up member raises :class:`~..resilience.errors.
EnsembleMemberDivergedError` naming its index while the others' results
stay valid.

Not ported yet: member-sharded device meshes (a ``mesh`` raises), the
measured tuner behind ``impl="auto"`` (raises, as the solvers do), and
the AOT prewarm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.models.base import (
    ensemble_cfg_gate,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import EnsembleState
from multigpu_advectiondiffusion_tpu_torch.resilience.errors import (
    EnsembleMemberDivergedError,
)

# member-override keys that rebuild the member's INITIAL STATE (via a
# per-member config) but do not enter the batched step as operands
_IC_KEYS = ("ic", "ic_params", "t0")


def parse_sweep_spec(spec: str, members: int) -> tuple:
    """``'NAME=a:b'`` (linear sweep) or ``'NAME=v1,v2,...'`` (explicit,
    one value per member) -> ``(name, [B floats])`` — the CLI
    ``--sweep`` grammar."""
    name, sep, body = spec.partition("=")
    name = name.strip()
    if not sep or not name or not body:
        raise ValueError(
            f"--sweep wants NAME=a:b or NAME=v1,v2,...; got {spec!r}"
        )
    if ":" in body:
        lo, _, hi = body.partition(":")
        values = np.linspace(float(lo), float(hi), members)
        return name, [float(v) for v in values]
    values = [float(v) for v in body.split(",")]
    if len(values) != members:
        raise ValueError(
            f"--sweep {name}: {len(values)} values for {members} members"
        )
    return name, values


class EnsembleSolver:
    """Front end over one template solver: build the batched state,
    dispatch the batched runs, report per-member health and summaries.

    ``members`` is an int B (B identical members) or a sequence of
    per-member override dicts whose keys are the solver's
    ``ensemble_operands`` names (member-varying scalars) and/or the IC
    keys ``ic``/``ic_params``/``t0``. ``device`` is the solver's (the GPU
    unless ``"cpu"`` is asked for)."""

    def __init__(self, solver_cls, cfg, members, mesh=None, decomp=None,
                 device=None):
        if mesh is not None or decomp is not None:
            raise ValueError(
                "ensemble meshes are not ported yet (ROADMAP queue 1 item "
                "8f): the port's ensemble runs on one device. (In the JAX "
                "package an ensemble mesh composes through a 'members' "
                "axis, e.g. make_mesh({'members': 8}); a purely spatial "
                "mesh shards one member's grid.)"
            )
        if isinstance(members, int):
            if members < 1:
                raise ValueError("an ensemble needs at least one member")
            members = [{} for _ in range(members)]
        self._overrides = [dict(m) for m in members]
        self.members = len(self._overrides)
        if not self.members:
            raise ValueError("an ensemble needs at least one member")
        # the config-level declines first: the port's solvers refuse
        # these configs at construction, with other words
        ensemble_cfg_gate(cfg)
        self.solver_cls = solver_cls
        self.cfg = cfg
        self.mesh = None
        self.solver = solver_cls(cfg, device=device)
        supported = set(self.solver.ensemble_operands())
        for i, ov in enumerate(self._overrides):
            unknown = sorted(set(ov) - supported - set(_IC_KEYS))
            if unknown:
                raise ValueError(
                    f"member {i}: override(s) {unknown} are neither "
                    f"member-varying operands ({sorted(supported)}) nor "
                    f"IC keys {list(_IC_KEYS)} — structure-changing "
                    "knobs (impl, weno_order, grid, ...) cannot vary "
                    "inside one batched executable"
                )
        # construction-time loud gate (slab pin, operand names)
        self.solver._ensemble_gate(
            tuple(k for ov in self._overrides for k in ov
                  if k in supported)
        )
        self._baseline = None

    # ------------------------------------------------------------------ #
    # State + operands
    # ------------------------------------------------------------------ #
    def member_cfg(self, i: int):
        """Member ``i``'s effective config (template + its overrides) —
        for per-member initial states and summaries; execution itself
        stays on the one batched dispatch."""
        ov = {
            k: v for k, v in self._overrides[i].items()
            if k in {f.name for f in dataclasses.fields(self.cfg)}
        }
        if "ic_params" in ov and not isinstance(ov["ic_params"], tuple):
            ov["ic_params"] = tuple(
                (k, v) for k, v in dict(ov["ic_params"]).items()
            )
        return dataclasses.replace(self.cfg, **ov) if ov else self.cfg

    def member_solver(self, i: int):
        """A throwaway single-member solver for member ``i`` (initial
        states, analytic solutions, looped baselines) on the ensemble's
        device — never the execution path."""
        return self.solver_cls(self.member_cfg(i),
                               device=self.solver.device)

    def initial_state(self) -> EnsembleState:
        """The members' initial states stacked; arms the health baseline
        (:meth:`arm`)."""
        est = EnsembleState.stack(
            self.member_solver(i).initial_state()
            for i in range(self.members)
        )
        self.arm(est)
        return est

    def operands(self) -> Optional[dict]:
        """``{name: [B values]}`` for every member-varying scalar where
        any member differs from the template default; ``None`` when the
        physics is uniform (the fused-eligible case)."""
        defaults = self.solver.ensemble_operands()
        out = {}
        for name, default in defaults.items():
            col = [
                float(ov.get(name, default)) for ov in self._overrides
            ]
            if any(v != float(default) for v in col):
                out[name] = col
        return out or None

    # ------------------------------------------------------------------ #
    # Execution
    # ------------------------------------------------------------------ #
    def run(self, estate: EnsembleState, num_iters: int,
            donate: bool = False) -> EnsembleState:
        return self.solver.run_ensemble(
            estate, num_iters, operands=self.operands(), donate=donate,
        )

    def advance_to(self, estate: EnsembleState, t_end,
                   max_steps: Optional[int] = None,
                   donate: bool = False) -> EnsembleState:
        """``t_end`` is a scalar or one horizon per member; ``donate=True``
        consumes ``estate`` (use the returned state only)."""
        return self.solver.advance_to_ensemble(
            estate, t_end, operands=self.operands(),
            max_steps=max_steps, donate=donate,
        )

    def engaged_path(self) -> dict:
        """Batched-dispatch provenance, the JAX package's keys: the rung
        of the last dispatch, the member count, the operands, the fused
        decline's reason, and the placement (one device, no mesh)."""
        last = self.solver._ensemble_last or {}
        return {
            "impl": self.cfg.impl,
            "stepper": last.get("stepper", "ensemble-vmap[unrun]"),
            "ensemble": self.members,
            "operands": last.get("operands", []),
            "fallback": self.solver._fused_fallback,
            "devices": last.get("devices", 1),
            "member_sharding": last.get("member_sharding", 1),
            "mesh": last.get("mesh"),
        }

    # ------------------------------------------------------------------ #
    # Per-member health + summaries
    # ------------------------------------------------------------------ #
    def probe(self, estate: EnsembleState) -> dict:
        """Per-member stats ``{key: [B floats]}`` — ``max_abs`` (NaN
        mapped to +inf), ``min``, ``max``, ``l2`` and ``mass`` — reduced
        along each member's own axes on the device in float32 and read
        back once (the JAX package's ``make_ensemble_probe_parts``)."""
        u = estate.u.detach()
        flat = u.reshape(u.shape[0], -1).to(torch.float32)
        a = flat.abs()
        a = torch.where(torch.isnan(a), torch.full_like(a, math.inf), a)
        m, umin, umax, s2, s = torch.stack([
            a.amax(dim=1), flat.amin(dim=1), flat.amax(dim=1),
            (flat * flat).sum(dim=1), flat.sum(dim=1),
        ]).cpu().tolist()
        vol = math.prod(self.solver.grid.spacing)
        return {
            "max_abs": m,
            "min": umin,
            "max": umax,
            "l2": [
                math.sqrt(max(vol * x, 0.0)) if math.isfinite(x) else x
                for x in s2
            ],
            "mass": [vol * x for x in s],
        }

    def arm(self, estate: EnsembleState) -> None:
        """Record the per-member healthy baseline (mass integrals and
        norms) the drift reports and the growth bound read against."""
        stats = self.probe(estate)
        bad = [
            i for i, m in enumerate(stats["max_abs"])
            if not np.isfinite(m)
        ]
        if bad:
            raise EnsembleMemberDivergedError(
                int(np.max(estate.it)), float(np.max(estate.t)),
                bad, [stats["max_abs"][i] for i in bad],
                reason="non-finite initial state",
            )
        self._baseline = stats

    def check_health(self, estate: EnsembleState,
                     growth: float = 1e3) -> dict:
        """Per-member divergence check: non-finite members (or members
        whose norm grew past ``growth * max(1, |u0|)``) raise
        :class:`EnsembleMemberDivergedError` naming their indices — the
        rest of the batch stays valid. Returns the stats on health."""
        stats = self.probe(estate)
        norms = stats["max_abs"]
        bad, why = [], None
        for i, m in enumerate(norms):
            if not np.isfinite(m):
                bad.append(i)
                why = "non-finite field"
        if not bad and self._baseline is not None:
            for i, m in enumerate(norms):
                bound = growth * max(1.0, self._baseline["max_abs"][i])
                if m > bound:
                    bad.append(i)
                    why = f"norm grew past the growth bound ({growth:g})"
        if bad:
            raise EnsembleMemberDivergedError(
                int(np.max(estate.it)), float(np.max(estate.t)),
                bad, [norms[i] for i in bad], reason=why,
            )
        return stats

    def member_summaries(self, estate: EnsembleState) -> list:
        """One dict per member (max|u|, min/max, l2, mass, mass drift
        against the armed baseline, final t/it, its overrides)."""
        stats = self.probe(estate)
        out = []
        for i in range(self.members):
            row = {
                "member": i,
                "t": float(estate.t[i]),
                "it": int(estate.it[i]),
                "max_abs": stats["max_abs"][i],
                "min": stats["min"][i],
                "max": stats["max"][i],
                "l2": stats["l2"][i],
                "mass": stats["mass"][i],
            }
            if self._baseline is not None:
                m0 = self._baseline["mass"][i]
                row["mass_drift"] = (row["mass"] - m0) / max(
                    abs(m0), 1e-30
                )
            if self._overrides[i]:
                row["overrides"] = dict(self._overrides[i])
            out.append(row)
        return out
