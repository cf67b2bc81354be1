"""The batched-ensemble CLI driver (JAX ``cli/drivers.py``
counterpart: ``build_ensemble_members`` and ``run_ensemble_solver``, on
one device).

``--ensemble B [--sweep NAME=a:b|v1,...]`` advances B members in one
batched dispatch (``models/ensemble.py``) and reports one summary row
per member, the engaged rung, each kernel's launches and the members'
MLUPS. A device mesh is refused with the JAX package's words; the
single-run supervision flags the JAX CLI refuses with ``--ensemble`` are
not flags of the port's CLI.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.models.ensemble import (
    EnsembleSolver,
    parse_sweep_spec,
)
from multigpu_advectiondiffusion_tpu_torch.timestepping.integrators import (
    STAGES,
)
from multigpu_advectiondiffusion_tpu_torch.utils import io as io_utils
from multigpu_advectiondiffusion_tpu_torch.utils.metrics import mlups

MEMBER_AXIS = "members"


def build_ensemble_members(sweeps, members: int, aliases=None):
    """CLI ``--sweep`` specs -> per-member override dicts.

    ``NAME=a:b`` sweeps linearly, ``NAME=v1,...`` lists one value per
    member. ``aliases`` maps CLI names to config fields (``K`` ->
    ``diffusivity``); an ``ic.PARAM`` name lands in the member's
    ``ic_params`` (e.g. ``ic.width=0.1:0.2``)."""
    aliases = aliases or {}
    out = [dict() for _ in range(members)]
    ic_params = [dict() for _ in range(members)]
    for spec in sweeps or []:
        name, values = parse_sweep_spec(spec, members)
        if name.startswith("ic."):
            key = name[3:]
            for i, v in enumerate(values):
                ic_params[i][key] = v
            continue
        name = aliases.get(name, name)
        for i, v in enumerate(values):
            out[i][name] = v
    for i, p in enumerate(ic_params):
        if p:
            out[i]["ic_params"] = tuple(sorted(p.items()))
    return out


def check_ensemble_mesh(mesh_spec) -> None:
    """``--mesh`` with ``--ensemble``: the JAX package composes a mesh
    through a ``members`` axis and declines any other with the words
    below; the port runs on one device and declines both."""
    if not mesh_spec:
        return
    names = [part.partition("=")[0].strip() for part in mesh_spec.split(",")]
    if MEMBER_AXIS not in names:
        raise ValueError(
            "--ensemble composes with --mesh through a 'members' axis "
            "(e.g. --mesh members=8 or --mesh members=4,dz=2); a "
            "purely spatial mesh shards one member's grid — drop "
            "--mesh or add the members axis"
        )
    raise NotImplementedError(
        "member-sharded meshes (--mesh members=P) are not ported yet "
        "(ROADMAP queue 1 item 8f); the port's ensemble runs on one "
        "device — drop --mesh"
    )


def run_ensemble_solver(solver_cls, cfg, name: str, args, aliases=None,
                        counters=None) -> dict:
    """The batched-ensemble CLI run: build the members from
    ``args.sweep``, run one untimed step (the kernels build at first
    use), then the timed dispatch — ``args.iters`` steps, or
    ``advance_to(args.t_end)`` — and print and save the per-member
    summary. ``counters`` maps kernel names to launch counters, reset
    before the timed dispatch and reported after it."""
    B = int(args.ensemble)
    check_ensemble_mesh(args.mesh)
    members = build_ensemble_members(args.sweep, B, aliases=aliases)
    es = EnsembleSolver(solver_cls, cfg, members,
                        device=args.device)
    estate = es.initial_state()
    iters = args.iters
    if iters is None and args.t_end is None:
        iters = 100
    device = es.solver.device
    counters = counters or {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # untimed warm-up: the kernels build at first use
    t0 = time.perf_counter()
    if iters is not None:
        es.run(estate, 1)
    else:
        es.advance_to(estate, float(np.max(estate.t)))
    sync()
    warm_s = time.perf_counter() - t0

    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    if iters is not None:
        out = es.run(estate, iters)
    else:
        out = es.advance_to(estate, args.t_end)
    sync()
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items() if c.launches}

    work = iters if iters is not None else int(np.max(out.it))
    rate = mlups(cfg.grid.num_cells * B, max(1, work),
                 STAGES[cfg.integrator], seconds)
    summaries = es.member_summaries(out)
    es.check_health(out)
    engaged = es.engaged_path()
    result = {
        "name": name,
        "ensemble": B,
        "grid_xyz": list(cfg.grid.shape_xyz),
        "iters": work,
        "seconds": round(seconds, 6),
        "warmup_seconds": round(warm_s, 4),
        "mlups_members": round(rate, 2),
        "devices": engaged["devices"],
        "member_sharding": engaged["member_sharding"],
        "mesh": engaged["mesh"],
        "device": str(device),
        "engaged": engaged,
        "launches": launches,
        "members": summaries,
    }
    print(f"-- {name} ensemble: B={B} members, {work} iters, "
          f"{seconds:.4f}s, {rate:,.1f} MLUPS*members "
          f"({engaged['stepper']}) on {device}")
    if engaged["fallback"]:
        print(f"   fused fallback: {engaged['fallback']}")
    print("   kernel launches: "
          + (", ".join(f"{k} x{v}" for k, v in launches.items()) or "none"))
    for row in summaries:
        drift = row.get("mass_drift")
        print(
            f"   member {row['member']:3d}: t={row['t']:.5g} "
            f"max|u|={row['max_abs']:.5g}"
            + (f" mass_drift={drift:+.3e}" if drift is not None else "")
            + (f" {row['overrides']}" if row.get("overrides") else "")
        )
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        io_utils.save_binary(out.u, os.path.join(args.save,
                                                 "ensemble_result.bin"))
        tmp = os.path.join(args.save, "ensemble_summary.json.tmp")
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1)
        os.replace(tmp, os.path.join(args.save, "ensemble_summary.json"))
    return result
