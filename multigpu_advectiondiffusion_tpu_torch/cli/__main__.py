"""Command-line interface of the port: the ``diffusion{2,3}d``,
``burgers{2,3}d`` and ``adr{2,3}d`` verbs, generated from the model
registry (``models/registry.py``).

    python -m multigpu_advectiondiffusion_tpu_torch.cli diffusion3d \
        --n 400 200 206 --lengths 10 5 5.15 --iters 101 --impl pallas \
        --save out/ --check-error
    python -m multigpu_advectiondiffusion_tpu_torch.cli burgers3d \
        --n 512 512 512 --iters 86 --nu 1e-5 --impl pallas
    python -m multigpu_advectiondiffusion_tpu_torch.cli burgers3d \
        --fixed-dt --impl pallas_slab --cfl 0.3 --lengths 2 2 4 \
        --n 400 400 406 --iters 267
    python -m multigpu_advectiondiffusion_tpu_torch.cli diffusion2d \
        --n 1001 1001 --lengths 10 10 --iters 10000 --impl pallas
    python -m multigpu_advectiondiffusion_tpu_torch.cli burgers2d \
        --n 400 400 --lengths 2 2 --iters 200 --fixed-dt --impl pallas
    python -m multigpu_advectiondiffusion_tpu_torch.cli burgers3d \
        --fixed-dt --impl pallas_axis --cfl 0.3 --lengths 2 2 4 \
        --n 400 400 406 --iters 267
    python -m multigpu_advectiondiffusion_tpu_torch.cli adr3d \
        --n 508 204 160 --lengths 12.7 5.1 4 --kappa-variation 0.2 \
        --reaction 0.25 --iters 404 --impl pallas
    python -m multigpu_advectiondiffusion_tpu_torch.cli diffusion3d \
        --n 256 128 64 --lengths 6.4 3.2 1.6 --iters 60 --impl pallas_slab \
        --ic gaussian --ensemble 64 --sweep ic.width=0.1:0.226 --save out/
    python -m multigpu_advectiondiffusion_tpu_torch.cli diffusion3d \
        --n 400 200 206 --lengths 10 5 5.15 --iters 101 --impl pallas \
        --mesh dz=2 --overlap split

The flags are the JAX CLI's flags of the same names. ``--ensemble B``
with ``--sweep NAME=a:b`` (or ``NAME=v1,...``, repeatable; NAME a
family's sweep alias such as ``K``, a member-varying scalar, or
``ic.PARAM``) runs B members in one batched dispatch
(``cli/drivers.py``) and prints and saves one summary row per member.
The run goes to the GPU unless ``--device cpu`` is given. ``--mesh
dz=P`` (``dz=2,dy=2``, ...) runs on a device mesh: P visible cards, or P
shards on ``--device`` (``--device cpu``: P CPU shards). The summary
names the kernel path that ran, as the JAX CLI's summary does, the mesh
and its halo schedule, and the launches of each hand-written kernel in
the run (summed over the shards). ``--save DIR`` writes
``initial.bin`` and ``result.bin`` in the reference's float32 layout.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import torch

from multigpu_advectiondiffusion_tpu_torch.cli.drivers import (
    run_ensemble_solver,
)
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models import registry
from multigpu_advectiondiffusion_tpu_torch.ops import IMPLS
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused2d_sharded,
    fused_adr,
    fused_burgers,
    fused_diffusion,
    fused_diffusion_step,
    fused_slab_run,
    laplacian,
    weno,
    whole_run,
)
from multigpu_advectiondiffusion_tpu_torch.timestepping.integrators import (
    STAGES,
)
from multigpu_advectiondiffusion_tpu_torch.utils import io, metrics
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
    Decomposition,
    make_mesh,
)
from multigpu_advectiondiffusion_tpu_torch.utils.ic import (
    REGISTRY as ic_registry,
)


def build_parser() -> argparse.ArgumentParser:
    """The verbs are generated from the model registry, as the JAX CLI
    generates them: every registered family gets ``<name>{2,3}d`` with
    the common flags and its spec's own, and ``--check-error`` where the
    family has an analytic solution (``ModelSpec.check_error``)."""
    parser = argparse.ArgumentParser(
        prog="python -m multigpu_advectiondiffusion_tpu_torch.cli"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for spec in registry.specs():
        for ndim in sorted(spec.cli_dims, reverse=True):
            p = sub.add_parser(f"{spec.name}{ndim}d",
                               help=f"{ndim}-D {spec.description}")
            _common(p, ndim)
            spec.cli_configure(p, ndim)
            if spec.check_error:
                p.add_argument("--check-error", action="store_true",
                               help="report L1/L2/Linf against the exact "
                                    "solution")
            p.set_defaults(spec=spec, ndim=ndim)
    return parser


def _common(p, ndim: int) -> None:
    """The flags every verb shares, as the JAX CLI names them."""
    names = ("NX", "NY", "NZ")[:ndim]
    p.add_argument("--n", type=int, nargs=ndim, required=True,
                   metavar=names,
                   help="grid nodes per physical axis "
                        f"({' '.join(n[-1].lower() for n in names)})")
    p.add_argument("--lengths", type=float, nargs=ndim, default=None,
                   help="physical extents; domain centered at 0")
    p.add_argument("--iters", type=int, default=None,
                   help="fixed iteration count (reference main.c mode)")
    p.add_argument("--t-end", type=float, default=None,
                   help="march to this simulated time instead of --iters")
    p.add_argument("--impl", default="xla", choices=IMPLS,
                   help="kernel rung: xla (generic); pallas_axis (the "
                        "per-axis kernels, a launch per operator and "
                        "stage); in 3-D pallas_stage (a CUDA kernel a "
                        "stage), pallas_step (a kernel a step, diffusion; "
                        "a kernel a stage, Burgers), pallas_slab (a kernel "
                        "a run) or pallas (the slab rung where the "
                        "measured gate prefers it, else a kernel a "
                        "stage); in 2-D every fused flavor runs the "
                        "whole-run kernel; ADR fuses a kernel a stage under "
                        "pallas and pallas_stage only. A config a fused "
                        "rung declines runs the per-axis kernels")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--precision", default="native",
                   choices=["native", "bf16"],
                   help="storage precision rung: bf16 = keep the state in "
                        "bfloat16 between steps (the fused kernels' "
                        "buffers; on the generic path a compensated "
                        "(hi, lo) pair) while every stencil tap and RK "
                        "stage computes in float32; requires --dtype "
                        "float32, one device, single runs (3-D Burgers "
                        "needs --fixed-dt and engages the slab rung)")
    p.add_argument("--ic", default=None, choices=sorted(ic_registry),
                   help="initial condition (default: the family's)")
    p.add_argument("--save", default=None, metavar="DIR",
                   help="write initial.bin and result.bin here")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda)")
    p.add_argument("--ensemble", type=int, default=0, metavar="B",
                   help="batched ensemble engine: advance B independent "
                        "members (varying ICs and/or swept scalars, see "
                        "--sweep) in one batched dispatch instead of B "
                        "runs; uniform physics folds B into one launch of "
                        "the slab kernel (K2b) where the slab rung engages "
                        "and launches the stage kernel once per member on "
                        "the per-stage rung (0 = off)")
    p.add_argument("--sweep", action="append", default=[],
                   metavar="NAME=a:b",
                   help="member-varying parameter for --ensemble B: "
                        "NAME=a:b sweeps linearly across the B members, "
                        "NAME=v1,v2,... lists one value per member. NAME "
                        "is a member-varying scalar (diffusion: K/"
                        "diffusivity; burgers: cfl; adr: K, lambda) or an "
                        "IC parameter as ic.PARAM (e.g. ic.width); "
                        "repeatable")
    p.add_argument("--mesh", default=None,
                   help="device-mesh spec, e.g. 'dz=2' or 'dz=2,dy=2': P "
                        "visible GPUs, or P shards on --device (e.g. "
                        "--device cpu); mesh axis dz/dy/dx shards grid "
                        "axis z/y/x. With --ensemble refused in the JAX "
                        "CLI's words")
    p.add_argument("--overlap", default="padded",
                   choices=["padded", "split"],
                   help="sharded halo schedule: 'padded' exchanges before "
                        "each stencil, 'split' computes the interior while "
                        "the z slabs are exchanged (the fused rungs' "
                        "three-call interior/edge schedule)")
    p.add_argument("--steps-per-exchange", type=int, default=1, metavar="K",
                   help="exchange a K*G-deep ghost zone once per K steps "
                        "instead of G-deep every step (sharded z-slab "
                        "slab-rung runs only)")
    p.add_argument("--exchange", choices=["collective", "dma"],
                   default="collective",
                   help="halo transport of the sharded slab rung: "
                        "collective (an exchange between launches) or dma "
                        "(K4: one launch a run for every shard of the "
                        "card, the ghost rows moved inside the kernel)")


def _sync(solver) -> None:
    devices = ([solver.device] if solver.mesh is None
               else solver.mesh.device_list())
    for device in set(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _grid(args) -> Grid:
    lengths = (args.lengths if args.lengths is not None
               else [2.0] * len(args.n))
    return Grid.make(*args.n, lengths=lengths)


def run_model(args) -> int:
    """Build the family's config from the flags (``ModelSpec.cli_build``)
    and drive its solver."""
    spec = args.spec
    cfg = spec.cli_build(args, _grid(args), args.ndim)
    if args.ensemble and args.ensemble > 1:
        # batched ensemble engine; sweep aliases (e.g. K -> diffusivity)
        # come from the family's registration spec
        run_ensemble_solver(spec.solver_cls, cfg, args.command, args,
                            aliases=dict(spec.sweep_aliases),
                            counters=_COUNTERS)
        return 0
    knobs = {"overlap": args.overlap,
             "steps_per_exchange": args.steps_per_exchange,
             "exchange": args.exchange}
    fields = {f.name for f in dataclasses.fields(cfg)}
    cfg = dataclasses.replace(
        cfg, **{k: v for k, v in knobs.items() if k in fields})
    if args.mesh:
        mesh, sizes = parse_mesh_spec(args.mesh, args.device)
        solver = spec.solver_cls(cfg, mesh=mesh,
                                 decomp=decomposition_for(cfg.grid, sizes))
    else:
        solver = spec.solver_cls(cfg, device=args.device)
    return _drive(args.command, solver, args,
                  check_error=spec.check_error and args.check_error)


def parse_mesh_spec(spec: str, device=None):
    """``'dz=4,dy=2'`` -> ``(mesh, sizes)`` (the JAX CLI's function): the
    visible GPUs, or every shard on ``device`` when one is given."""
    sizes = {}
    for part in spec.split(","):
        name, _, num = part.partition("=")
        sizes[name.strip()] = int(num)
    devices = None
    if device is not None:
        devices = [torch.device(device)] * math.prod(sizes.values())
    return make_mesh(sizes, devices=devices), sizes


def decomposition_for(grid, mesh_sizes) -> Decomposition:
    """Mesh axis names map to grid axes by suffix: dz/dy/dx -> z/y/x; a
    ``_suffix`` after the letter declares a member of a compound axis
    (outermost first), as in the JAX CLI."""
    names = ("z", "y", "x")[-grid.ndim:]
    suffix_to_axis = {n: ax for ax, n in enumerate(names)}
    groups = {}
    for mesh_name in mesh_sizes:
        suffix = mesh_name.lstrip("d").split("_", 1)[0]
        if suffix not in suffix_to_axis:
            raise ValueError(
                f"mesh axis {mesh_name!r} has no grid axis (grid axes: "
                f"{names})")
        groups.setdefault(suffix_to_axis[suffix], []).append(mesh_name)
    return Decomposition.of({
        ax: (ns[0] if len(ns) == 1 else tuple(ns))
        for ax, ns in groups.items()})


# the launch counter of each hand-written kernel, by name
_COUNTERS = {
    "K1 fused_diffusion_stage": fused_diffusion.fused_stage,
    "K1 fused_diffusion_stage_bf16": fused_diffusion.fused_stage_bf16,
    "K5 fused_burgers_stage": fused_burgers.fused_burgers_stage,
    "of them K5's y/x-sharded instance": fused_burgers.yx_instance,
    "K7 whole_run": whole_run.whole_run,
    "K7a whole_run_adaptive": whole_run.whole_run_adaptive,
    "K10 fused_step_diffusion": fused_diffusion_step.fused_step,
    "K2 slab_run_diffusion": fused_slab_run.slab_run_diffusion,
    "K6 slab_run_burgers": fused_slab_run.slab_run_burgers,
    "K2 slab_run_diffusion_bf16": fused_slab_run.slab_run_diffusion_bf16,
    "K6 slab_run_burgers_bf16": fused_slab_run.slab_run_burgers_bf16,
    "K2b slab_run_diffusion_batched":
        fused_slab_run.slab_run_diffusion_batched,
    "K2b slab_run_burgers_batched": fused_slab_run.slab_run_burgers_batched,
    "K3 slab_step_diffusion": fused_slab_run.slab_step_diffusion,
    "K3 slab_step_burgers": fused_slab_run.slab_step_burgers,
    "K4 slab_run_dma_diffusion": fused_slab_run.slab_run_dma_diffusion,
    "K4 slab_run_dma_burgers": fused_slab_run.slab_run_dma_burgers,
    "K3 slab_step_diffusion_bf16": fused_slab_run.slab_step_diffusion_bf16,
    "K3 slab_step_burgers_bf16": fused_slab_run.slab_step_burgers_bf16,
    "K4 slab_run_dma_diffusion_bf16":
        fused_slab_run.slab_run_dma_diffusion_bf16,
    "K4 slab_run_dma_burgers_bf16": fused_slab_run.slab_run_dma_burgers_bf16,
    "K11 laplacian_o4_3d": laplacian.laplacian_o4_3d,
    "K11b laplacian_o4_2d": laplacian.laplacian_o4_2d,
    "K12 weno_axis_3d": weno.flux_divergence_3d,
    "K12b weno_axis_2d": weno.flux_divergence_2d,
    "K9 fused_adr_stage": fused_adr.fused_adr_stage,
    "K9 fused_adr_stage_bf16": fused_adr.fused_adr_stage_bf16,
    "K8 fused2d_stage": fused2d_sharded.fused2d_stage,
    "K8b fused2d_band_stage": fused2d_sharded.fused2d_band_stage,
}


def _drive(verb: str, solver, args, check_error: bool = False) -> int:
    """Run ``solver`` as the flags ask, print the summary, save."""
    cfg, grid = solver.cfg, solver.grid
    state = solver.initial_state()
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        io.save_binary(state.u, os.path.join(args.save, "initial.bin"))
    mode = "iters" if args.t_end is None else "t_end"
    engaged = solver.engaged_path(mode)

    for counter in _COUNTERS.values():
        counter.launches = 0
    _sync(solver)
    t0 = time.perf_counter()
    if args.t_end is None:
        out = solver.run(state, args.iters if args.iters is not None else 100)
    else:
        out = solver.advance_to(state, args.t_end)
    _sync(solver)
    seconds = time.perf_counter() - t0
    iters = out.it - state.it

    stages = STAGES[cfg.integrator]
    device = solver.device
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    line = f"{engaged['stepper']} (impl={engaged['impl']})"
    print("=" * 60)
    print(f" {verb} (PyTorch port)")
    print("=" * 60)
    print(f" grid               : {'x'.join(map(str, grid.shape_xyz))} "
          f"({grid.num_cells:,} cells)")
    print(f" device             : {device} [{where}]")
    print(f" dtype              : {args.dtype}"
          + (f" (storage {engaged['storage_dtype']}, precision="
             f"{engaged['precision']})"
             if engaged["precision"] != "native"
             or engaged["storage_dtype"] != args.dtype else ""))
    print(f" kernel path        : {line}")
    if solver.mesh is not None:
        print(f" mesh               : {solver.mesh.shape} on "
              f"{', '.join(str(d) for d in solver.mesh.device_list())}; "
              f"overlap={engaged['overlap']}, steps/exchange="
              f"{engaged['steps_per_exchange']}, "
              f"exchange={engaged['exchange']}")
    if engaged["fallback"]:
        print(f" fused fallback     : {engaged['fallback']}")
    launched = [f"{name} x{c.launches}" for name, c in _COUNTERS.items()
                if c.launches]
    print(f" kernel launches    : {', '.join(launched) or 'none'}")
    print(f" iterations         : {iters} x {stages} RK stages")
    print(f" simulated time     : {float(out.t):.6f}")
    print(f" wall time          : {seconds:.4f} s")
    if iters:
        print(f" MLUPS ({device.type:4s})      : "
              f"{metrics.mlups(grid.num_cells, iters, stages, seconds):.1f}")
    if check_error:
        try:
            l1, l2, linf = solver.error_norms(out)
        except ValueError as exc:  # this config has no analytic solution
            print(f" error L1/L2/Linf   : none ({exc})")
        else:
            print(f" error L1/L2/Linf   : {l1:.4e} / {l2:.4e} / {linf:.4e}")
    if args.save:
        io.save_binary(out.u, os.path.join(args.save, "result.bin"))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return run_model(args)


if __name__ == "__main__":
    sys.exit(main())
