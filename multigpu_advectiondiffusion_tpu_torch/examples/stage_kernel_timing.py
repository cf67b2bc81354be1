"""Time the unsharded paths of the kernels that carry a sharded
instance or share a stage with one on the card: K1, K5, K7/K7a and K9,
and K9's sharded path; the paths of the diffusion slab body (K10, K2,
K2b, K3, K4); and K6's Burgers slab path.

The paths are the reference's 3-D diffusion run, 400x200x206 for 101
steps on K1 (``impl="pallas_stage"``); 3-D Burgers with WENO5 on K5:
400x400x406 at fixed dt for 40 steps, and 512^3 adaptive for 86 steps;
the 2-D whole runs on K7: diffusion 1001^2 for 10,000 steps, Burgers
400^2 for 200 steps at fixed dt (K7) and adaptive (K7a); ADR
508x204x160 for 404 steps on K9 (bench.py's ``adr3d`` row), and on a
``{"dz": 2}`` mesh of two shards on ``cuda:0`` (K9's sharded instance,
host-bound); and 3-D Burgers 400x400x406 at fixed dt for 267 steps on
K6 (``impl="pallas_slab"``, one launch a run). The
diffusion body's paths (``--paths K2``) are the 3-D diffusion run on K10
(``impl="pallas_step"``) and on K2 (``"pallas_slab"``); the diffusion
ensemble of 64 members of 256x128x64 for 60 steps on K2b (bench.py's
ensemble row); and the 3-D diffusion run on a ``{"dz": 2}`` mesh of two
shards on ``cuda:0``, on K3 (the collective exchange) and on K4
(``exchange="dma"``). The per-axis rung's paths (``--paths axis``:
K11/K12 inside the generic loop, ``impl="pallas_axis"``) are the 3-D
diffusion run, both 3-D Burgers runs, both 2-D Burgers runs (400^2,
fixed and adaptive dt) and the ADR run at their full depth, which
chip_smoke.py times over 20 steps (40 for ADR) since it outgrew its
time; K5's y/x-sharded instance (``--paths yx``) runs the
512^3 adaptive Burgers path on ``{"dy": 2}`` and on the block ``{"dz":
2, "dy": 2, "dx": 2}`` and the 400x400x406 fixed-dt one on ``{"dy":
2}`` and ``{"dz": 2, "dy": 2}``, every shard on ``cuda:0``. The 2-D
mesh paths (``--paths mesh2d``: K8 and K8b, every shard on ``cuda:0``)
are MultiGPU/Diffusion2d_Baseline and MultiGPU/Burgers2d_Baseline at
400^2 on ``{"dy": 2}``, serialized (K8) and split (K8b), Burgers at fixed
and adaptive dt, ``burgers2d_weno7`` (408x400) on ``{"dy": 2}`` both
ways, and both 400^2 families on the pencil ``{"dy": 2, "dx": 2}``, each
over ``run(200)``; their kernel time a launch is the mean over every K8
or K8b launch of the run (the split schedule's count differs between
checkouts). For each
path it prints ms/step, the median of 3
CUDA-event samples of ``run`` after a warm-up (``--reps``), and, where the profiler
sees every launch (not the cooperative ones), the kernel's mean device
time a launch from ``torch.profiler`` (for the stage kernels, stage 1
and stages 2-3); for the 2-D Burgers paths also the floor, ms a step of
the same whole-run grid with the body off (its grid-wide barriers only);
for every profiled path the device kernels and copies a step, by name.
The last line is a JSON object of these numbers.

The script calls only the solvers' public entry points, so one call on
the card can time two checkouts, each put first on the path (``--paths
K5`` times the paths whose group or name holds K5 only, ``--paths
K6,K9`` those of K6 and K9):

    PYTHONPATH=<checkout> python \\
        multigpu_advectiondiffusion_tpu_torch/examples/stage_kernel_timing.py \\
        --label NAME [--paths K5] [--reps 9]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import statistics
import subprocess

import torch

DIFFUSION_N = (400, 200, 206)  # MultiGPU/Diffusion3d_Baseline, Run.m
DIFFUSION_LENGTHS = (10.0, 5.0, 5.15)
DIFFUSION_ITERS = 101
BURGERS_N = (400, 400, 406)  # MultiGPU/Burgers3d_Baseline
BURGERS_LENGTHS = (2.0, 2.0, 4.0)
BURGERS_ITERS = 40
K6_ITERS = 267  # MultiGPU/Burgers3d_Baseline
ADAPTIVE_N = 512  # SingleGPU/Burgers3d_WENO5, Run.m
ADAPTIVE_ITERS = 86
DIFF2D_N = 1001  # SingleGPU/Diffusion2d, Run.m
DIFF2D_ITERS = 10000
BURGERS2D_N = 400  # MultiGPU/Burgers2d_Baseline
BURGERS2D_ITERS = 200
ADR_N = (508, 204, 160)  # bench.py's adr3d row
ADR_LENGTHS = (12.7, 5.1, 4.0)
ADR_ITERS = 404
ENS_N = (256, 128, 64)  # bench.py's diffusion ensemble row
ENS_LENGTHS = (6.4, 3.2, 1.6)
ENS_MEMBERS = 64
ENS_ITERS = 60
W7_2D_N = (400, 408)  # bench/matrix.py's burgers2d_weno7 (physical nx, ny)
MESH2D_ITERS = 200


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def ms_per_step(solver, state0, iters: int,
                reps: int = 3) -> tuple[float, list]:
    """Median of ``reps`` CUDA-event samples of ``run(iters)`` after a
    warm-up, per step, and the samples (ms a run)."""
    samples = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver.run(state0, iters)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    samples = samples[1:]
    return statistics.median(samples) / iters, samples


def kernel_name(name: str) -> str:
    """A device event's name without its return type, anonymous
    namespaces and parameter list, cut to 90 characters."""
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void |\(.*$", "", name)[:90]


def per_launch_ms(solver, state0, iters: int, kernel: str,
                  launches: int) -> dict:
    """Mean device time (ms) of the kernel named ``kernel`` a launch in
    one profiled ``run`` of ``launches`` launches; for a stage kernel
    (three a step) also stage 1 and stages 2-3."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.run(state0, iters)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    times = [(e.time_range.end - e.time_range.start) / 1e3
             for e in dev if kernel in e.name]
    # every device kernel and copy a step, by name: a pad, a sum or a
    # negation between the kernels shows here
    work = collections.Counter(kernel_name(e.name)
                               for e in dev)
    seen = {"launches_seen": len(times),
            "device_work_per_step": sum(work.values()) / iters,
            "device_work_by_name": {k: v / iters
                                    for k, v in work.most_common()}}
    if launches is None:  # any count: the mean over every launch
        return {**seen, "mean_ms": statistics.mean(times)}
    if len(times) != launches:
        return seen
    if launches != 3 * iters:
        return {**seen, "mean_ms": statistics.mean(times)}
    return {**seen,
            "stage1_ms": statistics.mean(times[0::3]),
            "stages23_ms": statistics.mean(times[1::3] + times[2::3]),
            "mean_ms": statistics.mean(times)}


def burgers2d_floor_ms(solver, state0, iters: int, reps: int) -> float:
    """ms a step of K7 Burgers' grid with the body off, at fixed dt: the
    median of ``reps`` CUDA-event samples after a warm-up."""
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        fused_burgers as fb,
    )
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        fused_burgers2d as fb2,
    )

    cfg = solver.cfg
    spacing = cfg.grid.spacing
    params = fb.stage_params(solver.flux, cfg.weno_variant, spacing, cfg.nu)
    S = state0.u.clone()
    T1, T2 = torch.empty_like(S), torch.empty_like(S)
    samples = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fb2.whole_run_burgers2d(S, T1, T2, iters, params=params,
                                dt=cfg.cfl * min(spacing), sync_floor=True)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples[1:]) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--paths", default="",
                    help="time only the paths whose group or name holds "
                         "this text, or one of these comma-separated ones "
                         "(K2: the diffusion body's paths; K5; K6,K9; "
                         "axis: the per-axis rung; yx: K5 on y/x-cut "
                         "meshes); all by default")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs a path (the median is printed)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage_kernel_timing: no CUDA device is available")
        return 2
    import multigpu_advectiondiffusion_tpu_torch as port
    from multigpu_advectiondiffusion_tpu_torch import (
        ADRConfig,
        ADRSolver,
        BurgersConfig,
        BurgersSolver,
        DiffusionConfig,
        DiffusionSolver,
        EnsembleSolver,
        Grid,
    )
    from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
        Decomposition,
        make_mesh,
    )

    card = card_line()
    print(f"{args.label}: package {port.__file__} [{card}]")
    burgers2d = BurgersConfig(
        grid=Grid.make(BURGERS2D_N, BURGERS2D_N, lengths=2.0), cfl=0.4,
        dtype="float32", impl="pallas")
    diffusion = DiffusionConfig(
        grid=Grid.make(*DIFFUSION_N, lengths=DIFFUSION_LENGTHS),
        dtype="float32", impl="pallas_stage")

    def two_shards():
        return make_mesh({"dz": 2}, devices=[torch.device("cuda:0")] * 2)

    def yx_mesh(sizes, mapping):
        n = 1
        for k in sizes.values():
            n *= k
        return {"mesh": make_mesh(sizes, devices=[torch.device("cuda:0")] * n),
                "decomp": Decomposition.of(mapping)}

    baseline = BurgersConfig(
        grid=Grid.make(*BURGERS_N, lengths=BURGERS_LENGTHS), cfl=0.3,
        adaptive_dt=False, dtype="float32", impl="pallas")
    adaptive = BurgersConfig(
        grid=Grid.make(ADAPTIVE_N, ADAPTIVE_N, ADAPTIVE_N, lengths=2.0),
        nu=1e-5, dtype="float32", impl="pallas")
    adr = ADRConfig(grid=Grid.make(*ADR_N, lengths=ADR_LENGTHS),
                    dtype="float32", impl="pallas_axis", velocity=0.5,
                    kappa_variation=0.2, reaction_rate=0.25)
    dy2 = ({"dy": 2}, {1: "dy"})
    dzdy = ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"})
    block = ({"dz": 2, "dy": 2, "dx": 2}, {0: "dz", 1: "dy", 2: "dx"})

    def ensemble():
        cfg = DiffusionConfig(grid=Grid.make(*ENS_N, lengths=ENS_LENGTHS),
                              diffusivity=1.0, ic="gaussian",
                              impl="pallas_slab")
        return EnsembleSolver(DiffusionSolver, cfg, [
            {"ic_params": (("width", 0.1 + 0.002 * i),)}
            for i in range(ENS_MEMBERS)])

    # (name, group, steps, solver factory, kernel name, launches a run;
    # None where the profiler misses the cooperative launch)
    paths = (
        ("K1 diffusion 400x200x206", "K1", DIFFUSION_ITERS,
         lambda: DiffusionSolver(diffusion), "stage_kernel",
         3 * DIFFUSION_ITERS),
        ("K5 Burgers 400x400x406 fixed dt", "K5", BURGERS_ITERS,
         lambda: BurgersSolver(BurgersConfig(
             grid=Grid.make(*BURGERS_N, lengths=BURGERS_LENGTHS), cfl=0.3,
             adaptive_dt=False, dtype="float32", impl="pallas_stage")),
         "stage_kernel", 3 * BURGERS_ITERS),
        ("K5 Burgers 512^3 adaptive", "K5", ADAPTIVE_ITERS,
         lambda: BurgersSolver(BurgersConfig(
             grid=Grid.make(ADAPTIVE_N, ADAPTIVE_N, ADAPTIVE_N, lengths=2.0),
             nu=1e-5, dtype="float32", impl="pallas_stage")),
         "stage_kernel", 3 * ADAPTIVE_ITERS),
        ("K7 diffusion 1001^2", "K7", DIFF2D_ITERS,
         lambda: DiffusionSolver(DiffusionConfig(
             grid=Grid.make(DIFF2D_N, DIFF2D_N, lengths=10.0),
             dtype="float32", impl="pallas")),
         "whole_run_kernel", 1),
        ("K7 Burgers 400^2 fixed dt", "K7", BURGERS2D_ITERS,
         lambda: BurgersSolver(dataclasses.replace(burgers2d,
                                                   adaptive_dt=False)),
         "whole_run_kernel", 1),
        ("K7a Burgers 400^2 adaptive", "K7", BURGERS2D_ITERS,
         lambda: BurgersSolver(burgers2d), "whole_run_kernel", 1),
        ("K9 ADR 508x204x160", "K9", ADR_ITERS,
         lambda: ADRSolver(ADRConfig(
             grid=Grid.make(*ADR_N, lengths=ADR_LENGTHS), dtype="float32",
             impl="pallas", velocity=0.5, kappa_variation=0.2,
             reaction_rate=0.25)),
         "adr_stage_kernel", 3 * ADR_ITERS),
        ("K9 ADR 508x204x160 on {dz: 2}", "K9", ADR_ITERS,
         lambda: ADRSolver(ADRConfig(
             grid=Grid.make(*ADR_N, lengths=ADR_LENGTHS), dtype="float32",
             impl="pallas", velocity=0.5, kappa_variation=0.2,
             reaction_rate=0.25), mesh=two_shards()),
         "adr_stage_kernel", 6 * ADR_ITERS),
        ("K6 Burgers 400x400x406 fixed dt", "K6", K6_ITERS,
         lambda: BurgersSolver(BurgersConfig(
             grid=Grid.make(*BURGERS_N, lengths=BURGERS_LENGTHS), cfl=0.3,
             adaptive_dt=False, dtype="float32", impl="pallas_slab")),
         None, None),
        ("K10 diffusion 400x200x206", "K2", DIFFUSION_ITERS,
         lambda: DiffusionSolver(dataclasses.replace(
             diffusion, impl="pallas_step")),
         "step_kernel", DIFFUSION_ITERS),
        ("K2 diffusion 400x200x206", "K2", DIFFUSION_ITERS,
         lambda: DiffusionSolver(dataclasses.replace(
             diffusion, impl="pallas_slab")), None, None),
        (f"K2b diffusion ensemble B={ENS_MEMBERS} 256x128x64", "K2",
         ENS_ITERS, ensemble, None, None),
        ("K3 diffusion 400x200x206 on {dz: 2}", "K2", DIFFUSION_ITERS,
         lambda: DiffusionSolver(dataclasses.replace(
             diffusion, impl="pallas_slab"), mesh=two_shards()),
         "step_kernel", 2 * DIFFUSION_ITERS),
        ("K4 diffusion 400x200x206 on {dz: 2}, dma", "K2", DIFFUSION_ITERS,
         lambda: DiffusionSolver(dataclasses.replace(
             diffusion, impl="pallas_slab", exchange="dma"),
             mesh=two_shards()), None, None),
        ("per-axis diffusion 400x200x206", "axis", DIFFUSION_ITERS,
         lambda: DiffusionSolver(dataclasses.replace(
             diffusion, impl="pallas_axis")),
         "laplacian3d_kernel", 3 * DIFFUSION_ITERS),
        ("per-axis Burgers 512^3 adaptive", "axis", ADAPTIVE_ITERS,
         lambda: BurgersSolver(dataclasses.replace(
             adaptive, impl="pallas_axis")),
         "weno_axis_kernel", 9 * ADAPTIVE_ITERS),
        ("per-axis Burgers 400x400x406 fixed dt", "axis", K6_ITERS,
         lambda: BurgersSolver(dataclasses.replace(
             baseline, impl="pallas_axis")),
         "weno_axis_kernel", 9 * K6_ITERS),
        ("per-axis Burgers 400^2 fixed dt", "axis", BURGERS2D_ITERS,
         lambda: BurgersSolver(dataclasses.replace(
             burgers2d, adaptive_dt=False, impl="pallas_axis")),
         "weno_axis_kernel", 6 * BURGERS2D_ITERS),
        ("per-axis Burgers 400^2 adaptive", "axis", BURGERS2D_ITERS,
         lambda: BurgersSolver(dataclasses.replace(
             burgers2d, impl="pallas_axis")),
         "weno_axis_kernel", 6 * BURGERS2D_ITERS),
        ("per-axis ADR 508x204x160", "axis", ADR_ITERS,
         lambda: ADRSolver(adr), "laplacian3d_kernel", 3 * ADR_ITERS),
        ("y/x-sharded Burgers 512^3 adaptive on {dy: 2}", "yx",
         ADAPTIVE_ITERS, lambda: BurgersSolver(adaptive, **yx_mesh(*dy2)),
         "stage_kernel", 6 * ADAPTIVE_ITERS),
        ("y/x-sharded Burgers 512^3 adaptive on {dz: 2, dy: 2, dx: 2}",
         "yx", ADAPTIVE_ITERS,
         lambda: BurgersSolver(adaptive, **yx_mesh(*block)),
         "stage_kernel", 24 * ADAPTIVE_ITERS),
        ("y/x-sharded Burgers 400x400x406 fixed dt on {dy: 2}", "yx",
         K6_ITERS, lambda: BurgersSolver(baseline, **yx_mesh(*dy2)),
         "stage_kernel", 6 * K6_ITERS),
        ("y/x-sharded Burgers 400x400x406 fixed dt on {dz: 2, dy: 2}",
         "yx", K6_ITERS, lambda: BurgersSolver(baseline, **yx_mesh(*dzdy)),
         "stage_kernel", 12 * K6_ITERS),
    )
    dy2_2d = ({"dy": 2}, {0: "dy"})
    pencil = ({"dy": 2, "dx": 2}, {0: "dy", 1: "dx"})
    diffusion2d = DiffusionConfig(
        grid=Grid.make(BURGERS2D_N, BURGERS2D_N, lengths=2.0),
        diffusivity=1.0, dtype="float32", impl="pallas")
    weno7 = BurgersConfig(grid=Grid.make(*W7_2D_N, lengths=2.0),
                          weno_order=7, adaptive_dt=False, dtype="float32",
                          impl="pallas")
    fixed2d = dataclasses.replace(burgers2d, adaptive_dt=False)
    split = {"overlap": "split"}
    # (name, config, layout): every K8/K8b kernel of the run is timed
    mesh2d = (
        ("K8 diffusion 400^2 on {dy: 2}", diffusion2d, dy2_2d),
        ("K8b diffusion 400^2 on {dy: 2}, split",
         dataclasses.replace(diffusion2d, **split), dy2_2d),
        ("K8 Burgers 400^2 fixed dt on {dy: 2}", fixed2d, dy2_2d),
        ("K8b Burgers 400^2 fixed dt on {dy: 2}, split",
         dataclasses.replace(fixed2d, **split), dy2_2d),
        ("K8 Burgers 400^2 adaptive on {dy: 2}", burgers2d, dy2_2d),
        ("K8 Burgers WENO7 408x400 fixed dt on {dy: 2}", weno7, dy2_2d),
        ("K8b Burgers WENO7 408x400 fixed dt on {dy: 2}, split",
         dataclasses.replace(weno7, **split), dy2_2d),
        ("K8 diffusion 400^2 on {dy: 2, dx: 2}", diffusion2d, pencil),
        ("K8 Burgers 400^2 fixed dt on {dy: 2, dx: 2}", fixed2d, pencil),
    )
    paths = paths + tuple(
        (name, "mesh2d", MESH2D_ITERS,
         (lambda cfg=cfg, lay=lay: (
             DiffusionSolver if isinstance(cfg, DiffusionConfig)
             else BurgersSolver)(cfg, **yx_mesh(*lay))),
         "diffusion_" if isinstance(cfg, DiffusionConfig) else "burgers_",
         None)
        for name, cfg, lay in mesh2d)
    result = {"label": args.label, "card": card, "paths": {}}
    for name, group, iters, make, kernel, launches in paths:
        wanted = [w for w in args.paths.split(",") if w]
        if wanted and not any(w == group or w in name for w in wanted):
            continue
        solver = make()
        state0 = solver.initial_state()
        ms, samples = ms_per_step(solver, state0, iters, args.reps)
        launch = ({} if kernel is None else
                  per_launch_ms(solver, state0, iters, kernel, launches))
        if group == "K7" and "Burgers" in name:
            launch["floor_ms_per_step"] = burgers2d_floor_ms(
                solver, state0, iters, args.reps)
        result["paths"][name] = {"iters": iters, "ms_per_step": ms,
                                 "samples_ms": samples, **launch}
        print(f"{args.label}: {name} run({iters}): {ms:.4f} ms/step "
              f"({[round(s, 3) for s in samples]} ms); a launch {launch} "
              f"[{card}]")
        del solver, state0
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
