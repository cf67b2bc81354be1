"""Time the unsharded paths of the kernels that carry a sharded
instance or share a stage with one on the card: K1, K5, K7/K7a and K9.

The paths are the reference's 3-D diffusion run, 400x200x206 for 101
steps on K1 (``impl="pallas_stage"``); 3-D Burgers with WENO5 on K5:
400x400x406 at fixed dt for 40 steps, and 512^3 adaptive for 86 steps;
the 2-D whole runs on K7: diffusion 1001^2 for 10,000 steps, Burgers
400^2 for 200 steps at fixed dt (K7) and adaptive (K7a); and ADR
508x204x160 for 404 steps on K9 (bench.py's ``adr3d`` row). For each
path it prints ms/step, the median of 3 CUDA-event samples of ``run``
after a warm-up, and the kernel's mean device time a launch from
``torch.profiler`` (for the stage kernels, stage 1 and stages 2-3). The
last line is a JSON object of these numbers.

The script calls only the solvers' public entry points, so one call on
the card can time two checkouts, each put first on the path (``--paths
K5`` times the K5 paths only):

    PYTHONPATH=<checkout> python \\
        multigpu_advectiondiffusion_tpu_torch/examples/stage_kernel_timing.py \\
        --label NAME [--paths K5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import torch

DIFFUSION_N = (400, 200, 206)  # MultiGPU/Diffusion3d_Baseline, Run.m
DIFFUSION_LENGTHS = (10.0, 5.0, 5.15)
DIFFUSION_ITERS = 101
BURGERS_N = (400, 400, 406)  # MultiGPU/Burgers3d_Baseline
BURGERS_LENGTHS = (2.0, 2.0, 4.0)
BURGERS_ITERS = 40
ADAPTIVE_N = 512  # SingleGPU/Burgers3d_WENO5, Run.m
ADAPTIVE_ITERS = 86
DIFF2D_N = 1001  # SingleGPU/Diffusion2d, Run.m
DIFF2D_ITERS = 10000
BURGERS2D_N = 400  # MultiGPU/Burgers2d_Baseline
BURGERS2D_ITERS = 200
ADR_N = (508, 204, 160)  # bench.py's adr3d row
ADR_LENGTHS = (12.7, 5.1, 4.0)
ADR_ITERS = 404


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def ms_per_step(solver, state0, iters: int) -> tuple[float, list]:
    """Median of 3 CUDA-event samples of ``run(iters)`` after a warm-up,
    per step, and the samples (ms a run)."""
    samples = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver.run(state0, iters)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    samples = samples[1:]
    return statistics.median(samples) / iters, samples


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
    times = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    if len(times) != launches:
        return {"launches_seen": len(times)}
    if launches != 3 * iters:
        return {"launches_seen": len(times),
                "mean_ms": statistics.mean(times)}
    return {"launches_seen": len(times),
            "stage1_ms": statistics.mean(times[0::3]),
            "stages23_ms": statistics.mean(times[1::3] + times[2::3]),
            "mean_ms": statistics.mean(times)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--paths", default="",
                    help="time only the paths whose name holds this text "
                         "(e.g. K5); all by default")
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
        Grid,
    )

    card = card_line()
    print(f"{args.label}: package {port.__file__} [{card}]")
    burgers2d = BurgersConfig(
        grid=Grid.make(BURGERS2D_N, BURGERS2D_N, lengths=2.0), cfl=0.4,
        dtype="float32", impl="pallas")
    # (name, steps, solver, kernel name, launches a run)
    paths = (
        ("K1 diffusion 400x200x206", DIFFUSION_ITERS, DiffusionSolver(
            DiffusionConfig(grid=Grid.make(*DIFFUSION_N,
                                           lengths=DIFFUSION_LENGTHS),
                            dtype="float32", impl="pallas_stage")),
         "stage_kernel", 3 * DIFFUSION_ITERS),
        ("K5 Burgers 400x400x406 fixed dt", BURGERS_ITERS, BurgersSolver(
            BurgersConfig(grid=Grid.make(*BURGERS_N,
                                         lengths=BURGERS_LENGTHS),
                          cfl=0.3, adaptive_dt=False, dtype="float32",
                          impl="pallas_stage")),
         "stage_kernel", 3 * BURGERS_ITERS),
        ("K5 Burgers 512^3 adaptive", ADAPTIVE_ITERS, BurgersSolver(
            BurgersConfig(grid=Grid.make(ADAPTIVE_N, ADAPTIVE_N,
                                         ADAPTIVE_N, lengths=2.0),
                          nu=1e-5, dtype="float32", impl="pallas_stage")),
         "stage_kernel", 3 * ADAPTIVE_ITERS),
        ("K7 diffusion 1001^2", DIFF2D_ITERS, DiffusionSolver(
            DiffusionConfig(grid=Grid.make(DIFF2D_N, DIFF2D_N, lengths=10.0),
                            dtype="float32", impl="pallas")),
         "whole_run_kernel", 1),
        ("K7 Burgers 400^2 fixed dt", BURGERS2D_ITERS, BurgersSolver(
            dataclasses.replace(burgers2d, adaptive_dt=False)),
         "whole_run_kernel", 1),
        ("K7a Burgers 400^2 adaptive", BURGERS2D_ITERS,
         BurgersSolver(burgers2d), "whole_run_kernel", 1),
        ("K9 ADR 508x204x160", ADR_ITERS, ADRSolver(
            ADRConfig(grid=Grid.make(*ADR_N, lengths=ADR_LENGTHS),
                      dtype="float32", impl="pallas", velocity=0.5,
                      kappa_variation=0.2, reaction_rate=0.25)),
         "adr_stage_kernel", 3 * ADR_ITERS),
    )
    result = {"label": args.label, "card": card, "paths": {}}
    for name, iters, solver, kernel, launches in paths:
        if args.paths not in name:
            continue
        state0 = solver.initial_state()
        ms, samples = ms_per_step(solver, state0, iters)
        launch = per_launch_ms(solver, state0, iters, kernel, launches)
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
