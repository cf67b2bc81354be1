"""Time the unsharded per-stage paths on the card: K1 and K5.

The paths are the reference's 3-D diffusion run, 400x200x206 for 101
steps on K1 (``impl="pallas_stage"``), and 3-D Burgers with WENO5 on K5:
400x400x406 at fixed dt for 40 steps, and 512^3 adaptive for 86 steps.
For each path it prints ms/step, the median of 3 CUDA-event samples of
``run`` after a warm-up, and each kernel's mean device time a launch,
for stage 1 and for stages 2-3, from ``torch.profiler``. The last line
is a JSON object of these numbers.

The script calls only the solvers' public entry points, so one call on
the card can time two checkouts, each put first on the path:

    PYTHONPATH=<checkout> python \\
        multigpu_advectiondiffusion_tpu_torch/examples/stage_kernel_timing.py \\
        --label NAME
"""

from __future__ import annotations

import argparse
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


def per_launch_ms(solver, state0, iters: int) -> dict:
    """Mean device time (ms) of the stage kernel a launch in one profiled
    ``run``: stage 1 and stages 2-3 (launches in order, three a step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.run(state0, iters)
        torch.cuda.synchronize()
    times = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "stage_kernel" in e.name]
    if len(times) != 3 * iters:
        return {"launches_seen": len(times)}
    return {"launches_seen": len(times),
            "stage1_ms": statistics.mean(times[0::3]),
            "stages23_ms": statistics.mean(times[1::3] + times[2::3]),
            "mean_ms": statistics.mean(times)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage_kernel_timing: no CUDA device is available")
        return 2
    import multigpu_advectiondiffusion_tpu_torch as port
    from multigpu_advectiondiffusion_tpu_torch import (
        BurgersConfig,
        BurgersSolver,
        DiffusionConfig,
        DiffusionSolver,
        Grid,
    )

    card = card_line()
    print(f"{args.label}: package {port.__file__} [{card}]")
    paths = (
        ("K1 diffusion 400x200x206", DIFFUSION_ITERS, DiffusionSolver(
            DiffusionConfig(grid=Grid.make(*DIFFUSION_N,
                                           lengths=DIFFUSION_LENGTHS),
                            dtype="float32", impl="pallas_stage"))),
        ("K5 Burgers 400x400x406 fixed dt", BURGERS_ITERS, BurgersSolver(
            BurgersConfig(grid=Grid.make(*BURGERS_N,
                                         lengths=BURGERS_LENGTHS),
                          cfl=0.3, adaptive_dt=False, dtype="float32",
                          impl="pallas_stage"))),
        ("K5 Burgers 512^3 adaptive", ADAPTIVE_ITERS, BurgersSolver(
            BurgersConfig(grid=Grid.make(ADAPTIVE_N, ADAPTIVE_N,
                                         ADAPTIVE_N, lengths=2.0),
                          nu=1e-5, dtype="float32", impl="pallas_stage"))),
    )
    result = {"label": args.label, "card": card, "paths": {}}
    for name, iters, solver in paths:
        state0 = solver.initial_state()
        ms, samples = ms_per_step(solver, state0, iters)
        launch = per_launch_ms(solver, state0, iters)
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
