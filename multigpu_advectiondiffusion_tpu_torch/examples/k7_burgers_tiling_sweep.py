"""Time the 2-D Burgers whole run (K7, ``csrc/whole_run_burgers2d.cu``)
alone on the card for a set of tilings beside the one its planner picks.

At 400^2 (``MultiGPU/Burgers2d_Baseline``: lengths 2, CFL 0.4, fixed dt,
WENO5-JS, inviscid) and at 1478^2, the largest square
``whole_run.fits_l2`` admits (no tiling keeps every window resident
there), it times the planned tiling and the ``CHEAPEST`` other tilings
of ``fused_burgers2d.burgers2d_tilings`` by the planner's cost, each the
median of 5 CUDA-event samples of ``run(STEPS)`` after a warm-up, a
step, beside the plan's issued operations an output cell a stage
(``fused_burgers2d.ops_issued``) and its floor (the same grid with the
body off); ``--tilings`` adds tilings of its own where a shape allows
them (``12x22,16x16``: 12 x 22 and 16 x 16 tiles). The last line is a
JSON object of the times:

    PYTHONPATH=. python \\
        multigpu_advectiondiffusion_tpu_torch/examples/k7_burgers_tiling_sweep.py \\
        [--tilings 12x22,16x16]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as fb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers2d as fb2,
)

SHAPES = ((400, 400), (1478, 1478))
CHEAPEST = 12  # other tilings timed a shape
STEPS = 200
CFL = 0.4
LENGTH = 2.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def us_per_step(fn) -> float:
    """Median of 5 CUDA-event samples of ``fn`` after a warm-up, per
    step, in microseconds."""
    fn()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples) / STEPS * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tilings", default="",
                    help="more tilings to time, comma-separated MYxMX")
    args = ap.parse_args()
    extra = [tuple(int(n) for n in t.split("x"))
             for t in args.tilings.split(",") if t]
    if not torch.cuda.is_available():
        print("k7_burgers_tiling_sweep: no CUDA device is available")
        return 2
    card = card_line()
    result = {"card": card, "threads": fb2.THREADS, "shapes": {}}
    for shape in SHAPES:
        spacing = tuple(LENGTH / (n - 1) for n in shape)
        params = fb.stage_params(pflux.burgers(), "js", spacing, 0.0)
        limits = fb2.card_limits("cuda", params, False)
        dt = CFL * min(spacing)
        x = np.linspace(-1.0, 1.0, shape[1], dtype=np.float32)
        y = np.linspace(-1.0, 1.0, shape[0], dtype=np.float32)
        u0 = np.exp(-10.0 * (y[:, None] ** 2 + x[None, :] ** 2))
        S0 = torch.from_numpy(u0.astype(np.float32)).cuda()
        S, T1, T2 = S0.clone(), torch.empty_like(S0), torch.empty_like(S0)
        planned = fb2.burgers2d_schedule(*shape, **limits)
        others = sorted((p for p in fb2.burgers2d_tilings(*shape, **limits)
                         if p["tiles"] != planned["tiles"]),
                        key=lambda p: (p["cost"], p["jobs"]))[:CHEAPEST]
        for tiles in extra:
            try:
                others.append(fb2.burgers2d_schedule(*shape, **limits,
                                                     tiles=tiles))
            except ValueError as e:
                print(f"  {tiles}: not timed ({e})")
        print(f"{shape}: card numbers {limits} [{card}]")
        rows = []
        for plan in [planned, *others]:
            tiles = plan["tiles"]
            us = us_per_step(lambda: fb2.whole_run_burgers2d(
                S, T1, T2, STEPS, params=params, dt=dt, tiles=tiles))
            per_cell = fb2.ops_issued(*shape, plan, viscous=False,
                                      variant="js", adaptive=False) / (
                                          3 * shape[0] * shape[1])
            row = {"tiles": tiles, "jobs": plan["jobs"],
                   "resident": plan["resident"], "rounds": plan["rounds"],
                   "cost": plan["cost"], "ops_per_cell": per_cell,
                   "us_per_step": us}
            rows.append(row)
            print(f"  {'planned' if plan is planned else 'other  '} "
                  f"{tiles}: {us:.3f} us/step; jobs {plan['jobs']}, "
                  f"{'resident' if plan['resident'] else 'reloaded'}, "
                  f"rounds {plan['rounds']}, cost {plan['cost']:,}, "
                  f"{per_cell:.1f} issued operations an output cell a "
                  "stage")
        floor = us_per_step(lambda: fb2.whole_run_burgers2d(
            S, T1, T2, STEPS, params=params, dt=dt, sync_floor=True))
        print(f"  floor of the planned grid (body off): {floor:.3f} us/step "
              f"[{card}]")
        result["shapes"][f"{shape[0]}x{shape[1]}"] = {
            "planned": list(planned["tiles"]), "floor_us": floor,
            "tilings": rows}
        del S, T1, T2, S0
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
