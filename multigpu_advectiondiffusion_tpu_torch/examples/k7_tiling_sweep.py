"""Time the 2-D diffusion whole run (K7, ``csrc/whole_run_diffusion2d.cu``)
alone on the card for a set of tilings beside the one its planner picks,
and fit the planner's cost of a job that reloads its window to them.

At 1001^2 (``SingleGPU/Diffusion2d``) and at 1474^2, the largest square
``whole_run.fits_l2`` admits (no tiling keeps every window resident
there), it times the planned tiling and the cheapest tiling of each
other class of ``fused_diffusion2d.diffusion2d_tilings`` (rounds of jobs,
blocks sharing an SM, rounds of a block's threads the patches of a step
take, residency), at most ``CLASSES`` a shape. Each time is the median
of 5 CUDA-event samples of ``run(STEPS)`` after a warm-up, a step. It
then fits, by least squares over every timed tiling,

    us a step = a * rounds * shared * P + b * rounds * shared * reload + c

(P the rounds of a block's threads a step's patches take, reload 1 for a
job that reloads its window each step) and prints b / a, the
``RELOAD_ROUNDS`` the measurement supports, beside the planner's. The
last line is a JSON object of the times and the fit:

    PYTHONPATH=. python \\
        multigpu_advectiondiffusion_tpu_torch/examples/k7_tiling_sweep.py
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion2d as fd2,
)

SHAPES = ((1001, 1001), (1474, 1474))
CLASSES = 6  # tilings timed a shape, the planned one included
STEPS = 1000
SPACING = (0.01, 0.01)
DT = 2e-5  # inside the explicit limit dx^2 / 8 at this spacing


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def key(plan: dict) -> tuple:
    """The planner's order: cost, then patches, then jobs."""
    return (plan["cost"], plan["rounds"] * sum(plan["patches"]),
            plan["jobs"])


def terms(plan: dict, sms: int) -> tuple:
    """The plan's two terms of the fit: rounds x shared x P and rounds x
    shared x reload."""
    shared = -(-plan["blocks"] // sms)
    p = sum(-(-n // fd2.THREADS) for n in plan["patches"])
    return (plan["rounds"] * shared * p,
            plan["rounds"] * shared * (0 if plan["resident"] else 1))


def chosen(shape, card: dict) -> list:
    """The planned tiling first, then the cheapest of each other class."""
    planned = fd2.diffusion2d_schedule(*shape, **card)
    picks, seen = [planned], {terms(planned, card["sms"])}
    for plan in sorted(fd2.diffusion2d_tilings(*shape, **card), key=key):
        cls = terms(plan, card["sms"])
        if cls not in seen and len(picks) < CLASSES:
            seen.add(cls)
            picks.append(plan)
    return picks


def us_per_step(S0, tiles, taps) -> float:
    S, T1, T2 = S0.clone(), S0.clone(), S0.clone()
    samples = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fd2.whole_run_diffusion2d(S, T1, T2, STEPS, DT, taps=taps, band=2,
                                  bc_value=0.0, tiles=tiles)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples[1:]) / STEPS * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_tiling_sweep: no CUDA device is available")
        return 2
    card_name = card_line()
    card = fd2.card_limits("cuda")
    taps = fd.stage_taps(SPACING, (1.0, 1.0))
    print(f"K7 tiling sweep [{card_name}]; the card's numbers: {card}")
    rows = []
    for shape in SHAPES:
        rng = np.random.default_rng(7)
        S0 = torch.zeros(tuple(n + 4 for n in shape), device="cuda")
        S0[2:-2, 2:-2] = torch.from_numpy(
            rng.random(shape, dtype=np.float32)).cuda()
        for i, plan in enumerate(chosen(shape, card)):
            us = us_per_step(S0, plan["tiles"], taps)
            x1, x2 = terms(plan, card["sms"])
            rows.append({"shape": shape, "tiles": plan["tiles"],
                         "planned": i == 0, "jobs": plan["jobs"],
                         "rounds": plan["rounds"],
                         "resident": plan["resident"], "cost": plan["cost"],
                         "p_term": x1, "reload_term": x2,
                         "us_per_step": us})
            print(f"  {shape[0]}x{shape[1]} tiles {plan['tiles']}"
                  f"{' (planned)' if i == 0 else ''}: {plan['jobs']} jobs, "
                  f"{plan['rounds']} round(s), "
                  f"{'resident' if plan['resident'] else 'reloaded'}, cost "
                  f"{plan['cost']}: {us:.3f} us/step [{card_name}]")
        del S0
    a = np.array([[r["p_term"], r["reload_term"], 1.0] for r in rows])
    t = np.array([r["us_per_step"] for r in rows])
    (ca, cb, cc), *_ = np.linalg.lstsq(a, t, rcond=None)
    rms = float(np.sqrt(np.mean((a @ np.array([ca, cb, cc]) - t) ** 2)))
    print(f"  fit: us/step = {ca:.4f} x rounds.shared.P + {cb:.4f} x "
          f"rounds.shared.reload + {cc:.4f} (rms {rms:.4f} us); reload "
          f"costs {cb / ca:.2f} rounds of a block's threads (planner: "
          f"RELOAD_ROUNDS = {fd2.RELOAD_ROUNDS}) [{card_name}]")
    print(json.dumps({"card": card_name, "limits": card, "rows": rows,
                      "fit": {"a": ca, "b": cb, "c": cc, "rms": rms,
                              "reload_rounds": cb / ca}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
