"""Time every launch form of the diffusion slab body (K10, K2, K2b, K3,
K4; ``csrc/fused_step_diffusion.cu``) alone on the card for each z chunk
the planner could pick, beside the chunk it picks.

The forms run at their main paths' shapes: K10 a step and K2 a
``run(101)`` at 400x200x206 (``MultiGPU/Diffusion3d_Baseline``) and at
128^3; K2b a ``run(60)`` of 64 members of 256x128x64 (bench.py's
ensemble row); K3 one shard's per-step window and K4 a ``run(101)`` of
both shards of 400x200x206 on a ``{"dz": 2}`` mesh. The chunks are the
sizes of the splits of each window into n = 1..16 near-equal chunks,
the candidates of ``fused_diffusion_step.diffusion_schedule``. Each time
is the median of 5 CUDA-event samples after a warm-up (K10 and K3: of
21 launches in turn on three buffer sets, more than the L2 holds). The
last line is a JSON object of the times:

    PYTHONPATH=. python \\
        multigpu_advectiondiffusion_tpu_torch/examples/diffusion_zchunk_sweep.py
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion_step as fds,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as fsr,
)

REF_SHAPE = (206, 200, 400)  # interior (nz, ny, nx), Run.m
CUBE_SHAPE = (128, 128, 128)
ENS_SHAPE = (64, 128, 256)  # bench.py's diffusion ensemble row
ENS_MEMBERS = 64
ENS_ITERS = 60
ITERS = 101
SHARDS = 2
SPACING = (0.025, 0.025, 0.025)
DT = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def splits(window: int) -> list[int]:
    """The chunk sizes of the splits of ``window`` planes into n = 1..16
    near-equal chunks."""
    return sorted({-(-window // n) for n in range(1, min(16, window) + 1)})


def median_ms(fn, batch: int = 1) -> float:
    """Median of 5 CUDA-event samples of ``batch`` calls, after a
    warm-up, a call."""
    fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def padded(shape, seed: int, lead=()):
    """A random padded state on the card, its ghost ring at 0."""
    rng = np.random.default_rng(seed)
    S = torch.from_numpy(rng.uniform(-0.1, 1.0, lead + tuple(
        n + 2 * fd.R for n in shape)).astype(np.float32)).cuda()
    S[..., :fd.R, :] = S[..., -fd.R:, :] = 0.0
    S[..., :fd.R] = S[..., -fd.R:] = 0.0
    return S


def sweep(window: int, timed) -> dict:
    """``timed(z)`` for each chunk of :func:`splits`."""
    return {z: timed(z) for z in splits(window)}


def main() -> int:
    if not torch.cuda.is_available():
        print("diffusion_zchunk_sweep: no CUDA device is available")
        return 2
    card = card_line()
    kw = dict(taps=fd.stage_taps(SPACING, (1.0, 1.0, 1.0)), band=2,
              bc_value=0.0)
    result = {"card": card, "forms": {}}

    def report(name, window, shape, units, unit, times):
        planned = fds.diffusion_zchunk(window, *shape[1:], units, "cuda")
        best = min(times, key=times.get)
        result["forms"][name] = {"ms": times, "planned": planned,
                                 "fastest": best, "unit": unit}
        print(f"{name}: {unit} by zchunk "
              f"{ {z: round(t, 4) for z, t in times.items()} }; planned "
              f"{planned} ({times.get(planned, float('nan')):.4f}), "
              f"fastest {best} ({times[best]:.4f}) [{card}]", flush=True)

    for shape in (REF_SHAPE, CUBE_SHAPE):
        sets = [(padded(shape, 10 + i), padded(shape, 20 + i))
                for i in range(3)]
        turn = itertools.cycle(sets)

        def k10(z):
            def launch():
                S, out = next(turn)
                fds.fused_step(S, out, DT, zchunk=z, **kw)
            return median_ms(launch, 21)

        report(f"K10 {shape}", shape[0], shape, 1, "ms a step",
               sweep(shape[0], k10))
        S, out = sets[0]
        report(f"K2 {shape} run({ITERS})", shape[0], shape, 1, "ms a run",
               sweep(shape[0], lambda z: median_ms(
                   lambda: fsr.slab_run_diffusion(S, out, ITERS, DT,
                                                  zchunk=z, **kw))))
        del sets, turn, S, out
        torch.cuda.empty_cache()

    shape = ENS_SHAPE
    S0, S1 = (padded(shape, s, (ENS_MEMBERS,)) for s in (30, 31))
    report(f"K2b B={ENS_MEMBERS} {shape} run({ENS_ITERS})", shape[0],
           shape, ENS_MEMBERS, "ms a run", sweep(
               shape[0], lambda z: median_ms(
                   lambda: fsr.slab_run_diffusion_batched(
                       S0, S1, ENS_ITERS, DT, zchunk=z, **kw))))
    del S0, S1
    torch.cuda.empty_cache()

    shape = REF_SHAPE
    lz = shape[0] // SHARDS
    G = fsr.SlabRunDiffusionStepper.halo
    sets = [padded((lz + 2 * G - 2 * fd.R,) + shape[1:], 40 + i)
            for i in range(3)]
    out = torch.empty_like(sets[0])
    turn = itertools.cycle(sets)

    def k3(z):
        return median_ms(lambda: fsr.slab_step_diffusion(
            next(turn), out, DT, global_nz=shape[0], oz=0, depth=G,
            window=(0, lz), zchunk=z, **kw), 21)

    report(f"K3 one shard's window {(lz,) + shape[1:]}", lz, shape, 1,
           "ms a launch", sweep(lz, k3))
    del sets, out, turn
    S0s = [padded((lz + 2 * G - 2 * fd.R,) + shape[1:], 50 + i)
           for i in range(SHARDS)]
    S1s = [torch.zeros_like(S) for S in S0s]
    lands = [torch.zeros((2, 2, G) + S0s[0].shape[1:], device="cuda")
             for _ in range(SHARDS)]
    report(f"K4 {SHARDS} shards of {(lz,) + shape[1:]} run({ITERS})", lz,
           shape, SHARDS, "ms a run", sweep(lz, lambda z: median_ms(
               lambda: fsr.slab_run_dma_diffusion(
                   S0s, S1s, lands, ITERS, DT, zchunk=z, **kw))))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
