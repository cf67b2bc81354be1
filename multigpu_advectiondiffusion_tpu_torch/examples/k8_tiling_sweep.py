"""Time K8 and K8b, the 2-D sharded stage kernels, alone on the card:
the mean device time a launch (``torch.profiler``) of stage 2 (with
``u``) over a whole shard (K8), over the split schedule's interior band
and over its two edge bands (K8b; one launch where the checkout has the
paired edge role, else the bottom and top launches summed), beside the
bound of the same work; K8's third stage emitting its maximum (Burgers),
the memset that zeroes it counted where the checkout issues one; and the
host time a launch.

Shards: 200x400 (400^2 on ``{"dy": 2}``, MultiGPU/Diffusion2d_Baseline
and Burgers2d_Baseline), 204x400 at WENO order 7 (bench/matrix.py's
``burgers2d_weno7`` 408x400 grid) and 2048x4096 (4096^2 on ``{"dy":
2}``, past K7's L2 gate), for diffusion, Burgers WENO5-JS and WENO7-JS
(inviscid, the Burgers flux). Where the checkout has a tile planner
(``fused2d_sharded.plan_tiles``, which every launch plan asks), each
shape is also timed with the planner forced to the CELL and TILED bodies
(Burgers; diffusion has the CELL body only), to one-float window loads
and to other tiles and thread counts (``SWEEP``).

The host time a launch is the ``time.perf_counter`` time of 1,000
launches without synchronisation, through the stepper's lean entry
(``fused2d_sharded.launch`` on a ``StagePlan``) where the checkout has
one, and through ``fused2d_stage``.

The script calls only ``fused2d_sharded``'s public entries, so one call
on the card can time two checkouts, each put first on the path:

    PYTHONPATH=<checkout> python \\
        multigpu_advectiondiffusion_tpu_torch/examples/k8_tiling_sweep.py \\
        --label NAME [--quick]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12
REPS = 20  # launches profiled a case
HOST_LAUNCHES = 1000
# f32 operations a cell of one stage with u (csrc/fused2d_sharded.cu's
# note): diffusion 24; Burgers each face once, inviscid, split 6, 103 an
# axis (WENO7 219), the sum and negation 2, the combine 5
OPS = {"diffusion": 24, "burgers": 6 + 2 * 103 + 2 + 5,
       "burgers7": 6 + 2 * 219 + 2 + 5}


# the TILED tilings timed beside the planned one: ((rows, columns) of the
# largest tile, threads), by shard (2048x4096 or not) and family; among
# them the tilings a residency cost model chose (17x37 and 20x31 of 512
# threads on the small shards, 32x50 of 256 and 26x32 of 128 on the large)
SWEEP = {
    (False, "burgers"): (((20, 31), 512), ((13, 31), 256)),
    (False, "burgers7"): (((17, 37), 512), ((20, 31), 512),
                          ((13, 31), 256)),
    (True, "burgers"): (((32, 50), 256), ((32, 32), 256), ((32, 64), 256)),
    (True, "burgers7"): (((26, 32), 128), ((32, 32), 128), ((32, 32), 256)),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, per_call: int = 1, reps: int = REPS,
              memsets: bool = False) -> float:
    """Mean device time (ms) of the ``per_call`` K8/K8b kernels a call of
    ``fn`` (summed), over ``reps`` profiled calls after a warm-up; the
    capture is taken again, up to four times, while the profiler drops
    some of the kernels (it does now and then on the card's machine),
    and the last one's mean a kernel counts otherwise. With ``memsets``
    the device memsets of the calls are added."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [(e.time_range.end - e.time_range.start) / 1e3
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and ("burgers_" in e.name or "diffusion_" in e.name)]
        if len(times) == reps * per_call:
            break
    if not times:
        raise RuntimeError("the profiler saw no K8 kernel")
    extra = 0.0
    if memsets:
        extra = sum((e.time_range.end - e.time_range.start) / 1e3
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name.startswith("Memset")) / reps
    return statistics.mean(times) * per_call + extra


def bound_ms(cells: int, in_cells: int, ops: int) -> tuple[float, str]:
    by_bytes = 4 * (in_cells + cells) / HBM_BYTES_PER_S
    by_ops = ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--quick", action="store_true",
                    help="the planned tiles only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_tiling_sweep: no CUDA device is available")
        return 2
    import multigpu_advectiondiffusion_tpu_torch as port
    from multigpu_advectiondiffusion_tpu_torch import Grid
    from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        fused2d_sharded as fsh,
    )
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        fused_burgers as fb,
    )
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        fused_diffusion as fd,
    )

    card = card_line()
    print(f"{args.label}: package {port.__file__} [{card}]")
    planner = hasattr(fsh, "plan_tiles")
    dev = torch.device("cuda")
    cases = []  # (family, shard (ly, lx), global shape, params)
    for n, shard in ((400, (200, 400)), (4096, (2048, 4096))):
        grid = Grid.make(n, n, lengths=2.0)
        cases.append(("diffusion", shard, grid.shape, fsh.DiffusionParams(
            fd.stage_taps(grid.spacing, (1.0, 1.0)), 2, 0.0)))
        cases.append(("burgers", shard, grid.shape, fb.stage_params(
            pflux.get("burgers"), "js", grid.spacing, 0.0)))
    for n, shard in (((400, 408), (204, 400)), ((4096, 4096), (2048, 4096))):
        grid = Grid.make(*n, lengths=2.0)
        cases.append(("burgers7", shard, grid.shape, fb.stage_params(
            pflux.get("burgers"), "js", grid.spacing, 0.0, order=7)))

    result = {"label": args.label, "card": card, "cases": []}
    for family, (ly, lx), gshape, params in cases:
        h = fsh.halo_of(params)
        padded = (ly + 2 * h, lx + 2 * h)
        g = torch.Generator(device=dev).manual_seed(ly)
        v, u, out = (torch.rand(padded, generator=g, device=dev)
                     for _ in range(3))
        lo, hi = (torch.rand((h, padded[1]), generator=g, device=dev)
                  for _ in range(2))
        dt = (np.float32(1e-4) if family == "diffusion"
              else torch.full((), 1e-3, device=dev))
        kw = dict(params=params, a=0.75, b=0.25, global_shape=gshape)
        offs = (0, 0)
        options = {"planned": None}
        if planner and not args.quick:
            options["cell"] = {"body": fsh.CELL}
            if family != "diffusion":  # diffusion has the CELL body only
                options["tiled"] = {"body": fsh.TILED}
                options["tiled, one-float loads"] = {"body": fsh.TILED,
                                                     "vec": 1}
            for tile, threads in SWEEP.get((ly >= 1024, family), ()):
                options[f"tiled {tile[0]}x{tile[1]} {threads}"] = {
                    "body": fsh.TILED, "tile": tile, "threads": threads}
        mid, bottom, top = fsh.split_bands(ly, h)
        planned_tiles = getattr(fsh, "plan_tiles", None)
        for name, ov in options.items():
            if ov is not None:  # every plan of this option is forced
                fsh.plan_tiles = (lambda *a, ov=ov, **k:
                                  planned_tiles(*a, **{**k, **ov}))

            def whole():
                fsh.fused2d_stage(v, u, out, dt, offs, **kw)

            def interior():
                fsh.fused2d_band_stage(v, u, out, dt, offs, rows=mid[0],
                                       **kw)

            if planner:
                def edges():
                    fsh.fused2d_band_stage(v, u, out, dt, offs,
                                           rows=fsh.edge_bands(ly, h),
                                           lo=lo, hi=hi, **kw)
            else:
                def edges():
                    fsh.fused2d_band_stage(v, u, out, dt, offs,
                                           rows=bottom[0], lo=lo, **kw)
                    fsh.fused2d_band_stage(v, u, out, dt, offs,
                                           rows=top[0], hi=hi, **kw)

            for launch, rows in (("K8", ly), ("K8b interior", ly - 2 * h),
                                 ("K8b edges", 2 * h)):
                fn = {"K8": whole, "K8b interior": interior,
                      "K8b edges": edges}[launch]
                ms = device_ms(fn, 2 if launch == "K8b edges"
                               and not planner else 1)
                cells = rows * lx
                in_cells = ((rows + 2 * h * (2 if launch == "K8b edges"
                                             else 1)) * padded[1] + cells)
                bound, by = bound_ms(cells, in_cells, OPS[family] * cells)
                plan = None
                if planner:
                    bands = ([rows] if launch != "K8b edges" else [h, h])
                    plan = fsh.plan_tiles(
                        bands, lx, h, **fsh.card(0),
                        burgers=family != "diffusion",
                        order=7 if family == "burgers7" else 5)
                    plan = {k: plan[k] for k in ("body", "tile", "my", "mx",
                                                 "threads", "vec", "tiles")}
                row = {"family": family, "shard": [ly, lx], "launch": launch,
                       "option": name, "ms": ms, "bound_ms": bound,
                       "bound_by": by, "plan": plan}
                result["cases"].append(row)
                print(f"{args.label}: {family} {ly}x{lx} {launch} [{name}]: "
                      f"{ms * 1e3:.2f} us a launch, bound {bound * 1e3:.2f} "
                      f"us ({by}); plan {plan} [{card}]")
            if ov is not None:
                fsh.plan_tiles = planned_tiles
        if family != "diffusion":
            # K8's third stage emitting max|f'|: the fold in the launch,
            # or the parent's memset and atomicMax
            mx = torch.zeros((), device=dev)
            ms = device_ms(lambda: fsh.fused2d_stage(
                v, u, out, dt, offs, mx=mx, params=params, a=1 / 3,
                b=2 / 3, global_shape=gshape), memsets=True)
            result["cases"].append({"family": family, "shard": [ly, lx],
                                    "launch": "K8 emitting", "ms": ms})
            print(f"{args.label}: {family} {ly}x{lx} K8 emitting its "
                  f"maximum: {ms * 1e3:.2f} us a launch, memsets counted "
                  f"[{card}]")
        del v, u, out, lo, hi
        torch.cuda.empty_cache()

    # the host time a launch, 200x400 Burgers stage 2
    family, (ly, lx), gshape, params = cases[1]
    h = params.r
    padded = (ly + 2 * h, lx + 2 * h)
    v, u, out = (torch.rand(padded, device=dev) for _ in range(3))
    dt = torch.full((), 1e-3, device=dev)
    kw = dict(params=params, a=0.75, b=0.25, global_shape=gshape)
    host = {}
    calls = {"fused2d_stage": lambda: fsh.fused2d_stage(v, u, out, dt,
                                                        (0, 0), **kw)}
    if planner:
        plan = fsh.StagePlan(fsh.fused2d_stage, params, 0.75, 0.25, padded,
                             (0, 0), gshape, (((0, ly), None),), dev,
                             buffers=(v.data_ptr(), u.data_ptr(),
                                      out.data_ptr()))
        calls["lean launch"] = lambda: fsh.launch(plan, v, u, out, dt)
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(HOST_LAUNCHES):
                fn()
            samples.append((time.perf_counter() - t0) / HOST_LAUNCHES * 1e6)
            torch.cuda.synchronize()
        host[name] = statistics.median(samples)
        print(f"{args.label}: host time a launch, {name}: "
              f"{host[name]:.2f} us (median of {[round(s, 2) for s in samples]}"
              f") [{card}]")
    result["host_us"] = host
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
