#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root. It builds every CUDA kernel of the port's
main path from ``multigpu_advectiondiffusion_tpu_torch/csrc`` (into the
ignored ``build/`` directory), then:

0. prints the card's name and power limit and its measured
   device-to-device copy rate;
1. holds the fused RK-stage kernel (K1) against its plain PyTorch twin
   for every stage kind, at the main path's shape and at an odd small
   one: ``max|kernel - twin| / max|twin| <= 32 eps_f32``; times the
   kernel alone at the main path's shape for each z-chunk length of
   ``ZCHUNKS``, cycling through buffers larger than L2;
2. drives the main path — the reference grid 400x200x206, float32,
   ``impl="pallas"``, 101 steps through ``DiffusionSolver.run`` — and
   checks the engaged stepper, the kernel's launch count (3 a step),
   agreement with the generic path (``rtol=1e-5, atol=1e-6 max|u|``)
   and finite error norms against the exact solution; times it with
   CUDA events (median of 3 after a warm-up) and profiles one run for
   K1's time per launch in the run and the device's idle share;
3. drives ``advance_to`` to ``t0 + 4.5 dt``: 5 steps, landing on
   ``t_end``, agreeing with the generic path;
4. times ``conv3d`` computing the 13-point Laplacian alone, a yardstick
   that computes less than K1 and that the port never calls;
5. holds the fused Burgers/WENO5 stage kernel (K5) against its plain
   twin for every stage kind: at 512^3 for the main configuration
   (WENO5-JS, Burgers flux, nu = 1e-5, the last stage emitting
   max|f'|) and at an odd small shape for WENO5-Z, the inviscid case
   and the linear and Buckley-Leverett fluxes; ``<= 32 eps`` of
   max|twin| (the ulp count printed), the emitted maximum exactly; times
   K5 alone at 512^3 for each stage kind and z-chunk of ``K5_ZCHUNKS``,
   and prints its tiling (checked against ``fused_burgers.tile_geometry``)
   and the f32 operations it issues a cell (``fused_burgers.ops_issued``)
   with their rate against 67 and 33.5 T/s;
6. drives the Burgers main path — 512^3, lengths 2, float32, adaptive
   dt, nu = 1e-5, ``impl="pallas"``, 86 steps through
   ``BurgersSolver.run`` (``SingleGPU/Burgers3d_WENO5/Run.m``) — and
   checks the engaged stepper, 258 K5 launches, at most one
   device-to-host copy in a profiled run (dt stays on the card), values
   inside [-1e-6, 1.05] and agreement with the generic path at 10 steps
   (``rtol=2e-5, atol=2e-6 max|u|``); times it (median of 3 after a
   warm-up, CUDA events), profiles K5 per stage kind in the run, the
   idle share and the host enqueue, and reads the peak memory of the
   fused and the generic runs;
7. a fixed-dt ``run(5)`` and ``advance_to(t0 + 4.5 dt0)`` (5 steps, 15
   launches, landing on ``t_end``) against the generic path;
8. holds the whole-run diffusion kernel (K7, one cooperative launch per
   run) against its plain twin over 1 and 5 steps at 1001^2 and at an
   odd small shape (``<= 32 eps`` of max|twin|, the ulp count printed);
   times it alone for the main path's 10,000 steps, and the sync floor
   (the same grid with the stage body off, its 3 barriers a step);
9. drives the 2-D diffusion main path — 1001^2, lengths 10, float32,
   ``impl="pallas"``, ``run(10000)`` (``SingleGPU/Diffusion2d/Run.m``) —
   and checks the engaged stepper, one K7 launch, agreement with the
   generic path at 100 steps and error norms of the generic path's size
   at 10,000; times it (median of 3 after a warm-up) and profiles it for
   the idle share; times ``conv2d`` computing the 2-D Laplacian alone;
10. holds the whole-run Burgers kernel (K7 at fixed dt, K7a adaptive)
   against its twin at 400^2 (the main configuration) and at the odd
   shape (WENO5-Z, viscous, linear and Buckley-Leverett fluxes; the
   adaptive time advance exactly); drives both Burgers 2-D paths —
   400^2, lengths 2, WENO5-JS, inviscid, CFL 0.4, ``run(200)``
   (``MultiGPU/Burgers2d_Baseline``) at fixed and at adaptive dt — with
   one launch each, at most one device-to-host copy in a profiled
   adaptive run, u inside [-1e-6, 1.05] and agreement with the generic
   path; times the kernels alone, the sync floor and both paths;
11. ``advance_to`` on 2-D grids runs the generic loop on the per-axis
   kernels (K11b, K12b) and says why;
12. holds the whole-step diffusion kernel (K10, one launch a step) and
   the whole-run slab kernel (K2, one cooperative launch a run) against
   their twin (three K1-twin stages a step) to the bit, over 1 and 5
   steps at 400x200x206 and at an odd shape, K2 against K10, and both
   paths against the K1 path after ``run(101)``; times K10 and K2 alone
   for each z-chunk of ``STEP_ZCHUNKS`` and the planned ones
   (``fused_diffusion_step.diffusion_zchunk``, K10's and the cooperative
   K2's), and the twin; prints each
   launch's plan (chunk, jobs, waves) and the f32 operations it issues
   (``fused_diffusion_step.ops_issued``) with their rate against 33.5
   T/s;
13. drives ``impl="pallas_step"`` and ``"pallas_slab"`` on the diffusion
   reference run (400x200x206, 101 steps): 101 K10 launches, one K2
   launch, agreement with the generic path and error norms as in phase
   2; ms/step and MLUPS beside the 8 B a cell bound and the K1 path's
   time in the same call;
14. holds the Burgers slab kernel (K6, one cooperative launch a
   fixed-dt run) against its twin (three K5-twin stages a step) to the
   bit at 400x400x406 and at the odd shape (WENO5-Z, viscous, linear
   and Buckley-Leverett fluxes); times it alone for each z-chunk of
   ``K6_ZCHUNKS`` and the planned one (``fused_slab_run.burgers_zchunk``),
   with the grid's blocks, the jobs and waves a step and the operation
   rate against 67 and 33.5 T/s; drives ``MultiGPU/Burgers3d_Baseline``
   on one card
   (400x400x406, lengths 2 2 4, CFL 0.3, fixed dt, ``run(267)``,
   ``impl="pallas_slab"``): one launch, u inside [-1e-6, 1.05],
   agreement with the generic path at 10 steps, the K5 path on the
   same config, the operations bound;
15. times the per-stage and the slab paths on the slab gates' grids
   (the paths in turn, ``GATE_ROUNDS`` rounds, with their spread) and
   prints which was faster beyond the spread and which the gate picks
   (reported, not held);
16. holds the per-axis Laplacian kernels (K11 in 3-D, K11b in 2-D)
   against their plain twin at 400x200x206, 512^3, 1001^2 and the odd
   shapes (``<= 32 eps`` of max|twin|, the ulp count printed); times
   each alone at the paths' shapes beside its bytes bound, the twin and
   ``conv3d``/``conv2d`` computing the same Laplacian;
17. holds the per-axis WENO kernels (K12, K12b) against their twin:
   every sweep axis at 512^3 and 400x400x406 (WENO5-JS), 400^2, and at
   the odd shapes WENO5-Z, WENO7-JS (its difference-form betas to 0 ulp)
   and the linear and Buckley-Leverett fluxes; times each axis alone
   beside its bound and the twin;
18. drives the six per-axis paths (``impl="pallas_axis"``): diffusion
   3-D ``run(101)`` (303 K11 launches), Burgers 512^3 adaptive
   ``run(86)`` (774 K12, 258 K11), ``MultiGPU/Burgers3d_Baseline``
   ``run(267)`` (2,403 K12), diffusion 1001^2 ``run(10000)`` (30,000
   K11b; timed over ``run(1000)``) and Burgers 400^2 ``run(200)`` at
   fixed and adaptive dt (1,200 K12b each); each against ``impl="xla"``
   at the bounds of phases 2 and 6, diffusion's error norms, Burgers' u
   inside [-1e-6, 1.05]; ms/step beside the fused path's, MLUPS, the
   idle share and device-to-host copies of a profiled run;
19. Burgers 3-D ``impl="pallas_step"`` engages K5, and diffusion with
   periodic walls under ``impl="pallas"`` the per-axis rung (K11);
20. holds the fused ADR stage kernel (K9) against its plain twin to the
   bit, every stage kind, at 508x204x160 and at the odd shape, with eps 0
   and 0.2, lambda 0 and 0.25, mixed-sign velocities and a non-zero wall
   value; times K9 alone at 508x204x160 for each z-chunk of ``ZCHUNKS``
   beside its bytes bound, the twin and ``conv3d`` computing the
   constant-coefficient right-hand side;
21. drives the ADR 3-D main path, ``bench.py``'s ``adr3d`` row built
   through ``registry.get("adr").bench_build`` — 508x204x160, lengths
   12.7 5.1 4, velocity 0.5, ``kappa_variation`` 0.2, ``reaction_rate``
   0.25, float32, ``impl="pallas"``, ``run(404)`` — with 1,212 K9
   launches; agreement with ``impl="xla"`` (phase 2's bounds after 10
   steps, reported after 404), the max-principle and positivity rules,
   the eps = 0 variant against ``exact_solution`` (no worse than 1.05x
   the generic path's error), ``advance_to`` landing on ``t_end``,
   ms/step, MLUPS and the idle share; then the same config on the
   per-axis rung (1,212 K11 launches, against ``impl="xla"``);
22. bench.py's ``adr2d`` configuration (1001^2, lengths 20) under
   ``impl="pallas"``, ``run(200)``: the per-axis rung with the JAX
   package's reason, 600 K11b launches, against ``impl="xla"``;
23. holds K2b, the B-folded slab kernel (K2 and K6 with a member axis),
   against its plain twin to the bit: diffusion at 24x16x16 and Burgers
   at 24x8x8, B = 4, 2 and 3 steps;
24. holds every member of K2b against the single K2 (K6) run of that
   member, to the bit, at the ensemble main sizes (bench.py's ensemble
   rows): diffusion 256x128x64, B = 64, 60 steps; Burgers 128x64x64,
   B = 8, 30 steps; times K2b's run beside its bound, the twin of the
   same run, MLUPS*members and the peak memory, and prints the diffusion
   launch's plan (chunk, jobs, waves) and issued-operation rate;
25. drives the diffusion ensemble (256x128x64, the width sweep 0.1 +
   0.002 i, 60 steps, B = 8 and 64) through ``EnsembleSolver.run`` on
   the three rungs — ``impl="pallas_slab"`` (one K2b launch a run),
   ``"pallas"`` (K1 per member, 3 B launches a step) and ``"xla"`` (the
   generic loop per member) — each member equal to its looped single
   run to the bit; MLUPS*members of the batched and the looped runs and
   the idle share of the per-member rung;
26. the Burgers ensemble (128x64x64, fixed dt, nu 1e-5, 30 steps, B = 8)
   under ``"pallas_slab"`` (K2b) and ``"pallas"`` (K5 per member), the
   same checks;
27. member-varying operands on the card: a K sweep 0.5:2 at B = 8 on the
   diffusion grid (``run`` within phase 2's bounds of the looped generic
   runs; ``advance_to`` with per-member ``t_end``, per-member step counts
   equal to the looped runs'), an ADR ``diffusivity``/``reaction_rate``
   sweep at B = 4 on the ADR grid, 20 steps, and a member seeded with a
   NaN named by ``EnsembleMemberDivergedError``;
28. holds K3, the windowed slab step of a shard of a z-slab mesh,
   against its twin to the bit at the main shards' shapes (400x200x103
   for diffusion, 400x400x203 for Burgers): the per-step window, the
   split schedule's bottom ("lo") and top ("hi") calls on exchanged
   operands, and the k = 4 deep windows, on the first and the last shard;
   times K3 alone beside its bound and the twin, and prints each K3's
   jobs and waves a step and its operation rate (diffusion: the chunk
   planned and the operations issued);
29. drives ``MultiGPU/Diffusion3d_Baseline`` on a ``{"dz": 2}`` mesh with
   both shards on ``cuda:0`` (400x200x206, ``run(101)``): K1 serialized
   (606 launches), K1 split (1,818), K3 (202) and K3 with
   ``steps_per_exchange=4`` (202), each 0 ulp from the unsharded run of
   its rung (K1, K1, K2, K2), ``t`` equal, the ``engaged_path()`` labels;
   ms/step (median of 3 after a warm-up, CUDA events) beside the
   unsharded run's, the halo refresh alone and the idle share;
30. ``MultiGPU/Burgers3d_Baseline`` on ``{"dz": 2}`` (400x400x406, fixed
   dt, ``run(267)``) on K5 (1,602 launches) and K3 (534), 0 ulp from the
   unsharded K5 and K6 runs; ms/step timed over ``run(20)``;
31. adaptive Burgers 512^3 on ``{"dz": 2}``, ``run(86)`` on K5: ``u`` and
   ``t`` equal to the unsharded run's, at most one device-to-host copy
   (dt from the shards' maxima on the card);
32. the generic and per-axis rungs on ``{"dz": 2}`` at 10 steps
   (diffusion 400x200x206, Burgers 400x400x406), 0 ulp from unsharded,
   the per-axis launches summed over the shards (not timed);
33. holds K8, the sharded 2-D stage, and K8b, its split-schedule bands,
   against their twin to the bit (Burgers' emitted maximum exactly):
   diffusion, WENO5-JS inviscid and WENO5-Z viscous; every stage kind
   and every band; the main shard's shape (200x400, a shard of 400^2 on
   ``dy = 2``) and an odd one (23x37); the first, a middle and the last
   shard of ``dy = 4`` and a pencil's corner shard; times K8 and each
   K8b band alone at the main shard's shape beside its bound and twin,
   and ``conv2d`` computing the main shard's 2-D Laplacian;
34. drives ``MultiGPU/Diffusion2d_Baseline`` on ``{"dy": 2}`` (400^2,
   lengths 2, K = 1, ``run(1000)``, both shards on ``cuda:0``): K8
   serialized (6,000 launches) and K8b split (18,000), each 0 ulp from
   K7's unsharded ``run(1000)``, ``t`` equal, error norms against the
   exact heat kernel; ms/step over ``run(200)`` beside K7's, MLUPS, one
   exchange of both shards alone, the idle share of a profiled
   ``run(100)`` and the ``engaged_path()`` labels;
35. drives ``MultiGPU/Burgers2d_Baseline`` on ``{"dy": 2}`` (400^2,
   lengths 2, WENO5-JS, inviscid, CFL 0.4): fixed dt ``run(200)`` on K8
   (1,200 launches) and K8b split (3,600), 0 ulp from K7's unsharded
   ``run(200)``; adaptive ``run(200)`` 0 ulp and ``t`` equal to K7a's,
   at most one device-to-host copy; the example's ``advance_to(0.4)``
   and ``advance_to(0.2)`` against the generic rung on the same mesh:
   the same steps and landing ``t``, ``u`` within the JAX suite's bound
   (``rtol 2e-5, atol 2e-6 max|u|``) at 0.2, before the shock, and its
   gap at 0.4, past it, reported;
36. ``{"dy": 2, "dx": 2}``, four shards on the card: both families at
   400^2, ``run(100)`` on K8 (12 launches a step), 0 ulp from K7's
   unsharded run;
37. ADR on meshes: bench.py's ``adr3d`` row on ``{"dz": 2}``,
   ``run(404)`` on K9's sharded instance (2,424 launches), 0 ulp and
   ``t`` equal to the unsharded K9 run, ms/step over ``run(100)``; and
   ``adr2d`` on ``{"dy": 2}`` (at 1000^2, its spacing: 1001 rows do not
   split into two equal shards), the generic and per-axis rungs at 10
   steps, 0 ulp from unsharded;
38. holds K4, the sharded slab run of every shard of the card in one
   cooperative launch with the ghost rows moved inside the kernel,
   against its twin to the bit (every state and landing buffer) at the
   main shards' shapes: diffusion 400x200x103 on two shards at k = 1 (3
   steps) and k = 4 (5 steps: a partial block), 400x200x52 on four
   shards, Burgers 400x400x203 WENO5-JS and WENO5-Z at k = 1 and JS at
   k = 2 (3 steps); times K4 alone at k = 1 beside its twin, and prints
   each K4's grid blocks, jobs and waves a step and operation rate
   (diffusion: the chunk planned and the operations issued);
39. drives ``MultiGPU/Diffusion3d_Baseline`` on ``{"dz": 2}`` with
   ``exchange="dma"`` at k = 1 and k = 4, ``run(101)``: the labels, one K4
   launch and no other (no K3), no collective halo byte and the in-kernel
   exchange's bytes as counted, 0 ulp and ``t`` equal to the collective
   K3 run and the unsharded K2 run; ms/step of the three (median of 3
   after a warm-up, CUDA events);
40. ``MultiGPU/Burgers3d_Baseline`` on ``{"dz": 2}`` with
   ``exchange="dma"``, fixed dt, ``run(267)``: the same checks against
   the collective K3 run and the unsharded K6 run, u inside [-1e-6,
   1.05]; ms/step over ``run(20)``;
41. the CLI: ``diffusion3d --mesh dz=2 --device cuda:0 --impl
   pallas_slab --exchange dma`` at the reference's size, its summary
   naming the in-kernel exchange and one K4 launch.

It prints a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failed check raises; without a
GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch import (
    ADRSolver,
    BurgersConfig,
    BurgersSolver,
    DiffusionConfig,
    DiffusionSolver,
    EnsembleMemberDivergedError,
    EnsembleSolver,
    EnsembleState,
    Grid,
)
from multigpu_advectiondiffusion_tpu_torch.diagnostics import physics
from multigpu_advectiondiffusion_tpu_torch.models import registry
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.timestepping import cfl as pcfl
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused2d_sharded as fsh,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import fused_adr as fa
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as fb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers2d as fb2,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion2d as fd2,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion_step as fds,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as fsr,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    laplacian as klap,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import weno as kweno
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

EPS32 = float(np.finfo(np.float32).eps)
KERNEL_TOL = 32 * EPS32  # relative to max|twin|, the JAX suite's fused bound
# NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# with -fmad=false every product and sum issues alone: one f32 operation
# a lane a cycle, 16,896 lanes at 1.98 GHz, half the rate above
F32_NOFMA_OPS_PER_S = F32_OPS_PER_S / 2

REF_N = (400, 200, 206)  # physical nx, ny, nz (Run.m)
REF_LENGTHS = (10.0, 5.0, 5.15)
ITERS = 101  # Run.m's iteration count
ODD_SHAPE = (23, 29, 37)  # interior (nz, ny, nx) of an odd small grid
ZCHUNKS = (4, 8, 16, 32)  # z planes a K1 thread marches, timed alone
ROTATE = 3  # buffer sets K1 alone cycles through: 3 x 207 MB >> L2

BURGERS_N = 512  # SingleGPU/Burgers3d_WENO5/Run.m:15-25: 512^3, 86 steps
BURGERS_ITERS = 86
BURGERS_NU = 1e-5
BURGERS_CHECK_ITERS = 10  # steps held against the generic path
K5_ZCHUNKS = (32, 64, 128)  # z planes a K5 block marches, timed alone
K5_ODD_CASES = (  # (flux, flux kwargs, variant, nu) at ODD_SHAPE
    ("burgers", {}, "z", 0.0),
    ("linear", {"c": -0.7}, "js", 1e-5),
    ("buckley", {}, "z", 1e-5),
)

DIFF2D_N = 1001  # SingleGPU/Diffusion2d/Run.m:3-12: 1001^2, 10000 steps
DIFF2D_ITERS = 10000
DIFF2D_CHECK_ITERS = 100  # steps held against the generic path
BURGERS2D_N = 400  # MultiGPU/Burgers2d_Baseline: 400^2, 200 steps
BURGERS2D_ITERS = 200
# steps held against the generic path: a shock forms at t ~ 0.37, and
# past it the generic q-form and the fused e-form differ by up to 4e-3
# at the shock (400^2, fixed dt, 200 steps, on the CPU); t = 0.2 is
# before it. The kernels are held to their twins over all 200 steps.
BURGERS2D_CHECK_ITERS = 100
ODD_2D = (23, 37)  # (ny, nx) of an odd small 2-D grid
K7_ODD_CASES = (  # (flux, flux kwargs, variant, nu) at ODD_2D
    ("burgers", {}, "z", 0.0),
    ("burgers", {}, "js", 1e-5),
    ("linear", {"c": -0.7}, "js", 1e-5),
    ("buckley", {}, "z", 1e-5),
)
STEP_ZCHUNKS = (8, 16, 26, 30, 52, 64, 206)  # z planes a K10/K2 job marches
# MultiGPU/Burgers3d_Baseline (BASELINE.md:35, examples/
# multigpu_burgers3d.sh) on one card: 400x400x406, lengths 2 2 4, CFL 0.3,
# fixed dt, inviscid WENO5-JS; 267 steps in place of --t-end 0.4, since
# the slab stepper has no run_to
K6_N = (400, 400, 406)
K6_LENGTHS = (2.0, 2.0, 4.0)
K6_CFL = 0.3
K6_ITERS = 267
K6_CHECK_ITERS = 10  # steps held against the generic path, before the shock
K6_ZCHUNKS = (58, 68, 102, 136, 203, 406)  # z planes a K6 job, timed
# phase 15: physical (nx, ny, nz) of the grids each gate is measured on,
# from JAX's ladder grid to the main configurations
SWEEP_DIFFUSION = ((24, 16, 16), (32, 32, 32), (64, 64, 64),
                   (128, 128, 128), REF_N)
SWEEP_BURGERS = ((24, 16, 16), (64, 64, 64), (160, 160, 162), K6_N,
                 (512, 512, 512))
SWEEP_BURGERS_ITERS = 20
GATE_ROUNDS = 5  # the Burgers gate's K5 and K6 timings, taken in turn
# every launch counter, reset before each main path and read after it
COUNTERS = {"K1": fd.fused_stage, "K5": fb.fused_burgers_stage,
            "K7": wr.whole_run, "K7a": wr.whole_run_adaptive,
            "K10": fds.fused_step, "K2": fsr.slab_run_diffusion,
            "K6": fsr.slab_run_burgers, "K11": klap.laplacian_o4_3d,
            "K11b": klap.laplacian_o4_2d, "K12": kweno.flux_divergence_3d,
            "K12b": kweno.flux_divergence_2d, "K9": fa.fused_adr_stage,
            "K2b": fsr.slab_run_diffusion_batched,
            "K2b-burgers": fsr.slab_run_burgers_batched,
            "K3": fsr.slab_step_diffusion,
            "K3-burgers": fsr.slab_step_burgers,
            "K8": fsh.fused2d_stage, "K8b": fsh.fused2d_band_stage,
            "K4": fsr.slab_run_dma_diffusion,
            "K4-burgers": fsr.slab_run_dma_burgers}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int, batch: int = 1) -> list[float]:
    """Per-call times of ``fn`` (ms) from CUDA events: ``reps`` samples,
    each one event pair around ``batch`` back-to-back calls."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return times


def device_profile(fn) -> tuple[float, float, dict]:
    """Run ``fn`` under ``torch.profiler``: the device span from the first
    kernel's start to the last one's end (ms), the device busy time in it
    (ms), and the mean device time (ms) of each kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return 0.0, 0.0, {}  # the caller's check names what is missing
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    per_name: dict = {}
    for e in events:
        per_name.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    busy = sum(sum(v) for v in per_name.values())
    means = {k: statistics.mean(v) for k, v in per_name.items()}
    return (end - start) / 1e3, busy, means


def retake(capture, complete, tries: int = 2):
    """``capture()``, taken again (at most ``tries`` captures in all) while
    ``complete`` says it missed device events: torch.profiler on the card
    has dropped some from a capture (two of a run's 258 K5 launches once,
    and the read-back). The launch counters hold the runs themselves; the
    caller's checks then hold the last capture."""
    result = capture()
    for _ in range(tries - 1):
        if complete(result):
            break
        print("  the profiler's capture missed device events; once more")
        result = capture()
    return result


def reset_counts() -> None:
    for counter in COUNTERS.values():
        counter.launches = 0


def counts() -> dict:
    return {name: c.launches for name, c in COUNTERS.items()}


def l2_copy_rate_gbs() -> float:
    """Copy rate (read + write bytes) of a 12 MiB buffer into another,
    both resident in the 50 MB L2: a CUDA graph of 50 copies, so no
    launch gap counts."""
    x = torch.rand(3 << 20, device="cuda")
    y = torch.empty_like(x)
    y.copy_(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(50):
            y.copy_(x)
    graph.replay()
    ms = statistics.median(cuda_ms(graph.replay, 5))
    return 2 * x.numel() * 4 * 50 / (ms * 1e-3) / 1e9


def copy_rate_gbs() -> float:
    """Device-to-device copy rate of a 1 GiB clone (read + write bytes)."""
    x = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    x.fill_(1.0)
    x.clone()
    ms = statistics.median(cuda_ms(lambda: x.clone(), 5))
    return 2 * x.numel() * 4 / (ms * 1e-3) / 1e9


# --------------------------------------------------------------------- #
# K1 against its twin
# --------------------------------------------------------------------- #
def stage_bytes(shape, has_u: bool) -> int:
    """Bytes one stage must move: v's interior read once, u's interior
    read once (stages 2-3), the interior written once — 8 or 12 B/cell.
    With band 2 no computed cell reaches the ghost ring, so it needs no
    read."""
    return 4 * math.prod(shape) * (3 if has_u else 2)


def stage_ops(shape, has_u: bool) -> int:
    """f32 operations a stage does: 15 products and 14 sums of taps,
    dt*acc, v+., b*., and a*u plus its sum when there is a u."""
    return math.prod(shape) * (32 + (2 if has_u else 0))


def stage_inputs(shape, seed: int):
    """Padded v, u and a wall-valued out buffer on the card, from numpy."""
    rng = np.random.default_rng(seed)
    padded = tuple(n + 2 * fd.R for n in shape)
    v = torch.from_numpy(rng.random(padded, dtype=np.float32)).cuda()
    u = torch.from_numpy(rng.random(padded, dtype=np.float32)).cuda()
    out = torch.zeros(padded, dtype=torch.float32, device="cuda")
    return v, u, out


def isolated_ms(buffers, zchunk: int, **kw) -> float:
    """Per-launch time of K1 alone: median of 5 samples of 21 back-to-back
    launches, each on the next of ``buffers`` (v, u, out) sets in turn.
    The sets together are far larger than the 50 MB L2, so a launch
    finds little of its inputs there (in the main path, only stage 1
    finds part of its input, just written by stage 3)."""
    turn = itertools.cycle(buffers)

    def launch():
        v, u, out = next(turn)
        fd.fused_stage(v, u, out, zchunk=zchunk, **kw)

    launch()  # warm-up
    return statistics.median(cuda_ms(launch, 5, 21))


def check_k1(shape, taps, dt, seed: int, timed: bool) -> dict:
    """Every stage kind once against the twin; when ``timed``, also the
    kernel alone (:func:`isolated_ms`) at each z-chunk of ``ZCHUNKS``,
    the twin (median of 3) and the bound."""
    res = {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound_ms": [],
           "sweep": {z: [] for z in ZCHUNKS}}
    for kind, (a, b) in enumerate(fd.STAGES):
        has_u = kind > 0
        v, u, out = stage_inputs(shape, seed + kind)
        kw = dict(taps=taps, a=a, b=b, band=2, bc_value=0.0)
        ref = out.clone()
        fd.stage_reference(v, u if has_u else None, ref, dt, **kw)
        fd.fused_stage(v, u if has_u else None, out, dt, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        rel = err / scale
        print(f"  K1 stage {kind + 1} at {shape}: max|kernel-twin| = {err:.3e}"
              f" ({rel / EPS32:.2f} eps of max|twin|)")
        if not rel <= KERNEL_TOL:
            raise AssertionError(
                f"K1 stage {kind + 1} at {shape} differs from its twin: "
                f"{rel / EPS32:.2f} eps > 32 eps"
            )
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if timed:
            u_arg = u if has_u else None
            buffers = [(v.clone(), None if u_arg is None else u.clone(),
                        out.clone()) for _ in range(ROTATE)]
            for z in ZCHUNKS:
                res["sweep"][z].append(isolated_ms(buffers, z, dt=dt, **kw))
            del buffers
            res["ms"].append(res["sweep"][fd.Z_CHUNK][-1])
            res["plain_ms"].append(statistics.median(cuda_ms(
                lambda: fd.stage_reference(v, u_arg, ref, dt, **kw), 3)))
            res["bound_ms"].append(1e3 * max(
                stage_bytes(shape, has_u) / HBM_BYTES_PER_S,
                stage_ops(shape, has_u) / F32_OPS_PER_S,
            ))
            gbs = stage_bytes(shape, has_u) / (res["ms"][-1] * 1e-3) / 1e9
            sweep = ", ".join(f"{z}: {res['sweep'][z][-1]:.4f}"
                              for z in ZCHUNKS)
            print(f"    kernel alone {res['ms'][-1]:.4f} ms ({gbs:.0f} GB/s)"
                  f" at zchunk {fd.Z_CHUNK}; by zchunk {{{sweep}}} ms; twin "
                  f"{res['plain_ms'][-1]:.4f} ms; bound "
                  f"{res['bound_ms'][-1]:.4f} ms (bytes)")
    return res


def laplacian_conv3d_ms(spacing, shape) -> float:
    """Yardstick: conv3d evaluating the 13-point Laplacian alone (no RK
    combine, no masks) on a padded float32 state, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros((1, 1, 5, 5, 5), dtype=torch.float32)
    for axis in range(3):
        scale = 1.0 / (12.0 * spacing[axis] ** 2)
        for j, c in enumerate(fd.O4_COEFFS):
            idx = [2, 2, 2]
            idx[axis] = j
            w[(0, 0, *idx)] += c * scale
    w = w.cuda()
    x = torch.rand((1, 1) + tuple(n + 4 for n in shape), device="cuda")
    conv = torch.nn.functional.conv3d
    conv(x, w)
    return statistics.median(cuda_ms(lambda: conv(x, w), 10))


# --------------------------------------------------------------------- #
# Main path
# --------------------------------------------------------------------- #
def assert_matches(name, got, want, rtol=1e-5, atol=1e-6) -> None:
    """``|got - want| <= rtol |want| + atol max|want|`` everywhere."""
    scale = float(want.abs().max())
    bad = (got - want).abs() > rtol * want.abs() + atol * scale
    worst = float((got - want).abs().max())
    print(f"  {name}: max|fused - generic| = {worst:.3e} "
          f"(max|u| = {scale:.4f})")
    if bool(bad.any()):
        raise AssertionError(f"{name}: fused and generic paths disagree")


# --------------------------------------------------------------------- #
# K5 and the Burgers main path
# --------------------------------------------------------------------- #
def k5_stage_ops(shape, has_u: bool, viscous: bool, variant: str) -> int:
    """f32 operations one K5 stage needs with the Burgers flux and each
    face computed once — the count in ``csrc/fused_burgers_stage.cu``'s
    note: split 6, 103 an axis (WENO5-Z 113), the divergences' sum and
    negation 3, the Laplacian 30, the combine 5 (stage 1: 3)."""
    per_axis = 103 + (10 if variant == "z" else 0)
    per_cell = (6 + 3 * per_axis + 3 + (30 if viscous else 0)
                + (5 if has_u else 3))
    return math.prod(shape) * per_cell


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors of one shape."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max())


def k5_isolated_ms(buffers, zchunk: int, dt, mx, **kw) -> float:
    """Per-launch time of K5 alone: median of 3 samples of 21
    back-to-back launches, each on the next of ``buffers`` (v, u, out)
    sets in turn, far larger together than the 50 MB L2."""
    turn = itertools.cycle(buffers)

    def launch():
        v, u, out = next(turn)
        fb.fused_burgers_stage(v, u, out, dt, mx, zchunk=zchunk, **kw)

    launch()  # warm-up
    return statistics.median(cuda_ms(launch, 3, 21))


def check_k5(shape, params, dt, seed: int, timed: bool) -> dict:
    """Every stage kind once against the twin on random data in
    [-0.1, 1.0) (the last stage in place and emitting max|f'|); when
    ``timed``, also K5 alone at each z-chunk of ``K5_ZCHUNKS``, the twin
    (median of 3) and the bound."""
    res = {"max_abs_err": 0.0, "ulps": 0, "ms": [], "plain_ms": [],
           "bound_ms": [], "sweep": {z: [] for z in K5_ZCHUNKS}}
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.rand(shape, generator=g, device="cuda") * 1.1 - 0.1
    u = torch.rand(shape, generator=g, device="cuda") * 1.1 - 0.1
    dt = torch.full((), dt, dtype=torch.float32, device="cuda")
    viscous = params.lap_taps is not None
    for kind, (a, b) in enumerate(fb.STAGES):
        has_u, emit = kind > 0, kind == 2
        kw = dict(params=params, a=a, b=b)
        ref = fb.stage_reference(v, u if has_u else None,
                                 torch.empty_like(v), dt, emit=emit, **kw)
        want, want_max = ref if emit else (ref, None)
        out = u.clone() if emit else torch.empty_like(v)
        mx = torch.full((1,), -1.0, device="cuda") if emit else None
        fb.fused_burgers_stage(v, out if emit else (u if has_u else None),
                               out, dt, mx, **kw)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        rel = err / float(want.abs().max())
        n_ulps = ulps(out, want)
        line = (f"  K5 stage {kind + 1} at {shape} ({params.flux.name}, "
                f"{params.variant}, {'viscous' if viscous else 'inviscid'})"
                f": max|kernel-twin| = {err:.3e} ({rel / EPS32:.2f} eps of "
                f"max|twin|, {n_ulps} ulp)")
        if emit:
            line += f"; emitted max {float(mx[0])!r} vs twin {float(want_max)!r}"
        print(line)
        if not rel <= KERNEL_TOL:
            raise AssertionError(
                f"K5 stage {kind + 1} at {shape} differs from its twin: "
                f"{rel / EPS32:.2f} eps > 32 eps")
        if emit and float(mx[0]) != float(want_max):
            raise AssertionError("K5's emitted max differs from the twin's")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ulps"] = max(res["ulps"], n_ulps)
        del ref, want, out
        if timed:
            buffers = []
            for _ in range(ROTATE):
                uu = u.clone()
                buffers.append((v.clone(), uu if has_u else None,
                                uu if emit else torch.empty_like(v)))
            for z in K5_ZCHUNKS:
                res["sweep"][z].append(k5_isolated_ms(buffers, z, dt, mx,
                                                      **kw))
            del buffers
            res["ms"].append(res["sweep"][fb.Z_CHUNK][-1])
            u_arg = u if has_u else None
            scratch = torch.empty_like(v)
            res["plain_ms"].append(statistics.median(cuda_ms(
                lambda: fb.stage_reference(v, u_arg, scratch, dt, emit=emit,
                                           **kw), 3)))
            del scratch
            by_bytes = stage_bytes(shape, has_u) / HBM_BYTES_PER_S
            by_ops = k5_stage_ops(shape, has_u, viscous,
                                  params.variant) / F32_OPS_PER_S
            res["bound_ms"].append(1e3 * max(by_bytes, by_ops))
            res["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
            sweep = ", ".join(f"{z}: {res['sweep'][z][-1]:.4f}"
                              for z in K5_ZCHUNKS)
            print(f"    kernel alone {res['ms'][-1]:.4f} ms at zchunk "
                  f"{fb.Z_CHUNK}; by zchunk {{{sweep}}} ms; twin "
                  f"{res['plain_ms'][-1]:.4f} ms; bound "
                  f"{res['bound_ms'][-1]:.4f} ms ({res['bound_by']}: "
                  f"{1e3 * by_ops:.4f} ms of operations, "
                  f"{1e3 * by_bytes:.4f} ms of bytes)")
            issued = fb.ops_issued(shape, fb.Z_CHUNK, has_u=has_u,
                                   viscous=viscous, variant=params.variant)
            rate = issued / (res["ms"][-1] * 1e-3)
            print(f"    issued {issued / math.prod(shape):.2f} f32 "
                  f"operations a cell (fb.ops_issued; the face-once count "
                  f"{by_ops * F32_OPS_PER_S / math.prod(shape):.0f}): "
                  f"{rate / 1e12:.2f} T operations/s, "
                  f"{rate / F32_OPS_PER_S:.3f} of 67 and "
                  f"{rate / F32_NOFMA_OPS_PER_S:.3f} of 33.5 T/s")
    return res


def burgers_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: device span and busy time,
    K5's per-launch time by stage kind (launches come in s1, s2, s3
    order), the device-to-host copies, and the host enqueue time — from
    the first host operation to the start of the run's read-back."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    if not dev:
        return {"k5_launches": 0}  # the caller's check names what is missing
    start = min(e.time_range.start for e in dev)
    end = max(e.time_range.end for e in dev)
    busy = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
    k5 = sorted((e for e in dev if "stage_kernel" in e.name),
                key=lambda e: e.time_range.start)
    by_kind = [[(e.time_range.end - e.time_range.start) / 1e3
                for e in k5[q::3]] for q in range(3)]
    reads = [e for e in host if e.name == "aten::_local_scalar_dense"]
    first = min(e.time_range.start for e in host)
    enqueue = ((min(e.time_range.start for e in reads) - first) / 1e3
               if reads else float("nan"))
    return {
        "span_ms": (end - start) / 1e3, "busy_ms": busy,
        "k5_launches": len(k5),
        "k5_ms": [statistics.mean(x) if x else float("nan")
                  for x in by_kind],
        "dtoh": sum(1 for e in dev if "DtoH" in e.name),
        "reads": len(reads), "enqueue_ms": enqueue,
    }


def burgers_phases(card: str) -> dict:
    """Phases 5-7; returns K5's entry of the ``kernels`` line."""
    n = BURGERS_N
    grid = Grid.make(n, n, n, lengths=2.0)
    cfg = BurgersConfig(grid=grid, nu=BURGERS_NU, dtype="float32",
                        impl="pallas")
    solver = BurgersSolver(cfg)
    params = fb.stage_params(solver.flux, cfg.weno_variant, grid.spacing,
                             cfg.nu)
    dt_cfl = cfg.cfl * min(grid.spacing)

    print("phase 5: K5 against its twin")
    geo = fb.geometry()
    want = fb.tile_geometry()
    print(f"  K5 tiling: {geo['tile_y']}x{geo['tile_x']} tile, "
          f"{geo['threads']} threads, {geo['smem_bytes']} B static shared "
          f"memory, {geo['blocks_per_sm']} blocks an SM, "
          f"{geo['registers']} registers and {geo['local_bytes']} B local "
          f"memory a thread")
    if ((geo["tile_y"], geo["tile_x"]) != fb.TILE
            or geo["threads"] != want["threads"]
            or geo["smem_bytes"] != want["smem_bytes"]):
        raise AssertionError(f"K5's tiling {geo} is not the host's "
                             f"{fb.TILE} / {want}")
    main5 = check_k5(grid.shape, params, dt_cfl, seed=5, timed=True)
    k5_err, k5_ulps = main5["max_abs_err"], main5["ulps"]
    for i, (name, kw, variant, nu) in enumerate(K5_ODD_CASES):
        odd = check_k5(ODD_SHAPE, fb.stage_params(
            pflux.get(name, **kw), variant, (0.05, 0.07, 0.09), nu),
            dt_cfl, seed=50 + i, timed=False)
        k5_err = max(k5_err, odd["max_abs_err"])
        k5_ulps = max(k5_ulps, odd["ulps"])
    torch.cuda.empty_cache()

    print(f"phase 6: Burgers main path, run({BURGERS_ITERS}) at {n}^3")
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "fused-stage":
        raise AssertionError(f"main path did not engage K5: {path}")
    state0 = solver.initial_state()
    torch.cuda.reset_peak_memory_stats()
    out = drive("pallas", solver, state0, BURGERS_ITERS,
                {"K5": 3 * BURGERS_ITERS})
    launches = 3 * BURGERS_ITERS
    fused_peak = torch.cuda.max_memory_allocated()
    print(f"  t = {float(out.t)!r}")
    lo, hi = float(out.u.min()), float(out.u.max())
    print(f"  u in [{lo!r}, {hi!r}]")
    if not (math.isfinite(lo) and math.isfinite(hi)
            and lo >= -1e-6 and hi <= 1.05):
        raise AssertionError(f"u left [-1e-6, 1.05]: [{lo}, {hi}]")
    del out
    reps = cuda_ms(lambda: solver.run(state0, BURGERS_ITERS), 4)[1:]
    run_ms = statistics.median(reps)
    step_ms = run_ms / BURGERS_ITERS
    mlups = grid.num_cells * BURGERS_ITERS * 3 / (run_ms * 1e-3) / 1e6
    print(f"  run({BURGERS_ITERS}): median {run_ms:.3f} ms of {len(reps)} "
          f"reps {[round(r, 3) for r in reps]}; {step_ms:.4f} ms/step; "
          f"{mlups:.0f} MLUPS [{card}]")
    prof = retake(
        lambda: burgers_profile(lambda: solver.run(state0, BURGERS_ITERS)),
        lambda p: p["k5_launches"] == 3 * BURGERS_ITERS)
    if prof["k5_launches"] != 3 * BURGERS_ITERS:
        raise AssertionError(f"profiled run missed K5 launches: "
                             f"{prof['k5_launches']} of {3 * BURGERS_ITERS}")
    idle = 1.0 - prof["busy_ms"] / prof["span_ms"]
    in_run_ms = statistics.mean(prof["k5_ms"])
    print(f"  profiled run({BURGERS_ITERS}): device span "
          f"{prof['span_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms, idle "
          f"share {idle:.4f}; K5 launches {prof['k5_launches']}, per launch "
          f"in the run: stage 1 {prof['k5_ms'][0]:.4f} ms, stage 2 "
          f"{prof['k5_ms'][1]:.4f} ms, stage 3 {prof['k5_ms'][2]:.4f} ms, "
          f"mean {in_run_ms:.4f} ms; device-to-host copies {prof['dtoh']} "
          f"(host reads {prof['reads']}); host enqueue to the read-back "
          f"{prof['enqueue_ms']:.3f} ms under the profiler [{card}]")
    if prof["dtoh"] > 1 or prof["reads"] > 1:
        raise AssertionError("the run copied to the host more than once")

    generic = BurgersSolver(dataclasses.replace(cfg, impl="xla"))
    if generic.engaged_path()["stepper"] != "generic-xla":
        raise AssertionError("impl='xla' did not run the generic path")
    f10 = solver.run(state0, BURGERS_CHECK_ITERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g10 = generic.run(state0, BURGERS_CHECK_ITERS)
    generic_peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory: fused run {fused_peak / 2**30:.2f} GiB, "
          f"generic run {generic_peak / 2**30:.2f} GiB (the initial state "
          f"included)")
    if abs(float(f10.t) - float(g10.t)) > 1e-5 * float(g10.t):
        raise AssertionError(f"t differs: {f10.t} vs {g10.t}")
    assert_matches(f"run({BURGERS_CHECK_ITERS})", f10.u, g10.u, rtol=2e-5,
                   atol=2e-6)
    del f10, g10

    print("phase 7: fixed dt and advance_to()")
    fixed = BurgersSolver(dataclasses.replace(cfg, adaptive_dt=False))
    gfixed = BurgersSolver(dataclasses.replace(cfg, adaptive_dt=False,
                                               impl="xla"))
    fb.fused_burgers_stage.launches = 0
    f5 = fixed.run(state0, 5)
    torch.cuda.synchronize()
    fixed_launches = fb.fused_burgers_stage.launches
    g5 = gfixed.run(state0, 5)
    print(f"  fixed dt: {fixed.engaged_path()['fallback']}; K5 launches "
          f"{fixed_launches}; t {float(f5.t)!r} vs {float(g5.t)!r}")
    if fixed_launches != 15 or f5.t != g5.t:
        raise AssertionError("fixed-dt run(5) went wrong")
    assert_matches("fixed run(5)", f5.u, g5.u, rtol=2e-5, atol=2e-6)
    del f5, g5
    dt0 = float(cfg.cfl * min(grid.spacing)
                / float(state0.u.abs().max()))
    t_end = float(state0.t) + 4.5 * dt0
    fb.fused_burgers_stage.launches = 0
    adv = solver.advance_to(state0, t_end)
    torch.cuda.synchronize()
    adv_launches = fb.fused_burgers_stage.launches
    gadv = generic.advance_to(state0, t_end)
    print(f"  advance_to: steps {adv.it} (generic {gadv.it}), K5 launches "
          f"{adv_launches}, t {float(adv.t)!r} vs t_end {t_end!r}")
    if adv.it != 5 or gadv.it != 5 or adv_launches != 15:
        raise AssertionError("advance_to did not take 5 fused steps")
    if abs(float(adv.t) - t_end) > 1e-6 * t_end:
        raise AssertionError("advance_to did not land on t_end")
    assert_matches("advance_to", adv.u, gadv.u, rtol=2e-5, atol=2e-6)
    del adv, gadv, state0
    torch.cuda.empty_cache()

    return {
        "name": "fused_burgers_stage",
        "id": "K5",
        "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_burgers_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_burgers.py:352",
        "launches": launches,
        "max_abs_err": k5_err,
        "max_ulps": k5_ulps,
        # per launch, mean over the three stage kinds a step launches;
        # "ms" is what a launch takes in the main path's run
        "ms": in_run_ms,
        "ms_by_stage": prof["k5_ms"],
        "ms_isolated": statistics.mean(main5["ms"]),
        "ms_isolated_by_zchunk": {
            str(z): statistics.mean(main5["sweep"][z]) for z in K5_ZCHUNKS},
        "zchunk": fb.Z_CHUNK,
        "plain_ms": statistics.mean(main5["plain_ms"]),
        "bound_ms": statistics.mean(main5["bound_ms"]),
        "bound_by": main5["bound_by"],
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes a WENO5 "
                        "stage",
        "ms_per_step": step_ms,
        "mlups": mlups,
        "device_idle_share": idle,
        "host_enqueue_ms": prof["enqueue_ms"],
        "dtoh_copies": prof["dtoh"],
        "peak_gib_fused": fused_peak / 2**30,
        "peak_gib_generic": generic_peak / 2**30,
    }


# --------------------------------------------------------------------- #
# K7 / K7a and the 2-D main paths
# --------------------------------------------------------------------- #
def k7_diffusion_ops(shape, steps: int) -> int:
    """f32 operations a K7 diffusion run needs: per interior cell (band
    2) and step, 10 products and 9 sums of taps, dt*acc, v+., b*. in
    every stage, and a*u plus its sum in stages 2-3 — 22 + 24 + 24."""
    return math.prod(n - 4 for n in shape) * 70 * steps


def k7_burgers_ops(shape, steps: int, viscous: bool, variant: str,
                   adaptive: bool) -> int:
    """f32 operations a K7 Burgers run needs with each face computed
    once, the count in ``csrc/whole_run_burgers2d.cu``'s note: split 6,
    103 an axis (WENO5-Z 113), the divergences' sum and negation 2, the
    Laplacian 20, the combine 5 (stage 1: 3); adaptive adds |f'| and its
    max, 2 a cell."""
    per_axis = 103 + (10 if variant == "z" else 0)
    stage = 6 + 2 * per_axis + 2 + (20 if viscous else 0)
    per_cell = 3 * stage + 3 + 5 + 5 + (2 if adaptive else 0)
    return math.prod(shape) * per_cell * steps


def run_bound(state_bytes: int, ops: int) -> tuple[float, str]:
    """The least time (ms) of a whole run: the state read once and
    written once at the HBM rate, or its operations at the f32 rate."""
    by_bytes = 2 * state_bytes / HBM_BYTES_PER_S
    by_ops = ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "operations" if by_ops >= by_bytes else "bytes")


def median_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event samples of one call, after a warm-up."""
    fn()
    return statistics.median(cuda_ms(fn, reps))


def compare(name, got, want) -> tuple[float, int]:
    """Kernel against twin: ``<= 32 eps`` of max|twin|; returns the
    largest absolute difference and ulp distance."""
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    n_ulps = ulps(got, want)
    print(f"  {name}: max|kernel-twin| = {err:.3e} ({rel / EPS32:.2f} eps "
          f"of max|twin|, {n_ulps} ulp)")
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{name}: kernel differs from its twin: "
                             f"{rel / EPS32:.2f} eps > 32 eps")
    return err, n_ulps


def run_profile(fn, kernel: str) -> dict | None:
    """Run ``fn`` under ``torch.profiler``: device span and busy time, the
    launches and mean time of kernels whose name holds ``kernel``, and
    the device-to-host copies; ``None`` when the profiler saw no device
    activity (the caller then times with CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    start = min(e.time_range.start for e in dev)
    end = max(e.time_range.end for e in dev)
    mine = [(e.time_range.end - e.time_range.start) / 1e3
            for e in dev if kernel in e.name]
    return {
        "span_ms": (end - start) / 1e3,
        "busy_ms": sum(e.time_range.end - e.time_range.start
                       for e in dev) / 1e3,
        "launches": len(mine),
        "kernel_ms": statistics.mean(mine) if mine else float("nan"),
        "dtoh": sum(1 for e in dev if "DtoH" in e.name),
    }


def count_reads(fn) -> int:
    """Host reads of device scalars (``Tensor.item``, each one
    device-to-host copy) in one call of ``fn``."""
    n = [0]
    item = torch.Tensor.item

    def counted(self):
        n[0] += 1
        return item(self)

    torch.Tensor.item = counted
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        torch.Tensor.item = item
    return n[0]


def profiler_sees_device() -> bool:
    """Whether ``torch.profiler`` records a plain PyTorch kernel now."""
    return run_profile(lambda: torch.ones(1 << 20, device="cuda") + 1,
                       "") is not None


def drive(name, solver, state0, iters: int, expect: dict):
    """One main path: every count set to 0 just before ``run``, read just
    after; ``expect`` gives the launches of each kernel (others 0)."""
    reset_counts()
    out = solver.run(state0, iters)
    torch.cuda.synchronize()
    got = counts()
    print(f"  {name}: launches in run({iters}): {got}")
    if got != {k: expect.get(k, 0) for k in COUNTERS}:
        raise AssertionError(f"{name}: expected launches {expect}, {got}")
    return out


def drive_path(name, solver, state0, iters: int, expect: str) -> dict:
    """One 2-D main path on the whole-run rung: :func:`drive`, with one
    launch of ``expect``'s kernel."""
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "fused-whole-run":
        raise AssertionError(f"{name} did not engage the whole-run rung")
    return {"out": drive(name, solver, state0, iters, {expect: 1}),
            "launches": 1}


def time_path(name, solver, state0, iters: int, kernel: str, card: str,
              alone_ms: float):
    """ms per run (median of 3 after a warm-up), ms/step, MLUPS, the host
    reads of one run, and one profiled run: the kernel's time in it, the
    idle share and the device-to-host copies. Where the profiler does not
    see the cooperative launch (it saw no device activity around one, or
    only other kernels), the kernel's time is ``alone_ms`` (CUDA events)
    and the idle share and copies are not measured."""
    reps = cuda_ms(lambda: solver.run(state0, iters), 4)[1:]
    run_ms = statistics.median(reps)
    mlups = solver.grid.num_cells * iters * 3 / (run_ms * 1e-3) / 1e6
    reads = count_reads(lambda: solver.run(state0, iters))
    prof = run_profile(lambda: solver.run(state0, iters), kernel)
    line = (f"  {name} run({iters}): median {run_ms:.3f} ms of {len(reps)} "
            f"reps {[round(r, 3) for r in reps]}; "
            f"{run_ms / iters * 1e3:.3f} us/step; {mlups:.0f} MLUPS; host "
            f"reads of device scalars {reads}")
    if prof is None or prof["launches"] == 0:
        seen = ("no device activity" if prof is None else
                f"{prof['busy_ms']:.3f} ms of other device work and not the "
                "kernel")
        print(f"{line}; the profiler saw {seen} in the run (a plain kernel "
              f"after it: {'seen' if profiler_sees_device() else 'not seen'}"
              f"): kernel time from CUDA events alone, idle share and "
              f"device-to-host copies not measured [{card}]")
        kernel_ms, idle, dtoh = alone_ms, None, None
    else:
        kernel_ms, dtoh = prof["kernel_ms"], prof["dtoh"]
        idle = 1.0 - prof["busy_ms"] / prof["span_ms"]
        print(f"{line}; profiled: kernel {kernel_ms:.3f} ms "
              f"({prof['launches']} launch), span {prof['span_ms']:.3f} ms, "
              f"busy {prof['busy_ms']:.3f} ms, idle share {idle:.4f}, "
              f"device-to-host copies {dtoh} [{card}]")
        if prof["launches"] != 1:
            raise AssertionError(f"{name}: the profiled run saw its kernel "
                                 f"{prof['launches']} times")
    return {"ms": kernel_ms, "run_ms": run_ms,
            "ms_per_step": run_ms / iters, "mlups": mlups,
            "device_idle_share": idle, "dtoh_copies": dtoh,
            "host_reads": reads}


def laplacian_conv2d_ms(spacing, shape) -> float:
    """Yardstick: conv2d evaluating the 9-point 2-D O4 Laplacian alone
    (no RK combine, no masks) on a padded float32 state, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros((1, 1, 5, 5), dtype=torch.float32)
    for axis in range(2):
        scale = 1.0 / (12.0 * spacing[axis] ** 2)
        for j, c in enumerate(fd.O4_COEFFS):
            idx = [2, 2]
            idx[axis] = j
            w[(0, 0, *idx)] += c * scale
    w = w.cuda()
    x = torch.rand((1, 1) + tuple(n + 4 for n in shape), device="cuda")
    conv = torch.nn.functional.conv2d
    return median_ms(lambda: conv(x, w), 10)


def diffusion2d_phases(card: str, l2_gbs: float) -> dict:
    """Phases 8-9 and the diffusion half of 11; returns K7's entry."""
    n, iters = DIFF2D_N, DIFF2D_ITERS
    grid = Grid.make(n, n, lengths=10.0)
    cfg = DiffusionConfig(grid=grid, dtype="float32", impl="pallas")
    solver = DiffusionSolver(cfg)
    taps = fd.stage_taps(grid.spacing, [cfg.diffusivity] * 2)
    dt = solver.dt

    print("phase 8: K7 (diffusion) against its twin")
    probe = torch.zeros((40, 40), device="cuda")
    seen = run_profile(lambda: fd2.whole_run_diffusion2d(
        probe, probe.clone(), probe.clone(), 2, dt, taps=taps, band=2,
        bc_value=0.0), "whole_run_kernel")
    print("  the profiler on the first cooperative launch: "
          + ("no device activity" if seen is None else
             f"{seen['launches']} K7 launch, {seen['kernel_ms']:.4f} ms"))
    err, n_ulps = 0.0, 0
    for shape, bc, seed in ((grid.shape, 0.0, 8), (ODD_2D, 0.25, 81)):
        kw = dict(taps=taps, band=2, bc_value=bc)
        rng = np.random.default_rng(seed)
        S0 = torch.full(tuple(m + 4 for m in shape), bc, device="cuda")
        S0[2:-2, 2:-2] = torch.from_numpy(
            rng.random(shape, dtype=np.float32)).cuda()
        for steps in (1, 5):
            want = wr.plain_run(
                lambda v, u, o, d, a, b: fd2.stage_reference(
                    v, u, o, d, a=a, b=b, **kw),
                S0.clone(), S0.clone(), S0.clone(), steps, dt)
            got = S0.clone()
            fd2.whole_run_diffusion2d(got, S0.clone(), S0.clone(), steps,
                                      dt, **kw)
            torch.cuda.synchronize()
            e, u = compare(f"K7 diffusion {steps} step(s) at {shape}", got,
                           want)
            err, n_ulps = max(err, e), max(n_ulps, u)
    state0 = solver.initial_state()
    fused = solver._fused_stepper()
    S = fused.embed(state0.u)
    T1, T2 = S.clone(), S.clone()
    kw = dict(taps=taps, band=2, bc_value=0.0)
    blocks = []
    alone = median_ms(lambda: fd2.whole_run_diffusion2d(
        S, T1, T2, iters, dt, grid_blocks=blocks, **kw))
    floor = median_ms(lambda: fd2.whole_run_diffusion2d(
        S, T1, T2, iters, dt, sync_floor=True, **kw))
    state_bytes = 4 * S.numel()
    bound_ms, bound_by = run_bound(state_bytes,
                                   k7_diffusion_ops(grid.shape, iters))
    l2_ms = 32 * S.numel() * iters / (l2_gbs * 1e9) * 1e3
    plain_S = fused.embed(state0.u)
    plain_ms = cuda_ms(lambda: wr.plain_run(
        lambda v, u, o, d, a, b: fd2.stage_reference(v, u, o, d, a=a, b=b,
                                                     **kw),
        plain_S, T1, T2, iters, dt), 1)[0]
    got = fused.embed(state0.u)
    fd2.whole_run_diffusion2d(got, plain_S.clone(), plain_S.clone(), iters,
                              dt, **kw)
    torch.cuda.synchronize()
    e, u = compare(f"K7 diffusion {iters} steps at {grid.shape} (the main "
                   "path's initial state)", got, plain_S)
    err, n_ulps = max(err, e), max(n_ulps, u)
    del got, plain_S
    print(f"  K7 alone, run({iters}) at {n}^2: {alone:.3f} ms "
          f"({alone / iters * 1e3:.3f} us/step) on {blocks[0]} blocks of "
          f"256; sync floor {floor:.3f} ms ({floor / iters * 1e3:.3f} "
          f"us/step, 3 barriers a step); bound {bound_ms:.3f} ms "
          f"({bound_by}); through L2 at the measured copy rate "
          f"{l2_ms:.3f} ms; twin {plain_ms:.1f} ms [{card}]")
    del S, T1, T2

    print(f"phase 9: diffusion 2-D main path, run({iters}) at {n}^2")
    res = drive_path("diffusion 2-D", solver, state0, iters, "K7")
    generic = DiffusionSolver(dataclasses.replace(cfg, impl="xla"))
    gout = generic.run(state0, iters)
    if res["out"].t != gout.t:
        raise AssertionError(f"t differs: {res['out'].t} vs {gout.t}")
    fn, gn = solver.error_norms(res["out"]), generic.error_norms(gout)
    print(f"  error vs exact at t={float(gout.t):.6f}: fused L1 {fn.l1:.4e} "
          f"L2 {fn.l2:.4e} Linf {fn.linf:.4e}; generic L1 {gn.l1:.4e} "
          f"L2 {gn.l2:.4e} Linf {gn.linf:.4e}")
    # of the generic path's size: finite and at most twice its norms.
    # After 10,000 float32 steps both are mostly rounding, which the two
    # paths accumulate differently (taps with K folded in, another sum
    # order), so they differ by more than their states do at 100 steps.
    if not all(math.isfinite(x) and x <= 2 * y for x, y in zip(fn, gn)):
        raise AssertionError(f"error norms out of range: {fn} vs {gn}")
    assert_matches(f"run({DIFF2D_CHECK_ITERS})",
                   solver.run(state0, DIFF2D_CHECK_ITERS).u,
                   generic.run(state0, DIFF2D_CHECK_ITERS).u)
    del gout
    timing = time_path("diffusion 2-D", solver, state0, iters,
                       "whole_run_kernel", card, alone)
    lib_ms = laplacian_conv2d_ms(grid.spacing, grid.shape)
    print(f"  conv2d 9-point Laplacian alone, TF32 off: {lib_ms:.4f} ms "
          f"[{card}] (one of the run's {3 * iters} stage evaluations, "
          "without the combine and walls)")

    print("phase 11: advance_to() on the 2-D diffusion grid")
    check_advance_generic(solver, generic, state0, 4.5 * dt, {"K11b": 15})
    return {
        "name": "whole_run_diffusion2d",
        "id": "K7",
        "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "whole_run_diffusion2d.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "whole_run.py:28",
        "launches": res["launches"],
        "max_abs_err": err,
        "max_ulps": n_ulps,
        # per run of the main path (10,000 steps, one launch)
        **timing,
        "ms_isolated": alone,
        "sync_floor_ms": floor,
        "grid_blocks": blocks[0],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "l2_traffic_ms": l2_ms,
        "library_ms": lib_ms,
        "library_call": "torch.nn.functional.conv2d, one 9-point "
                        "Laplacian (one stage's stencil of 30,000 in the "
                        "run)",
    }


def check_advance_generic(solver, generic, state0, span: float,
                          expect: dict, **bounds) -> None:
    """``advance_to`` on a whole-run config: the generic loop on the
    per-axis kernels (``expect``: their launches in 5 steps), the
    whole-run stepper's reason, the generic path's result within
    ``bounds``."""
    path = solver.engaged_path("t_end")
    print(f"  engaged (t_end): {path}")
    want_reason = ("fused-whole-run stepper has no run_to; t_end mode runs "
                   "the generic loop")
    if (path["stepper"] != "per-axis-pallas"
            or path["fallback"] != want_reason):
        raise AssertionError(f"advance_to engaged {path}")
    t_end = float(state0.t) + span
    reset_counts()
    adv = solver.advance_to(state0, t_end)
    torch.cuda.synchronize()
    got = counts()
    gadv = generic.advance_to(state0, t_end)
    print(f"  advance_to: {adv.it} steps, launches {got}, t "
          f"{float(adv.t)!r} vs t_end {t_end!r}")
    if got != {k: expect.get(k, 0) for k in COUNTERS} or adv.it != 5:
        raise AssertionError("advance_to did not run the per-axis loop")
    assert_matches("advance_to", adv.u, gadv.u, **bounds)


def burgers2d_phases(card: str, l2_gbs: float) -> list[dict]:
    """Phase 10 and the Burgers half of 11; returns K7's and K7a's
    entries."""
    n, iters = BURGERS2D_N, BURGERS2D_ITERS
    grid = Grid.make(n, n, lengths=2.0)
    cfg = BurgersConfig(grid=grid, dtype="float32", impl="pallas",
                        adaptive_dt=False)
    acfg = dataclasses.replace(cfg, adaptive_dt=True)
    fixed, adaptive = BurgersSolver(cfg), BurgersSolver(acfg)
    spacing, cfl = grid.spacing, cfg.cfl
    dt = cfl * min(spacing)

    def check(shape, params, sp, seed, steps, adapt):
        rng = np.random.default_rng(seed)
        S0 = torch.from_numpy(
            rng.uniform(-0.1, 1.0, shape).astype(np.float32)).cuda()
        T = [torch.empty_like(S0) for _ in range(4)]
        stage = (lambda v, u, o, d, a, b: fb2.stage_reference(
            v, u, o, d, params=params, a=a, b=b))
        got = S0.clone()
        label = (f"K7{'a' if adapt else ''} {steps} step(s) at {shape} "
                 f"({params.flux.name}, {params.variant}, "
                 f"{'viscous' if params.lap_taps else 'inviscid'})")
        if adapt:
            _, t_sum = fb2.whole_run_burgers2d(
                got, T[0], T[1], steps, params=params, spacing=sp, cfl=cfl)
            df = params.flux.df
            want, want_t = wr.plain_run_adaptive(
                stage, lambda u: pcfl.advective_dt(u, df, sp, cfl),
                S0.clone(), T[2], T[3], steps)
            if float(t_sum) != float(want_t):
                raise AssertionError(f"{label}: t_sum {float(t_sum)!r} vs "
                                     f"twin {float(want_t)!r}")
            label += f", t_sum {float(t_sum)!r} equal"
        else:
            fb2.whole_run_burgers2d(got, T[0], T[1], steps, params=params,
                                    dt=cfl * min(sp))
            want = wr.plain_run(stage, S0.clone(), T[2], T[3], steps,
                                cfl * min(sp))
        torch.cuda.synchronize()
        return compare(label, got, want)

    print("phase 10: K7 (Burgers) and K7a against their twin")
    params = fb.stage_params(fixed.flux, cfg.weno_variant, spacing, cfg.nu)
    err, n_ulps = 0.0, 0
    cases = [(grid.shape, params, spacing, 10, 1, False),
             (grid.shape, params, spacing, 11, 5, False),
             (grid.shape, params, spacing, 12, 5, True)]
    odd_sp = (0.05, 0.07)
    for i, (name, kw, variant, nu) in enumerate(K7_ODD_CASES):
        p = fb.stage_params(pflux.get(name, **kw), variant, odd_sp, nu)
        cases += [(ODD_2D, p, odd_sp, 100 + i, 5, False),
                  (ODD_2D, p, odd_sp, 200 + i, 5, True)]
    for case in cases:
        e, u = check(*case)
        err, n_ulps = max(err, e), max(n_ulps, u)

    state0 = fixed.initial_state()
    S = state0.u.clone()
    T1, T2 = torch.empty_like(S), torch.empty_like(S)
    blocks = []
    alone = median_ms(lambda: fb2.whole_run_burgers2d(
        S, T1, T2, iters, params=params, dt=dt, grid_blocks=blocks))
    alone_a = median_ms(lambda: fb2.whole_run_burgers2d(
        S, T1, T2, iters, params=params, spacing=spacing, cfl=cfl))
    floor = median_ms(lambda: fb2.whole_run_burgers2d(
        S, T1, T2, iters, params=params, dt=dt, sync_floor=True))
    stage = (lambda v, u, o, d, a, b: fb2.stage_reference(
        v, u, o, d, params=params, a=a, b=b))
    # the twins over the main paths' whole runs, timed, and the kernels
    # held against them from the same initial state
    want = state0.u.clone()
    plain = cuda_ms(lambda: wr.plain_run(stage, want, T1, T2, iters, dt),
                    1)[0]
    got = state0.u.clone()
    fb2.whole_run_burgers2d(got, T1, T2, iters, params=params, dt=dt)
    torch.cuda.synchronize()
    e, u = compare(f"K7 {iters} steps at {grid.shape} (the main path's "
                   "initial state)", got, want)
    err, n_ulps = max(err, e), max(n_ulps, u)
    want = state0.u.clone()
    twin_t = []
    plain_a = cuda_ms(lambda: twin_t.append(wr.plain_run_adaptive(
        stage, lambda u: pcfl.advective_dt(u, fixed.flux.df, spacing, cfl),
        want, T1, T2, iters)[1]), 1)[0]
    got = state0.u.clone()
    _, t_sum = fb2.whole_run_burgers2d(got, T1, T2, iters, params=params,
                                       spacing=spacing, cfl=cfl)
    torch.cuda.synchronize()
    if float(t_sum) != float(twin_t[0]):
        raise AssertionError(f"K7a t_sum {float(t_sum)!r} vs twin "
                             f"{float(twin_t[0])!r}")
    e, u = compare(f"K7a {iters} steps at {grid.shape} (the main path's "
                   f"initial state), t_sum {float(t_sum)!r} equal", got, want)
    err, n_ulps = max(err, e), max(n_ulps, u)
    del got, want
    bound = run_bound(4 * S.numel(), k7_burgers_ops(
        grid.shape, iters, False, cfg.weno_variant, False))
    bound_a = run_bound(4 * S.numel(), k7_burgers_ops(
        grid.shape, iters, False, cfg.weno_variant, True))
    l2_ms = 32 * S.numel() * iters / (l2_gbs * 1e9) * 1e3
    print(f"  alone, run({iters}) at {n}^2 on {blocks[0]} blocks of 256: "
          f"K7 {alone:.3f} ms, K7a {alone_a:.3f} ms; sync floor "
          f"{floor:.3f} ms ({floor / iters * 1e3:.3f} us/step); bounds "
          f"{bound[0]:.4f} / {bound_a[0]:.4f} ms ({bound[1]}); through L2 "
          f"{l2_ms:.4f} ms; twins {plain:.1f} / {plain_a:.1f} ms [{card}]")
    del S, T1, T2

    entry = {}
    for label, solver, key, alone_ms in (("fixed", fixed, "K7", alone),
                                         ("adaptive", adaptive, "K7a",
                                          alone_a)):
        print(f"phase 10: Burgers 2-D main path, {label} dt, run({iters}) "
              f"at {n}^2")
        res = drive_path(f"Burgers 2-D {label}", solver, state0, iters, key)
        out = res["out"]
        generic = BurgersSolver(dataclasses.replace(solver.cfg, impl="xla"))
        gout = generic.run(state0, iters)
        lo, hi = float(out.u.min()), float(out.u.max())
        print(f"  t = {float(out.t)!r} (generic {float(gout.t)!r}); u in "
              f"[{lo!r}, {hi!r}]")
        if not (math.isfinite(lo) and math.isfinite(hi)
                and lo >= -1e-6 and hi <= 1.05):
            raise AssertionError(f"u left [-1e-6, 1.05]: [{lo}, {hi}]")
        if abs(float(out.t) - float(gout.t)) > 1e-5 * float(gout.t):
            raise AssertionError(f"t differs: {out.t} vs {gout.t}")
        print(f"  max|fused - generic| at run({iters}), past the shock: "
              f"{float((out.u - gout.u).abs().max()):.3e} (not a check)")
        check = BURGERS2D_CHECK_ITERS
        assert_matches(f"{label} run({check})", solver.run(state0, check).u,
                       generic.run(state0, check).u, rtol=2e-5, atol=2e-6)
        del out, gout
        timing = time_path(f"Burgers 2-D {label}", solver, state0, iters,
                           "whole_run_kernel", card, alone_ms)
        if (timing["dtoh_copies"] or 0) > 1 or timing["host_reads"] > 1:
            raise AssertionError("the run copied to the host more than once")
        entry[key] = {"launches": res["launches"], **timing}
        if label == "fixed":
            print("phase 11: advance_to() on the 2-D Burgers grid")
            check_advance_generic(solver, generic, state0, 4.5 * dt,
                                  {"K12b": 30}, rtol=2e-5, atol=2e-6)

    common = {
        "name": "whole_run_burgers2d",
        "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "whole_run_burgers2d.cu",
        "max_abs_err": err,
        "max_ulps": n_ulps,
        "grid_blocks": blocks[0],
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes a WENO5 "
                        "stage",
    }
    return [{
        **common, "id": "K7",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "whole_run.py:28",
        **entry["K7"],
        "ms_isolated": alone,
        "sync_floor_ms": floor,
        "plain_ms": plain,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "l2_traffic_ms": l2_ms,
    }, {
        **common, "id": "K7a",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "whole_run.py:75",
        **entry["K7a"],
        "ms_isolated": alone_a,
        "plain_ms": plain_a,
        "bound_ms": bound_a[0],
        "bound_by": bound_a[1],
    }]


# --------------------------------------------------------------------- #
# K10 / K2, K6 and the 3-D fused-step paths (phases 12-15)
# --------------------------------------------------------------------- #
def exact(name, got, want) -> float:
    """Kernel against twin to the bit: prints the distance, raises unless
    it is 0 ulp; returns the largest absolute difference."""
    err = float((got - want).abs().max())
    n_ulps = ulps(got, want)
    print(f"  {name}: max|kernel-twin| = {err:.3e}, {n_ulps} ulp")
    if n_ulps != 0:
        raise AssertionError(f"{name}: {n_ulps} ulp from its twin")
    return err


def twin_steps(step, S0, steps: int):
    """The plain twin of ``steps`` fused steps from ``S0`` (unchanged):
    ``step(src, dst)`` on two copies in turn; returns the result."""
    return fsr.ping_pong(step, S0.clone(), S0.clone(), steps)


def padded_random(shape, bc: float, seed: int):
    """A padded state on the card: numpy's random interior, the ghost
    ring at ``bc``."""
    rng = np.random.default_rng(seed)
    S = torch.full(tuple(n + 2 * fd.R for n in shape), bc, device="cuda")
    S[2:-2, 2:-2, 2:-2] = torch.from_numpy(
        rng.random(shape, dtype=np.float32)).cuda()
    return S


def run_ms(solver, state0, iters: int) -> tuple[float, list]:
    """A path's ``run(iters)``: the median of 3 CUDA-event samples after
    a warm-up (ms) and the samples."""
    reps = cuda_ms(lambda: solver.run(state0, iters), 4)[1:]
    return statistics.median(reps), reps


def step_phases(card: str) -> list[dict]:
    """Phases 12-13; returns K10's and K2's entries."""
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    cfg = DiffusionConfig(grid=grid, dtype="float32", impl="pallas_step")
    solvers = {impl: DiffusionSolver(dataclasses.replace(cfg, impl=impl))
               for impl in ("pallas_stage", "pallas_step", "pallas_slab",
                            "xla")}
    dt = solvers["pallas_step"].dt
    taps = fd.stage_taps(grid.spacing, [cfg.diffusivity] * 3)
    cells = grid.num_cells

    print("phase 12: K10 and K2 against their twin")
    odd_sp = (0.05, 0.07, 0.09)
    err = 0.0
    for shape, tp, dt_, bc, seed in (
            (grid.shape, taps, dt, 0.0, 12),
            (ODD_SHAPE, fd.stage_taps(odd_sp, (1.0, 0.5, 2.0)),
             pcfl.diffusive_dt(2.0, odd_sp), 0.25, 121)):
        kw = dict(taps=tp, band=2, bc_value=bc)
        S0 = padded_random(shape, bc, seed)
        for steps in (1, 5):
            want = twin_steps(lambda s, d: fds.step_reference(s, d, dt_, **kw),
                              S0, steps)
            got, other = S0.clone(), S0.clone()
            for _ in range(steps):
                fds.fused_step(got, other, dt_, **kw)
                got, other = other, got
            slab = fsr.slab_run_diffusion(S0.clone(), S0.clone(), steps, dt_,
                                          **kw)
            torch.cuda.synchronize()
            err = max(err,
                      exact(f"K10 {steps} step(s) at {shape}", got, want),
                      exact(f"K2 {steps} step(s) at {shape}", slab, want))
            exact(f"K2 against K10, {steps} step(s) at {shape}", slab, got)
    state0 = solvers["pallas_stage"].initial_state()
    u = {impl: solvers[impl].run(state0, ITERS).u
         for impl in ("pallas_stage", "pallas_step", "pallas_slab")}
    for impl, key in (("pallas_step", "K10"), ("pallas_slab", "K2")):
        exact(f"{key} path against the K1 path after run({ITERS})", u[impl],
              u["pallas_stage"])
    del u

    kw = dict(taps=taps, band=2, bc_value=0.0)
    sets = [(padded_random(grid.shape, 0.0, 120 + i),
             torch.zeros(tuple(n + 4 for n in grid.shape), device="cuda"))
            for i in range(ROTATE)]
    planned = fds.diffusion_zchunk(*grid.shape, 1, "cuda")
    planned_k2 = fds.diffusion_zchunk(*grid.shape, 1, "cuda",
                                      cooperative=True)
    zchunks = sorted({*STEP_ZCHUNKS, planned, planned_k2})
    sweep = {}
    for z in zchunks:
        turn = itertools.cycle(sets)

        def launch():
            S, out = next(turn)
            fds.fused_step(S, out, dt, zchunk=z, **kw)

        launch()
        sweep[z] = statistics.median(cuda_ms(launch, 5, 21))
    S, out = sets[0]
    plain_step = statistics.median(cuda_ms(
        lambda: fds.step_reference(S, out, dt, **kw), 3))
    slab_sweep = {z: median_ms(lambda: fsr.slab_run_diffusion(
        S, out, ITERS, dt, zchunk=z, **kw)) for z in zchunks}
    blocks = []
    fsr.slab_run_diffusion(S, out, 1, dt, grid_blocks=blocks, **kw)
    plain_run = cuda_ms(lambda: twin_steps(
        lambda s, d: fds.step_reference(s, d, dt, **kw), S, ITERS), 1)[0]
    del sets, S, out
    step_bytes = 8 * cells
    step_ops = 100 * cells  # K1's 32 + 34 + 34 a cell (check_k1)
    k10_bound, k10_by = run_bound(4 * cells, step_ops)
    k2_bound, k2_by = run_bound(4 * cells, step_ops * ITERS)
    issued = fds.ops_issued(grid.shape, planned)
    issued_k2 = fds.ops_issued(grid.shape, planned_k2)
    print(f"  K10 alone at {grid.shape} by zchunk "
          f"{ {z: round(v, 4) for z, v in sweep.items()} } ms a step "
          f"(planned {planned}: {sweep[planned]:.4f} ms, "
          f"{step_bytes / (sweep[planned] * 1e-3) / 1e9:.0f} GB/s of its "
          f"8 B a cell); twin {plain_step:.3f} ms; bound {k10_bound:.4f} ms "
          f"({k10_by}; 100 operations a cell at 67 T/s "
          f"{1e3 * step_ops / F32_OPS_PER_S:.4f} ms) [{card}]")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    diffusion_schedule_report(
        "K10 alone", sweep[planned], grid.shape[0], grid.shape, 1,
        fds.BLOCKS_PER_SM * sms, planned, issued, card,
        grid=" (two an SM; the launch: one block a job)")
    print(f"  K2 alone, run({ITERS}), by zchunk "
          f"{ {z: round(v, 3) for z, v in slab_sweep.items()} } ms on "
          f"{blocks[0]} blocks of 352 (planned {planned_k2}); twin {plain_run:.1f} ms; bound "
          f"{k2_bound:.3f} ms ({k2_by}; 8 B a cell a step would be "
          f"{1e3 * step_bytes * ITERS / HBM_BYTES_PER_S:.3f} ms) [{card}]")
    diffusion_schedule_report(
        "K2 alone", slab_sweep[planned_k2] / ITERS, grid.shape[0],
        grid.shape, 1, blocks[0], planned_k2, issued_k2, card)

    print(f"phase 13: the diffusion 3-D fused-step paths, run({ITERS}) at "
          f"{grid.shape}")
    gout = solvers["xla"].run(state0, ITERS)
    k1_ms, k1_reps = run_ms(solvers["pallas_stage"], state0, ITERS)
    print(f"  the K1 path (pallas_stage): {k1_ms / ITERS:.4f} ms/step "
          f"({[round(r, 3) for r in k1_reps]} ms a run) [{card}]")
    res = {}
    for impl, key, launches in (("pallas_step", "K10", ITERS),
                                ("pallas_slab", "K2", 1)):
        solver = solvers[impl]
        path = solver.engaged_path()
        print(f"  engaged: {path}")
        want_label = "fused-step" if key == "K10" else "fused-whole-run-slab"
        if path["stepper"] != want_label or path["fallback"] is not None:
            raise AssertionError(f"{impl} did not engage {key}: {path}")
        out = drive(impl, solver, state0, ITERS, {key: launches})
        if out.t != gout.t or out.it != gout.it:
            raise AssertionError(f"t/it differ: {out.t}/{out.it} vs "
                                 f"{gout.t}/{gout.it}")
        assert_matches(f"{impl} run({ITERS})", out.u, gout.u)
        norms = solver.error_norms(out)
        print(f"  error vs exact at t={float(out.t):.6f}: L1 {norms.l1:.4e} "
              f"L2 {norms.l2:.4e} Linf {norms.linf:.4e}")
        if not all(math.isfinite(x) for x in norms) or not norms.linf < 1e-3:
            raise AssertionError(f"error norms out of range: {norms}")
        del out
        ms, reps = run_ms(solver, state0, ITERS)
        mlups = cells * ITERS * 3 / (ms * 1e-3) / 1e6
        print(f"  {impl} run({ITERS}): median {ms:.3f} ms of "
              f"{[round(r, 3) for r in reps]}; {ms / ITERS:.4f} ms/step; "
              f"{mlups:.0f} MLUPS; bound 8 B a cell a step "
              f"{1e3 * step_bytes / HBM_BYTES_PER_S:.4f} ms/step; the K1 "
              f"path {k1_ms / ITERS:.4f} ms/step [{card}]")
        res[key] = {"launches": launches, "run_ms": ms,
                    "ms_per_step": ms / ITERS, "mlups": mlups}
    del gout

    common = {"route": "cuda", "max_abs_err": err, "max_ulps": 0,
              "library_ms": None,
              "library_call": "none: no single PyTorch call computes an "
                              "RK step",
              "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                        "fused_step_diffusion.cu",
              "k1_path_ms_per_step": k1_ms / ITERS}
    return [{
        "name": "fused_step_diffusion", "id": "K10", **common,
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_diffusion_step.py:94",
        "launches": res["K10"]["launches"],
        # per launch (one step) in the main path's run(101)
        "ms": res["K10"]["ms_per_step"],
        "ms_isolated": sweep[planned],
        "ms_isolated_by_zchunk": {str(z): v for z, v in sweep.items()},
        "zchunk": planned, "ops_issued": issued,
        "plain_ms": plain_step, "bound_ms": k10_bound, "bound_by": k10_by,
        "ms_per_step": res["K10"]["ms_per_step"],
        "mlups": res["K10"]["mlups"],
    }, {
        "name": "slab_run_diffusion", "id": "K2", **common,
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_slab_run.py:188",
        "launches": res["K2"]["launches"],
        # per launch: the main path's run(101)
        "ms": res["K2"]["run_ms"],
        "ms_isolated_by_zchunk": {str(z): v for z, v in slab_sweep.items()},
        "zchunk": planned_k2, "ops_issued_per_step": issued_k2,
        "grid_blocks": blocks[0],
        "plain_ms": plain_run, "bound_ms": k2_bound, "bound_by": k2_by,
        "ms_per_step": res["K2"]["ms_per_step"],
        "mlups": res["K2"]["mlups"],
    }]


def k6_step_ops(shape, viscous: bool, variant: str) -> int:
    """f32 operations one fused Burgers step needs, each face once: K5's
    count (``k5_stage_ops``) for its three stages."""
    return (k5_stage_ops(shape, False, viscous, variant)
            + 2 * k5_stage_ops(shape, True, viscous, variant))


def schedule_report(name, ms_step: float, window: int, shape, units: int,
                    blocks: int, ops: float, card: str,
                    grid: str = "") -> None:
    """Print a slab Burgers kernel's schedule and rate: ``blocks``
    resident blocks (``grid`` says what the launch was, where it is not
    those blocks), one step's jobs and waves (jobs a resident block) on
    a ``window``-plane output window of ``units`` tiles' sets (members
    or shards), as ``fused_slab_run.burgers_schedule`` plans them, and
    ``ops`` (the operations of a step, each face once) over ``ms_step``
    against 67 and 33.5 T/s. Reported, not held."""
    plan = fsr.burgers_schedule(window, shape[1], shape[2], blocks,
                                units=units)
    rate = ops / (ms_step * 1e-3)
    print(f"  {name}: {blocks} resident blocks{grid}; a step {plan['jobs']} "
          f"jobs of {plan['chunk_planes']} planes ({plan['tiles']} tiles x "
          f"{units} x {plan['chunks']} chunks), {plan['waves']:.2f} waves; "
          f"{rate / 1e12:.2f} T operations/s, {rate / F32_OPS_PER_S:.3f} of "
          f"67 and {rate / F32_NOFMA_OPS_PER_S:.3f} of 33.5 T/s [{card}]")


def diffusion_schedule_report(name, ms_step: float, window: int, shape,
                              units: int, blocks: int, zchunk: int,
                              issued: int, card: str,
                              grid: str = "") -> None:
    """Print a diffusion-body launch's plan and rate: ``blocks`` resident
    blocks, one step's jobs and waves on a ``window``-plane output window
    of ``units`` tiles' sets in jobs of ``zchunk`` planes
    (``fused_diffusion_step.diffusion_schedule``), and the f32
    operations the body issues in the step (``issued``,
    ``fused_diffusion_step.ops_issued``, recompute included) over
    ``ms_step`` against 33.5 T/s, the rate without FMA (the body rounds
    each product and sum). Reported, not held; the bounds stay at 67."""
    plan = fds.diffusion_schedule(window, shape[1], shape[2], blocks,
                                  units=units, zchunk=zchunk)
    rate = issued / (ms_step * 1e-3)
    print(f"  {name}: {blocks} resident blocks{grid}; a step {plan['jobs']} "
          f"jobs of {plan['chunk_planes']} planes ({plan['tiles']} tiles x "
          f"{units} x {plan['chunks']} chunks), {plan['waves']:.2f} waves; "
          f"{issued / 1e9:.3f} G f32 operations issued, "
          f"{issued / (math.prod(shape) * units):.1f} an output cell; "
          f"{rate / 1e12:.2f} T/s, {rate / F32_NOFMA_OPS_PER_S:.3f} of "
          f"33.5 T/s [{card}]")


def slab_burgers_phases(card: str) -> dict:
    """Phase 14; returns K6's entry."""
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    cfg = BurgersConfig(grid=grid, cfl=K6_CFL, adaptive_dt=False,
                        dtype="float32", impl="pallas_slab")
    solver = BurgersSolver(cfg)
    params = fb.stage_params(solver.flux, cfg.weno_variant, grid.spacing,
                             cfg.nu)
    dt = solver.dt
    cells = grid.num_cells

    print("phase 14: K6 against its twin")
    odd_sp = (0.05, 0.07, 0.09)
    cases = [(grid.shape, params, dt, 14)]
    for i, (name, kw, variant, nu) in enumerate(K7_ODD_CASES):
        cases.append((ODD_SHAPE, fb.stage_params(pflux.get(name, **kw),
                                                 variant, odd_sp, nu),
                      K6_CFL * min(odd_sp), 140 + i))
    err = 0.0
    for shape, p, dt_, seed in cases:
        rng = np.random.default_rng(seed)
        S0 = torch.from_numpy(
            rng.uniform(-0.1, 1.0, shape).astype(np.float32)).cuda()
        for steps in (1, 5):
            want = twin_steps(lambda s, d: fsr.burgers_step_reference(
                s, d, dt_, params=p), S0, steps)
            got = fsr.slab_run_burgers(S0.clone(), torch.empty_like(S0),
                                       steps, dt_, params=p)
            torch.cuda.synchronize()
            err = max(err, exact(
                f"K6 {steps} step(s) at {shape} ({p.flux.name}, {p.variant}, "
                f"{'viscous' if p.lap_taps else 'inviscid'})", got, want))
            del want, got
        del S0
    torch.cuda.empty_cache()

    state0 = solver.initial_state()
    A, B = state0.u.clone(), torch.empty_like(state0.u)
    sweep = {z: median_ms(lambda: fsr.slab_run_burgers(
        A, B, 5, dt, params=params, zchunk=z)) / 5
        for z in (*K6_ZCHUNKS, None)}
    blocks = []
    fsr.slab_run_burgers(A, B, 1, dt, params=params, grid_blocks=blocks)
    plain_step = cuda_ms(lambda: fsr.burgers_step_reference(
        A, B, dt, params=params), 1)[0]
    del A, B
    torch.cuda.empty_cache()
    ops = k6_step_ops(grid.shape, False, cfg.weno_variant)
    bound = 1e3 * max(8 * cells / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    planned = fsr.burgers_schedule(grid.shape[0], grid.shape[1],
                                   grid.shape[2], blocks[0])["chunk_planes"]
    print(f"  K6 alone at {grid.shape}, run(5), by z planes a job "
          f"{ {z: round(v, 4) for z, v in sweep.items() if z} } ms a step, "
          f"planned ({planned}) {sweep[None]:.4f}; twin {plain_step:.1f} ms "
          f"a step; bound {bound:.4f} ms a step (operations: "
          f"{ops / 1e9:.2f} G, each face once) [{card}]")
    schedule_report("K6 alone", sweep[None], grid.shape[0], grid.shape, 1,
                    blocks[0], ops, card)

    print(f"phase 14: the Burgers slab path, fixed dt, run({K6_ITERS}) at "
          f"{grid.shape}")
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "fused-whole-run-slab" or path["fallback"]:
        raise AssertionError(f"pallas_slab did not engage K6: {path}")
    out = drive("pallas_slab", solver, state0, K6_ITERS, {"K6": 1})
    lo, hi = float(out.u.min()), float(out.u.max())
    print(f"  t = {float(out.t)!r}; u in [{lo!r}, {hi!r}]")
    if not (math.isfinite(lo) and math.isfinite(hi)
            and lo >= -1e-6 and hi <= 1.05):
        raise AssertionError(f"u left [-1e-6, 1.05]: [{lo}, {hi}]")
    stage = BurgersSolver(dataclasses.replace(cfg, impl="pallas_stage"))
    k5_out = drive("pallas_stage", stage, state0, K6_ITERS,
                   {"K5": 3 * K6_ITERS})
    print(f"  the K6 path against the K5 path after run({K6_ITERS}): "
          f"{ulps(out.u, k5_out.u)} ulp; t {float(out.t)!r} vs "
          f"{float(k5_out.t)!r}")
    if out.t != k5_out.t:
        raise AssertionError("t differs between the K6 and K5 paths")
    del out, k5_out
    generic = BurgersSolver(dataclasses.replace(cfg, impl="xla"))
    f10 = solver.run(state0, K6_CHECK_ITERS)
    g10 = generic.run(state0, K6_CHECK_ITERS)
    if f10.t != g10.t:
        raise AssertionError(f"t differs: {f10.t} vs {g10.t}")
    assert_matches(f"run({K6_CHECK_ITERS})", f10.u, g10.u, rtol=2e-5,
                   atol=2e-6)
    del f10, g10, generic
    torch.cuda.empty_cache()
    ms, reps = run_ms(solver, state0, K6_ITERS)
    k5_ms, k5_reps = run_ms(stage, state0, K6_ITERS)
    mlups = cells * K6_ITERS * 3 / (ms * 1e-3) / 1e6
    print(f"  pallas_slab run({K6_ITERS}): median {ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]}; {ms / K6_ITERS:.4f} ms/step; "
          f"{mlups:.0f} MLUPS; bound {bound:.4f} ms/step; the K5 path "
          f"{k5_ms / K6_ITERS:.4f} ms/step ({[round(r, 3) for r in k5_reps]}"
          f" ms a run) [{card}]")
    return {
        "name": "slab_run_burgers", "id": "K6", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "slab_run_burgers.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_slab_run.py:1540",
        "launches": 1,
        "max_abs_err": err, "max_ulps": 0,
        # per step of the main path's run(267), one launch for the run:
        # the twin over a whole run would take over a minute
        "per": "step",
        "ms": ms / K6_ITERS,
        "run_ms": ms,
        "ms_isolated_by_zchunk": {str(z): v for z, v in sweep.items()},
        "plain_ms": plain_step, "bound_ms": bound, "bound_by": "operations",
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes an RK step",
        "ms_per_step": ms / K6_ITERS, "mlups": mlups,
        "k5_path_ms_per_step": k5_ms / K6_ITERS,
    }


def gate_sweep(card: str) -> None:
    """Phase 15: the per-stage and the slab paths timed on the gates'
    grids (after a warm-up, ``GATE_ROUNDS`` rounds of one run of each
    path in turn); which was faster beyond the spread and which the gate
    picks. Reported, not held."""
    print(f"phase 15: the slab gates (K2 against K1, run({ITERS}); K6 "
          f"against K5 at fixed dt, run({SWEEP_BURGERS_ITERS}))")
    for n in SWEEP_DIFFUSION:
        grid = Grid.make(*n, lengths=REF_LENGTHS)
        runs = {}
        for impl in ("pallas_stage", "pallas_step", "pallas_slab"):
            s = DiffusionSolver(DiffusionConfig(grid=grid, impl=impl))
            runs[impl] = (s, s.initial_state())
            s.run(runs[impl][1], ITERS)  # warm-up
        # the three paths in turn, one timed run each a round
        ms = {impl: [] for impl in runs}
        for _ in range(GATE_ROUNDS):
            for impl, (s, s0) in runs.items():
                ms[impl] += [t / ITERS for t in cuda_ms(
                    lambda: s.run(s0, ITERS), 1)]
        del runs, s, s0
        k1, k10, k2 = (sorted(ms[i]) for i in ("pallas_stage", "pallas_step",
                                              "pallas_slab"))
        faster = ("K2" if k2[-1] < k1[0] else "K1" if k1[-1] < k2[0]
                  else "neither beyond the spread")
        gate = ("K2" if fsr.SlabRunDiffusionStepper.profitable(
            grid.shape, torch.float32) else "K1")
        print(f"  diffusion {grid.shape} ({grid.num_cells} cells): ms/step "
              f"over {GATE_ROUNDS} rounds, median [min, max]: K1 "
              f"{statistics.median(k1):.5f} [{k1[0]:.5f}, {k1[-1]:.5f}], "
              f"K10 {statistics.median(k10):.5f} [{k10[0]:.5f}, "
              f"{k10[-1]:.5f}], K2 {statistics.median(k2):.5f} [{k2[0]:.5f}, "
              f"{k2[-1]:.5f}]; faster {faster}; the gate picks {gate} "
              f"[{card}]")
    for n in SWEEP_BURGERS:
        grid = Grid.make(*n, lengths=K6_LENGTHS)
        runs = {}
        for impl in ("pallas_stage", "pallas_slab"):
            s = BurgersSolver(BurgersConfig(grid=grid, cfl=K6_CFL,
                                            adaptive_dt=False, impl=impl))
            runs[impl] = (s, s.initial_state())
            s.run(runs[impl][1], SWEEP_BURGERS_ITERS)  # warm-up
        # the two paths in turn, one timed run each a round
        ms = {impl: [] for impl in runs}
        for _ in range(GATE_ROUNDS):
            for impl, (s, s0) in runs.items():
                ms[impl] += [t / SWEEP_BURGERS_ITERS for t in cuda_ms(
                    lambda: s.run(s0, SWEEP_BURGERS_ITERS), 1)]
        del runs, s, s0
        torch.cuda.empty_cache()
        k5, k6 = sorted(ms["pallas_stage"]), sorted(ms["pallas_slab"])
        # faster only beyond the spread: every round of one path below
        # every round of the other
        faster = ("K6" if k6[-1] < k5[0] else "K5" if k5[-1] < k6[0]
                  else "neither beyond the spread")
        gate = ("K6" if fsr.SlabRunBurgersStepper.profitable(
            grid.shape, torch.float32) else "K5")
        print(f"  Burgers {grid.shape} ({grid.num_cells} cells): ms/step "
              f"over {GATE_ROUNDS} rounds, median [min, max]: K5 "
              f"{statistics.median(k5):.5f} [{k5[0]:.5f}, {k5[-1]:.5f}], "
              f"K6 {statistics.median(k6):.5f} [{k6[0]:.5f}, "
              f"{k6[-1]:.5f}]; faster {faster}; the gate picks {gate} "
              f"[{card}]")


# --------------------------------------------------------------------- #
# K11/K11b, K12/K12b and the per-axis paths (phases 16-19)
# --------------------------------------------------------------------- #
K12_ODD_CASES = (  # (flux, flux kwargs, variant, order) at ODD_SHAPE/ODD_2D
    ("burgers", {}, "z", 5),
    ("burgers", {}, "js", 7),
    ("linear", {"c": -0.7}, "js", 5),
    ("buckley", {}, "js", 5),
    ("buckley", {}, "js", 7),
)
K12_CHUNKS = (4, 8, 16, 32)  # cells a K12 thread marches, timed at 512^3
# split operations a cell by flux (the note in csrc/weno_axis.cu)
SPLIT_OPS = {"burgers": 6, "linear": 7, "buckley": 22}


def lap_ops(shape) -> int:
    """f32 operations of K11/K11b: per axis 5 products and 4 sums, a
    K-product, and the sum of the axes — 32 a cell in 3-D, 21 in 2-D."""
    return math.prod(shape) * (11 * len(shape) - 1)


def weno_ops(shape, flux: str, variant: str, order: int) -> int:
    """f32 operations of one K12 sweep with each face computed once (the
    note in csrc/weno_axis.cu): the split, then 103 (WENO5-JS), 113
    (WENO5-Z) or 293 (WENO7) a cell."""
    per_axis = {(5, "js"): 103, (5, "z"): 113, (7, "js"): 293}[
        (order, variant)]
    return math.prod(shape) * (SPLIT_OPS[flux] + per_axis)


def kernel_bound(in_elems: int, out_elems: int, ops: int):
    """The least time (ms) of one launch: its input read once and output
    written once at the HBM rate, or its operations at the f32 rate."""
    by_bytes = 4 * (in_elems + out_elems) / HBM_BYTES_PER_S
    by_ops = ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "operations" if by_ops >= by_bytes else "bytes")


def alone_ms(launch, inputs, batch: int) -> float:
    """Per-launch time of a kernel alone: median of 5 CUDA-event samples
    of ``batch`` back-to-back launches, each on the next of ``inputs``
    in turn (together larger than the 50 MB L2 where the path's state
    is)."""
    turn = itertools.cycle(inputs)
    launch(next(turn))  # warm-up
    return statistics.median(cuda_ms(lambda: launch(next(turn)), 5, batch))


def random_on_card(shape, seed: int, lo=-0.1, hi=1.1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo


def laplacian_axis_phase(card: str) -> list[dict]:
    """Phase 16: K11 and K11b against their twin, timed alone at the
    per-axis paths' shapes beside their bound, the twin and conv3d /
    conv2d; returns their partial entries."""
    print("phase 16: K11 and K11b against their twin")
    ref = Grid.make(*REF_N, lengths=REF_LENGTHS)
    b3 = Grid.make(BURGERS_N, BURGERS_N, BURGERS_N, lengths=2.0)
    d2 = Grid.make(DIFF2D_N, DIFF2D_N, lengths=10.0)
    cases = (  # (grid shape, spacing, K, timed)
        (ref.shape, ref.spacing, (1.0,) * 3, True),
        (b3.shape, b3.spacing, (BURGERS_NU,) * 3, True),
        (ODD_SHAPE, (0.05, 0.07, 0.09), (1.0, 0.5, 2.0), False),
        (d2.shape, d2.spacing, (1.0,) * 2, True),
        (ODD_2D, (0.05, 0.07), (1.0, 0.5), False),
    )
    res = {3: {"err": 0.0, "ulps": 0, "timed": []},
           2: {"err": 0.0, "ulps": 0, "timed": []}}
    for i, (shape, sp, k, timed) in enumerate(cases):
        nd = len(shape)
        fn = klap.laplacian_o4_3d if nd == 3 else klap.laplacian_o4_2d
        up = random_on_card(tuple(n + 4 for n in shape), seed=160 + i)
        want = klap.laplacian_reference(up, sp, k)
        got = fn(up, sp, k)
        torch.cuda.synchronize()
        e, u = compare(f"K11{'' if nd == 3 else 'b'} at {shape}", got, want)
        res[nd]["err"], res[nd]["ulps"] = (max(res[nd]["err"], e),
                                           max(res[nd]["ulps"], u))
        del got, want
        if not timed:
            continue
        sets = [up] + [up.clone() for _ in range(ROTATE - 1)
                       if up.numel() * 4 < 256 << 20 and nd == 3]
        ms = alone_ms(lambda x: fn(x, sp, k), sets, 21)
        plain = statistics.median(cuda_ms(
            lambda: klap.laplacian_reference(up, sp, k), 3))
        bound, by = kernel_bound(up.numel(), math.prod(shape),
                                 lap_ops(shape))
        lib = (laplacian_conv3d_ms(sp, shape) if nd == 3
               else laplacian_conv2d_ms(sp, shape))
        gbs = 4 * (up.numel() + math.prod(shape)) / (ms * 1e-3) / 1e9
        line = (f"    alone {ms:.4f} ms ({gbs:.0f} GB/s); twin {plain:.4f} "
                f"ms; bound {bound:.4f} ms ({by}); conv{nd}d {lib:.4f} ms")
        if nd == 3 and shape == ref.shape:
            sweep = {z: alone_ms(lambda x: fn(x, sp, k, zchunk=z), sets, 21)
                     for z in ZCHUNKS}
            line += "; by zchunk {" + ", ".join(
                f"{z}: {t:.4f}" for z, t in sweep.items()) + "} ms"
        print(f"{line} [{card}]")
        res[nd]["timed"].append({"shape": list(shape), "ms": ms,
                                 "plain_ms": plain, "bound_ms": bound,
                                 "bound_by": by, "library_ms": lib})
        del sets, up
        torch.cuda.empty_cache()
    entries = []
    for nd, kid, name, line in ((3, "K11", "laplacian_o4_3d", 162),
                                (2, "K11b", "laplacian_o4_2d", 209)):
        main = res[nd]["timed"][0]  # the diffusion path's shape
        entries.append({
            "name": name, "id": kid, "route": "cuda",
            "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                      "laplacian_o4.cu",
            "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                        f"laplacian.py:{line}",
            "max_abs_err": res[nd]["err"], "max_ulps": res[nd]["ulps"],
            # per launch alone at the diffusion path's shape
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_call": f"torch.nn.functional.conv{nd}d, the same "
                            "Laplacian, TF32 off",
            "timed": res[nd]["timed"],
        })
    return entries


def weno_axis_phase(card: str) -> list[dict]:
    """Phase 17: K12 and K12b against their twin: every sweep axis at
    512^3 and 400x400x406 (WENO5-JS, Burgers flux), each timed alone
    beside its bound and the twin; the odd shapes for WENO5-Z, WENO7-JS
    and the linear and Buckley-Leverett fluxes; 400^2 in 2-D."""
    print("phase 17: K12 and K12b against their twin")
    fx = pflux.burgers()
    res = {3: {"err": 0.0, "ulps": 0, "timed": []},
           2: {"err": 0.0, "ulps": 0, "timed": []}}

    def check(shape, axis, flux, kw, variant, order, seed, timed):
        nd = len(shape)
        fn = kweno.flux_divergence_3d if nd == 3 else kweno.flux_divergence_2d
        padded = list(shape)
        padded[axis] += 2 * kweno.HALO[order]
        up = random_on_card(tuple(padded), seed)
        f = pflux.get(flux, **kw)
        want = kweno.flux_divergence_reference(up, axis, 0.05, f, variant,
                                               order)
        got = fn(up, axis, 0.05, f, variant, order)
        torch.cuda.synchronize()
        tag = f"K12{'' if nd == 3 else 'b'}"
        e, u = compare(f"{tag} at {tuple(shape)} axis {axis} ({flux}, "
                       f"WENO{order}-{variant})", got, want)
        if order == 7 and u != 0:  # the difference-form betas, held exactly
            raise AssertionError(f"{tag} WENO7 at {tuple(shape)} axis "
                                 f"{axis}: {u} ulp from its twin")
        res[nd]["err"], res[nd]["ulps"] = (max(res[nd]["err"], e),
                                           max(res[nd]["ulps"], u))
        del got, want
        if timed:
            ms = alone_ms(lambda x: fn(x, axis, 0.05, f, variant, order),
                          [up], 5 if nd == 3 else 21)
            plain = statistics.median(cuda_ms(
                lambda: kweno.flux_divergence_reference(
                    up, axis, 0.05, f, variant, order), 3))
            bound, by = kernel_bound(up.numel(), math.prod(shape),
                                     weno_ops(shape, flux, variant, order))
            line = (f"    alone {ms:.4f} ms; twin {plain:.3f} ms; bound "
                    f"{bound:.4f} ms ({by})")
            if nd == 3 and shape[0] == BURGERS_N:
                sweep = {c: alone_ms(lambda x: fn(
                    x, axis, 0.05, f, variant, order, chunk=c), [up], 5)
                    for c in K12_CHUNKS}
                line += "; by chunk {" + ", ".join(
                    f"{c}: {t:.4f}" for c, t in sweep.items()) + "} ms"
            print(f"{line} [{card}]")
            res[nd]["timed"].append({"shape": list(shape), "axis": axis,
                                     "ms": ms, "plain_ms": plain,
                                     "bound_ms": bound, "bound_by": by})
        del up
        torch.cuda.empty_cache()

    for i, shape in enumerate(((BURGERS_N,) * 3, tuple(reversed(K6_N)))):
        for axis in range(3):
            check(shape, axis, "burgers", {}, "js", 5, 170 + 3 * i + axis,
                  True)
    for axis in range(2):
        check((BURGERS2D_N, BURGERS2D_N), axis, "burgers", {}, "js", 5,
              176 + axis, True)
    for j, (flux, kw, variant, order) in enumerate(K12_ODD_CASES):
        for shape in (ODD_SHAPE, ODD_2D):
            for axis in range(len(shape)):
                check(shape, axis, flux, kw, variant, order,
                      180 + 10 * j + axis, False)
    entries = []
    for nd, kid, name, line in ((3, "K12", "flux_divergence_3d", 221),
                                (2, "K12b", "flux_divergence_2d", 276)):
        main = [t for t in res[nd]["timed"]
                if t["shape"][0] in (BURGERS_N, BURGERS2D_N)]
        entries.append({
            "name": name, "id": kid, "route": "cuda",
            "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                      "weno_axis.cu",
            "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                        f"weno.py:{line}",
            "max_abs_err": res[nd]["err"], "max_ulps": res[nd]["ulps"],
            # per launch alone, mean over the sweep axes at the main
            # per-axis path's shape (512^3; 400^2)
            "ms": statistics.mean(t["ms"] for t in main),
            "plain_ms": statistics.mean(t["plain_ms"] for t in main),
            "bound_ms": statistics.mean(t["bound_ms"] for t in main),
            "bound_by": main[0]["bound_by"],
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes a WENO "
                            "flux divergence",
            "timed": res[nd]["timed"],
        })
    return entries


def axis_profile(fn, ndim: int) -> dict | None:
    """Run ``fn`` under ``torch.profiler``: device span and busy time,
    the launches and mean time of each per-axis kernel of an ``ndim``-D
    run, and the device-to-host copies; ``None`` when it saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    start = min(e.time_range.start for e in dev)
    end = max(e.time_range.end for e in dev)
    kernels = {}
    suffix = "" if ndim == 3 else "b"
    for key, name in ((f"K11{suffix}", f"laplacian{ndim}d_kernel"),
                      (f"K12{suffix}", "weno_axis_kernel")):
        times = [(e.time_range.end - e.time_range.start) / 1e3
                 for e in dev if name in e.name]
        if times:
            kernels[key] = {"launches": len(times),
                            "ms": statistics.mean(times),
                            "share": sum(times) / ((end - start) / 1e3)}
    return {
        "span_ms": (end - start) / 1e3,
        "busy_ms": sum(e.time_range.end - e.time_range.start
                       for e in dev) / 1e3,
        "kernels": kernels,
        "dtoh": sum(1 for e in dev if "DtoH" in e.name),
    }


def per_axis_path(name, solver, iters: int, expect: dict, card: str,
                  fused_ms_per_step: float, time_iters: int | None = None,
                  profile_iters: int | None = None):
    """One per-axis path, ``impl="pallas_axis"``: the engaged stepper,
    the launches of ``run(iters)`` (:func:`drive`), then ms/step (median
    of 3 CUDA-event samples of ``run(time_iters)`` after a warm-up),
    MLUPS, the host reads of device scalars and one profiled
    ``run(profile_iters)`` (the idle share, the kernels' share and the
    device-to-host copies). Returns the run's state and the numbers."""
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "per-axis-pallas" or path["fallback"] is not None:
        raise AssertionError(f"{name} did not engage the per-axis rung")
    state0 = solver.initial_state()
    out = drive(name, solver, state0, iters, expect)
    t_iters = time_iters or iters
    p_iters = profile_iters or iters
    total_ms, reps = run_ms(solver, state0, t_iters)
    step_ms = total_ms / t_iters
    mlups = solver.grid.num_cells * t_iters * 3 / (total_ms * 1e-3) / 1e6
    reads = count_reads(lambda: solver.run(state0, p_iters))
    prof = axis_profile(lambda: solver.run(state0, p_iters),
                        solver.grid.ndim)
    line = (f"  {name} run({t_iters}): median {total_ms:.3f} ms of "
            f"{[round(r, 3) for r in reps]}; {step_ms:.4f} ms/step "
            f"({step_ms / fused_ms_per_step:.2f}x the fused path's "
            f"{fused_ms_per_step:.4f}); {mlups:.0f} MLUPS; host reads of "
            f"device scalars in run({p_iters}) {reads}")
    idle = dtoh = None
    if prof is None:
        print(f"{line}; the profiler saw no device activity: idle share "
              f"and device-to-host copies not measured [{card}]")
    else:
        idle = 1.0 - prof["busy_ms"] / prof["span_ms"]
        dtoh = prof["dtoh"]
        shares = ", ".join(f"{k} {v['launches']} launches, {v['ms']:.4f} "
                           f"ms each, {v['share']:.3f} of the span"
                           for k, v in prof["kernels"].items())
        print(f"{line}; profiled run({p_iters}): span "
              f"{prof['span_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms, "
              f"idle share {idle:.4f}, device-to-host copies {dtoh}; "
              f"{shares} [{card}]")
    return out, state0, {
        "ms_per_step": step_ms, "mlups": mlups, "run_iters": t_iters,
        "fused_ms_per_step": fused_ms_per_step,
        "device_idle_share": idle, "dtoh_copies": dtoh,
        "host_reads": reads,
        "profile": None if prof is None else prof["kernels"],
    }


def check_burgers_path(name, solver, out, state0, check_iters: int):
    """u inside [-1e-6, 1.05] after the run, and agreement with the
    generic path after ``check_iters`` steps (before the shock)."""
    lo, hi = float(out.u.min()), float(out.u.max())
    print(f"  {name}: t = {float(out.t)!r}; u in [{lo!r}, {hi!r}]")
    if not (math.isfinite(lo) and math.isfinite(hi)
            and lo >= -1e-6 and hi <= 1.05):
        raise AssertionError(f"u left [-1e-6, 1.05]: [{lo}, {hi}]")
    generic = BurgersSolver(dataclasses.replace(solver.cfg, impl="xla"))
    got = solver.run(state0, check_iters)
    want = generic.run(state0, check_iters)
    if abs(float(got.t) - float(want.t)) > 1e-5 * float(want.t):
        raise AssertionError(f"t differs: {got.t} vs {want.t}")
    assert_matches(f"run({check_iters}) against impl='xla'", got.u, want.u,
                   rtol=2e-5, atol=2e-6)


def per_axis_phases(card: str, fused: dict) -> dict:
    """Phase 18: the six per-axis paths; ``fused`` holds the fused
    paths' ms/step measured earlier in this run on the same configs.
    Returns each path's numbers by name."""
    paths = {}

    n = ITERS
    print(f"phase 18: diffusion 3-D per-axis path, run({n}) at "
          f"{'x'.join(map(str, REF_N))}")
    cfg = DiffusionConfig(grid=Grid.make(*REF_N, lengths=REF_LENGTHS),
                          dtype="float32", impl="pallas_axis")
    solver = DiffusionSolver(cfg)
    out, state0, paths["diffusion3d"] = per_axis_path(
        "diffusion 3-D", solver, n, {"K11": 3 * n}, card,
        fused["diffusion3d"])
    gout = DiffusionSolver(dataclasses.replace(cfg, impl="xla")).run(
        state0, n)
    if out.t != gout.t:
        raise AssertionError(f"t differs: {out.t} vs {gout.t}")
    assert_matches(f"run({n}) against impl='xla'", out.u, gout.u)
    print(f"  equal to the generic path to the bit: "
          f"{bool(torch.equal(out.u, gout.u))}")
    norms = solver.error_norms(out)
    print(f"  error vs exact at t={float(out.t):.6f}: L1 {norms.l1:.4e} "
          f"L2 {norms.l2:.4e} Linf {norms.linf:.4e}")
    if not all(math.isfinite(x) for x in norms) or not norms.linf < 1e-3:
        raise AssertionError(f"error norms out of range: {norms}")
    del out, gout, solver, state0
    torch.cuda.empty_cache()

    n = BURGERS_ITERS
    print(f"phase 18: Burgers 3-D per-axis path (SingleGPU/Burgers3d_WENO5)"
          f", adaptive dt, nu = {BURGERS_NU}, run({n}) at {BURGERS_N}^3")
    grid = Grid.make(BURGERS_N, BURGERS_N, BURGERS_N, lengths=2.0)
    solver = BurgersSolver(BurgersConfig(grid=grid, nu=BURGERS_NU,
                                         dtype="float32",
                                         impl="pallas_axis"))
    out, state0, paths["burgers3d"] = per_axis_path(
        "Burgers 3-D", solver, n, {"K12": 9 * n, "K11": 3 * n}, card,
        fused["burgers3d"])
    check_burgers_path("Burgers 3-D", solver, out, state0,
                       BURGERS_CHECK_ITERS)
    del out, solver, state0
    torch.cuda.empty_cache()

    n = K6_ITERS
    print(f"phase 18: Burgers 3-D per-axis path (MultiGPU/Burgers3d_"
          f"Baseline), fixed dt, inviscid, CFL {K6_CFL}, run({n}) at "
          f"{'x'.join(map(str, K6_N))}")
    solver = BurgersSolver(BurgersConfig(
        grid=Grid.make(*K6_N, lengths=K6_LENGTHS), cfl=K6_CFL,
        adaptive_dt=False, dtype="float32", impl="pallas_axis"))
    out, state0, paths["burgers3d_baseline"] = per_axis_path(
        "Burgers 3-D baseline", solver, n, {"K12": 9 * n}, card,
        fused["burgers3d_baseline"])
    check_burgers_path("Burgers 3-D baseline", solver, out, state0,
                       K6_CHECK_ITERS)
    del out, solver, state0
    torch.cuda.empty_cache()

    n = DIFF2D_ITERS
    print(f"phase 18: diffusion 2-D per-axis path, run({n}) at "
          f"{DIFF2D_N}^2 (timed over run({n // 10}))")
    cfg = DiffusionConfig(grid=Grid.make(DIFF2D_N, DIFF2D_N, lengths=10.0),
                          dtype="float32", impl="pallas_axis")
    solver = DiffusionSolver(cfg)
    out, state0, paths["diffusion2d"] = per_axis_path(
        "diffusion 2-D", solver, n, {"K11b": 3 * n}, card,
        fused["diffusion2d"], time_iters=n // 10,
        profile_iters=DIFF2D_CHECK_ITERS)
    gout = DiffusionSolver(dataclasses.replace(cfg, impl="xla")).run(
        state0, n)
    assert_matches(f"run({n}) against impl='xla'", out.u, gout.u)
    print(f"  equal to the generic path to the bit: "
          f"{bool(torch.equal(out.u, gout.u))}")
    norms = solver.error_norms(out)
    print(f"  error vs exact at t={float(out.t):.6f}: L1 {norms.l1:.4e} "
          f"L2 {norms.l2:.4e} Linf {norms.linf:.4e}")
    if not all(math.isfinite(x) for x in norms):
        raise AssertionError(f"error norms out of range: {norms}")
    del out, gout, solver, state0

    n = BURGERS2D_ITERS
    for label, adaptive in (("fixed", False), ("adaptive", True)):
        print(f"phase 18: Burgers 2-D per-axis path, {label} dt, run({n}) "
              f"at {BURGERS2D_N}^2")
        solver = BurgersSolver(BurgersConfig(
            grid=Grid.make(BURGERS2D_N, BURGERS2D_N, lengths=2.0),
            adaptive_dt=adaptive, dtype="float32", impl="pallas_axis"))
        out, state0, paths[f"burgers2d_{label}"] = per_axis_path(
            f"Burgers 2-D {label}", solver, n, {"K12b": 6 * n}, card,
            fused[f"burgers2d_{label}"])
        check_burgers_path(f"Burgers 2-D {label}", solver, out, state0,
                           BURGERS2D_CHECK_ITERS)
    return paths


def repaired_dispatch_phase() -> None:
    """Phase 19: Burgers 3-D ``impl="pallas_step"`` at 512^3 engages the
    fused stage kernel K5 (it raised before the per-axis rung existed),
    and diffusion with periodic walls under ``impl="pallas"`` at the
    reference grid engages the per-axis rung and launches K11."""
    print("phase 19: the repaired dispatch")
    grid = Grid.make(BURGERS_N, BURGERS_N, BURGERS_N, lengths=2.0)
    solver = BurgersSolver(BurgersConfig(grid=grid, nu=BURGERS_NU,
                                         dtype="float32",
                                         impl="pallas_step"))
    path = solver.engaged_path()
    print(f"  Burgers pallas_step: {path}")
    if path["stepper"] != "fused-stage" or path["fallback"] is not None:
        raise AssertionError("Burgers pallas_step did not engage K5")
    drive("Burgers pallas_step", solver, solver.initial_state(), 2,
          {"K5": 6})
    del solver
    torch.cuda.empty_cache()
    solver = DiffusionSolver(DiffusionConfig(
        grid=Grid.make(*REF_N, lengths=REF_LENGTHS), dtype="float32",
        bc="periodic", impl="pallas"))
    path = solver.engaged_path()
    print(f"  diffusion periodic pallas: {path}")
    if (path["stepper"] != "per-axis-pallas" or path["fallback"]
            != "fused walls need uniform Dirichlet BCs on every axis"):
        raise AssertionError("periodic diffusion did not engage K11")
    drive("diffusion periodic", solver, solver.initial_state(), 2,
          {"K11": 6})


# --------------------------------------------------------------------- #
# K9 and the ADR paths (phases 20-22)
# --------------------------------------------------------------------- #
# bench.py's adr3d row: the title workload at the diffusion headline's
# grid class, physical (nx, ny, nz) 508x204x160, lengths 12.7 5.1 4,
# velocity 0.5 on every axis, K(x) with eps 0.2, decay 0.25, 404 steps
ADR_N = (508, 204, 160)
ADR_LENGTHS = (12.7, 5.1, 4.0)
ADR_ITERS = 404
ADR_CHECK_ITERS = 10  # steps held hard against the generic path
ADR2D_N = 1001  # bench.py's adr2d row: 1001^2, lengths 20
ADR2D_ITERS = 200
# phase 20: (eps, lambda, velocity per array axis z, y, x, wall value)
K9_CASES = (
    (0.0, 0.0, (0.5, -0.3, 0.0), 0.1),
    (0.2, 0.0, (0.5, -0.3, 0.0), 0.1),
    (0.0, 0.25, (-0.2, 0.4, 0.7), 0.0),
    (0.2, 0.25, (0.5, 0.5, 0.5), 0.0),  # the main path's physics
)


def k9_stage_ops(shape, has_u: bool, eps: float, lam: float,
                 adv_axes: int) -> int:
    """f32 operations of one K9 stage: 15 tap products and 14 sums; per
    advecting axis 2 differences, 2 products and their sum, and the sums
    of the axes; the coefficient (5, or 1 with eps 0) and its product;
    the advective and reaction terms; dt*rhs, v+., b*.; a*u and its sum
    when there is a u."""
    per_cell = (29 + 5 * adv_axes + max(adv_axes - 1, 0)
                + (6 if eps else 1) + (1 if adv_axes else 0)
                + (2 if lam else 0) + 3 + (2 if has_u else 0))
    return math.prod(shape) * per_cell


def adr_rhs_conv3d_ms(spacing, shape, velocity, lam) -> float:
    """Yardstick: conv3d evaluating the constant-coefficient ADR
    right-hand side ``K0 lap(u) - upwind(a) - lambda u`` (K0 = 1) as one
    5x5x5 stencil on a padded float32 state, TF32 off. It computes less
    than K9: no K(x), no RK combine, no masks."""
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros((1, 1, 5, 5, 5), dtype=torch.float64)
    for axis in range(3):
        scale = 1.0 / (12.0 * spacing[axis] ** 2)
        cp = max(velocity[axis], 0.0) / spacing[axis]
        cm = min(velocity[axis], 0.0) / spacing[axis]
        for j, c in enumerate(fd.O4_COEFFS):
            idx = [2, 2, 2]
            idx[axis] = j
            w[(0, 0, *idx)] += c * scale
        for off, c in ((-1, cp), (0, cm - cp), (1, -cm)):
            idx = [2, 2, 2]
            idx[axis] = 2 + off
            w[(0, 0, *idx)] += c
    w[0, 0, 2, 2, 2] -= lam
    w = w.float().cuda()
    x = torch.rand((1, 1) + tuple(n + 4 for n in shape), device="cuda")
    conv = torch.nn.functional.conv3d
    conv(x, w)
    return statistics.median(cuda_ms(lambda: conv(x, w), 10))


def k9_phase(card: str) -> dict:
    """Phase 20: K9 against its twin to the bit, every stage kind, at the
    main path's shape and an odd one, for every case of ``K9_CASES``;
    K9 alone at the main shape (the main physics) for each z-chunk of
    ``ZCHUNKS``, cycling through buffers larger than L2, beside its
    bound, the twin and the conv3d yardstick."""
    print("phase 20: K9 against its twin")
    grid = Grid.make(*ADR_N, lengths=ADR_LENGTHS)
    spacing = grid.spacing
    res = {"err": 0.0, "ms": [], "plain_ms": [], "bound_ms": [],
           "sweep": {z: [] for z in ZCHUNKS}}
    for i, (eps, lam, vel, bc) in enumerate(K9_CASES):
        main = i == len(K9_CASES) - 1
        for shape in (grid.shape, ODD_SHAPE):
            dt = pcfl.advection_diffusion_dt(vel, 1.0 + eps, spacing,
                                              reaction=lam)
            kw = fa.FusedADRStepper(shape, spacing, 1.0, vel, lam, dt, 2, bc,
                                    "cuda", kappa_variation=eps
                                    ).stage_kwargs()
            for kind, (a, b) in enumerate(fd.STAGES):
                has_u = kind > 0
                v = padded_random(shape, bc, 200 + 10 * i + kind)
                u = padded_random(shape, bc, 300 + 10 * i + kind) \
                    if has_u else None
                out = torch.full_like(v, bc)
                ref = out.clone()
                fa.adr_stage_reference(v, u, ref, dt, a=a, b=b, **kw)
                fa.fused_adr_stage(v, u, out, dt, a=a, b=b, **kw)
                torch.cuda.synchronize()
                res["err"] = max(res["err"], exact(
                    f"K9 stage {kind + 1} at {shape}, eps {eps}, lambda "
                    f"{lam}, velocity {vel}, wall {bc}", out, ref))
                if not (main and shape == grid.shape):
                    continue
                buffers = [(v.clone(), None if u is None else u.clone(),
                            out.clone()) for _ in range(ROTATE)]
                for z in ZCHUNKS:
                    res["sweep"][z].append(alone_ms(
                        lambda bufs: fa.fused_adr_stage(
                            bufs[0], bufs[1], bufs[2], dt, a=a, b=b,
                            zchunk=z, **kw), buffers, 21))
                del buffers
                res["ms"].append(res["sweep"][fa.Z_CHUNK][-1])
                res["plain_ms"].append(statistics.median(cuda_ms(
                    lambda: fa.adr_stage_reference(v, u, ref, dt, a=a, b=b,
                                                   **kw), 3)))
                bound, by = kernel_bound(
                    (2 if has_u else 1) * math.prod(shape), math.prod(shape),
                    k9_stage_ops(shape, has_u, eps, lam, 3))
                res["bound_ms"].append(bound)
                res["bound_by"] = by
                gbs = stage_bytes(shape, has_u) / (res["ms"][-1] * 1e-3) / 1e9
                sweep = ", ".join(f"{z}: {res['sweep'][z][-1]:.4f}"
                                  for z in ZCHUNKS)
                print(f"    K9 stage {kind + 1} alone {res['ms'][-1]:.4f} ms"
                      f" ({gbs:.0f} GB/s) at zchunk {fa.Z_CHUNK}; by zchunk "
                      f"{{{sweep}}} ms; twin {res['plain_ms'][-1]:.4f} ms; "
                      f"bound {bound:.4f} ms ({by}) [{card}]")
            del v, u, out, ref
            torch.cuda.empty_cache()
    lib_ms = adr_rhs_conv3d_ms(spacing, grid.shape, (0.5, 0.5, 0.5), 0.25)
    print(f"  conv3d constant-coefficient ADR right-hand side alone, TF32 "
          f"off: {lib_ms:.4f} ms [{card}] (computes less than one K9 stage)")
    return {
        "name": "fused_adr_stage", "id": "K9", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_adr_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_adr.py:69",
        "max_abs_err": res["err"], "max_ulps": 0,
        # per launch alone, mean over the three stage kinds a step launches
        "ms_isolated": statistics.mean(res["ms"]),
        "ms_isolated_by_zchunk": {
            str(z): statistics.mean(res["sweep"][z]) for z in ZCHUNKS},
        "zchunk": fa.Z_CHUNK,
        "plain_ms": statistics.mean(res["plain_ms"]),
        "bound_ms": statistics.mean(res["bound_ms"]),
        "bound_by": res["bound_by"],
        "library_ms": lib_ms,
        "library_call": "torch.nn.functional.conv3d, constant-coefficient "
                        "ADR right-hand side as one stencil (computes less "
                        "than K9)",
    }


def adr_main_phase(card: str, k9: dict) -> dict:
    """Phase 21: the ADR 3-D main path, bench.py's adr3d row built
    through the port's registry: 1,212 K9 launches in ``run(404)``;
    agreement with ``impl="xla"`` (hard after ``ADR_CHECK_ITERS`` steps,
    reported after 404); the max-principle and positivity rules of
    ``diagnostics_spec``; the constant-coefficient variant against
    ``exact_solution``, its error no worse than 1.05x the generic
    path's; ``advance_to`` landing on ``t_end``; ms/step, MLUPS and the
    idle share of a profiled run; the same config on the per-axis rung
    (1,212 K11 launches)."""
    n = ADR_ITERS
    print(f"phase 21: ADR 3-D main path, run({n}) at "
          f"{'x'.join(map(str, ADR_N))}")
    spec = registry.get("adr")
    grid = Grid.make(*ADR_N, lengths=ADR_LENGTHS)
    cfg = spec.bench_build(grid, "float32", "pallas", None)
    solver = spec.solver_cls(cfg)
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "fused-stage" or path["fallback"] is not None:
        raise AssertionError(f"the ADR main path did not engage K9: {path}")
    state0 = solver.initial_state()
    out = drive("ADR 3-D pallas", solver, state0, n, {"K9": 3 * n})
    generic = spec.solver_cls(dataclasses.replace(cfg, impl="xla"))
    if generic.engaged_path()["stepper"] != "generic-xla":
        raise AssertionError("impl='xla' did not run the generic path")
    assert_matches(f"run({ADR_CHECK_ITERS})",
                   solver.run(state0, ADR_CHECK_ITERS).u,
                   generic.run(state0, ADR_CHECK_ITERS).u)
    gout = generic.run(state0, n)
    if out.t != gout.t or out.it != gout.it:
        raise AssertionError(f"t/it differ: {out.t}/{out.it} vs "
                             f"{gout.t}/{gout.it}")
    scale = float(gout.u.abs().max())
    gap = float((out.u - gout.u).abs().max())
    within = bool(((out.u - gout.u).abs()
                   <= 1e-5 * gout.u.abs() + 1e-6 * scale).all())
    print(f"  run({n}) against impl='xla' (reported): max|fused - generic|"
          f" = {gap:.3e} ({gap / scale / EPS32:.2f} eps of max|u| = "
          f"{scale:.4f}); within rtol 1e-5, atol 1e-6 max|u|: {within}")
    base = {"max": float(state0.u.max()), "min": float(state0.u.min())}
    stats = {"max": float(out.u.max()), "min": float(out.u.min())}
    rules = solver.diagnostics_spec()["rules"]
    bad = physics.check_violations(rules, stats, base)
    print(f"  diagnostics rules {[r.name for r in rules]}: initial {base}, "
          f"after run({n}) {stats}; violations {bad}")
    if bad or not all(math.isfinite(x) for x in stats.values()):
        raise AssertionError(f"ADR physics rules broken: {bad}")

    const = spec.solver_cls(dataclasses.replace(cfg, kappa_variation=0.0))
    const_g = spec.solver_cls(dataclasses.replace(cfg, kappa_variation=0.0,
                                                  impl="xla"))
    cnorms = const.error_norms(const.run(state0, n))
    gnorms = const_g.error_norms(const_g.run(state0, n))
    print(f"  eps = 0 against exact_solution after run({n}): fused "
          f"{tuple(cnorms)}, generic {tuple(gnorms)}")
    if not all(math.isfinite(x) and x <= 1.05 * y
               for x, y in zip(cnorms, gnorms)):
        raise AssertionError("the fused eps = 0 run is less accurate than "
                             "1.05x the generic path's")
    del const, const_g

    t_end = float(state0.t) + 4.5 * solver.dt
    reset_counts()
    adv = solver.advance_to(state0, t_end)
    torch.cuda.synchronize()
    adv_launches = counts()["K9"]
    gadv = generic.advance_to(state0, t_end)
    print(f"  advance_to: steps {adv.it} (generic {gadv.it}), K9 launches "
          f"{adv_launches}, t {float(adv.t)!r} vs t_end {t_end!r}")
    if adv.it != 5 or gadv.it != 5 or adv_launches != 15:
        raise AssertionError("advance_to did not take 5 fused steps")
    if abs(float(adv.t) - t_end) > 1e-6 * t_end:
        raise AssertionError("advance_to did not land on t_end")
    assert_matches("advance_to", adv.u, gadv.u)
    del generic, gout, adv, gadv

    total_ms, reps = run_ms(solver, state0, n)
    step_ms = total_ms / n
    mlups = grid.num_cells * n * 3 / (total_ms * 1e-3) / 1e6
    span_ms, busy_ms, per_kernel = retake(
        lambda: device_profile(lambda: solver.run(state0, n)),
        lambda r: sum("adr_stage_kernel<" in k for k in r[2]) == 2)
    # the unsharded instances (<HAS_U, SHARDED>): stage 1, stages 2-3
    s1 = [ms for k, ms in per_kernel.items()
          if "adr_stage_kernel<false, false>" in k]
    s23 = [ms for k, ms in per_kernel.items()
           if "adr_stage_kernel<true, false>" in k]
    if len(s1) != 1 or len(s23) != 1:
        raise AssertionError(f"profiled run missed K9: {list(per_kernel)}")
    in_run_ms = (s1[0] + 2 * s23[0]) / 3
    idle = 1.0 - busy_ms / span_ms
    print(f"  run({n}): median {total_ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]}; {step_ms:.4f} ms/step; "
          f"{mlups:.0f} MLUPS; profiled: span {span_ms:.3f} ms, busy "
          f"{busy_ms:.3f} ms, idle share {idle:.4f}; K9 per launch in the "
          f"run: stage 1 {s1[0]:.4f} ms, stages 2-3 {s23[0]:.4f} ms, mean "
          f"{in_run_ms:.4f} ms [{card}]")
    del solver, out
    torch.cuda.empty_cache()

    print(f"phase 21: the same config on the per-axis rung, run({n})")
    axis = spec.solver_cls(dataclasses.replace(cfg, impl="pallas_axis"))
    aout, _, axis_nums = per_axis_path("ADR 3-D per-axis", axis, n,
                                       {"K11": 3 * n}, card, step_ms)
    gout = spec.solver_cls(dataclasses.replace(cfg, impl="xla")).run(
        state0, n)
    assert_matches(f"run({n}) against impl='xla'", aout.u, gout.u)
    print(f"  equal to the generic path to the bit: "
          f"{bool(torch.equal(aout.u, gout.u))}")
    del axis, aout, gout
    torch.cuda.empty_cache()
    return {**k9, "launches": 3 * n, "ms": in_run_ms,
            "ms_per_step": step_ms, "mlups": mlups,
            "device_idle_share": idle,
            "ms_per_step_pallas_axis": axis_nums["ms_per_step"],
            "reported_gap_404_eps": gap / scale / EPS32,
            "reported_gap_404_within_bounds": within}


def adr2d_phase(card: str) -> None:
    """Phase 22: bench.py's adr2d configuration under ``impl="pallas"``,
    ``run(200)``: the fused rung declines with the JAX package's reason
    and the per-axis rung runs the Laplacian on K11b (600 launches),
    agreeing with ``impl="xla"``."""
    n = ADR2D_ITERS
    print(f"phase 22: ADR 2-D, run({n}) at {ADR2D_N}^2")
    spec = registry.get("adr")
    cfg = spec.bench_build(Grid.make(ADR2D_N, ADR2D_N, lengths=20.0),
                           "float32", "pallas", None)
    solver = spec.solver_cls(cfg)
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if (path["stepper"] != "per-axis-pallas"
            or path["fallback"] != "fused ADR kernel is 3-D only"):
        raise AssertionError(f"ADR 2-D did not engage the per-axis rung: "
                             f"{path}")
    state0 = solver.initial_state()
    out = drive("ADR 2-D pallas", solver, state0, n, {"K11b": 3 * n})
    gout = spec.solver_cls(dataclasses.replace(cfg, impl="xla")).run(
        state0, n)
    assert_matches(f"run({n}) against impl='xla'", out.u, gout.u)
    total_ms, reps = run_ms(solver, state0, n)
    print(f"  run({n}): median {total_ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]}; {total_ms / n:.4f} ms/step "
          f"[{card}]")

# --------------------------------------------------------------------- #
# K2b and the batched ensemble engine (phases 23-27)
# --------------------------------------------------------------------- #
# bench.py's ensemble rows (bench.py:322-397, the on_tpu sizes;
# bench/matrix.py:140-145): diffusion 3-D 256x128x64, lengths 6.4 3.2
# 1.6, K = 1, O4, 60 steps, B = 8 and 64; Burgers 3-D 128x64x64, lengths
# 2, WENO5-JS, nu = 1e-5, fixed dt, 30 steps, B = 8; member i a Gaussian
# of width 0.1 + 0.002 i
ENS_N = (256, 128, 64)
ENS_LENGTHS = (6.4, 3.2, 1.6)
ENS_ITERS = 60
ENS_MEMBERS = (8, 64)
ENSB_N = (128, 64, 64)
ENSB_ITERS = 30
ENSB_MEMBERS = 8
ADR_ENS_MEMBERS = 4
ADR_ENS_ITERS = 20
K_SWEEP_ITERS = 10


def width_sweep(B: int) -> list:
    return [{"ic_params": (("width", 0.1 + 0.002 * i),)} for i in range(B)]


def ens_cfg(family: str, impl: str):
    if family == "diffusion":
        return DiffusionConfig(grid=Grid.make(*ENS_N, lengths=ENS_LENGTHS),
                               diffusivity=1.0, ic="gaussian", impl=impl)
    return BurgersConfig(grid=Grid.make(*ENSB_N, lengths=2.0), nu=1e-5,
                         adaptive_dt=False, impl=impl)


def k2b_twin_phase() -> float:
    """Phase 23: K2b against its twin, 0 ulp; returns the largest
    absolute difference."""
    print("phase 23: K2b against its twin")
    err, B = 0.0, 4
    rng = np.random.default_rng(23)
    shape = (16, 16, 24)
    sp = (0.05, 0.07, 0.09)
    kw = dict(taps=fd.stage_taps(sp, (1.0, 0.5, 2.0)), band=2, bc_value=0.25)
    dt = pcfl.diffusive_dt(2.0, sp)
    S0 = torch.full((B, *(n + 4 for n in shape)), 0.25, device="cuda")
    S0[:, 2:-2, 2:-2, 2:-2] = torch.from_numpy(
        rng.random((B, *shape), dtype=np.float32)).cuda()
    bshape = (8, 8, 24)
    params = fb.stage_params(pflux.burgers(), "js", (2 / 7, 2 / 7, 2 / 23),
                             1e-5)
    U0 = torch.from_numpy(rng.uniform(-0.1, 1.0, (B, *bshape)).astype(
        np.float32)).cuda()
    for steps in (2, 3):
        want = fsr.ping_pong_members(lambda s, d: fds.step_reference(
            s, d, dt, **kw), S0.clone(), S0.clone(), steps)
        got = fsr.slab_run_diffusion_batched(S0.clone(), S0.clone(), steps,
                                             dt, **kw)
        torch.cuda.synchronize()
        err = max(err, exact(f"K2b diffusion, B={B}, {steps} steps at "
                             f"{shape}", got, want))
        want = fsr.ping_pong_members(lambda s, d: fsr.burgers_step_reference(
            s, d, 0.4 * 2 / 23, params=params), U0.clone(), U0.clone(), steps)
        got = fsr.slab_run_burgers_batched(U0.clone(), torch.empty_like(U0),
                                           steps, 0.4 * 2 / 23,
                                           params=params)
        torch.cuda.synchronize()
        err = max(err, exact(f"K2b Burgers, B={B}, {steps} steps at "
                             f"{bshape}", got, want))
    return err


def peak_gb(fn) -> float:
    """``fn()`` and the peak of allocated device memory while it ran (GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def k2b_main_phase(family: str, B: int, iters: int, twin_err: float,
                   card: str) -> dict:
    """Phase 24, one family, at the main size: K2b against its twin on
    the same initial states to 0 ulp (the twin timed once, as it runs),
    every member of K2b equal to the single K2/K6 run of that member to
    the bit; K2b's time a run, its bound, MLUPS*members, peak memory.
    Returns the kernel's entry."""
    es = EnsembleSolver(DiffusionSolver if family == "diffusion"
                        else BurgersSolver, ens_cfg(family, "pallas_slab"),
                        width_sweep(B))
    st = es.solver._fused_stepper()
    if st.engaged_label != "fused-whole-run-slab":
        raise AssertionError(f"{family}: the slab rung did not engage")
    est = es.initial_state()
    cells = es.solver.grid.num_cells
    shape = es.solver.grid.shape
    S0 = st.embed_batched(est.u)
    batched = (fsr.slab_run_diffusion_batched if family == "diffusion"
               else fsr.slab_run_burgers_batched)
    run = lambda A, C: st._whole_run_batched(A, C, iters)  # noqa: E731
    if family == "diffusion":
        step = lambda s, d: fds.step_reference(  # noqa: E731
            s, d, st.dt, taps=st.taps, band=st.band, bc_value=st.bc_value)
        ops = 100 * cells  # K1's 32 + 34 + 34 a cell (check_k1)
    else:
        step = lambda s, d: fsr.burgers_step_reference(  # noqa: E731
            s, d, st.dt, params=st.params)
        ops = k6_step_ops(shape, True, "js")
    got = run(S0.clone(), S0.clone())
    want = []
    plain_ms = cuda_ms(lambda: want.append(fsr.ping_pong_members(
        step, S0.clone(), S0.clone(), iters)), 1)[0]
    err = exact(f"K2b {family}, B={B}, {iters} steps at {shape}", got,
                want.pop())
    for i in range(B):
        single = st._whole_run(S0[i].clone(), S0[i].clone(), iters)
        if ulps(got[i], single) != 0:
            raise AssertionError(f"K2b member {i} differs from its single "
                                 f"run")
    print(f"  K2b {family}: all {B} members equal their single "
          f"{'K2' if family == 'diffusion' else 'K6'} runs to the bit "
          f"({iters} steps at {shape})")
    del got
    A, C = S0.clone(), S0.clone()
    blocks = []
    if family == "diffusion":
        fsr.slab_run_diffusion_batched(A, C, 1, st.dt, taps=st.taps,
                                       band=st.band, bc_value=st.bc_value,
                                       grid_blocks=blocks)
    else:
        fsr.slab_run_burgers_batched(A, C, 1, st.dt, params=st.params,
                                     grid_blocks=blocks)
    reps = cuda_ms(lambda: run(A, C), 4)[1:]
    ms = statistics.median(reps)
    del A, C, S0
    torch.cuda.empty_cache()
    bound, by = run_bound(4 * cells * B, ops * B * iters)
    mlups = cells * B * iters * 3 / (ms * 1e-3) / 1e6
    peak = peak_gb(lambda: es.run(est, iters, donate=False))
    print(f"  K2b {family} alone, B={B}, run({iters}): median {ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]} on {blocks[0]} blocks of "
          f"{352 if family == 'diffusion' else 768}; "
          f"{ms * 1e9 / (cells * B * iters):.1f} ps a member-cell-step; "
          f"{mlups:.0f} MLUPS*members; bound {bound:.3f} ms ({by}); twin "
          f"{plain_ms:.1f} ms; peak memory of the ensemble run "
          f"{peak:.3f} GB [{card}]")
    if family == "diffusion":
        planned = fds.diffusion_zchunk(shape[0], shape[1], shape[2], B,
                                       "cuda", cooperative=True)
        diffusion_schedule_report(
            f"K2b {family}", ms / iters, shape[0], shape, B, blocks[0],
            planned, B * fds.ops_issued(shape, planned), card)
    name = ("slab_run_diffusion_batched" if family == "diffusion"
            else "slab_run_burgers_batched")
    source = ("fused_step_diffusion.cu" if family == "diffusion"
              else "slab_run_burgers.cu")
    return {
        "name": name, "id": "K2b", "route": "cuda",
        "source": f"multigpu_advectiondiffusion_tpu_torch/csrc/{source}",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_slab_run.py:933",
        "launches": None,  # set from the main path's run (phase 25/26)
        # the largest over phase 23's small runs and this main-size run
        "max_abs_err": max(twin_err, err), "max_ulps": 0,
        # per launch: one ensemble run of B members
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "library_call": "none: no PyTorch call computes a batched fused run",
        "members": B, "steps": iters, "grid_blocks": blocks[0],
        "ps_per_member_cell_step": ms * 1e9 / (cells * B * iters),
        "mlups_members": mlups, "peak_gb": peak,
        "counter": batched,
    }


def timed(fn):
    """``fn()`` and its time (ms) from one CUDA event pair."""
    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1)[0]
    return out[0], ms


def ensemble_path(family: str, impl: str, B: int, iters: int, expect: dict,
                  stepper: str, card: str, profile: str | None = None,
                  reps: int = 3) -> dict:
    """One ensemble main path: ``EnsembleSolver.run`` with every count set
    to 0 just before and read just after (``expect`` the launches), each
    member against its looped single run to the bit, MLUPS*members of
    the batched run and of the looped single runs, both warm (every
    solver has run one step first) and each the median of ``reps`` runs
    (or, when ``reps`` is 0, the counted run and the check's loop, each
    timed once), and, when ``profile`` names the kernel, the idle share
    of a profiled run ("not measured" unless a capture saw every
    launch)."""
    es = EnsembleSolver(DiffusionSolver if family == "diffusion"
                        else BurgersSolver, ens_cfg(family, impl),
                        width_sweep(B))
    est = es.initial_state()
    solvers = [es.member_solver(i) for i in range(B)]
    loop = lambda: [s.run(est.member(i), iters)  # noqa: E731
                    for i, s in enumerate(solvers)]
    # the first use of the batch and of every member's solver, untimed
    es.run(est, 1)
    for i, s in enumerate(solvers):
        s.run(est.member(i), 1)
    torch.cuda.synchronize()
    reset_counts()
    out, first_ms = timed(lambda: es.run(est, iters))
    torch.cuda.synchronize()
    got = counts()
    path = es.engaged_path()
    print(f"  {family} {impl} B={B}: engaged {path['stepper']}; launches "
          f"in run({iters}): { {k: v for k, v in got.items() if v} }")
    if path["stepper"] != stepper:
        raise AssertionError(f"{impl}: engaged {path['stepper']}, expected "
                             f"{stepper}")
    if got != {k: expect.get(k, 0) for k in COUNTERS}:
        raise AssertionError(f"{impl}: expected launches {expect}, {got}")
    refs, first_loop_ms = timed(loop)
    for i, ref in enumerate(refs):
        if ulps(out.u[i], ref.u) != 0 or out.t[i] != ref.t:
            raise AssertionError(f"{impl}: member {i} differs from its "
                                 f"looped single run")
    if not bool(torch.isfinite(out.u).all()):
        raise AssertionError(f"{impl}: non-finite members")
    es.check_health(out)
    del out, refs
    cells = es.solver.grid.num_cells
    if reps:
        times = cuda_ms(lambda: es.run(est, iters), reps)
        loop_times = cuda_ms(loop, reps)
    else:
        times, loop_times = [first_ms], [first_loop_ms]
    ms, loop_ms = statistics.median(times), statistics.median(loop_times)
    rate = cells * B * iters * 3 / (ms * 1e-3) / 1e6
    loop_rate = cells * B * iters * 3 / (loop_ms * 1e-3) / 1e6
    res = {"ms": ms, "mlups_members": rate, "looped_ms": loop_ms,
           "looped_mlups_members": loop_rate, "stepper": path["stepper"]}
    line = (f"  {family} {impl} B={B}: run({iters}) median {ms:.3f} ms of "
            f"{[round(r, 3) for r in times]}, {ms / iters:.4f} ms/step, "
            f"{rate:.0f} MLUPS*members; looped single runs median "
            f"{loop_ms:.3f} ms of {[round(r, 3) for r in loop_times]}, "
            f"{loop_rate:.0f} MLUPS*members")
    if profile:
        n = sum(expect.values())
        complete = lambda r: r is not None and r["launches"] == n  # noqa
        prof = retake(lambda: run_profile(lambda: es.run(est, iters),
                                          profile), complete, tries=3)
        if prof is None:
            raise AssertionError(f"{impl}: the profiler saw no device work")
        if complete(prof):
            idle = 1.0 - prof["busy_ms"] / prof["span_ms"]
            line += (f"; profiled: span {prof['span_ms']:.3f} ms, busy "
                     f"{prof['busy_ms']:.3f} ms, idle share {idle:.4f}, "
                     f"{prof['launches']} {profile} launches of "
                     f"{prof['kernel_ms']:.4f} ms")
        else:
            idle = None
            line += (f"; idle share not measured: the last capture saw "
                     f"{prof['launches']} of {n} {profile} launches")
        res.update(idle=idle, profile=prof)
    print(line + f" [{card}]")
    del est, es
    torch.cuda.empty_cache()
    return res


def operand_phase(card: str) -> None:
    """Phase 27: member-varying operands and divergence on the card."""
    print("phase 27: member-varying operands on the card")
    B = 8
    cfg = DiffusionConfig(grid=Grid.make(*ENS_N, lengths=ENS_LENGTHS),
                          impl="pallas")
    members = [{"diffusivity": k} for k in np.linspace(0.5, 2.0, B)]
    es = EnsembleSolver(DiffusionSolver, cfg, members)
    est = es.initial_state()
    reset_counts()
    out = es.run(est, K_SWEEP_ITERS)
    torch.cuda.synchronize()
    path = es.engaged_path()
    print(f"  K sweep 0.5:2, B={B}: engaged {path}; launches "
          f"{ {k: v for k, v in counts().items() if v} }")
    if path["stepper"] != "ensemble-vmap[generic-xla]" or path[
            "operands"] != ["diffusivity"]:
        raise AssertionError(f"the K sweep did not ride the generic rung")
    t0 = float(est.t[0])
    te = [t0 + 0.001 * (1 + i / (B - 1)) for i in range(B)]
    adv = es.advance_to(est, te)
    for i in range(B):
        ref = DiffusionSolver(dataclasses.replace(
            es.member_cfg(i), impl="xla"))
        r = ref.run(est.member(i), K_SWEEP_ITERS)
        if abs(float(out.t[i]) - float(r.t)) > 1e-6 * float(r.t):
            raise AssertionError(f"member {i}: t {out.t[i]} vs {r.t}")
        assert_matches(f"K member {i} run({K_SWEEP_ITERS})", out.u[i], r.u)
        loop = es.member_solver(i).advance_to(est.member(i), te[i])
        if int(adv.it[i]) != loop.it:
            raise AssertionError(f"member {i}: advance_to took "
                                 f"{adv.it[i]} steps, the looped run "
                                 f"{loop.it}")
        if abs(float(adv.t[i]) - te[i]) > 1e-6 * te[i]:
            raise AssertionError(f"member {i} did not land on t_end")
    print(f"  advance_to per-member t_end: steps {adv.it.tolist()} equal "
          f"the looped runs'; t lands on t_end")
    del out, adv, est, es
    torch.cuda.empty_cache()

    grid = Grid.make(*ADR_N, lengths=ADR_LENGTHS)
    acfg = registry.get("adr").bench_build(grid, "float32", "pallas", None)
    members = [{"diffusivity": k, "reaction_rate": r}
               for k, r in ((0.5, 0.0), (0.8, 0.25), (1.2, 0.5),
                            (2.0, 1.0))][:ADR_ENS_MEMBERS]
    es = EnsembleSolver(ADRSolver, acfg, members)
    est = es.initial_state()
    t0 = time.perf_counter()
    out = es.run(est, ADR_ENS_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"  ADR K0/lambda sweep, B={ADR_ENS_MEMBERS} at {grid.shape}: "
          f"engaged {es.engaged_path()['stepper']}, operands "
          f"{es.engaged_path()['operands']}; run({ADR_ENS_ITERS}) "
          f"{secs:.3f} s wall")
    for i in range(ADR_ENS_MEMBERS):
        ref = ADRSolver(dataclasses.replace(es.member_cfg(i), impl="xla"))
        r = ref.run(est.member(i), ADR_ENS_ITERS)
        if abs(float(out.t[i]) - float(r.t)) > 1e-6 * float(r.t):
            raise AssertionError(f"ADR member {i}: t {out.t[i]} vs {r.t}")
        assert_matches(f"ADR member {i} run({ADR_ENS_ITERS})", out.u[i], r.u)
    rows = es.member_summaries(out)
    if not all(r["min"] >= -1e-6 and math.isfinite(r["max"]) for r in rows):
        raise AssertionError(f"ADR members left positivity: {rows}")
    del out, est, es
    torch.cuda.empty_cache()

    es = EnsembleSolver(DiffusionSolver, ens_cfg("diffusion", "pallas_slab"),
                        width_sweep(4))
    est = es.initial_state()
    u = est.u.clone()
    u[2, 32, 64, 128] = float("nan")
    out = es.run(EnsembleState(u=u, t=est.t, it=est.it), 5)
    try:
        es.check_health(out)
    except EnsembleMemberDivergedError as exc:
        if exc.members != [2]:
            raise AssertionError(f"named members {exc.members}, not [2]")
        print(f"  a NaN seeded in member 2: {exc}")
    else:
        raise AssertionError("the NaN member was not named")
    for i in (0, 1, 3):
        ref = es.member_solver(i).run(est.member(i), 5)
        if ulps(out.u[i], ref.u) != 0:
            raise AssertionError(f"member {i} was poisoned")
    del out, est, es, u
    torch.cuda.empty_cache()


def ensemble_phases(card: str) -> list[dict]:
    """Phases 23-27; returns K2b's two entries."""
    err = k2b_twin_phase()
    print("phase 24: K2b against the single K2/K6 run of every member")
    kd = k2b_main_phase("diffusion", max(ENS_MEMBERS), ENS_ITERS, err, card)
    torch.cuda.empty_cache()
    kb = k2b_main_phase("burgers", ENSB_MEMBERS, ENSB_ITERS, err, card)
    torch.cuda.empty_cache()
    print(f"phase 25: the diffusion ensemble, {ENS_N}, run({ENS_ITERS})")
    paths = {}
    for B in ENS_MEMBERS:
        n = ENS_ITERS
        paths["fold", B] = ensemble_path(
            "diffusion", "pallas_slab", B, n, {"K2b": 1},
            "ensemble-fold[fused-whole-run-slab]", card)
        paths["vmap", B] = ensemble_path(
            "diffusion", "pallas", B, n, {"K1": 3 * B * n},
            "ensemble-vmap[fused-stage]", card,
            profile="stage_kernel" if B == max(ENS_MEMBERS) else None)
        paths["generic", B] = ensemble_path(
            "diffusion", "xla", B, n, {}, "ensemble-vmap[generic-xla]", card,
            reps=0)
    print(f"phase 26: the Burgers ensemble, {ENSB_N}, fixed dt, "
          f"run({ENSB_ITERS}), B={ENSB_MEMBERS}")
    bfold = ensemble_path("burgers", "pallas_slab", ENSB_MEMBERS, ENSB_ITERS,
                          {"K2b-burgers": 1},
                          "ensemble-fold[fused-whole-run-slab]", card)
    bvmap = ensemble_path("burgers", "pallas", ENSB_MEMBERS, ENSB_ITERS,
                          {"K5": 3 * ENSB_MEMBERS * ENSB_ITERS},
                          "ensemble-vmap[fused-stage]", card)
    operand_phase(card)
    B = max(ENS_MEMBERS)
    kd.update(launches=1, ensemble_ms={
        f"{rung}_b{b}": paths[rung, b]["ms"] for rung, b in paths},
        ensemble_mlups_members={
            f"{rung}_b{b}": paths[rung, b]["mlups_members"]
            for rung, b in paths},
        looped_mlups_members={
            f"{rung}_b{b}": paths[rung, b]["looped_mlups_members"]
            for rung, b in paths},
        vmap_idle_share=paths["vmap", B].get("idle"))
    kb.update(launches=1, ensemble_ms={"fold_b8": bfold["ms"],
                                       "vmap_b8": bvmap["ms"]},
              ensemble_mlups_members={
                  "fold_b8": bfold["mlups_members"],
                  "vmap_b8": bvmap["mlups_members"]},
              looped_mlups_members={
                  "fold_b8": bfold["looped_mlups_members"],
                  "vmap_b8": bvmap["looped_mlups_members"]})
    for entry in (kd, kb):
        del entry["counter"]
    return [kd, kb]


# --------------------------------------------------------------------- #
# Phases 28-32: the z-slab mesh (two shards on one card) and K3
# --------------------------------------------------------------------- #
MESH_SHARDS = 2
MESH_TIME_ITERS = 20  # the Burgers runs timed: run(20), not run(267)
K3_DEEP = 4  # steps_per_exchange of the deep windows and the k-step path


def two_shards():
    return pmesh.make_mesh({"dz": MESH_SHARDS},
                           devices=[torch.device("cuda:0")] * MESH_SHARDS)


def k3_windows(lz: int, G: int):
    """(name, window, operand, depth) of the main path's K3 calls on a
    shard of lz planes: the per-step window, the split schedule's three
    calls, and the k-step block's first (widest) call with its split
    edge calls, and its last."""
    d, w = K3_DEEP * G, (K3_DEEP - 1) * G
    return [("step", (0, lz), None, G), ("interior", (G, lz - G), None, G),
            ("lo", (0, G), "lo", G), ("hi", (lz - G, lz), "hi", G),
            ("deep j=0", (-w, lz + w), None, d),
            ("deep lo", (-w, G), "lo", d), ("deep hi", (lz - G, lz + w), "hi", d),
            (f"deep j={K3_DEEP - 1}", (0, lz), None, d)]


def k3_check(family: str, shape, step, step_ref, G: int, ring: int,
             fill, card: str) -> dict:
    """K3 against its twin at a main shard's shape, every window of
    :func:`k3_windows` on the first and the last shard of two; times the
    per-step window alone (K3) and its twin. ``step(S, out, **kw)`` /
    ``step_ref`` take the window keywords; ``ring`` is the y/x ghost
    width of the layout, ``fill`` the wall value of its ring (or None)."""
    lz, ny, nx = shape
    gnz = MESH_SHARDS * lz
    rng = np.random.default_rng(28)
    err, n = 0.0, 0
    for name, window, op, depth in k3_windows(lz, G):
        for oz in (0, gnz - lz):
            pshape = (lz + 2 * depth, ny + 2 * ring, nx + 2 * ring)
            S = torch.from_numpy(rng.uniform(
                -0.1, 1.0, pshape).astype(np.float32)).cuda()
            if fill is not None:
                S[:, :ring] = S[:, -ring:] = fill
                S[:, :, :ring] = S[:, :, -ring:] = fill
            # an exchanged operand: other in-domain data, the same ring
            opnd = S[:depth].flip(0).contiguous() if op else None
            kw = dict(global_nz=gnz, oz=oz, depth=depth, window=window,
                      lo=opnd if op == "lo" else None,
                      hi=opnd if op == "hi" else None)
            out0 = torch.zeros_like(S)
            want = step_ref(S, out0.clone(), **kw)
            got = step(S, out0.clone(), **kw)
            torch.cuda.synchronize()
            err = max(err, exact(f"K3 {family} {name} {window} at {shape}, "
                                 f"shard z {oz}", got, want))
            n += 1
            del S, want, got, out0
    torch.cuda.empty_cache()
    pshape = (lz + 2 * G, ny + 2 * ring, nx + 2 * ring)
    bufs = [torch.rand(pshape, device="cuda") for _ in range(3)]
    kw = dict(global_nz=gnz, oz=0, depth=G, window=(0, lz))
    outs = torch.empty_like(bufs[0])
    ms = alone_ms(lambda S: step(S, outs, **kw), bufs, 5)
    plain = statistics.median(cuda_ms(lambda: step_ref(
        bufs[0], outs, **kw), 2))
    del bufs, outs
    torch.cuda.empty_cache()
    print(f"  K3 {family}: {n} windows 0 ulp; alone (per-step window "
          f"{lz} planes) {ms:.4f} ms; twin {plain:.2f} ms [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "windows": n}


def mesh_run(name, solver, one, state0, iters: int, expect: dict,
             label: tuple, card: str, time_iters: int | None = None,
             check=None):
    """One sharded main path: :func:`drive` (every count 0 before, read
    after), the labels, 0 ulp and ``t`` equal to ``one``'s unsharded run,
    and ``check(out)`` when given; then ms/step of both, timed over
    ``time_iters`` (median of 3 after a warm-up, CUDA events; not timed
    when it is 0). Returns the numbers."""
    path = solver.engaged_path()
    got_label = (path["stepper"], path["overlap"],
                 path["steps_per_exchange"])
    print(f"  {name}: engaged {got_label}")
    if got_label != label:
        raise AssertionError(f"{name}: engaged {got_label}, not {label}")
    out = drive(name, solver, state0, iters, expect)
    want = one.run(one_state(one, state0), iters)
    torch.cuda.synchronize()
    n_ulps = ulps(out.u.assemble(), want.u)
    print(f"  {name}: {n_ulps} ulp from the unsharded run, t {out.t!r} vs "
          f"{want.t!r}")
    if n_ulps != 0 or out.t != want.t or out.it != want.it:
        raise AssertionError(f"{name}: differs from the unsharded run")
    if check is not None:
        check(out)
    del out, want
    if time_iters == 0:
        return {}
    n = time_iters or iters
    ms, reps = run_ms(solver, state0, n)
    one0 = one_state(one, state0)
    ms1, reps1 = run_ms(one, one0, n)
    print(f"  {name} run({n}): {ms / n:.4f} ms/step "
          f"({[round(r, 3) for r in reps]} ms); unsharded "
          f"{ms1 / n:.4f} ms/step ({[round(r, 3) for r in reps1]}); "
          f"x{ms / ms1:.2f} [{card}]")
    return {"ms_per_step": ms / n, "unsharded_ms_per_step": ms1 / n}


def one_state(one, state0):
    """The sharded state ``state0`` gathered for the unsharded solver."""
    return type(state0)(u=state0.u.assemble(), t=state0.t, it=state0.it)


def halo_ms(solver, state0, reps: int = 50) -> float:
    """The engaged fused stepper's exchange alone, ms per exchange of both
    shards (CUDA events around ``reps`` of them): the ghost refresh, or
    under the split schedule the two z slabs exchanged on the exchange
    stream and joined to the compute stream."""
    fused = solver._fused_stepper()

    def body(u):
        refresh, _, exch = solver._fused_sharded_ctx(fused)
        S = fused.embed(u)
        for _ in range(reps):
            if exch is not None:
                pmesh.wait_exchange(*exch(S))
            else:
                refresh(S)
        return (u,)

    f = pmesh.shard_map(body, solver.mesh, (solver.decomp,),
                        (solver.decomp,))
    f(state0.u)
    return statistics.median(cuda_ms(lambda: f(state0.u), 3)) / reps


def mesh_phases(card: str) -> list[dict]:
    """Phases 28-32; returns K3's two entries (diffusion, Burgers)."""
    print("phase 28: K3 against its twin at the main shards' shapes")
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    dcfg = DiffusionConfig(grid=grid, dtype="float32", impl="pallas")
    one = DiffusionSolver(dcfg)
    taps = fd.stage_taps(grid.spacing, [dcfg.diffusivity] * 3)
    dkw = dict(taps=taps, band=dcfg.boundary_band, bc_value=0.0)
    lz = grid.shape[0] // MESH_SHARDS
    dshape = (lz,) + grid.shape[1:]
    G = fsr.SlabRunDiffusionStepper.halo
    k3d = k3_check(
        "diffusion", dshape,
        lambda S, o, **kw: fsr.slab_step_diffusion(S, o, one.dt, **dkw, **kw),
        lambda S, o, **kw: fsr.slab_step_diffusion_reference(
            S, o, one.dt, **dkw, **kw), G, fd.R, 0.0, card)
    # a K3 launch is a plain grid of one block a job, two resident an SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = fds.diffusion_zchunk(lz, *grid.shape[1:], 1, "cuda")
    diffusion_schedule_report(
        "K3 diffusion alone (one shard's step)", k3d["ms"], lz, dshape, 1,
        fds.BLOCKS_PER_SM * sms, planned,
        fds.ops_issued((MESH_SHARDS * lz,) + grid.shape[1:], planned,
                       (0, lz)), card,
        grid=" (two an SM; the launch: one block a job)")
    bgrid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    bcfg = BurgersConfig(grid=bgrid, cfl=K6_CFL, adaptive_dt=False,
                         dtype="float32", impl="pallas_slab")
    bone = BurgersSolver(bcfg)
    params = fb.stage_params(bone.flux, bcfg.weno_variant, bgrid.spacing,
                             bcfg.nu)
    blz = bgrid.shape[0] // MESH_SHARDS
    bshape = (blz,) + bgrid.shape[1:]
    BG = fsr.SlabRunBurgersStepper.halo
    k3b = k3_check(
        "burgers", bshape,
        lambda S, o, **kw: fsr.slab_step_burgers(S, o, bone.dt,
                                                 params=params, **kw),
        lambda S, o, **kw: fsr.slab_step_burgers_reference(
            S, o, bone.dt, params=params, **kw), BG, 0, None, card)
    # a K3 launch is a plain grid of one block a job, resident one an SM
    schedule_report(
        "K3 burgers alone (one shard's step)", k3b["ms"], blz, bshape, 1,
        sms, k6_step_ops(bshape, False, bcfg.weno_variant), card,
        grid=" (one an SM; the launch: one block a job)")

    print(f"phase 29: MultiGPU/Diffusion3d_Baseline on {{'dz': 2}} "
          f"(cuda:0 twice), run({ITERS}) at {grid.shape}")
    mesh = two_shards()
    runs = {}
    for name, kw, plain, expect, label in (
            ("K1 serialized", {}, "pallas_stage", {"K1": 6 * ITERS},
             ("fused-stage", "serialized-refresh", 1)),
            ("K1 split", {"overlap": "split"}, "pallas_stage",
             {"K1": 18 * ITERS}, ("fused-stage", "split", 1)),
            ("K3", {"impl": "pallas_slab"}, "pallas_slab",
             {"K3": 2 * ITERS}, ("fused-whole-run-slab",
                                 "serialized-refresh", 1)),
            (f"K3 k={K3_DEEP}", {"impl": "pallas_slab",
                                 "steps_per_exchange": K3_DEEP},
             "pallas_slab", {"K3": 2 * ITERS},
             ("fused-whole-run-slab", "serialized-refresh", K3_DEEP))):
        cfg = dataclasses.replace(dcfg, **kw)
        solver = DiffusionSolver(cfg, mesh=mesh,
                                 decomp=pmesh.Decomposition.slab("dz"))
        plain_solver = DiffusionSolver(dataclasses.replace(
            dcfg, impl=plain))
        state0 = solver.initial_state()
        runs[name] = mesh_run(name, solver, plain_solver, state0, ITERS,
                              expect, label, card)
        if name in ("K1 serialized", "K1 split", "K3"):
            runs[name]["halo_ms"] = halo_ms(solver, state0)
            what = ("z-slab exchange" if name == "K1 split"
                    else "ghost refresh")
            print(f"  {name}: one {what} of both shards alone "
                  f"{runs[name]['halo_ms']:.4f} ms [{card}]")
        if name in ("K1 serialized", "K1 split"):
            prof = run_profile(lambda: solver.run(state0, ITERS),
                               "stage_kernel")
            if prof:
                runs[name]["device_idle_share"] = 1 - (
                    prof["busy_ms"] / prof["span_ms"])
                print(f"  {name}: profiled idle share "
                      f"{runs[name]['device_idle_share']:.4f}, K1 "
                      f"{prof['kernel_ms']:.4f} ms a launch [{card}]")
        del solver, plain_solver, state0
        torch.cuda.empty_cache()

    print(f"phase 30: MultiGPU/Burgers3d_Baseline on {{'dz': 2}}, fixed dt, "
          f"run({K6_ITERS}) at {bgrid.shape}")
    for name, impl, plain, expect, label in (
            ("K5", "pallas", "pallas_stage", {"K5": 6 * K6_ITERS},
             ("fused-stage", "serialized-refresh", 1)),
            ("K3 burgers", "pallas_slab", "pallas_slab",
             {"K3-burgers": 2 * K6_ITERS},
             ("fused-whole-run-slab", "serialized-refresh", 1))):
        solver = BurgersSolver(dataclasses.replace(bcfg, impl=impl),
                               mesh=mesh)
        plain_solver = BurgersSolver(dataclasses.replace(bcfg, impl=plain))
        state0 = solver.initial_state()
        runs[name] = mesh_run(name, solver, plain_solver, state0, K6_ITERS,
                              expect, label, card,
                              time_iters=MESH_TIME_ITERS)
        del solver, plain_solver, state0
        torch.cuda.empty_cache()

    print(f"phase 31: adaptive Burgers {BURGERS_N}^3 on {{'dz': 2}}, "
          f"run({BURGERS_ITERS}) on K5")
    agrid = Grid.make(BURGERS_N, BURGERS_N, BURGERS_N, lengths=2.0)
    acfg = BurgersConfig(grid=agrid, nu=BURGERS_NU, dtype="float32",
                         impl="pallas")
    solver = BurgersSolver(acfg, mesh=mesh)
    plain_solver = BurgersSolver(acfg)
    state0 = solver.initial_state()
    runs["K5 adaptive"] = mesh_run(
        "K5 adaptive", solver, plain_solver, state0, BURGERS_ITERS,
        {"K5": 6 * BURGERS_ITERS}, ("fused-stage", "serialized-refresh", 1),
        card, time_iters=MESH_TIME_ITERS)
    reads = count_reads(lambda: solver.run(state0, BURGERS_ITERS))
    prof = run_profile(lambda: solver.run(state0, BURGERS_ITERS),
                       "stage_kernel")
    dtoh = None if prof is None else prof["dtoh"]
    print(f"  K5 adaptive: host reads of device scalars {reads}, "
          f"device-to-host copies {dtoh} in a profiled run [{card}]")
    if reads > 1 or (dtoh is not None and dtoh > 1):
        raise AssertionError("the sharded adaptive run read dt back")
    del solver, plain_solver, state0
    torch.cuda.empty_cache()

    print("phase 32: the generic and per-axis rungs on {'dz': 2}, 10 steps")
    for family, cfg, impls in (
            ("diffusion", dcfg, (("xla", {}), ("pallas_axis",
                                               {"K11": 6 * 10}))),
            ("burgers", bcfg, (("xla", {}), ("pallas_axis",
                                             {"K12": 18 * 10})))):
        cls = DiffusionSolver if family == "diffusion" else BurgersSolver
        for impl, expect in impls:
            c = dataclasses.replace(cfg, impl=impl)
            solver, plain_solver = cls(c, mesh=mesh), cls(c)
            state0 = solver.initial_state()
            label = ("per-axis-pallas" if impl == "pallas_axis"
                     else "generic-xla", "padded", 1)
            mesh_run(f"{family} {impl}", solver, plain_solver, state0, 10,
                     expect, label, card, time_iters=0)
            del solver, plain_solver, state0
            torch.cuda.empty_cache()

    dw = (lz + 2 * G) * grid.shape[1] * grid.shape[2]
    d_bound, d_by = kernel_bound(dw, math.prod(dshape),
                                 100 * math.prod(dshape))
    bw = (blz + 2 * BG) * bgrid.shape[1] * bgrid.shape[2]
    b_bound, b_by = kernel_bound(bw, math.prod(bshape),
                                 k6_step_ops(bshape, False,
                                             bcfg.weno_variant))
    common = {"id": "K3", "route": "cuda",
              "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                          "fused_slab_run.py:508",
              "library_ms": None,
              "library_call": "none: no single PyTorch call computes an RK "
                              "step"}
    return [{
        **common, "name": "slab_step_diffusion",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_step_diffusion.cu",
        "launches": 2 * ITERS, "max_abs_err": k3d["max_abs_err"],
        "ms": k3d["ms"], "plain_ms": k3d["plain_ms"], "bound_ms": d_bound,
        "bound_by": d_by, "windows_checked": k3d["windows"],
        "paths": {k: runs[k] for k in ("K1 serialized", "K1 split", "K3",
                                       f"K3 k={K3_DEEP}")},
    }, {
        **common, "name": "slab_step_burgers",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "slab_run_burgers.cu",
        "launches": 2 * K6_ITERS, "max_abs_err": k3b["max_abs_err"],
        "ms": k3b["ms"], "plain_ms": k3b["plain_ms"], "bound_ms": b_bound,
        "bound_by": b_by, "windows_checked": k3b["windows"],
        "paths": {k: runs[k] for k in ("K5", "K3 burgers", "K5 adaptive")},
    }]


# --------------------------------------------------------------------- #
# Phases 33-37: the 2-D mesh (K8, K8b) and ADR on meshes (sharded K9)
# --------------------------------------------------------------------- #
# MultiGPU/Diffusion2d_Baseline and MultiGPU/Burgers2d_Baseline
# (examples/multigpu_{diffusion,burgers}2d.sh): 400^2, lengths 2, two
# ranks (dy=2); diffusion K = 1, --iters 1000; Burgers CFL 0.4, fixed
# dt, --t-end 0.4
MESH2D_N = 400
MESH2D_DIFF_ITERS = 1000
MESH2D_BURGERS_ITERS = 200
MESH2D_TIME_ITERS = 200  # the runs timed: run(200)
MESH2D_T_END = 0.4
# u held to the JAX suite's fused-against-generic bound before the
# shock (t ~ 0.37, phase 10's note); at t_end the gap is reported
MESH2D_T_CHECK = 0.2
K8_ODD = (23, 37)  # an odd shard interior (ly, lx)
PENCIL_ITERS = 100


def k8_families(spacing) -> dict:
    """The stage configurations phase 33 holds: diffusion (the main
    path's), Burgers WENO5-JS inviscid (the main path's) and WENO5-Z
    viscous."""
    return {
        "diffusion": fsh.DiffusionParams(
            fd.stage_taps(spacing, (1.0, 1.0)), 2, 0.0),
        "burgers-js": fb.stage_params(pflux.get("burgers"), "js", spacing,
                                      0.0),
        "burgers-z-viscous": fb.stage_params(pflux.get("burgers"), "z",
                                             spacing, BURGERS_NU),
    }


def k8_shards(shape) -> dict:
    """(offsets, global shape) of the shards held: the first, a middle
    and the last of ``dy = 4``, and a corner of a ``dy x dx`` pencil."""
    ly, lx = shape
    g4 = (4 * ly, lx)
    return {"dy4 first": ((0, 0), g4), "dy4 middle": ((ly, 0), g4),
            "dy4 last": ((3 * ly, 0), g4),
            "pencil corner": ((ly, lx), (2 * ly, 2 * lx))}


def k8_stage_ops(params, cells: int) -> int:
    """f32 operations of one stage with ``u`` (stages 2-3): diffusion 24
    a cell; Burgers each face once as in K7's note, split 6, 103 an axis
    (WENO5-Z 113), the sum and negation 2, the viscous taps 20, the
    combine 5."""
    if isinstance(params, fsh.DiffusionParams):
        return 24 * cells
    per_axis = 103 + (10 if params.variant == "z" else 0)
    viscous = 20 if params.lap_taps is not None else 0
    return (6 + 2 * per_axis + 2 + viscous + 5) * cells


def k8_check(family, params, shape, dt, rng) -> tuple[int, float]:
    """K8 (every stage kind) and K8b (every band, stage 2) against their
    twin on every shard of :func:`k8_shards`, 0 ulp, Burgers' emitted
    maximum exact; returns the count of checks and the largest
    difference."""
    h = fsh.halo_of(params)
    ly, lx = shape
    padded = (ly + 2 * h, lx + 2 * h)
    burgers = family != "diffusion"
    n, err = 0, 0.0
    for shard, (offs, gshape) in k8_shards(shape).items():
        v, u, out0 = (random_on_card(padded, int(rng.integers(1 << 30)))
                      for _ in range(3))
        calls = [("K8", (a, b), kind, None, None)
                 for kind, (a, b) in enumerate(fd.STAGES)]
        calls += [("K8b", fd.STAGES[1], 1, rows, op)
                  for rows, op in fsh.split_bands(ly, h)]
        for kernel, (a, b), kind, rows, op in calls:
            ops = {}
            if op is not None:
                ops[op] = random_on_card((h, padded[1]),
                                         int(rng.integers(1 << 30)))
            u_arg = None if kind == 0 else u
            kw = dict(params=params, a=a, b=b, global_shape=gshape)
            ref = fsh.stage_reference(v, u_arg, out0.clone(), dt, offs,
                                      window=rows, emit=burgers, **ops, **kw)
            got = out0.clone()
            mx = torch.zeros((), device="cuda") if burgers else None
            if kernel == "K8":
                fsh.fused2d_stage(v, u_arg, got, dt, offs, mx=mx, **kw)
            else:
                fsh.fused2d_band_stage(v, u_arg, got, dt, offs, rows=rows,
                                       mx=mx, **ops, **kw)
            torch.cuda.synchronize()
            want = ref[0] if burgers else ref
            n_ulps = ulps(got, want)
            err = max(err, float((got - want).abs().max()))
            if n_ulps != 0 or (burgers and float(mx) != float(ref[1])):
                raise AssertionError(
                    f"{kernel} {family} {shard} {shape} stage {kind + 1} "
                    f"rows {rows}: {n_ulps} ulp from its twin (max "
                    f"{float(mx) if burgers else None} vs "
                    f"{float(ref[1]) if burgers else None})")
            n += 1
    return n, err


def k8_timing(params, shape, dt, card) -> dict:
    """K8 alone (stage 2) and each K8b band alone at the main shard's
    shape, the first shard of ``dy = 2``, each launch on the next of
    three buffer sets (the state is L2-resident in the main path too);
    the twin; the bounds from this shape."""
    h = fsh.halo_of(params)
    ly, lx = shape
    padded = (ly + 2 * h, lx + 2 * h)
    gshape, offs = (2 * ly, lx), (0, 0)
    burgers = isinstance(params, fb.StageParams)
    sets = [[random_on_card(padded, 330 + 3 * i + j) for j in range(3)]
            for i in range(3)]
    kw = dict(params=params, a=0.75, b=0.25, global_shape=gshape)
    ms = alone_ms(lambda s: fsh.fused2d_stage(s[0], s[1], s[2], dt, offs,
                                              **kw), sets, 20)
    plain = statistics.median(cuda_ms(lambda: fsh.stage_reference(
        sets[0][0], sets[0][1], sets[0][2], dt, offs, **kw), 3))
    in_elems = padded[0] * padded[1] + ly * lx
    bound, by = kernel_bound(in_elems, ly * lx, k8_stage_ops(params, ly * lx))
    bands = {}
    for rows, op in fsh.split_bands(ly, h):
        slab = random_on_card((h, padded[1]), 339)
        ops = {op: slab} if op else {}
        r = rows[1] - rows[0]
        band_ms = alone_ms(
            lambda s, rows=rows, ops=ops: fsh.fused2d_band_stage(
                s[0], s[1], s[2], dt, offs, rows=rows, **ops, **kw),
            sets, 20)
        band_plain = statistics.median(cuda_ms(
            lambda rows=rows, ops=ops: fsh.stage_reference(
                sets[0][0], sets[0][1], sets[0][2], dt, offs, window=rows,
                **ops, **kw), 3))
        b_in = (r + 2 * h) * padded[1] + r * lx
        b_bound, b_by = kernel_bound(b_in, r * lx,
                                     k8_stage_ops(params, r * lx))
        bands[op or "interior"] = {"rows": r, "ms": band_ms,
                                   "plain_ms": band_plain,
                                   "bound_ms": b_bound, "bound_by": b_by}
    family = "burgers" if burgers else "diffusion"
    print(f"  {family} at {shape}: K8 alone {ms:.4f} ms (twin {plain:.3f} "
          f"ms, bound {bound:.5f} ms by {by}); K8b alone "
          + ", ".join(f"{k} {v['ms']:.4f} ms ({v['rows']} rows)"
                      for k, v in bands.items()) + f" [{card}]")
    del sets
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "bands": bands}


def k8_phase(card: str) -> dict:
    """Phase 33: K8 and K8b against their twins at the main shard's shape
    (200x400, a shard of 400^2 on dy=2) and an odd one, every stage kind,
    every band, on the first, a middle and the last shard of dy=4 and a
    pencil's corner; each timed alone beside its bound and twin, and
    ``conv2d`` computing the 2-D Laplacian of the main shard."""
    print("phase 33: K8 and K8b against their twins")
    grid = Grid.make(MESH2D_N, MESH2D_N, lengths=2.0)
    dt_d = np.float32(DiffusionSolver(DiffusionConfig(
        grid=grid, dtype="float32")).dt)
    dt_b = torch.full((), BurgersSolver(BurgersConfig(
        grid=grid, cfl=0.4, adaptive_dt=False, dtype="float32")).dt,
        device="cuda")
    main_shape = (MESH2D_N // 2, MESH2D_N)
    rng = np.random.default_rng(33)
    errs = {}
    for family, params in k8_families(grid.spacing).items():
        dt = dt_d if family == "diffusion" else dt_b
        for shape in (main_shape, K8_ODD):
            n, err = k8_check(family, params, shape, dt, rng)
            errs[family] = max(errs.get(family, 0.0), err)
            print(f"  {family} at {shape}: K8 x3 stage kinds, K8b x3 "
                  f"bands on 4 shards: {n} checks, 0 ulp, max|kernel - "
                  f"twin| {err:.3e}")
        torch.cuda.empty_cache()
    fams = k8_families(grid.spacing)
    timing = {"diffusion": k8_timing(fams["diffusion"], main_shape, dt_d,
                                     card),
              "burgers": k8_timing(fams["burgers-js"], main_shape, dt_b,
                                   card)}
    lib_ms = laplacian_conv2d_ms(grid.spacing, main_shape)
    print(f"  conv2d 9-point Laplacian of the main shard alone, TF32 off: "
          f"{lib_ms:.4f} ms [{card}] (computes less than one K8 stage)")
    return {"timing": timing, "errs": errs, "library_ms": lib_ms}


def dy2_mesh():
    return pmesh.make_mesh({"dy": MESH_SHARDS},
                           devices=[torch.device("cuda:0")] * MESH_SHARDS)


def mesh2d_profile(name, solver, state0, iters: int, kernel: str,
                   card: str) -> dict:
    """The idle share of a profiled ``run(iters)`` and the kernel's mean
    time a launch in it (``None`` where the profiler saw no device
    activity)."""
    prof = run_profile(lambda: solver.run(state0, iters), kernel)
    if prof is None or prof["launches"] == 0:
        print(f"  {name}: the profiler saw no {kernel} launch: idle share "
              f"not measured [{card}]")
        return {"device_idle_share": None, "kernel_ms_in_run": None,
                "dtoh_copies": None}
    idle = 1 - prof["busy_ms"] / prof["span_ms"]
    print(f"  {name}: profiled run({iters}): idle share {idle:.4f}, "
          f"{kernel} {prof['kernel_ms']:.4f} ms a launch "
          f"({prof['launches']} launches), device-to-host copies "
          f"{prof['dtoh']} [{card}]")
    return {"device_idle_share": idle, "kernel_ms_in_run": prof["kernel_ms"],
            "dtoh_copies": prof["dtoh"]}


def diffusion2d_mesh_phase(card: str) -> dict:
    """Phase 34: MultiGPU/Diffusion2d_Baseline on {"dy": 2} (cuda:0
    twice), run(1000), serialized (K8, 6,000 launches) and split (K8b,
    18,000): each 0 ulp from K7's unsharded run(1000), ``t`` equal, the
    error norms against the exact heat kernel finite and at most twice
    the generic path's, as phase 9 holds them (on this grid the heat
    kernel is 0.08 at the walls, which the Dirichlet walls hold at 0, so
    both paths' norms are the walls' mismatch); ms/step over run(200),
    MLUPS, one exchange alone, the idle share."""
    n = MESH2D_DIFF_ITERS
    print(f"phase 34: MultiGPU/Diffusion2d_Baseline on {{'dy': 2}} "
          f"(cuda:0 twice), run({n}) at {MESH2D_N}^2")
    grid = Grid.make(MESH2D_N, MESH2D_N, lengths=2.0)
    cfg = DiffusionConfig(grid=grid, diffusivity=1.0, dtype="float32",
                          impl="pallas")
    one = DiffusionSolver(cfg)
    if one.engaged_path()["stepper"] != "fused-whole-run":
        raise AssertionError("the unsharded oracle did not engage K7")
    generic = DiffusionSolver(dataclasses.replace(cfg, impl="xla"))
    gn = generic.error_norms(generic.run(generic.initial_state(), n))
    del generic
    mesh = dy2_mesh()
    runs = {}
    for name, kw, expect, label, kernel in (
            ("K8 serialized", {}, {"K8": 6 * n},
             ("fused-stage", "serialized-refresh", 1), "diffusion_kernel"),
            ("K8b split", {"overlap": "split"}, {"K8b": 18 * n},
             ("fused-stage", "split", 1), "diffusion_kernel")):
        solver = DiffusionSolver(dataclasses.replace(cfg, **kw), mesh=mesh)
        state0 = solver.initial_state()
        norms = {}

        def check(out, solver=solver, norms=norms, name=name):
            e = solver.error_norms(out)
            norms.update(l1=e.l1, l2=e.l2, linf=e.linf)
            print(f"  {name}: error vs exact at t={float(out.t):.6f}: L1 "
                  f"{e.l1:.4e} L2 {e.l2:.4e} Linf {e.linf:.4e}; generic L1 "
                  f"{gn.l1:.4e} L2 {gn.l2:.4e} Linf {gn.linf:.4e}")
            if not all(math.isfinite(x) and x <= 2 * y
                       for x, y in zip(e, gn)):
                raise AssertionError(f"{name}: error norms out of range")

        r = mesh_run(name, solver, one, state0, n, expect, label, card,
                     time_iters=MESH2D_TIME_ITERS, check=check)
        r.update(errors=norms, launches=sum(expect.values()),
                 mlups=grid.num_cells * 3 / (r["ms_per_step"] * 1e-3) / 1e6,
                 exchange_ms=halo_ms(solver, state0),
                 engaged=list(label))
        r.update(mesh2d_profile(name, solver, state0, 100, kernel, card))
        print(f"  {name}: {r['mlups']:.1f} MLUPS; one "
              f"{'y-slab exchange' if 'split' in name else 'ghost refresh'}"
              f" of both shards alone {r['exchange_ms']:.4f} ms [{card}]")
        runs[name] = r
        del solver, state0
        torch.cuda.empty_cache()
    return runs


def burgers2d_mesh_phase(card: str) -> dict:
    """Phase 35: MultiGPU/Burgers2d_Baseline on {"dy": 2}: fixed dt
    run(200) serialized (K8, 1,200 launches) and split (K8b, 3,600), 0
    ulp from K7's unsharded run(200); the example's advance_to(0.4)
    against the generic rung on the same mesh (the same steps and
    landing ``t``; ``u`` held to the JAX suite's bound at t = 0.2,
    before the shock, and its gap at 0.4 reported); adaptive run(200) 0
    ulp and ``t`` equal to K7a, with at most one device-to-host copy."""
    n = MESH2D_BURGERS_ITERS
    print(f"phase 35: MultiGPU/Burgers2d_Baseline on {{'dy': 2}}, "
          f"run({n}) at {MESH2D_N}^2")
    grid = Grid.make(MESH2D_N, MESH2D_N, lengths=2.0)
    cfg = BurgersConfig(grid=grid, cfl=0.4, adaptive_dt=False,
                        dtype="float32", impl="pallas")
    mesh = dy2_mesh()
    runs = {}
    for name, kw, expect, label in (
            ("K8 serialized", {}, {"K8": 6 * n},
             ("fused-stage", "serialized-refresh", 1)),
            ("K8b split", {"overlap": "split"}, {"K8b": 18 * n},
             ("fused-stage", "split", 1)),
            ("K8 adaptive", {"adaptive_dt": True}, {"K8": 6 * n},
             ("fused-stage", "serialized-refresh", 1))):
        c = dataclasses.replace(cfg, **kw)
        solver = BurgersSolver(c, mesh=mesh)
        one = BurgersSolver(dataclasses.replace(c, overlap="padded"))
        state0 = solver.initial_state()
        r = mesh_run(name, solver, one, state0, n, expect, label, card,
                     time_iters=MESH2D_TIME_ITERS)
        r.update(launches=sum(expect.values()), engaged=list(label),
                 mlups=grid.num_cells * 3 / (r["ms_per_step"] * 1e-3) / 1e6,
                 exchange_ms=halo_ms(solver, state0))
        r.update(mesh2d_profile(name, solver, state0, n, "burgers_kernel",
                                card))
        if name == "K8 adaptive":
            r["host_reads"] = count_reads(lambda: solver.run(state0, n))
            print(f"  {name}: host reads of device scalars "
                  f"{r['host_reads']}, device-to-host copies "
                  f"{r['dtoh_copies']} in a profiled run [{card}]")
            if r["host_reads"] > 1 or (r["dtoh_copies"] or 0) > 1:
                raise AssertionError("the sharded adaptive run read dt back")
        print(f"  {name}: {r['mlups']:.1f} MLUPS; one exchange of both "
              f"shards alone {r['exchange_ms']:.4f} ms [{card}]")
        runs[name] = r
        del solver, one, state0
        torch.cuda.empty_cache()

    fused = BurgersSolver(cfg, mesh=mesh)
    generic = BurgersSolver(dataclasses.replace(cfg, impl="xla"), mesh=mesh)
    if (fused.engaged_path("t_end")["stepper"] != "fused-stage"
            or generic.engaged_path("t_end")["stepper"] != "generic-xla"):
        raise AssertionError("advance_to did not engage K8 / the generic "
                             "rung")
    state0 = fused.initial_state()
    gaps = {}
    for t_end in (MESH2D_T_CHECK, MESH2D_T_END):
        reset_counts()
        got = fused.advance_to(state0, t_end)
        torch.cuda.synchronize()
        launches = counts()["K8"]
        want = generic.advance_to(state0, t_end)
        g, w = got.u.assemble(), want.u.assemble()
        scale = float(w.abs().max())
        gap = float((g - w).abs().max())
        gaps[t_end] = gap / scale
        print(f"  advance_to({t_end}): {got.it} steps ({launches} K8 "
              f"launches), t {got.t!r}; generic {want.it} steps, t "
              f"{want.t!r}; max|fused - generic| {gap:.3e} "
              f"({gap / scale:.3e} of max|u|)")
        if got.it != want.it or got.t != want.t or launches != 6 * got.it:
            raise AssertionError("advance_to: steps or landing t differ")
        if abs(float(got.t) - t_end) > 1e-6 * t_end:
            raise AssertionError("advance_to did not land on t_end")
        if t_end == MESH2D_T_CHECK:
            assert_matches(f"advance_to({t_end}) against impl='xla'", g, w,
                           rtol=2e-5, atol=2e-6)
    runs["advance_to"] = {"steps": int(got.it), "t": float(got.t),
                          "gap_rel_t_check": gaps[MESH2D_T_CHECK],
                          "gap_rel_t_end": gaps[MESH2D_T_END]}
    del fused, generic, state0
    torch.cuda.empty_cache()
    return runs


def pencil_phase(card: str) -> dict:
    """Phase 36: {"dy": 2, "dx": 2}, four shards on the card: both
    families at 400^2, run(100), 0 ulp from K7's unsharded run, 12 K8
    launches a step."""
    n = PENCIL_ITERS
    print(f"phase 36: {{'dy': 2, 'dx': 2}} (cuda:0 four times), run({n}) "
          f"at {MESH2D_N}^2")
    mesh = pmesh.make_mesh({"dy": 2, "dx": 2},
                           devices=[torch.device("cuda:0")] * 4)
    decomp = pmesh.Decomposition.of({0: "dy", 1: "dx"})
    grid = Grid.make(MESH2D_N, MESH2D_N, lengths=2.0)
    runs = {}
    for name, cfg in (
            ("diffusion", DiffusionConfig(grid=grid, dtype="float32",
                                          impl="pallas")),
            ("burgers", BurgersConfig(grid=grid, cfl=0.4, adaptive_dt=False,
                                      dtype="float32", impl="pallas"))):
        cls = DiffusionSolver if name == "diffusion" else BurgersSolver
        solver, one = cls(cfg, mesh=mesh, decomp=decomp), cls(cfg)
        state0 = solver.initial_state()
        runs[name] = mesh_run(f"{name} pencil", solver, one, state0, n,
                              {"K8": 12 * n},
                              ("fused-stage", "serialized-refresh", 1), card)
        del solver, one, state0
        torch.cuda.empty_cache()
    return runs


def adr_mesh_phase(card: str) -> dict:
    """Phase 37: bench.py's adr3d row on {"dz": 2}, run(404) on K9's
    sharded instance (2,424 launches), 0 ulp and ``t`` equal to the
    unsharded K9 run, ms/step; adr2d on {"dy": 2}, the generic and
    per-axis rungs at 10 steps, 0 ulp from unsharded. The adr2d row's
    1001^2 does not divide over two shards (a decomposition takes equal
    blocks, as the JAX package's does): it runs at 1000^2 with its
    spacing (lengths 19.98)."""
    n = ADR_ITERS
    print(f"phase 37: ADR on meshes: adr3d {'x'.join(map(str, ADR_N))} on "
          f"{{'dz': 2}}, run({n}); adr2d on {{'dy': 2}}")
    spec = registry.get("adr")
    cfg = spec.bench_build(Grid.make(*ADR_N, lengths=ADR_LENGTHS),
                           "float32", "pallas", None)
    solver, one = spec.solver_cls(cfg, mesh=two_shards()), spec.solver_cls(
        cfg)
    state0 = solver.initial_state()
    runs = {"K9 sharded": mesh_run(
        "ADR 3-D K9 sharded", solver, one, state0, n, {"K9": 6 * n},
        ("fused-stage", "serialized-refresh", 1), card, time_iters=100)}
    runs["K9 sharded"]["launches"] = 6 * n
    del solver, one, state0
    torch.cuda.empty_cache()
    n2 = ADR2D_N - ADR2D_N % MESH_SHARDS
    length = 20.0 * (n2 - 1) / (ADR2D_N - 1)
    cfg2 = spec.bench_build(Grid.make(n2, n2, lengths=length), "float32",
                            "pallas", None)
    for impl, expect, label in (
            ("xla", {}, ("generic-xla", "padded", 1)),
            ("pallas_axis", {"K11b": 6 * 10},
             ("per-axis-pallas", "padded", 1))):
        c = dataclasses.replace(cfg2, impl=impl)
        solver, one = spec.solver_cls(c, mesh=dy2_mesh()), spec.solver_cls(c)
        mesh_run(f"ADR 2-D {impl}", solver, one, solver.initial_state(), 10,
                 expect, label, card, time_iters=0)
        del solver, one
        torch.cuda.empty_cache()
    return runs


def mesh2d_entries(k8: dict, diff: dict, burg: dict) -> list[dict]:
    """The kernels line's K8 and K8b entries, a family each: ``ms`` a
    launch in the main path's profiled run (K8b: the mean over its three
    bands' launches), else alone at the main shard's shape (launched
    alone from Python, a launch is bound by the wrapper's host time:
    ``ms_isolated``); launches from the main paths' runs (phases 34,
    35)."""
    common = {"route": "cuda",
              "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                        "fused2d_sharded.cu"}
    out = []
    for family, paths, lib in (("diffusion", diff, k8["library_ms"]),
                               ("burgers", burg, None)):
        t = k8["timing"][family]
        err = max(v for k, v in k8["errs"].items()
                  if k.startswith(family))
        bands = list(t["bands"].values())
        serial = paths["K8 serialized"]
        split = paths["K8b split"]
        lib_kw = {"library_ms": lib, "library_call": (
            "torch.nn.functional.conv2d, 9-point Laplacian only (computes "
            "less than K8)" if lib is not None else
            "none: no single PyTorch call computes a WENO stage")}
        out.append({
            **common, "id": "K8", "name": f"fused2d_stage ({family})",
            "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                        "fused2d_sharded.py:195",
            "launches": serial["launches"], "max_abs_err": err,
            "ms": serial.get("kernel_ms_in_run") or t["ms"],
            "ms_isolated": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], **lib_kw,
            "path": serial})
        out.append({
            **common, "id": "K8b", "name": f"fused2d_band_stage ({family})",
            "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                        "fused2d_sharded.py:231",
            "launches": split["launches"], "max_abs_err": err,
            "ms": split.get("kernel_ms_in_run") or statistics.mean(
                b["ms"] for b in bands),
            "ms_isolated": statistics.mean(b["ms"] for b in bands),
            "plain_ms": statistics.mean(b["plain_ms"] for b in bands),
            "bound_ms": statistics.mean(b["bound_ms"] for b in bands),
            "bound_by": bands[0]["bound_by"], **lib_kw,
            "bands": t["bands"], "path": split})
    return out

# --------------------------------------------------------------------- #
# Phases 38-41: K4, the sharded slab run with the in-kernel exchange
# --------------------------------------------------------------------- #
K4_DEEP = 4  # steps_per_exchange of the deep dma path (phase 39)
K4_P4_N = (400, 200, 208)  # the P = 4 check: a z extent four divides


def k4_buffers(P: int, lz: int, depth: int, ny: int, nx: int, ring: int,
               seed: int):
    """Random shard buffers on the card for a K4 call: P state pairs
    (the y/x ghost ring at the wall value 0 where ``ring``) and landing
    buffers, numpy-seeded."""
    rng = np.random.default_rng(seed)
    shape = (lz + 2 * depth, ny + 2 * ring, nx + 2 * ring)

    def rand(shape):
        return torch.from_numpy(rng.uniform(
            -0.1, 1.0, shape).astype(np.float32)).cuda()

    S0 = [rand(shape) for _ in range(P)]
    if ring:
        for S in S0:
            S[:, :ring] = S[:, -ring:] = 0.0
            S[:, :, :ring] = S[:, :, -ring:] = 0.0
    S1 = [rand(shape) for _ in range(P)]
    lands = [rand((2, 2, depth) + shape[1:]) for _ in range(P)]
    return S0, S1, lands


def k4_check(name, run, step_ref, P, lz, k, G, ny, nx, ring, steps,
             seed) -> float:
    """K4 against its twin (``slab_run_dma_reference`` over K3's twin),
    every state and landing buffer 0 ulp after ``steps`` steps; returns
    the largest absolute difference."""
    depth = k * G
    bufs = k4_buffers(P, lz, depth, ny, nx, ring, seed)
    got = [[t.clone() for t in ts] for ts in bufs]
    run(*got, steps, k)
    want = [[t.clone() for t in ts] for ts in bufs]
    fsr.slab_run_dma_reference(
        lambda S, out, window, oz: step_ref(S, out, P * lz, oz, depth,
                                            window),
        *want, steps, k=k, G=G)
    torch.cuda.synchronize()
    err = 0.0
    for what, a, b in zip(("S0", "S1", "land"), got, want):
        err = max(err, exact(
            f"K4 {name} P={P} lz={lz} k={k} {steps} steps, {what}",
            torch.stack(a), torch.stack(b)))
    del bufs, got, want
    torch.cuda.empty_cache()
    return err


def k4_alone(name, run, step_ref, P, lz, G, ny, nx, ring, steps,
             card) -> dict:
    """K4 alone at a main path's shard shapes, k = 1: ms a step of a
    ``run(steps)`` launch (median of 5 after a warm-up, CUDA events), the
    grid's blocks, and the twin's ms a step (one step)."""
    bufs = k4_buffers(P, lz, G, ny, nx, ring, 38)
    blocks = []
    run(*bufs, 1, 1, grid_blocks=blocks)
    ms = statistics.median(cuda_ms(lambda: run(*bufs, steps, 1), 5)) / steps
    plain = cuda_ms(lambda: fsr.slab_run_dma_reference(
        lambda S, out, window, oz: step_ref(S, out, P * lz, oz, G, window),
        *bufs, 1, k=1, G=G), 1)[0]
    del bufs
    torch.cuda.empty_cache()
    print(f"  K4 {name} alone, P={P} x {lz} planes, run({steps}): "
          f"{ms:.4f} ms a step on {blocks[0]} blocks; twin "
          f"{plain:.2f} ms a step [{card}]")
    return {"ms": ms, "plain_ms": plain, "grid_blocks": blocks[0]}


def dma_bytes(solver, iters: int) -> int:
    """What ``record_remote_dma`` counts for a dma run: every shard's two
    k*G-deep windows of its padded plane, once a block (the JAX
    package's formula)."""
    fused = solver._fused_stepper()
    blocks = -(-iters // fused.k)
    return (solver.mesh.size * 2 * fused.exchange_depth
            * math.prod(fused.padded_shape[1:]) * 4 * blocks)


def dma_path(name, solver, coll, one, state0, iters: int, expect: dict,
             card: str, time_iters: int) -> dict:
    """One dma main path: the labels, :func:`drive` (one K4 launch, every
    other count 0: no K3 launch), no collective halo byte and the dma
    bytes as counted; 0 ulp and ``t`` equal to the collective K3 run on
    the same mesh and to the unsharded run; ms/step of all three over
    ``run(time_iters)`` (median of 3 after a warm-up, CUDA events)."""
    from multigpu_advectiondiffusion_tpu_torch.parallel import halo as phalo

    path = solver.engaged_path()
    k = solver.cfg.steps_per_exchange
    label = (path["stepper"], path["overlap"], path["exchange"],
             path["steps_per_exchange"])
    print(f"  {name}: engaged {label}")
    if label != ("fused-whole-run-slab", "in-kernel", "dma", k):
        raise AssertionError(f"{name}: engaged {label}")
    halo0 = phalo.exchange_ghosts.bytes_per_execution.value
    dma0 = phalo.record_remote_dma.bytes_per_execution.value
    out = drive(name, solver, state0, iters, expect)
    halo = phalo.exchange_ghosts.bytes_per_execution.value - halo0
    dma = phalo.record_remote_dma.bytes_per_execution.value - dma0
    print(f"  {name}: collective halo bytes {halo}, in-kernel exchange "
          f"bytes {dma} (counted {dma_bytes(solver, iters)})")
    if halo != 0 or dma != dma_bytes(solver, iters):
        raise AssertionError(f"{name}: exchange bytes {halo} / {dma}")
    res = {"launches": 1, "dma_bytes": dma}
    for what, ref_solver, ref_state in (
            ("the collective K3 run", coll, state0),
            ("the unsharded run", one, one_state(one, state0))):
        want = ref_solver.run(ref_state, iters)
        got = out.u.assemble()
        want_u = want.u.assemble() if hasattr(want.u, "assemble") else want.u
        torch.cuda.synchronize()
        n_ulps = ulps(got, want_u)
        print(f"  {name}: {n_ulps} ulp from {what}, t {out.t!r} vs "
              f"{want.t!r}")
        if n_ulps != 0 or out.t != want.t or out.it != want.it:
            raise AssertionError(f"{name}: differs from {what}")
        del want, want_u
    del out
    torch.cuda.empty_cache()
    n = time_iters
    for key, s, st in (("ms_per_step", solver, state0),
                       ("k3_ms_per_step", coll, state0),
                       ("unsharded_ms_per_step", one,
                        one_state(one, state0))):
        ms, reps = run_ms(s, st, n)
        res[key] = ms / n
        res[key.replace("ms_per_step", "reps_ms")] = reps
    print(f"  {name} run({n}): {res['ms_per_step']:.4f} ms/step; the "
          f"collective K3 run {res['k3_ms_per_step']:.4f}; unsharded "
          f"{res['unsharded_ms_per_step']:.4f} [{card}]")
    return res


def cli_dma_phase(card: str) -> None:
    """Phase 41: the CLI with ``--exchange dma`` on the card: the summary
    names the in-kernel exchange and one K4 launch."""
    import contextlib
    import io

    from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import (
        main as cli_main,
    )

    argv = ["diffusion3d", "--n", *map(str, REF_N), "--lengths",
            *map(str, REF_LENGTHS), "--iters", str(ITERS), "--mesh", "dz=2",
            "--device", "cuda:0", "--impl", "pallas_slab", "--exchange",
            "dma"]
    print(f"phase 41: the CLI: {' '.join(argv)}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        if any(w in line for w in ("kernel path", "mesh", "launches",
                                   "wall time", "MLUPS")):
            print(f"  {line.strip()}")
    for want in ("overlap=in-kernel", "exchange=dma",
                 "K4 slab_run_dma_diffusion x1"):
        if want not in text:
            raise AssertionError(f"the CLI summary lacks {want!r}")
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    print(f"  the CLI ran the dma rung with one K4 launch [{card}]")


def k4_phases(card: str) -> list[dict]:
    """Phases 38-41; returns K4's two entries (diffusion, Burgers)."""
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    dcfg = DiffusionConfig(grid=grid, dtype="float32", impl="pallas_slab")
    one = DiffusionSolver(dcfg)
    dkw = dict(taps=fd.stage_taps(grid.spacing, [dcfg.diffusivity] * 3),
               band=dcfg.boundary_band, bc_value=0.0)
    G = fsr.SlabRunDiffusionStepper.halo
    nz, ny, nx = grid.shape
    lz = nz // MESH_SHARDS

    def drun(S0, S1, L, steps, k, **kw):
        return fsr.slab_run_dma_diffusion(S0, S1, L, steps, one.dt, k=k,
                                          **dkw, **kw)

    def dref(S, out, gnz, oz, depth, window):
        return fsr.slab_step_diffusion_reference(
            S, out, one.dt, global_nz=gnz, oz=oz, depth=depth,
            window=window, **dkw)

    bgrid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    bcfg = BurgersConfig(grid=bgrid, cfl=K6_CFL, adaptive_dt=False,
                         dtype="float32", impl="pallas_slab")
    bone = BurgersSolver(bcfg)
    BG = fsr.SlabRunBurgersStepper.halo
    bnz, bny, bnx = bgrid.shape
    blz = bnz // MESH_SHARDS
    bparams = {v: fb.stage_params(bone.flux, v, bgrid.spacing, bcfg.nu)
               for v in ("js", "z")}

    def brun(v):
        return lambda S0, S1, L, steps, k, **kw: fsr.slab_run_dma_burgers(
            S0, S1, L, steps, bone.dt, params=bparams[v], k=k, **kw)

    def bref(v):
        return lambda S, out, gnz, oz, depth, window: (
            fsr.slab_step_burgers_reference(
                S, out, bone.dt, params=bparams[v], global_nz=gnz, oz=oz,
                depth=depth, window=window))

    print("phase 38: K4 against its twin at the main shards' shapes")
    err = {"diffusion": 0.0, "burgers": 0.0}
    for k, steps in ((1, 3), (K4_DEEP, 5)):
        err["diffusion"] = max(err["diffusion"], k4_check(
            "diffusion", drun, dref, MESH_SHARDS, lz, k, G, ny, nx, fd.R,
            steps, 38 + k))
    p4 = K4_P4_N[2] // 4
    err["diffusion"] = max(err["diffusion"], k4_check(
        "diffusion", drun, dref, 4, p4, 1, G, K4_P4_N[1], K4_P4_N[0], fd.R,
        3, 384))
    for v in ("js", "z"):
        err["burgers"] = max(err["burgers"], k4_check(
            f"burgers {v}", brun(v), bref(v), MESH_SHARDS, blz, 1, BG, bny,
            bnx, 0, 3, 380))
    err["burgers"] = max(err["burgers"], k4_check(
        "burgers js", brun("js"), bref("js"), MESH_SHARDS, blz, 2, BG, bny,
        bnx, 0, 3, 382))
    d_alone = k4_alone("diffusion", drun, dref, MESH_SHARDS, lz, G, ny, nx,
                       fd.R, ITERS, card)
    planned = fds.diffusion_zchunk(lz, ny, nx, MESH_SHARDS, "cuda",
                                   cooperative=True)
    diffusion_schedule_report(
        "K4 diffusion alone", d_alone["ms"], lz, (lz, ny, nx), MESH_SHARDS,
        d_alone["grid_blocks"], planned,
        sum(fds.ops_issued(grid.shape, planned, (i * lz, (i + 1) * lz))
            for i in range(MESH_SHARDS)), card)
    b_alone = k4_alone("burgers", brun("js"), bref("js"), MESH_SHARDS, blz,
                       BG, bny, bnx, 0, MESH_TIME_ITERS, card)
    schedule_report(
        "K4 burgers alone", b_alone["ms"], blz, bgrid.shape, MESH_SHARDS,
        b_alone["grid_blocks"], k6_step_ops(bgrid.shape, False, "js"), card)

    print(f"phase 39: MultiGPU/Diffusion3d_Baseline on {{'dz': 2}} "
          f"(cuda:0 twice), exchange='dma', run({ITERS}) at {grid.shape}")
    druns = {}
    for k in (1, K4_DEEP):
        cfg = dataclasses.replace(dcfg, steps_per_exchange=k)
        solver = DiffusionSolver(dataclasses.replace(cfg, exchange="dma"),
                                 mesh=two_shards())
        coll = DiffusionSolver(cfg, mesh=two_shards())
        state0 = solver.initial_state()
        druns[f"k={k}"] = dma_path(f"K4 diffusion k={k}", solver, coll, one,
                                   state0, ITERS, {"K4": 1}, card, ITERS)
        del solver, coll, state0
        torch.cuda.empty_cache()

    print(f"phase 40: MultiGPU/Burgers3d_Baseline on {{'dz': 2}}, fixed dt, "
          f"exchange='dma', run({K6_ITERS}) at {bgrid.shape}")
    solver = BurgersSolver(dataclasses.replace(bcfg, exchange="dma"),
                           mesh=two_shards())
    coll = BurgersSolver(bcfg, mesh=two_shards())
    state0 = solver.initial_state()
    bruns = {"k=1": dma_path("K4 burgers", solver, coll, bone, state0,
                             K6_ITERS, {"K4-burgers": 1}, card,
                             MESH_TIME_ITERS)}
    out = solver.run(state0, K6_ITERS)
    u = out.u.assemble()
    lo, hi = float(u.min()), float(u.max())
    print(f"  K4 burgers: u in [{lo!r}, {hi!r}] after run({K6_ITERS})")
    if not (lo >= -1e-6 and hi <= 1.05):
        raise AssertionError(f"u left [-1e-6, 1.05]: [{lo}, {hi}]")
    del solver, coll, state0, out, u
    torch.cuda.empty_cache()

    cli_dma_phase(card)

    d_bound = run_bound(4 * grid.num_cells, 100 * grid.num_cells * ITERS)
    b_bound = run_bound(4 * bgrid.num_cells, K6_ITERS * k6_step_ops(
        bgrid.shape, False, bcfg.weno_variant))
    common = {"id": "K4", "route": "cuda",
              "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                          "fused_slab_run.py:327",
              "launches": 1, "library_ms": None,
              "library_call": "none: no single PyTorch call computes an RK "
                              "step",
              # per step of the main path's run, one launch for the run
              # of every shard: the twin over a whole run would take
              # minutes
              "per": "step"}
    return [{
        **common, "name": "slab_run_dma_diffusion",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_step_diffusion.cu",
        "max_abs_err": err["diffusion"], "ms": d_alone["ms"],
        "plain_ms": d_alone["plain_ms"], "bound_ms": d_bound[0] / ITERS,
        "bound_by": d_bound[1], "grid_blocks": d_alone["grid_blocks"],
        "ms_per_step": druns["k=1"]["ms_per_step"], "paths": druns,
    }, {
        **common, "name": "slab_run_dma_burgers",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "slab_run_burgers.cu",
        "max_abs_err": err["burgers"], "ms": b_alone["ms"],
        "plain_ms": b_alone["plain_ms"], "bound_ms": b_bound[0] / K6_ITERS,
        "bound_by": b_bound[1], "grid_blocks": b_alone["grid_blocks"],
        "ms_per_step": bruns["k=1"]["ms_per_step"], "paths": bruns,
    }]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, capability "
          f"{torch.cuda.get_device_capability(0)}")
    copy_gbs = copy_rate_gbs()
    l2_gbs = l2_copy_rate_gbs()
    print(f"phase 0: device-to-device copy {copy_gbs:.1f} GB/s; L2-resident "
          f"copy (12 MiB) {l2_gbs:.1f} GB/s [{card}]")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    sources = [(fd.SOURCE, ()), (fb.SOURCE, fb.NVCC_EXTRA),
               (fd2.SOURCE, ()), (fb2.SOURCE, fb.NVCC_EXTRA),
               (fds.SOURCE, ()), (fsr.BURGERS_SOURCE, fb.NVCC_EXTRA),
               (klap.SOURCE, ()), (kweno.SOURCE, fb.NVCC_EXTRA),
               (fa.SOURCE, fa.NVCC_EXTRA), (fsh.SOURCE, fsh.NVCC_EXTRA)]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(lambda args: build.build(*args), sources))
    for lib in (fd.library, fb.library, fd2.library, fb2.library,
                fa.library, fsh.library):
        lib()
    print(f"phase 0: built all {len(sources)} kernels in "
          f"{time.perf_counter() - t0:.2f} s (wall, in parallel)")
    for built in builds:
        print(f"  {built.path.name}: nvcc {built.seconds:.2f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    cfg = DiffusionConfig(grid=grid, dtype="float32", impl="pallas")
    solver = DiffusionSolver(cfg)
    taps = fd.stage_taps(grid.spacing, [cfg.diffusivity] * 3)

    print("phase 1: K1 against its twin")
    k1 = check_k1(grid.shape, taps, solver.dt, seed=1, timed=True)
    small = check_k1(ODD_SHAPE, taps, solver.dt, seed=11, timed=False)
    k1_err = max(k1["max_abs_err"], small["max_abs_err"])

    print("phase 2: main path, run()")
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "fused-stage":
        raise AssertionError(f"main path did not engage K1: {path}")
    state0 = solver.initial_state()
    out = drive("pallas", solver, state0, ITERS, {"K1": 3 * ITERS})
    launches = 3 * ITERS
    generic = DiffusionSolver(dataclasses.replace(cfg, impl="xla"))
    if generic.engaged_path()["stepper"] != "generic-xla":
        raise AssertionError("impl='xla' did not run the generic path")
    gout = generic.run(state0, ITERS)
    if out.t != gout.t or out.it != gout.it:
        raise AssertionError(f"t/it differ: {out.t}/{out.it} vs "
                             f"{gout.t}/{gout.it}")
    assert_matches(f"run({ITERS})", out.u, gout.u)
    norms = solver.error_norms(out)
    print(f"  error vs exact at t={float(out.t):.6f}: L1 {norms.l1:.4e} "
          f"L2 {norms.l2:.4e} Linf {norms.linf:.4e}")
    if not all(math.isfinite(x) for x in norms) or not norms.linf < 1e-3:
        raise AssertionError(f"error norms out of range: {norms}")
    reps = cuda_ms(lambda: solver.run(state0, ITERS), 4)[1:]  # 1 warm-up
    run_ms = statistics.median(reps)
    step_ms = run_ms / ITERS
    mlups = grid.num_cells * ITERS * 3 / (run_ms * 1e-3) / 1e6
    t0 = time.perf_counter()
    solver.run(state0, ITERS)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(f"  run({ITERS}): median {run_ms:.3f} ms of {len(reps)} reps "
          f"{[round(r, 3) for r in reps]}; {step_ms:.4f} ms/step; "
          f"{mlups:.0f} MLUPS; host enqueue {host_ms:.3f} ms [{card}]")
    # the kernel's two instantiations: stage 1 (no u), stages 2-3 (u)
    span_ms, busy_ms, per_kernel = retake(
        lambda: device_profile(lambda: solver.run(state0, ITERS)),
        lambda r: sum("stage_kernel<" in k for k in r[2]) == 2)
    s1 = [ms for k, ms in per_kernel.items() if "stage_kernel<false" in k]
    s23 = [ms for k, ms in per_kernel.items() if "stage_kernel<true" in k]
    if len(s1) != 1 or len(s23) != 1:
        raise AssertionError(f"profiled run missed K1: {list(per_kernel)}")
    in_run_ms = (s1[0] + 2 * s23[0]) / 3
    in_run_gbs = (stage_bytes(grid.shape, False)
                  + 2 * stage_bytes(grid.shape, True)) / 3 / (
                      in_run_ms * 1e-3) / 1e9
    idle = 1.0 - busy_ms / span_ms
    print(f"  profiled run({ITERS}): device span {span_ms:.3f} ms, busy "
          f"{busy_ms:.3f} ms, idle share {idle:.4f}; K1 per launch in the "
          f"run: stage 1 {s1[0]:.4f} ms, stages 2-3 {s23[0]:.4f} ms, "
          f"mean {in_run_ms:.4f} ms ({in_run_gbs:.0f} GB/s) [{card}]")

    print("phase 3: main path, advance_to()")
    t_end = float(state0.t) + 4.5 * solver.dt
    fd.fused_stage.launches = 0
    adv = solver.advance_to(state0, t_end)
    torch.cuda.synchronize()
    adv_launches = fd.fused_stage.launches
    gadv = generic.advance_to(state0, t_end)
    print(f"  steps {adv.it} (generic {gadv.it}), K1 launches {adv_launches},"
          f" t {float(adv.t)!r} vs t_end {t_end!r}")
    if adv.it != 5 or gadv.it != 5 or adv_launches != 15:
        raise AssertionError("advance_to did not take 5 fused steps")
    if abs(float(adv.t) - t_end) > 1e-6 * t_end:
        raise AssertionError("advance_to did not land on t_end")
    assert_matches("advance_to", adv.u, gadv.u)

    print("phase 4: yardstick (not called by the port)")
    lib_ms = laplacian_conv3d_ms(grid.spacing, grid.shape)
    print(f"  conv3d 13-point Laplacian alone, TF32 off: {lib_ms:.4f} ms "
          f"[{card}] (computes less than one K1 stage)")

    print("phases 5-7: Burgers/WENO5 (K5)")
    k5 = burgers_phases(card)
    torch.cuda.empty_cache()
    print("phases 8-11: the 2-D paths (K7, K7a)")
    k7d = diffusion2d_phases(card, l2_gbs)
    k7b, k7a = burgers2d_phases(card, l2_gbs)
    torch.cuda.empty_cache()
    print("phases 12-15: the 3-D fused-step rungs (K10, K2, K6)")
    k10, k2 = step_phases(card)
    torch.cuda.empty_cache()
    k6 = slab_burgers_phases(card)
    torch.cuda.empty_cache()
    gate_sweep(card)
    torch.cuda.empty_cache()
    print("phases 16-19: the per-axis rung (K11, K11b, K12, K12b)")
    k11, k11b = laplacian_axis_phase(card)
    k12, k12b = weno_axis_phase(card)
    torch.cuda.empty_cache()
    paths = per_axis_phases(card, {
        "diffusion3d": step_ms, "burgers3d": k5["ms_per_step"],
        "burgers3d_baseline": k6["k5_path_ms_per_step"],
        "diffusion2d": k7d["ms_per_step"],
        "burgers2d_fixed": k7b["ms_per_step"],
        "burgers2d_adaptive": k7a["ms_per_step"]})
    torch.cuda.empty_cache()
    repaired_dispatch_phase()
    torch.cuda.empty_cache()
    print("phases 20-22: advection-diffusion-reaction (K9)")
    k9 = adr_main_phase(card, k9_phase(card))
    torch.cuda.empty_cache()
    adr2d_phase(card)
    torch.cuda.empty_cache()
    print("phases 23-27: the batched ensemble engine (K2b)")
    k2b = ensemble_phases(card)
    torch.cuda.empty_cache()
    print("phases 28-32: the z-slab mesh (K3, sharded K1/K5)")
    k3 = mesh_phases(card)
    torch.cuda.empty_cache()
    print("phases 33-37: the 2-D mesh (K8, K8b) and ADR on meshes (sharded "
          "K9)")
    t_mesh2d = time.perf_counter()
    k8 = k8_phase(card)
    torch.cuda.empty_cache()
    mesh2d = mesh2d_entries(k8, diffusion2d_mesh_phase(card),
                            burgers2d_mesh_phase(card))
    pencil = pencil_phase(card)
    k9["sharded_paths"] = adr_mesh_phase(card)
    for entry in mesh2d:
        entry["pencil_path"] = pencil[
            "diffusion" if "diffusion" in entry["name"] else "burgers"]
    print(f"phases 33-37: {time.perf_counter() - t_mesh2d:.1f} s")
    torch.cuda.empty_cache()
    print("phases 38-41: the in-kernel exchange (K4)")
    t_k4 = time.perf_counter()
    k4 = k4_phases(card)
    print(f"phases 38-41: {time.perf_counter() - t_k4:.1f} s")
    # each kernel's main per-axis path: its launches as driven above and
    # "ms", what a launch takes in that path's profiled run (alone where
    # the profiler missed it; the 2-D launches are host-bound alone)
    for entry, path, n_launches, others in (
            (k11, "diffusion3d", 3 * ITERS, ("burgers3d",)),
            (k11b, "diffusion2d", 3 * DIFF2D_ITERS, ()),
            (k12, "burgers3d", 9 * BURGERS_ITERS, ("burgers3d_baseline",)),
            (k12b, "burgers2d_fixed", 6 * BURGERS2D_ITERS,
             ("burgers2d_adaptive",))):
        in_run = (paths[path]["profile"] or {}).get(entry["id"])
        entry.update(
            launches=n_launches, ms_isolated=entry["ms"],
            ms=in_run["ms"] if in_run else entry["ms"],
            ms_per_step=paths[path]["ms_per_step"],
            paths={k: paths[k] for k in (path, *others)})

    kernels = [{
        "name": "fused_diffusion_stage",
        "id": "K1",
        "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_diffusion_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_diffusion.py:85",
        "launches": launches,
        "max_abs_err": k1_err,
        # per launch, mean over the three stage kinds a step launches;
        # "ms" is what a launch takes in the main path's run
        "ms": in_run_ms,
        "plain_ms": statistics.mean(k1["plain_ms"]),
        "bound_ms": statistics.mean(k1["bound_ms"]),
        "bound_by": "bytes",
        "library_ms": lib_ms,
        "library_call": "torch.nn.functional.conv3d, 13-point Laplacian "
                        "only (computes less than K1)",
        "ms_per_step": step_ms,
        "mlups": mlups,
        "ms_isolated": statistics.mean(k1["ms"]),
        "ms_isolated_by_zchunk": {
            str(z): statistics.mean(k1["sweep"][z]) for z in ZCHUNKS},
        "zchunk": fd.Z_CHUNK,
        "device_idle_share": idle,
        "achieved_gbs": in_run_gbs,
        "copy_gbs": copy_gbs,
    }, k5, k7d, k7b, k7a, k10, k2, k6, k11, k11b, k12, k12b, k9, *k2b,
        *k3, *mesh2d, *k4]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
