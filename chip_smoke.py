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
   run, tiles of the grid through shared memory, one exchange a step)
   against its plain twin to the bit (0 ulp): 1, 2 and 5 steps at 1001^2,
   1 and 5 at an odd small shape, 3 (an odd count: the result comes
   back from the second buffer) in one tile and in the planned tiles,
   1 and 3 steps at the largest square ``whole_run.fits_l2`` admits
   (more jobs than blocks), each launch on as many blocks as its plan
   counts; prints the plan (``fused_diffusion2d.diffusion2d_schedule``:
   tiles, jobs, blocks, residency, shared memory, from the card's numbers
   of ``card_limits``) and times it alone for the main path's
   10,000 steps and its floor (the same grid and its one grid-wide
   barrier a step, the body off);
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
17. holds the per-axis WENO kernels (K12, K12b) on unpadded arrays
   against their twin at 0 ulp: every ghost source (edge, periodic,
   Dirichlet, a halo exchange's slabs) x store (div, the running sum,
   its negation) x scheme (WENO5-JS/Z, WENO7-JS) x sweep axis at the
   odd shapes, with the linear and Buckley-Leverett fluxes and forced
   plans too; times each axis alone at 512^3 and 400x400x406 (WENO5-JS
   and, at 512^3, WENO7-JS) and 400^2, with and without the sum, beside
   its bound and the twin, and sweeps the chunks and row segments;
18. holds five per-axis Burgers runs (64^3 and 400^2, every ghost rule,
   both orders, ``run(20)``) to the bit against the same runs with
   K12/K12b's twin composition in place of every launch; then drives the
   six per-axis paths (``impl="pallas_axis"``): diffusion
   3-D ``run(101)`` (303 K11 launches), Burgers 512^3 adaptive
   ``run(86)`` (774 K12, 258 K11), ``MultiGPU/Burgers3d_Baseline``
   ``run(267)`` (2,403 K12), diffusion 1001^2 ``run(10000)`` (30,000
   K11b; timed over ``run(1000)``) and Burgers 400^2 ``run(200)`` at
   fixed and adaptive dt (1,200 K12b each); each against ``impl="xla"``
   at the bounds of phases 2 and 6, diffusion's error norms, Burgers' u
   inside [-1e-6, 1.05]; ms/step beside the fused path's, MLUPS, the
   idle share, device-to-host copies and the device kernels a step, by
   name, of a profiled run;
19. Burgers 3-D ``impl="pallas_step"`` engages K5, and diffusion with
   periodic walls under ``impl="pallas"`` the per-axis rung (K11);
20. holds the fused ADR stage kernel (K9) against its plain twin to the
   bit, every stage kind, at 508x204x160 and at the odd shape, with eps 0
   and 0.2, lambda 0 and 0.25, mixed-sign velocities and a non-zero wall
   value, and at the odd shape with 3-plane chunks too; prints the plan
   (``fused_adr.adr_schedule``: tile, chunk, blocks, copy widths,
   resident blocks an SM) and times K9 alone at 508x204x160 for each
   z-chunk of ``K9_ZCHUNKS`` and the planned one, beside its bytes bound, its bytes rate against phase 0's
   copy rate, the f32 operations it issues a cell, the twin and
   ``conv3d`` computing the constant-coefficient right-hand side;
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
   shard of ``dy = 4`` and a pencil's corner shard; K8b's paired edge
   bands (one launch) and the stepper's lean entry on its launch plans
   likewise; times K8 and K8b's two launches of a split stage alone at
   the main shard's shape and at 2048x4096 beside their bounds, the twin
   and the host time a lean launch, and ``conv2d`` computing the main
   shard's 2-D Laplacian;
34. drives ``MultiGPU/Diffusion2d_Baseline`` on ``{"dy": 2}`` (400^2,
   lengths 2, K = 1, ``run(1000)``, both shards on ``cuda:0``): K8
   serialized (6,000 launches) and K8b split (12,000), each 0 ulp from
   K7's unsharded ``run(1000)``, ``t`` equal, error norms against the
   exact heat kernel; ms/step over ``run(50)`` beside K7's, MLUPS, one
   exchange of both shards alone, the idle share of a profiled
   ``run(100)`` and the ``engaged_path()`` labels;
35. drives ``MultiGPU/Burgers2d_Baseline`` on ``{"dy": 2}`` (400^2,
   lengths 2, WENO5-JS, inviscid, CFL 0.4): fixed dt ``run(200)`` on K8
   (1,200 launches) and K8b split (2,400), 0 ulp from K7's unsharded
   ``run(200)``; adaptive ``run(200)`` 0 ulp and ``t`` equal to K7a's,
   at most one device-to-host copy; the example's ``advance_to(0.4)``
   and ``advance_to(0.2)`` against the generic rung on the same mesh:
   the same steps and landing ``t``, ``u`` within the JAX suite's bound
   (``rtol 2e-5, atol 2e-6 max|u|``) at 0.2, before the shock, and its
   gap at 0.4, past it, reported; ms/step over ``run(50)``;
36. ``{"dy": 2, "dx": 2}``, four shards on the card: both families at
   400^2, ``run(100)`` on K8 (12 launches a step), 0 ulp from K7's
   unsharded run; ms/step over ``run(25)``;
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
   naming the in-kernel exchange and one K4 launch;
42. holds K5's WENO7-JS instance (reach 4) against its twin for every
   stage kind at 512^3 (nu = 1e-5) and at the odd shape (the Burgers,
   linear and Buckley-Leverett fluxes), ``<= 32 eps`` of max|twin| (the
   ulp count printed), the emitted maximum exactly; prints its tiling
   (checked against ``fused_burgers.tile_geometry(7)``) and times it
   alone at 512^3 beside the twin, its bound and its issued operations;
43. drives the JAX package's ``burgers3d_512_weno7`` row (512^3,
   lengths 2, nu = 1e-5, ``impl="pallas"``) at fixed and at adaptive
   dt, ``run(40)`` each: the engaged stepper (K5), 120 K5 launches, at
   most one device-to-host copy in the profiled adaptive run, u inside
   [-1e-6, 1.05] and agreement with the generic WENO7 path at 10 steps
   (``rtol=2e-5, atol=2e-6 max|u|``); ms/step, MLUPS and K5's time in
   the run;
44. holds K7 and K7a at order 7 against their twin to the bit (``t_sum``
   equal): 1, 2, 3, 5 and 200 steps at the physical 400x408 grid of the
   ``burgers2d_weno7`` row (planned tiles), at 1478^2 reloaded and at
   the odd 2-D shape for each flux, in the planned tiles and in one
   tile; prints the plan;
   times both alone with the floor; drives both ``burgers2d_weno7``
   paths (``run(200)``, one launch each, agreement with the generic
   path at 100 steps); and times K7 at order 7 against the generic path
   at 1001^2 and 1478^2, where the JAX package's VMEM gate runs the
   generic path;
45. holds K6's WENO7-JS instance (24x24 tiles) against its twin to the
   bit at 400x400x406 and at the odd shape; times it alone with its plan
   line; drives a pinned ``impl="pallas_slab"`` run at 400x400x406
   (lengths 2 2 4, inviscid, CFL 0.3, fixed dt, ``run(40)``): one
   launch, u inside [-1e-6, 1.05], agreement with the generic path at
   10 steps;
46. holds K5's WENO7 instance on z-slab shards (4 ghost planes a side)
   against its twin to the bit on the first and the last shard of the
   400x400x406 grid on ``{"dz": 2}``: the serialized call and the split
   schedule's interior, bottom (``lo``) and top (``hi``) calls, the
   emitted maximum folded; times it alone beside its twin and bound;
47. holds K3 and K4 at order 7 (G = 12) against their twins to the bit
   at those shards' shapes: K3 over the per-step, split and k = 4
   windows, K4 at k = 1 and 4; times each alone with its plan line;
48. drives ``MultiGPU/Burgers3d_Baseline`` at WENO order 7 on ``{"dz":
   2}`` (two shards on the card), ``run(40)``: K5 fixed and adaptive,
   serialized and split, K3 at k = 1 and 4, K4 (``exchange="dma"``) at
   k = 1 and 4; each 0 ulp and ``t`` equal to the unsharded run of its
   rung, its launches as driven, u inside [-1e-6, 1.05], ms/step, K5's
   and K3's time a launch in the profiled run;
49. drives a WENO7 ensemble of bench.py's Burgers row (B = 8 at
   128x64x64, ``run(30)``) through one K2b launch, every member equal
   to its single K6 run to the bit; K2b against its twin to the bit and
   alone, timed, with its bound;
50. holds K8 and K8b at order 7 (the shard padded by 4) against their
   twin to the bit at the main shard's shape and an odd one, every
   stage kind and band, the paired edge bands and the lean entry, on
   four shards' positions; times each alone there and at 2048x4096;
   drives ``burgers2d_weno7`` on ``{"dy": 2}`` (K8 and the split
   schedule's K8b, fixed and adaptive dt) and on ``{"dy": 2, "dx":
   2}`` (fixed and adaptive), ``run(200)``, each 0 ulp and ``t`` equal
   to the unsharded K7/K7a run, with its launches, ms/step (over
   ``run(25)``) and K8's time in the profiled run;
51. holds K1's bf16 instance (bf16 buffers, float32 arithmetic, one
   rounding a stage) against its twin to the bit, every stage kind, at
   the main path's shape and at the odd shape with a wall value bf16
   rounds; times it alone beside its bytes bound (4 B a cell at stage 1,
   6 at stages 2-3) and the twin;
52. drives the diffusion main path (400x200x206, ``run(101)``) under
   ``precision="bf16"`` on K1's bf16 instance (``impl="pallas"``, 303
   launches) and K2's (``impl="pallas_slab"``, one launch), and under
   ``dtype="bfloat16"`` (K1's, 303 launches): each equal to its twin run
   on the card to the bit, ``t`` as the float32 path's, its error
   against the exact heat kernel beside the float32 path's, ms/step;
53. float64 storage on the same run: ``impl="pallas"`` (K1, 303
   launches) and ``"pallas_slab"`` (K2, one launch), each equal to the
   float32 kernel run from ``f32(u0)`` after the upcast, ``t`` by the
   JAX package's rules; ms/step beside the float32 run's;
54. holds K2's bf16 instance and K6's at orders 5 and 7 (R = 3, 4)
   against their twins to the bit (400x200x206, bench.py's Burgers
   ensemble grid 128x64x64, and the odd shape); times each alone beside
   its bound and twin; drives that Burgers grid (fixed dt, ``run(30)``)
   under ``precision="bf16"``, ``impl="pallas"`` (one K6 bf16 launch),
   its distance from the float32 K6 run reported; drives
   ``MultiGPU/Burgers3d_Baseline`` (400x400x406, fixed dt) under
   ``precision="bf16"``: ``run(267)`` at order 5 and ``run(40)`` at order
   7, where the port takes the JAX slab's bf16 decline to the carried
   generic loop, held within the JAX package's bf16 band (relative L2
   <= 2e-2) of the float32 K6 run, K6's bf16 instance forced on that
   grid reported beside it;
55. holds K9's bf16 instance against its twin to the bit, every stage
   kind, at 508x204x160 and at odd widths whose row pitch takes 16-, 8-
   and 4-byte and single-value copies; times it alone beside its bytes
   bound and twin; drives bench.py's adr3d row under
   ``precision="bf16"``, ``run(404)``: 1,212 launches, equal to its twin
   run on the card, its distance from the float32 K9 run reported,
   ms/step;
56. one carried generic run (the diffusion grid, ``precision="bf16"``,
   ``impl="pallas_axis"``: the packed loop around K11, 303 launches),
   with the compensation carry and without it, each one's distance from
   the float32 run reported (the carry's must be the smaller);
57. holds the sharded bf16 instances against their twins to the bit:
   K1 (every stage kind on both shards of the diffusion baseline, the
   split roles with bf16 operands, an odd shard whose wall value bf16
   rounds), K3 diffusion (every window, and the odd shard), K3 Burgers
   at orders 5 and 7, K4 (every state and landing buffer; diffusion at
   k = 1 and 4, Burgers at both orders) and K9 (every stage kind on both
   shards of the ADR row); times each alone beside its bound (bf16
   bytes at 2 B a value, or operations) and its twin;
58. drives the diffusion baseline on ``{"dz": 2}`` under
   ``precision="bf16"``, ``run(101)``: the sharded K1 (606 launches;
   split 1,818), K3 (202), K4 (1) and ``dtype="bfloat16"`` on K1, each 0
   ulp from its unsharded bf16 run, ``t`` equal; the halo bytes and K4's
   in-kernel bytes half the float32 paths'; ms/step beside the float32
   mesh paths;
59. Burgers fixed dt on ``{"dz": 2}`` under ``precision="bf16"``,
   ``run(40)``, order 5 at 400x200x206 and order 7 at 200x100x104: K3
   (80 launches) and K4 (1) 0 ulp from the unsharded bf16 run (K6's
   bf16 instance), K4 from the collective run too, u in range, K4's
   bytes halved; ms/step beside the float32 paths;
60. the ADR row on ``{"dz": 2}`` under ``precision="bf16"``,
   ``run(404)``: the sharded K9 (2,424 launches), 0 ulp from the
   unsharded bf16 run; ms/step beside the float32 mesh path;
61. MultiGPU/Burgers3d_Baseline on ``{"dz": 2}`` under
   ``precision="bf16"``, ``run(267)``: JAX's decline to the carried
   per-axis loop (4,806 K12 launches), its halo bytes half the float32
   per-axis path's, within the JAX package's bf16 band (2e-2 relative
   L2) of the float32 K6 run.

It prints the seconds the whole run took, a ``{"kernels": [...]}`` line
and, last,
``{"ok": true, "device": {...}}``. Any failed check raises; without a
GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import json
import math
import re
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
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
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
# the largest square interior whole_run.fits_l2 admits: 3 x 4 x 1478^2 B
L2_MAX_2D = (1474, 1474)
L2_MAX_B2D = (1478, 1478)  # the same for the unpadded Burgers state
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
# steps of the per-axis paths' timed and profiled runs (phases 18, 21),
# run(iters) before the script outgrew its time: their ms/step is
# host-set and does not move with the depth
AXIS_TIME_ITERS = 20
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
            "K4-burgers": fsr.slab_run_dma_burgers,
            "K1-bf16": fd.fused_stage_bf16,
            "K2-bf16": fsr.slab_run_diffusion_bf16,
            "K6-bf16": fsr.slab_run_burgers_bf16,
            "K9-bf16": fa.fused_adr_stage_bf16,
            "K3-bf16": fsr.slab_step_diffusion_bf16,
            "K3-burgers-bf16": fsr.slab_step_burgers_bf16,
            "K4-bf16": fsr.slab_run_dma_diffusion_bf16,
            "K4-burgers-bf16": fsr.slab_run_dma_burgers_bf16,
            "K5-yx": fb.yx_instance}


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
    the twin (its check's call, timed once) and the bound."""
    res = {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound_ms": [],
           "sweep": {z: [] for z in ZCHUNKS}}
    for kind, (a, b) in enumerate(fd.STAGES):
        has_u = kind > 0
        v, u, out = stage_inputs(shape, seed + kind)
        kw = dict(taps=taps, a=a, b=b, band=2, bc_value=0.0)
        ref = out.clone()
        plain = cuda_ms(lambda: fd.stage_reference(
            v, u if has_u else None, ref, dt, **kw), 1)[0]
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
            res["plain_ms"].append(plain)
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
def k5_stage_ops(shape, has_u: bool, viscous: bool, variant: str,
                 order: int = 5) -> int:
    """f32 operations one K5 stage needs with the Burgers flux and each
    face computed once — the count in ``csrc/fused_burgers_stage.cu``'s
    note: split 6, 103 an axis (WENO5-Z 113; WENO7-JS 219), the
    divergences' sum and negation 3, the Laplacian 30, the combine 5
    (stage 1: 3)."""
    per_axis = 219 if order == 7 else 103 + (10 if variant == "z" else 0)
    per_cell = (6 + 3 * per_axis + 3 + (30 if viscous else 0)
                + (5 if has_u else 3))
    return math.prod(shape) * per_cell


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two float32
    (or two bf16) tensors of one shape."""
    bits, mag = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
                 else (torch.int32, 0x7FFFFFFF))

    def ordered(x):
        i = x.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)

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


def check_k5(shape, params, dt, seed: int, timed: bool,
             zchunks=K5_ZCHUNKS) -> dict:
    """Every stage kind once against the twin on random data in
    [-0.1, 1.0) (the last stage in place and emitting max|f'|); when
    ``timed``, also K5 alone at each z-chunk of ``zchunks`` (which holds
    ``fb.Z_CHUNK``), the twin (its check's call, timed once) and the
    bound. The WENO order is ``params.order``."""
    res = {"max_abs_err": 0.0, "ulps": 0, "ms": [], "plain_ms": [],
           "bound_ms": [], "sweep": {z: [] for z in zchunks}}
    w7 = " WENO7" if params.order == 7 else ""
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.rand(shape, generator=g, device="cuda") * 1.1 - 0.1
    u = torch.rand(shape, generator=g, device="cuda") * 1.1 - 0.1
    dt = torch.full((), dt, dtype=torch.float32, device="cuda")
    viscous = params.lap_taps is not None
    for kind, (a, b) in enumerate(fb.STAGES):
        has_u, emit = kind > 0, kind == 2
        kw = dict(params=params, a=a, b=b)
        ref = []
        plain = cuda_ms(lambda: ref.append(fb.stage_reference(
            v, u if has_u else None, torch.empty_like(v), dt, emit=emit,
            **kw)), 1)[0]
        ref = ref[0]
        want, want_max = ref if emit else (ref, None)
        out = u.clone() if emit else torch.empty_like(v)
        mx = torch.full((1,), -1.0, device="cuda") if emit else None
        fb.fused_burgers_stage(v, out if emit else (u if has_u else None),
                               out, dt, mx, **kw)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        rel = err / float(want.abs().max())
        n_ulps = ulps(out, want)
        line = (f"  K5{w7} stage {kind + 1} at {shape} ({params.flux.name}, "
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
            for z in zchunks:
                res["sweep"][z].append(k5_isolated_ms(buffers, z, dt, mx,
                                                      **kw))
            del buffers
            res["ms"].append(res["sweep"][fb.Z_CHUNK][-1])
            res["plain_ms"].append(plain)
            by_bytes = stage_bytes(shape, has_u) / HBM_BYTES_PER_S
            by_ops = k5_stage_ops(shape, has_u, viscous, params.variant,
                                  params.order) / F32_OPS_PER_S
            res["bound_ms"].append(1e3 * max(by_bytes, by_ops))
            res["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
            sweep = ", ".join(f"{z}: {res['sweep'][z][-1]:.4f}"
                              for z in zchunks)
            print(f"    kernel alone {res['ms'][-1]:.4f} ms at zchunk "
                  f"{fb.Z_CHUNK}; by zchunk {{{sweep}}} ms; twin "
                  f"{res['plain_ms'][-1]:.4f} ms; bound "
                  f"{res['bound_ms'][-1]:.4f} ms ({res['bound_by']}: "
                  f"{1e3 * by_ops:.4f} ms of operations, "
                  f"{1e3 * by_bytes:.4f} ms of bytes)")
            issued = fb.ops_issued(shape, fb.Z_CHUNK, has_u=has_u,
                                   viscous=viscous, variant=params.variant,
                                   order=params.order)
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
                   adaptive: bool, order: int = 5) -> int:
    """f32 operations a K7 Burgers run needs with each face computed
    once, the count in ``csrc/whole_run_burgers2d.cu``'s note: split 6,
    103 an axis (WENO5-Z 113; WENO7-JS 219), the divergences' sum and
    negation 2, the Laplacian 20, the combine 5 (stage 1: 3); adaptive
    adds |f'| and its max, 2 a cell."""
    per_axis = 219 if order == 7 else 103 + (10 if variant == "z" else 0)
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


def union_busy_ms(events) -> float:
    """The device's busy time (ms) over ``events``: the union of their
    intervals, so work that overlaps on the streams of a mesh's shards
    counts once."""
    busy, end = 0.0, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3


def run_profile(fn, kernel: str) -> dict | None:
    """Run ``fn`` under ``torch.profiler``: device span and busy time (the
    union of the device intervals), the launches and mean time of kernels
    whose name holds ``kernel``, and the device-to-host copies; ``None``
    when the profiler saw no device activity (the caller then times with
    CUDA events)."""
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
        "busy_ms": union_busy_ms(dev),
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


def diffusion2d_phases(card: str) -> dict:
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
    if not wr.fits_l2([m + 4 for m in L2_MAX_2D]) or wr.fits_l2(
            [m + 5 for m in L2_MAX_2D]):
        raise AssertionError(f"{L2_MAX_2D} is not the largest square the "
                             "L2 gate admits")
    err = 0.0
    # (shape, wall value, seed, steps, tiles)
    cases = [(grid.shape, 0.0, 8, k, None) for k in (1, 2, 5)]
    cases += [(ODD_2D, 0.25, 81, k, None) for k in (1, 3, 5)]
    cases += [(ODD_2D, 0.25, 82, 3, (1, 1)), (L2_MAX_2D, 0.0, 83, 1, None),
              (L2_MAX_2D, 0.0, 83, 3, None)]
    for shape, bc, seed, steps, tiles in cases:
        kw = dict(taps=taps, band=2, bc_value=bc)
        rng = np.random.default_rng(seed)
        S0 = torch.full(tuple(m + 4 for m in shape), bc, device="cuda")
        S0[2:-2, 2:-2] = torch.from_numpy(
            rng.random(shape, dtype=np.float32)).cuda()
        want = wr.plain_run(
            lambda v, u, o, d, a, b: fd2.stage_reference(
                v, u, o, d, a=a, b=b, **kw),
            S0.clone(), S0.clone(), S0.clone(), steps, dt)
        got = S0.clone()
        plan = {}
        fd2.whole_run_diffusion2d(got, S0.clone(), S0.clone(), steps, dt,
                                  tiles=tiles, schedule=plan, **kw)
        torch.cuda.synchronize()
        err = max(err, exact(
            f"K7 diffusion {steps} step(s) at {shape}, {plan['tiles']} "
            f"tiles ({'resident' if plan['resident'] else 'reloaded'})",
            got, want))
        if plan["blocks"] != plan["grid_blocks"]:
            raise AssertionError(
                f"K7 at {shape}: the plan counts {plan['blocks']} blocks, "
                f"the launch ran {plan['grid_blocks']}")
        del S0, want, got
    torch.cuda.empty_cache()
    state0 = solver.initial_state()
    fused = solver._fused_stepper()
    S = fused.embed(state0.u)
    T1, T2 = S.clone(), S.clone()
    kw = dict(taps=taps, band=2, bc_value=0.0)
    plan, blocks = {}, []
    alone = median_ms(lambda: fd2.whole_run_diffusion2d(
        S, T1, T2, iters, dt, schedule=plan, grid_blocks=blocks, **kw))
    floor = median_ms(lambda: fd2.whole_run_diffusion2d(
        S, T1, T2, iters, dt, sync_floor=True, **kw))
    state_bytes = 4 * S.numel()
    bound_ms, bound_by = run_bound(state_bytes,
                                   k7_diffusion_ops(grid.shape, iters))
    plain_S = fused.embed(state0.u)
    plain_ms = cuda_ms(lambda: wr.plain_run(
        lambda v, u, o, d, a, b: fd2.stage_reference(v, u, o, d, a=a, b=b,
                                                     **kw),
        plain_S, T1, T2, iters, dt), 1)[0]
    got = fused.embed(state0.u)
    fd2.whole_run_diffusion2d(got, plain_S.clone(), plain_S.clone(), iters,
                              dt, **kw)
    torch.cuda.synchronize()
    err = max(err, exact(f"K7 diffusion {iters} steps at {grid.shape} (the "
                         "main path's initial state)", got, plain_S))
    del got, plain_S
    plan = {k: plan[k] for k in ("tiles", "tile", "jobs", "blocks",
                                 "resident", "rounds", "patches",
                                 "smem_bytes")}
    print(f"  K7 plan at {n}^2: {plan}; grid {blocks[0]} blocks of "
          f"{fd2.THREADS} threads, one grid.sync() a step; the card's "
          f"numbers it was planned from: {fd2.card_limits('cuda')}")
    print(f"  K7 alone, run({iters}) at {n}^2: {alone:.3f} ms "
          f"({alone / iters * 1e3:.3f} us/step); floor (its barriers, body "
          f"off) {floor:.3f} ms ({floor / iters * 1e3:.3f} us/step); bound "
          f"{bound_ms:.3f} ms ({bound_by}), {2 * bound_ms:.3f} ms at the "
          f"no-FMA rate; twin {plain_ms:.1f} ms [{card}]")
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
        "max_ulps": 0,
        # per run of the main path (10,000 steps, one launch)
        **timing,
        "ms_isolated": alone,
        "floor_ms": floor,
        "plan": plan,
        "grid_blocks": blocks[0],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
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

    def check(shape, params, sp, seed, steps, adapt, tiles=None):
        rng = np.random.default_rng(seed)
        S0 = torch.from_numpy(
            rng.uniform(-0.1, 1.0, shape).astype(np.float32)).cuda()
        T = [torch.empty_like(S0) for _ in range(4)]
        stage = (lambda v, u, o, d, a, b: fb2.stage_reference(
            v, u, o, d, params=params, a=a, b=b))
        got = S0.clone()
        plan = {}
        if adapt:
            _, t_sum = fb2.whole_run_burgers2d(
                got, T[0], T[1], steps, params=params, spacing=sp, cfl=cfl,
                tiles=tiles, schedule=plan)
            df = params.flux.df
            want, want_t = wr.plain_run_adaptive(
                stage, lambda u: pcfl.advective_dt(u, df, sp, cfl),
                S0.clone(), T[2], T[3], steps)
        else:
            fb2.whole_run_burgers2d(got, T[0], T[1], steps, params=params,
                                    dt=cfl * min(sp), tiles=tiles,
                                    schedule=plan)
            want = wr.plain_run(stage, S0.clone(), T[2], T[3], steps,
                                cfl * min(sp))
        torch.cuda.synchronize()
        label = (f"K7{'a' if adapt else ''} {steps} step(s) at {shape} "
                 f"({params.flux.name}, {params.variant}, "
                 f"{'viscous' if params.lap_taps else 'inviscid'}), "
                 f"{plan['tiles']} tiles ("
                 f"{'resident' if plan['resident'] else 'reloaded'})")
        if adapt:
            if float(t_sum) != float(want_t):
                raise AssertionError(f"{label}: t_sum {float(t_sum)!r} vs "
                                     f"twin {float(want_t)!r}")
            label += f", t_sum {float(t_sum)!r} equal"
        if plan["blocks"] != plan["grid_blocks"]:
            raise AssertionError(
                f"{label}: the plan counts {plan['blocks']} blocks, the "
                f"launch ran {plan['grid_blocks']}")
        return exact(label, got, want)

    print("phase 10: K7 (Burgers) and K7a against their twin")
    params = fb.stage_params(fixed.flux, cfg.weno_variant, spacing, cfg.nu)
    if not wr.fits_l2(L2_MAX_B2D) or wr.fits_l2(
            [m + 1 for m in L2_MAX_B2D]):
        raise AssertionError(f"{L2_MAX_B2D} is not the largest square the "
                             "L2 gate admits")
    err = 0.0
    cases = [(grid.shape, params, spacing, 10, 1, False),
             (grid.shape, params, spacing, 11, 5, False),
             (grid.shape, params, spacing, 12, 5, True),
             (grid.shape, params, spacing, 13, 2, True, (20, 20)),
             (L2_MAX_B2D, params, spacing, 14, 1, False),
             (L2_MAX_B2D, params, spacing, 15, 3, True)]
    odd_sp = (0.05, 0.07)
    for i, (name, kw, variant, nu) in enumerate(K7_ODD_CASES):
        p = fb.stage_params(pflux.get(name, **kw), variant, odd_sp, nu)
        cases += [(ODD_2D, p, odd_sp, 100 + i, 5, False),
                  (ODD_2D, p, odd_sp, 200 + i, 5, True),
                  (ODD_2D, p, odd_sp, 300 + i, 3, i % 2 == 1, (1, 1))]
    for case in cases:
        err = max(err, check(*case))
    torch.cuda.empty_cache()

    state0 = fixed.initial_state()
    S = state0.u.clone()
    T1, T2 = torch.empty_like(S), torch.empty_like(S)
    blocks, plan = [], {}
    alone = median_ms(lambda: fb2.whole_run_burgers2d(
        S, T1, T2, iters, params=params, dt=dt, grid_blocks=blocks,
        schedule=plan))
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
    err = max(err, exact(f"K7 {iters} steps at {grid.shape} (the main "
                         "path's initial state)", got, want))
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
    err = max(err, exact(f"K7a {iters} steps at {grid.shape} (the main "
                         f"path's initial state), t_sum {float(t_sum)!r} "
                         "equal", got, want))
    del got, want
    bound = run_bound(4 * S.numel(), k7_burgers_ops(
        grid.shape, iters, False, cfg.weno_variant, False))
    bound_a = run_bound(4 * S.numel(), k7_burgers_ops(
        grid.shape, iters, False, cfg.weno_variant, True))
    l2_ms = 32 * S.numel() * iters / (l2_gbs * 1e9) * 1e3
    plan = {k: plan[k] for k in ("tiles", "tile", "window", "jobs", "blocks",
                                 "resident", "rounds", "smem_bytes")}
    cells = math.prod(grid.shape)
    issued = fb2.ops_issued(*grid.shape, fb2.burgers2d_schedule(
        *grid.shape, **fb2.card_limits("cuda", params, False)),
        viscous=False, variant=cfg.weno_variant, adaptive=False)
    once = k7_burgers_ops(grid.shape, 1, False, cfg.weno_variant, False)
    print(f"  K7 plan at {n}^2: {plan}; grid {blocks[0]} blocks of "
          f"{fb2.THREADS} threads, one grid.sync() a step; the card's "
          f"numbers it was planned from: "
          f"{fb2.card_limits('cuda', params, False)}")
    print(f"  issued f32 operations a step (Burgers flux, inviscid, "
          f"{cfg.weno_variant}): {issued:,} = {issued / (3 * cells):.1f} an "
          f"output cell a stage, against the face-once count's "
          f"{once / (3 * cells):.1f} (219 inviscid, 239 viscous, WENO5-JS "
          f"fixed dt): {issued / once:.3f}x")
    print(f"  alone, run({iters}) at {n}^2: K7 {alone:.3f} ms "
          f"({alone / iters * 1e3:.3f} us/step), K7a {alone_a:.3f} ms "
          f"({alone_a / iters * 1e3:.3f} us/step); floor (its barriers, "
          f"body off) {floor:.3f} ms ({floor / iters * 1e3:.3f} us/step); "
          f"bounds {bound[0]:.4f} / {bound_a[0]:.4f} ms ({bound[1]}); "
          f"through L2 {l2_ms:.4f} ms; twins {plain:.1f} / {plain_a:.1f} "
          f"ms [{card}]")
    del S, T1, T2
    # the largest grid the L2 gate admits: more jobs than blocks
    big = torch.from_numpy(np.random.default_rng(16).uniform(
        0.0, 1.0, L2_MAX_B2D).astype(np.float32)).cuda()
    Tb = [torch.empty_like(big) for _ in range(2)]
    big_plan = {}
    big_ms = median_ms(lambda: fb2.whole_run_burgers2d(
        big, *Tb, iters, params=params, dt=dt, schedule=big_plan))
    big_floor = median_ms(lambda: fb2.whole_run_burgers2d(
        big, *Tb, iters, params=params, dt=dt, sync_floor=True))
    big_plan = {k: big_plan[k] for k in ("tiles", "tile", "jobs",
                                         "grid_blocks", "resident", "rounds",
                                         "smem_bytes")}
    print(f"  K7 alone at {L2_MAX_B2D}, run({iters}): {big_ms:.3f} ms "
          f"({big_ms / iters * 1e3:.3f} us/step), floor {big_floor:.3f} ms; "
          f"plan {big_plan} [{card}]")
    del big, Tb

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
        "max_ulps": 0,
        "grid_blocks": blocks[0],
        "plan": plan,
        "ops_issued_per_cell": issued / (3 * cells),
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
        "ms_isolated_1478": big_ms,
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
    err = float((got.float() - want.float()).abs().max())
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


def k6_step_ops(shape, viscous: bool, variant: str, order: int = 5) -> int:
    """f32 operations one fused Burgers step needs, each face once: K5's
    count (``k5_stage_ops``) for its three stages."""
    return (k5_stage_ops(shape, False, viscous, variant, order)
            + 2 * k5_stage_ops(shape, True, viscous, variant, order))


def schedule_report(name, ms_step: float, window: int, shape, units: int,
                    blocks: int, ops: float, card: str,
                    grid: str = "", order: int = 5) -> None:
    """Print a slab Burgers kernel's schedule and rate: ``blocks``
    resident blocks (``grid`` says what the launch was, where it is not
    those blocks), one step's jobs and waves (jobs a resident block) on
    a ``window``-plane output window of ``units`` tiles' sets (members
    or shards), as ``fused_slab_run.burgers_schedule`` plans them, and
    ``ops`` (the operations of a step, each face once) over ``ms_step``
    against 67 and 33.5 T/s. Reported, not held."""
    plan = fsr.burgers_schedule(window, shape[1], shape[2], blocks,
                                units=units, order=order)
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
# K12/K12b against their twin (phase 17): every ghost source, store and
# scheme on the odd shapes, forced plans on the aligned ones, the other
# fluxes; (flux, kwargs) besides Burgers
K12_GHOSTS = {"edge": Boundary("edge"), "periodic": Boundary("periodic"),
              "dirichlet": Boundary("dirichlet", 0.37), "slabs": None}
K12_STORES = ("div", "sum", "negated-sum")
K12_SCHEMES = ((5, "js"), (5, "z"), (7, "js"))
K12_FLUXES = (("linear", {"c": -0.7}), ("buckley", {}))
K12_ALIGNED = ((23, 29, 40), (23, 40))  # inner a multiple of 4
K12_CHUNKS = (24, 48, 96, 192)  # cells a column thread marches, at 512^3
# split operations a cell by flux (the note in csrc/weno_axis.cu)
SPLIT_OPS = {"burgers": 6, "linear": 7, "buckley": 22}


def lap_ops(shape) -> int:
    """f32 operations of K11/K11b: per axis 5 products and 4 sums, a
    K-product, and the sum of the axes — 32 a cell in 3-D, 21 in 2-D."""
    return math.prod(shape) * (11 * len(shape) - 1)


def weno_ops(shape, flux: str, variant: str, order: int,
             store: str = "div") -> int:
    """f32 operations of one K12 sweep with each split and face computed
    once (the note in csrc/weno_axis.cu): the split, then 103 (WENO5-JS),
    113 (WENO5-Z) or 293 (WENO7) a cell, and the sum (1) and its sign
    (1) of the store."""
    per_axis = {(5, "js"): 103, (5, "z"): 113, (7, "js"): 293}[
        (order, variant)]
    extra = {"div": 0, "sum": 1, "negated-sum": 2}[store]
    return math.prod(shape) * (SPLIT_OPS[flux] + per_axis + extra)


def kernel_bound(in_elems: int, out_elems: int, ops: int, size: int = 4):
    """The least time (ms) of one launch: its input read once and output
    written once (``size`` bytes a value) at the HBM rate, or its
    operations at the f32 rate."""
    by_bytes = size * (in_elems + out_elems) / HBM_BYTES_PER_S
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
    """Phase 17: K12 and K12b on unpadded arrays against their twin
    (``flux_divergence_axis_reference``), every instance at 0 ulp: each
    ghost source (edge, periodic, Dirichlet 0.37, a halo exchange's
    slabs) x store (div, the running sum, its negation) x scheme
    (WENO5-JS/Z, WENO7-JS) x sweep axis on the odd shapes, with the
    linear and Buckley-Leverett fluxes too; forced chunks and segments
    on the aligned shapes; every axis at 512^3
    and 400x400x406 and at 400^2 in 2-D, each timed alone with and
    without the sum beside its bound (the twin once, as its check
    runs); WENO7-JS at 512^3; the column chunks and the last-axis
    segment swept at 512^3."""
    print("phase 17: K12 and K12b against their twin")
    fx = pflux.burgers()
    edge = K12_GHOSTS["edge"]
    res = {nd: {"err": 0.0, "ulps": 0, "instances": 0, "timed": []}
           for nd in (2, 3)}

    def entry(nd):
        return kweno.flux_divergence_3d if nd == 3 else \
            kweno.flux_divergence_2d

    def operands(shape, axis, order, seed):
        slab = list(shape)
        slab[axis] = kweno.HALO[order]
        return (random_on_card(shape, seed),
                random_on_card(shape, seed + 1, -1.0, 1.0),
                (random_on_card(tuple(slab), seed + 2),
                 random_on_card(tuple(slab), seed + 3)))

    def instance(ops, axis, f, variant, order, ghost, store, plan):
        """The kernel against the twin on one instance: the largest
        difference, its ulps and the twin's time (ms, once)."""
        u, acc, slabs = ops
        bc = K12_GHOSTS[ghost]
        src = {"ghosts": slabs} if bc is None else {"bc": bc}
        neg = store == "negated-sum"
        summed = store != "div"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = kweno.flux_divergence_axis_reference(
            u, axis, 0.05, f, variant, order, acc=acc if summed else None,
            negate=neg, **src)
        end.record()
        got = entry(u.dim())(u, axis, 0.05, f, variant, order,
                             acc=acc.clone() if summed else None,
                             negate=neg, **src, **plan)
        torch.cuda.synchronize()
        return (float((got - want).abs().max()), ulps(got, want),
                start.elapsed_time(end))

    def group(shape, axis, cases, seed, ops=None) -> float:
        """``cases`` of (flux, variant, order, ghost, store, plan) at
        ``shape`` along ``axis`` (on ``ops``, one order's operands, where
        given): all must be 0 ulp; returns the twin's last time."""
        nd = len(shape)
        ops = ops or {o: operands(shape, axis, o, seed)
                      for o in {c[2] for c in cases}}
        err, worst, plain = 0.0, 0, 0.0
        for f, variant, order, ghost, store, plan in cases:
            e, n, plain = instance(ops[order], axis, f, variant, order,
                                   ghost, store, plan)
            err, worst = max(err, e), max(worst, n)
            if n != 0:
                raise AssertionError(
                    f"K12 at {shape} axis {axis} ({f.name}, WENO{order}-"
                    f"{variant}, {ghost} ghosts, {store}, plan {plan}): "
                    f"{n} ulp from its twin")
        tag = "K12" if nd == 3 else "K12b"
        print(f"  {tag} at {tuple(shape)} axis {axis}: {len(cases)} "
              f"instances, max|kernel-twin| = {err:.3e}, {worst} ulp")
        r = res[nd]
        r["err"], r["ulps"] = max(r["err"], err), max(r["ulps"], worst)
        r["instances"] += len(cases)
        return plain

    every = [(fx, v, o, g, st, {}) for o, v in K12_SCHEMES
             for g in K12_GHOSTS for st in K12_STORES]
    every += [(pflux.get(name, **kw), v, o, g, "sum", {})
              for name, kw in K12_FLUXES for o, v in K12_SCHEMES
              for g in K12_GHOSTS]
    for i, shape in enumerate((ODD_SHAPE, ODD_2D)):
        for axis in range(len(shape)):
            group(shape, axis, every, 170 + 10 * i + axis)
    for i, shape in enumerate(K12_ALIGNED):
        for axis in range(len(shape)):
            plans = ([{}, {"chunk": 8}, {"chunk": 12}]
                     if axis == len(shape) - 1 else
                     [{}, {"chunk": 1}, {"chunk": 5}, {"chunk": 13}])
            cases = [(fx, v, o, g, "negated-sum", p) for o, v in K12_SCHEMES
                     for g in K12_GHOSTS for p in plans]
            group(shape, axis, cases, 190 + 10 * i + axis)

    def timed(shape, axis, order, store, seed, sweep=False):
        nd = len(shape)
        fn = entry(nd)
        ops = operands(shape, axis, order, seed)
        plain = group(shape, axis, [(fx, "js", order, "edge", store, {})],
                      seed, {order: ops})
        u, acc, _ = ops
        summed = store != "div"
        plan = {}

        def launch(x, **kw):
            fn(x, axis, 0.05, fx, "js", order, bc=edge,
               acc=acc if summed else None, **kw)

        ms = alone_ms(lambda x: launch(x, plan=plan), [u],
                      5 if nd == 3 else 21)
        bound, by = kernel_bound(u.numel() * (2 if summed else 1),
                                 u.numel(),
                                 weno_ops(shape, "burgers", "js", order,
                                          store))
        line = (f"    alone {ms:.4f} ms ({store}; plan {plan}); twin "
                f"{plain:.3f} ms once; bound {bound:.4f} ms ({by})")
        if sweep:
            last = axis == nd - 1
            knobs = [{"chunk": t} for t in
                     ((16, 32, 48, 64) if last else K12_CHUNKS)]
            times = {", ".join(f"{k} {v}" for k, v in kw.items()):
                     alone_ms(lambda x: launch(x, **kw), [u], 5)
                     for kw in knobs}
            line += "; by plan {" + ", ".join(
                f"{k}: {t:.4f}" for k, t in times.items()) + "} ms"
        print(f"{line} [{card}]")
        res[nd]["timed"].append({
            "shape": list(shape), "axis": axis, "order": order,
            "store": store, "plan": plan, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by})
        del ops, u, acc
        torch.cuda.empty_cache()

    for i, shape in enumerate(((BURGERS_N,) * 3, tuple(reversed(K6_N)))):
        for axis in range(3):
            for store in ("div", "sum"):
                timed(shape, axis, 5, store, 200 + 10 * i + axis,
                      sweep=i == 0 and store == "sum")
    for axis in range(3):
        timed((BURGERS_N,) * 3, axis, 7, "sum", 230 + axis)
    for axis in range(2):
        for store in ("div", "sum"):
            timed((BURGERS2D_N, BURGERS2D_N), axis, 5, store, 240 + axis)
    entries = []
    for nd, kid, name, line in ((3, "K12", "flux_divergence_3d", 221),
                                (2, "K12b", "flux_divergence_2d", 276)):
        # the main per-axis path's mix at its shape (512^3; 400^2):
        # the first sweep stores div, the others the sum
        main = [t for t in res[nd]["timed"]
                if t["shape"][0] in (BURGERS_N, BURGERS2D_N)
                and t["order"] == 5
                and (t["store"] == "div") == (t["axis"] == 0)]
        entries.append({
            "name": name, "id": kid, "route": "cuda",
            "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                      "weno_axis.cu",
            "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                        f"weno.py:{line}",
            "max_abs_err": res[nd]["err"], "max_ulps": res[nd]["ulps"],
            "instances_checked": res[nd]["instances"],
            # per launch alone, mean over the main path's sweeps
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


def kernel_name(name: str) -> str:
    """A device event's name without its return type, anonymous
    namespaces and parameter list, cut to 90 characters."""
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void |\(.*$", "", name)[:90]


def axis_profile(fn, ndim: int, steps: int = 1) -> dict | None:
    """Run ``fn`` (``steps`` steps) under ``torch.profiler``: device span
    and busy time, the launches and mean time of each per-axis kernel of
    an ``ndim``-D run, the device-to-host copies, and every device kernel
    a step by name (so a pad, a sum or a negation shows); ``None`` when
    it saw no device activity."""
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
    names = collections.Counter(
        kernel_name(e.name) for e in dev)
    return {
        "span_ms": (end - start) / 1e3,
        "busy_ms": sum(e.time_range.end - e.time_range.start
                       for e in dev) / 1e3,
        "kernels": kernels,
        "dtoh": sum(1 for e in dev if "DtoH" in e.name),
        "per_step": {k: v / steps for k, v in names.most_common()},
    }


def per_axis_path(name, solver, iters: int, expect: dict, card: str,
                  fused_ms_per_step: float, time_iters: int | None = None,
                  profile_iters: int | None = None):
    """One per-axis path, ``impl="pallas_axis"``: the engaged stepper,
    the launches of ``run(iters)`` (:func:`drive`), then ms/step (median
    of 3 CUDA-event samples of ``run(time_iters)`` after a warm-up),
    MLUPS, the host reads of device scalars and one profiled
    ``run(profile_iters)`` (the idle share, the kernels' share and the
    device-to-host copies); both windows ``AXIS_TIME_ITERS`` steps unless
    given. Returns the run's state and the numbers."""
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "per-axis-pallas" or path["fallback"] is not None:
        raise AssertionError(f"{name} did not engage the per-axis rung")
    state0 = solver.initial_state()
    out = drive(name, solver, state0, iters, expect)
    t_iters = min(iters, time_iters or AXIS_TIME_ITERS)
    p_iters = min(iters, profile_iters or AXIS_TIME_ITERS)
    total_ms, reps = run_ms(solver, state0, t_iters)
    step_ms = total_ms / t_iters
    mlups = solver.grid.num_cells * t_iters * 3 / (total_ms * 1e-3) / 1e6
    reads = count_reads(lambda: solver.run(state0, p_iters))
    prof = axis_profile(lambda: solver.run(state0, p_iters),
                        solver.grid.ndim, p_iters)
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
        work = prof["per_step"]
        print(f"  device work a step: {sum(work.values()):g} ("
              + "; ".join(f"{k} {v:g}" for k, v in work.items()) + ")")
    return out, state0, {
        "ms_per_step": step_ms, "mlups": mlups, "run_iters": t_iters,
        "fused_ms_per_step": fused_ms_per_step,
        "device_idle_share": idle, "dtoh_copies": dtoh,
        "host_reads": reads,
        "profile": None if prof is None else prof["kernels"],
        "device_work_per_step": None if prof is None else prof["per_step"],
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


# per-axis Burgers runs held bit for bit against the same runs with
# every K12/K12b launch replaced by the twin composition (phase 18):
# (label, grid shape, config)
AXIS_TWIN_ITERS = 20
AXIS_TWIN_CASES = (
    ("64^3 adaptive, nu 1e-5, edge", (64, 64, 64), {"nu": BURGERS_NU}),
    ("64^3 fixed dt, periodic, WENO7", (64, 64, 64),
     {"bc": "periodic", "weno_order": 7, "adaptive_dt": False}),
    ("64^3 adaptive, Dirichlet, WENO5-Z", (64, 64, 64),
     {"bc": "dirichlet", "weno_variant": "z"}),
    ("400^2 fixed dt, edge", (BURGERS2D_N, BURGERS2D_N),
     {"adaptive_dt": False}),
    ("400^2 adaptive, periodic", (BURGERS2D_N, BURGERS2D_N),
     {"bc": "periodic"}),
)


def twin_entry(u, axis, dx, flux, variant="js", order=5, *, bc=None,
               ghosts=None, acc=None, negate=False, **_):
    """K12/K12b's twin composition in place of a launch: the result into
    ``acc`` where one is given, as the kernel stores it."""
    out = kweno.flux_divergence_axis_reference(
        u, axis, dx, flux, variant, order, bc=bc, ghosts=ghosts, acc=acc,
        negate=negate)
    return out if acc is None else acc.copy_(out)


def axis_twin_phase(card: str) -> None:
    """Phase 18, first: each per-axis run of ``AXIS_TWIN_CASES`` (every
    ghost rule of a single device, both dimensions, both orders) against
    the same run with K12/K12b's twin composition in place of every
    launch: the final state equal to the bit, ``t`` equal."""
    n = AXIS_TWIN_ITERS
    print(f"phase 18: per-axis Burgers runs against the twin composition, "
          f"run({n})")
    for label, shape, kw in AXIS_TWIN_CASES:
        cfg = BurgersConfig(grid=Grid.make(*shape, lengths=2.0),
                            dtype="float32", impl="pallas_axis", **kw)
        nd = len(shape)
        expect = {"K12" if nd == 3 else "K12b": 3 * nd * n}
        if cfg.nu:
            expect["K11" if nd == 3 else "K11b"] = 3 * n
        solver = BurgersSolver(cfg)
        state0 = solver.initial_state()
        out = drive(label, solver, state0, n, expect)
        saved = kweno.flux_divergence_3d, kweno.flux_divergence_2d
        kweno.flux_divergence_3d = kweno.flux_divergence_2d = twin_entry
        try:
            twin = BurgersSolver(cfg).run(state0, n)
            torch.cuda.synchronize()
        finally:
            kweno.flux_divergence_3d, kweno.flux_divergence_2d = saved
        same = (bool(torch.equal(out.u, twin.u))
                and float(out.t) == float(twin.t))
        print(f"  {label}: t {float(out.t)!r}; equal to the twin "
              f"composition's run to the bit: {same} [{card}]")
        if not same:
            raise AssertionError(
                f"{label}: the kernel run is {ulps(out.u, twin.u)} ulp from "
                f"the twin composition's (t {out.t} vs {twin.t})")
        del solver, state0, out, twin
    torch.cuda.empty_cache()


def per_axis_phases(card: str, fused: dict) -> dict:
    """Phase 18: the six per-axis paths; ``fused`` holds the fused
    paths' ms/step measured earlier in this run on the same configs.
    Returns each path's numbers by name."""
    axis_twin_phase(card)
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
          f"{DIFF2D_N}^2 (timed over run({n // 50}))")
    cfg = DiffusionConfig(grid=Grid.make(DIFF2D_N, DIFF2D_N, lengths=10.0),
                          dtype="float32", impl="pallas_axis")
    solver = DiffusionSolver(cfg)
    out, state0, paths["diffusion2d"] = per_axis_path(
        "diffusion 2-D", solver, n, {"K11b": 3 * n}, card,
        fused["diffusion2d"], time_iters=n // 50,
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
            fused[f"burgers2d_{label}"], time_iters=n // 4,
            profile_iters=n // 4)
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
K9_ZCHUNKS = (4, 8, 16, 32)  # z planes a K9 block marches, timed alone
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


def k9_phase(card: str, copy_gbs: float) -> dict:
    """Phase 20: K9 against its twin to the bit, every stage kind, at the
    main path's shape and an odd one, for every case of ``K9_CASES``, and
    at the odd shape in 3-plane chunks too; K9 alone at the main shape
    (the main physics) for each z-chunk of ``K9_ZCHUNKS`` and the planned
    one, cycling through buffers larger than L2, beside its bound, its
    bytes rate, its operations a cell, the twin and the conv3d
    yardstick."""
    print("phase 20: K9 against its twin")
    grid = Grid.make(*ADR_N, lengths=ADR_LENGTHS)
    spacing = grid.spacing
    sweep = (*K9_ZCHUNKS, None)
    res = {"err": 0.0, "ms": [], "plain_ms": [], "bound_ms": [],
           "sweep": {key: [] for key in sweep}}
    launch = {}
    for i, (eps, lam, vel, bc) in enumerate(K9_CASES):
        main = i == len(K9_CASES) - 1
        for shape in (grid.shape, ODD_SHAPE):
            dt = pcfl.advection_diffusion_dt(vel, 1.0 + eps, spacing,
                                              reaction=lam)
            kw = fa.FusedADRStepper(shape, spacing, 1.0, vel, lam, dt, 2, bc,
                                    "cuda", kappa_variation=eps
                                    ).stage_kwargs()
            chunks = (None, 3) if shape == ODD_SHAPE else (None,)
            for kind, (a, b) in enumerate(fd.STAGES):
                has_u = kind > 0
                v = padded_random(shape, bc, 200 + 10 * i + kind)
                u = padded_random(shape, bc, 300 + 10 * i + kind) \
                    if has_u else None
                out = torch.full_like(v, bc)
                ref = out.clone()
                fa.adr_stage_reference(v, u, ref, dt, a=a, b=b, **kw)
                for zchunk in chunks:
                    fa.fused_adr_stage(v, u, out, dt, a=a, b=b,
                                       zchunk=zchunk, launch=launch, **kw)
                    torch.cuda.synchronize()
                    res["err"] = max(res["err"], exact(
                        f"K9 stage {kind + 1} at {shape}, eps {eps}, lambda "
                        f"{lam}, velocity {vel}, wall {bc}, "
                        f"{launch['zchunk']}-plane chunks", out, ref))
                if not (main and shape == grid.shape):
                    continue
                if has_u:
                    main_launch = dict(launch)
                buffers = [(v.clone(), None if u is None else u.clone(),
                            out.clone()) for _ in range(ROTATE)]
                for zchunk in sweep:
                    res["sweep"][zchunk].append(alone_ms(
                        lambda bufs: fa.fused_adr_stage(
                            bufs[0], bufs[1], bufs[2], dt, a=a, b=b,
                            zchunk=zchunk, **kw), buffers, 21))
                del buffers
                res["ms"].append(res["sweep"][None][-1])
                res["plain_ms"].append(statistics.median(cuda_ms(
                    lambda: fa.adr_stage_reference(v, u, ref, dt, a=a, b=b,
                                                   **kw), 3)))
                bound, by = kernel_bound(
                    (2 if has_u else 1) * math.prod(shape), math.prod(shape),
                    k9_stage_ops(shape, has_u, eps, lam, 3))
                res["bound_ms"].append(bound)
                res["bound_by"] = by
                gbs = stage_bytes(shape, has_u) / (res["ms"][-1] * 1e-3) / 1e9
                ops = k9_stage_ops(shape, has_u, eps, lam, 3)
                tops = ops / (res["ms"][-1] * 1e-3) / 1e12
                print(f"    K9 stage {kind + 1} alone {res['ms'][-1]:.4f} ms"
                      f" ({gbs:.0f} GB/s, {gbs / copy_gbs:.3f} of the copy "
                      f"rate; {ops / math.prod(shape):.0f} f32 operations a "
                      f"cell, {tops:.2f} T/s); twin "
                      f"{res['plain_ms'][-1]:.4f} ms; bound {bound:.4f} ms "
                      f"({by}) [{card}]")
            del v, u, out, ref
            torch.cuda.empty_cache()
    blocks = fa.BLOCKS_PER_SM * torch.cuda.get_device_properties(
        0).multi_processor_count
    plan = {**fa.adr_schedule(grid.shape, blocks),
            "copy_floats": main_launch["copy_floats"],
            "blocks_per_sm": main_launch["blocks_per_sm"]}
    print(f"  K9 plan at {grid.shape} (stages 2-3): {plan}")
    if plan["blocks_per_sm"] != fa.BLOCKS_PER_SM:
        raise AssertionError(f"K9 runs {plan['blocks_per_sm']} blocks an "
                             f"SM, its plan {fa.BLOCKS_PER_SM}")
    by_chunk = {f"{z or plan['chunk_planes']}{'' if z else ' (planned)'}":
                statistics.mean(res["sweep"][z]) for z in sweep}
    print("  K9 alone, mean of the three stage kinds, by z chunk (ms): "
          f"{by_chunk} [{card}]")
    lib_ms = adr_rhs_conv3d_ms(spacing, grid.shape, (0.5, 0.5, 0.5), 0.25)
    print(f"  conv3d constant-coefficient ADR right-hand side alone, TF32 "
          f"off: {lib_ms:.4f} ms [{card}] (computes less than one K9 stage)")
    ms = statistics.mean(res["ms"])
    return {
        "name": "fused_adr_stage", "id": "K9", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_adr_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_adr.py:69",
        "max_abs_err": res["err"], "max_ulps": 0,
        # per launch alone, mean over the three stage kinds a step launches
        "ms_isolated": ms,
        "ms_isolated_by_zchunk": by_chunk,
        "plan": plan,
        "achieved_gbs": (stage_bytes(grid.shape, False)
                         + 2 * stage_bytes(grid.shape, True)) / 3
                        / (ms * 1e-3) / 1e9,
        "copy_gbs": copy_gbs,
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
    # the unsharded float32 instances (<W, HAS_U, SHARDED, T>): stage 1,
    # stages 2-3
    s1 = [ms for k, ms in per_kernel.items()
          if "adr_stage_kernel<" in k and ", false, false, float>" in k]
    s23 = [ms for k, ms in per_kernel.items()
           if "adr_stage_kernel<" in k and ", true, false, float>" in k]
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
                                       {"K11": 3 * n}, card, step_ms,
                                       time_iters=n // 10,
                                       profile_iters=n // 10)
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
    timed once; the fused rungs time one more warm run of each since
    the script outgrew its time), and, when ``profile`` names the
    kernel, the idle share
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
            "ensemble-fold[fused-whole-run-slab]", card, reps=1)
        paths["vmap", B] = ensemble_path(
            "diffusion", "pallas", B, n, {"K1": 3 * B * n},
            "ensemble-vmap[fused-stage]", card,
            profile="stage_kernel" if B == max(ENS_MEMBERS) else None,
            reps=1)
        paths["generic", B] = ensemble_path(
            "diffusion", "xla", B, n, {}, "ensemble-vmap[generic-xla]", card,
            reps=0)
    print(f"phase 26: the Burgers ensemble, {ENSB_N}, fixed dt, "
          f"run({ENSB_ITERS}), B={ENSB_MEMBERS}")
    bfold = ensemble_path("burgers", "pallas_slab", ENSB_MEMBERS, ENSB_ITERS,
                          {"K2b-burgers": 1},
                          "ensemble-fold[fused-whole-run-slab]", card, reps=1)
    bvmap = ensemble_path("burgers", "pallas", ENSB_MEMBERS, ENSB_ITERS,
                          {"K5": 3 * ENSB_MEMBERS * ENSB_ITERS},
                          "ensemble-vmap[fused-stage]", card, reps=1)
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
             fill, card: str, dtype=torch.float32,
             timed: bool = True) -> dict:
    """K3 against its twin at a main shard's shape, every window of
    :func:`k3_windows` on the first and the last shard of two; times the
    per-step window alone (K3) and its twin unless not ``timed``.
    ``step(S, out, **kw)`` / ``step_ref`` take the window keywords;
    ``ring`` is the y/x ghost width of the layout, ``fill`` the wall
    value of its ring (or None); ``dtype`` the buffers'."""
    lz, ny, nx = shape
    gnz = MESH_SHARDS * lz
    rng = np.random.default_rng(28)
    err, n = 0.0, 0
    for name, window, op, depth in k3_windows(lz, G):
        for oz in (0, gnz - lz):
            pshape = (lz + 2 * depth, ny + 2 * ring, nx + 2 * ring)
            S = torch.from_numpy(rng.uniform(
                -0.1, 1.0, pshape).astype(np.float32)).cuda().to(dtype)
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
    if not timed:
        print(f"  K3 {family}: {n} windows 0 ulp")
        return {"max_abs_err": err, "windows": n}
    pshape = (lz + 2 * G, ny + 2 * ring, nx + 2 * ring)
    bufs = [torch.rand(pshape, device="cuda").to(dtype) for _ in range(3)]
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
# the runs timed: run(50) (run(200) before the script grew; the
# host-bound paths' ms/step does not move with the depth)
MESH2D_TIME_ITERS = 50
MESH2D_T_END = 0.4
# u held to the JAX suite's fused-against-generic bound before the
# shock (t ~ 0.37, phase 10's note); at t_end the gap is reported
MESH2D_T_CHECK = 0.2
K8_ODD = (23, 37)  # an odd shard interior (ly, lx)
K8_LARGE = (2048, 4096)  # a shard of 4096^2 on dy=2, past K7's L2 gate
# K8/K8b's kernels in a profile: the CELL and TILED bodies
K8_KERNELS = "fused2d_"
PENCIL_ITERS = 100
PENCIL_TIME_ITERS = 25  # the pencil runs timed: run(25)


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
    (WENO5-Z 113; WENO7-JS 219, K5's note), the sum and negation 2, the
    viscous taps 20, the combine 5."""
    if isinstance(params, fsh.DiffusionParams):
        return 24 * cells
    per_axis = (219 if params.order == 7
                else 103 + (10 if params.variant == "z" else 0))
    viscous = 20 if params.lap_taps is not None else 0
    return (6 + 2 * per_axis + 2 + viscous + 5) * cells


def k8_twin(v, u, out, dt, offs, bands, ops, emit, **kw):
    """The twin of one K8/K8b launch over ``bands`` (``(rows, operand)``
    pairs; rows ``None``: the whole shard), the single-band twin calls in
    the split schedule's order; returns the maximum folded from 0."""
    m = 0.0
    for rows, op in bands:
        res = fsh.stage_reference(v, u, out, dt, offs, window=rows,
                                  emit=emit, **({op: ops[op]} if op else {}),
                                  **kw)
        if emit:
            m = max(m, float(res[1]))
    return m


def k8_check(family, params, shape, dt, rng) -> tuple[int, float]:
    """K8 (every stage kind) and K8b (each band of the split schedule and
    both edge bands in one launch, stage 2) against their twin on every
    shard of :func:`k8_shards`, then the stepper's lean entry on the
    launch plans of every stage (the whole shard; the interior band and
    the paired edge bands, the maximum folded), 0 ulp, Burgers' emitted
    maximum exact; returns the count of checks and the largest
    difference."""
    h = fsh.halo_of(params)
    ly, lx = shape
    padded = (ly + 2 * h, lx + 2 * h)
    burgers = family != "diffusion"
    bands = fsh.split_bands(ly, h)
    n, err = 0, 0.0

    def held(name, got, want, mx, m):
        nonlocal n, err
        torch.cuda.synchronize()
        n_ulps = ulps(got, want)
        err = max(err, float((got - want).abs().max()))
        if n_ulps != 0 or (burgers and float(mx) != m):
            raise AssertionError(
                f"{name}: {n_ulps} ulp from its twin (max "
                f"{float(mx) if burgers else None} vs {m})")
        n += 1

    for shard, (offs, gshape) in k8_shards(shape).items():
        v, u, out0 = (random_on_card(padded, int(rng.integers(1 << 30)))
                      for _ in range(3))
        ops = {op: random_on_card((h, padded[1]), int(rng.integers(1 << 30)))
               for op in ("lo", "hi")}
        calls = [("K8", (a, b), kind, ((None, None),))
                 for kind, (a, b) in enumerate(fd.STAGES)]
        calls += [("K8b", fd.STAGES[1], 1, (band,)) for band in bands]
        calls += [("K8b", fd.STAGES[1], 1, bands[1:])]
        for kernel, (a, b), kind, chosen in calls:
            u_arg = None if kind == 0 else u
            kw = dict(params=params, a=a, b=b, global_shape=gshape)
            ref = out0.clone()
            m = k8_twin(v, u_arg, ref, dt, offs, chosen, ops, burgers, **kw)
            got = out0.clone()
            mx = torch.zeros((), device="cuda") if burgers else None
            if kernel == "K8":
                fsh.fused2d_stage(v, u_arg, got, dt, offs, mx=mx, **kw)
            elif len(chosen) == 2:
                fsh.fused2d_band_stage(v, u_arg, got, dt, offs,
                                       rows=fsh.edge_bands(ly, h), mx=mx,
                                       **ops, **kw)
            else:
                (rows, op), = chosen
                fsh.fused2d_band_stage(v, u_arg, got, dt, offs, rows=rows,
                                       mx=mx, **({op: ops[op]} if op else {}),
                                       **kw)
            held(f"{kernel} {family} {shard} {shape} stage {kind + 1} "
                 f"bands {chosen}", got, ref, mx, m)
        # the stepper's lean entry on its launch plans, every stage kind
        got = out0.clone()
        pk = dict(params=params, padded=padded, offsets=offs,
                  global_shape=gshape, device=v.device,
                  buffers=(v.data_ptr(), u.data_ptr(), got.data_ptr()))
        for kind, (a, b) in enumerate(fd.STAGES):
            u_arg = None if kind == 0 else u
            kw = dict(params=params, a=a, b=b, global_shape=gshape)
            mid = fsh.StagePlan(fsh.fused2d_band_stage, a=a, b=b,
                                bands=bands[:1], **pk)
            edges = fsh.StagePlan(fsh.fused2d_band_stage, a=a, b=b,
                                  bands=bands[1:], **pk)
            whole = fsh.StagePlan(fsh.fused2d_stage, a=a, b=b,
                                  bands=(((0, ly), None),), **pk)
            for plans in ((whole,), (mid, edges)):
                got.copy_(out0)
                ref = out0.clone()
                chosen = tuple(bd for p in plans for bd in p.bands)
                m = k8_twin(v, u_arg, ref, dt, offs, chosen, ops, burgers,
                            **kw)
                mx = torch.zeros((), device="cuda") if burgers else None
                for i, plan in enumerate(plans):
                    fsh.launch(plan, v, u_arg, got, dt, mx=mx, mx_init=i == 0,
                               **({} if plan is not edges else ops))
                held(f"the lean entry {family} {shard} {shape} stage "
                     f"{kind + 1} plans {[p.bands for p in plans]}", got, ref,
                     mx, m)
    return n, err


def k8_device_ms(launch, reps: int = 20) -> tuple[float, str]:
    """A K8/K8b launch's device time (ms) alone: the mean of its kernel
    over ``reps`` back-to-back launches in a profiled run, taken again
    while the profiler drops some; the CUDA-event time of the launches
    (then bound by the host) where it sees none."""
    launch()
    torch.cuda.synchronize()
    prof = None
    for _ in range(3):
        prof = run_profile(lambda: [launch() for _ in range(reps)],
                           K8_KERNELS)
        if prof is not None and prof["launches"] == reps:
            break
    if prof is not None and prof["launches"] > 0:
        return prof["kernel_ms"], "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "CUDA events (host-bound)"


def k8_timing(params, shape, dt, card, plain: bool = True) -> dict:
    """K8 (stage 2) alone over a shard of ``shape`` (the first of ``dy =
    2``) and K8b's two launches of a split stage (the interior band, then
    both edge bands), each through the stepper's lean entry on its
    launch plan, their device time beside the bounds of the same work;
    the twin (``plain``); the host time a launch (``time.perf_counter``
    over 1,000 lean launches without synchronisation, at the main
    shard's shape)."""
    h = fsh.halo_of(params)
    ly, lx = shape
    padded = (ly + 2 * h, lx + 2 * h)
    gshape, offs = (2 * ly, lx), (0, 0)
    v, u, out = (random_on_card(padded, 330 + j) for j in range(3))
    ops = {op: random_on_card((h, padded[1]), 339 + i)
           for i, op in enumerate(("lo", "hi"))}
    pk = dict(params=params, a=0.75, b=0.25, padded=padded, offsets=offs,
              global_shape=gshape, device=v.device,
              buffers=(v.data_ptr(), u.data_ptr(), out.data_ptr()))
    kw = dict(params=params, a=0.75, b=0.25, global_shape=gshape)
    bands = fsh.split_bands(ly, h)
    launches = {
        "K8": (fsh.StagePlan(fsh.fused2d_stage, bands=(((0, ly), None),),
                             **pk), {}),
        "interior": (fsh.StagePlan(fsh.fused2d_band_stage,
                                   bands=bands[:1], **pk), {}),
        "edges": (fsh.StagePlan(fsh.fused2d_band_stage, bands=bands[1:],
                                **pk), ops)}
    out_t = {}
    for name, (plan, extra) in launches.items():
        ms, how = k8_device_ms(
            lambda plan=plan, extra=extra: fsh.launch(plan, v, u, out, dt,
                                                      **extra))
        rows = sum(r1 - r0 for (r0, r1), _ in plan.bands)
        in_elems = (rows + 2 * h * len(plan.bands)) * padded[1] + rows * lx
        bound, by = kernel_bound(in_elems, rows * lx,
                                 k8_stage_ops(params, rows * lx))
        twin = None
        if plain:
            twin = statistics.median(cuda_ms(lambda plan=plan: k8_twin(
                v, u, out.clone(), dt, offs, plan.bands, ops, False, **kw),
                1))
        t = plan.tiles
        # f32 operations the TILED body issues a cell (each split and face
        # once a tile) against the face-once count k8_stage_ops takes
        issued = (fsh.ops_issued(t, [b for b, _ in plan.bands], lx, params)
                  / (rows * lx) if t["body"] == fsh.TILED else None)
        out_t[name] = {"rows": rows, "ms": ms, "timed_by": how,
                       "plain_ms": twin, "bound_ms": bound, "bound_by": by,
                       "ops_issued_a_cell": issued,
                       "plan": {k: t[k] for k in ("body", "tile", "my", "mx",
                                                  "threads", "vec",
                                                  "tiles")}}
    host = None
    if plain:
        plan = launches["K8"][0]
        fsh.launch(plan, v, u, out, dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fsh.launch(plan, v, u, out, dt)
        host = (time.perf_counter() - t0) / 1000 * 1e3
        torch.cuda.synchronize()
    family = "diffusion" if isinstance(params, fsh.DiffusionParams) else (
        f"burgers WENO{params.order}")
    k8 = out_t.pop("K8")
    issued = ("" if k8["ops_issued_a_cell"] is None else
              f"; {k8['ops_issued_a_cell']:.1f} f32 operations issued a "
              f"cell against {k8_stage_ops(params, 1)} each face once")
    print(f"  {family} at {shape}: K8 alone {1e3 * k8['ms']:.2f} us "
          f"({k8['timed_by']}; bound {1e3 * k8['bound_ms']:.2f} us by "
          f"{k8['bound_by']}; plan {k8['plan']}{issued}); K8b alone "
          + ", ".join(f"{k} {1e3 * b['ms']:.2f} us ({b['rows']} rows, "
                      f"bound {1e3 * b['bound_ms']:.3f} us, "
                      f"{'CELL' if b['plan']['body'] == fsh.CELL else 'TILED'}"
                      f")" for k, b in out_t.items())
          + ("" if host is None else
             f"; host time a lean launch {1e3 * host:.2f} us")
          + f" [{card}]")
    del v, u, out
    return {**k8, "bands": out_t, "host_ms": host}


def k8_phase(card: str) -> dict:
    """Phase 33: K8 and K8b against their twins at the main shard's shape
    (200x400, a shard of 400^2 on dy=2) and an odd one, every stage kind,
    every band and both edge bands in one launch, on the first, a middle
    and the last shard of dy=4 and a pencil's corner, and the stepper's
    lean entry; each timed alone at the main shard's shape and at
    2048x4096 (a shard of 4096^2 on dy=2) beside its bound, the twin and
    the host time a launch; ``conv2d`` computing the 2-D Laplacian of the
    main shard."""
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
                  f"bands and the paired edge bands, the lean entry x3 "
                  f"stage kinds x2 schedules, on 4 shards: {n} checks, 0 "
                  f"ulp, max|kernel - twin| {err:.3e}")
        torch.cuda.empty_cache()
    fams = k8_families(grid.spacing)
    timing = {}
    for family, key in (("diffusion", "diffusion"), ("burgers", "burgers-js")):
        dt = dt_d if family == "diffusion" else dt_b
        timing[family] = k8_timing(fams[key], main_shape, dt, card)
        timing[family]["large"] = k8_timing(fams[key], K8_LARGE, dt, card,
                                            plain=False)
        torch.cuda.empty_cache()
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
    12,000): each 0 ulp from K7's unsharded run(1000), ``t`` equal, the
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
             ("fused-stage", "serialized-refresh", 1), K8_KERNELS),
            ("K8b split", {"overlap": "split"}, {"K8b": 12 * n},
             ("fused-stage", "split", 1), K8_KERNELS)):
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
    run(200) serialized (K8, 1,200 launches) and split (K8b, 2,400), 0
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
            ("K8b split", {"overlap": "split"}, {"K8b": 12 * n},
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
        r.update(mesh2d_profile(name, solver, state0, n, K8_KERNELS,
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
                              ("fused-stage", "serialized-refresh", 1), card,
                              time_iters=PENCIL_TIME_ITERS)
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
    launch in the main path's profiled run (K8b: the mean over its two
    launches a stage), else alone at the main shard's shape
    (``ms_isolated``, the device time of lean launches; K8b the mean of
    its interior and paired edge launches); the same alone at 2048x4096
    and the host time a lean launch; launches from the main paths' runs
    (phases 34, 35)."""
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
            "plan": t["plan"], "host_ms_a_launch": t["host_ms"],
            "large": {k: t["large"][k] for k in ("ms", "bound_ms",
                                                 "bound_by", "plan")},
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
            "bands": t["bands"], "large": t["large"]["bands"],
            "path": split})
    return out

# --------------------------------------------------------------------- #
# Phases 38-41: K4, the sharded slab run with the in-kernel exchange
# --------------------------------------------------------------------- #
K4_DEEP = 4  # steps_per_exchange of the deep dma path (phase 39)
K4_P4_N = (400, 200, 208)  # the P = 4 check: a z extent four divides


def k4_buffers(P: int, lz: int, depth: int, ny: int, nx: int, ring: int,
               seed: int, dtype=torch.float32):
    """Random shard buffers on the card for a K4 call: P state pairs
    (the y/x ghost ring at the wall value 0 where ``ring``) and landing
    buffers, numpy-seeded, of ``dtype``."""
    rng = np.random.default_rng(seed)
    shape = (lz + 2 * depth, ny + 2 * ring, nx + 2 * ring)

    def rand(shape):
        return torch.from_numpy(rng.uniform(
            -0.1, 1.0, shape).astype(np.float32)).cuda().to(dtype)

    S0 = [rand(shape) for _ in range(P)]
    if ring:
        for S in S0:
            S[:, :ring] = S[:, -ring:] = 0.0
            S[:, :, :ring] = S[:, :, -ring:] = 0.0
    S1 = [rand(shape) for _ in range(P)]
    lands = [rand((2, 2, depth) + shape[1:]) for _ in range(P)]
    return S0, S1, lands


def k4_check(name, run, step_ref, P, lz, k, G, ny, nx, ring, steps,
             seed, dtype=torch.float32) -> float:
    """K4 against its twin (``slab_run_dma_reference`` over K3's twin),
    every state and landing buffer 0 ulp after ``steps`` steps; returns
    the largest absolute difference."""
    depth = k * G
    bufs = k4_buffers(P, lz, depth, ny, nx, ring, seed, dtype)
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
             card, dtype=torch.float32) -> dict:
    """K4 alone at a main path's shard shapes, k = 1: ms a step of a
    ``run(steps)`` launch (median of 5 after a warm-up, CUDA events), the
    grid's blocks, and the twin's ms a step (one step)."""
    bufs = k4_buffers(P, lz, G, ny, nx, ring, 38, dtype)
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
            * math.prod(fused.padded_shape[1:]) * fused.dtype.itemsize
            * blocks)


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


# --------------------------------------------------------------------- #
# WENO7-JS on the fused rungs: K5, K7/K7a and K6 at order 7 (phases 42-45)
# --------------------------------------------------------------------- #
# bench/matrix.py's burgers3d_512_weno7 (512^3, nu 1e-5, fixed dt, 40
# steps) and burgers2d_weno7 (physical 400x408, fixed dt, 200 steps)
W7_N = 512
W7_ITERS = 40
W7_CHECK_ITERS = 10  # steps held against the generic WENO7 path
W7_PROF_ITERS = 10  # steps of the profiled run (30 K5 launches)
W7_2D_N = (400, 408)
W7_2D_ITERS = 200
W7_2D_CHECK_ITERS = 100  # before the shock, as for WENO5 (phase 10)
W7_GATE_N = (1001, 1478)  # the L2 gate's grids the JAX VMEM gate refuses
W7_GATE_ITERS = 20
W7_K6_ITERS = 40  # K6 at order 7 on MultiGPU/Burgers3d_Baseline's grid
W7_ODD_CASES = (  # (flux, flux kwargs, nu) at the odd shapes
    ("burgers", {}, 1e-5),
    ("linear", {"c": -0.7}, 1e-5),
    ("buckley", {}, 0.0),
)


def in_range(name, u) -> None:
    lo, hi = float(u.min()), float(u.max())
    print(f"  {name}: u in [{lo!r}, {hi!r}]")
    if not (math.isfinite(lo) and math.isfinite(hi)
            and lo >= -1e-6 and hi <= 1.05):
        raise AssertionError(f"{name}: u left [-1e-6, 1.05]: [{lo}, {hi}]")


def k5_weno7_phases(card: str) -> dict:
    """Phases 42-43: K5's order-7 instance against its twin, alone, and
    the ``burgers3d_512_weno7`` path; returns its ``kernels`` entry."""
    n = W7_N
    grid = Grid.make(n, n, n, lengths=2.0)
    cfg = BurgersConfig(grid=grid, nu=BURGERS_NU, weno_order=7,
                        adaptive_dt=False, dtype="float32", impl="pallas")
    solver = BurgersSolver(cfg)
    params = fb.stage_params(solver.flux, "js", grid.spacing, cfg.nu,
                             order=7)
    dt = solver.dt

    print("phase 42: K5 at order 7 against its twin")
    geo, want = fb.geometry(7), fb.tile_geometry(7)
    print(f"  K5 WENO7 tiling: {geo['tile_y']}x{geo['tile_x']} tile, "
          f"{geo['threads']} threads, {geo['smem_bytes']} B static shared "
          f"memory, {geo['blocks_per_sm']} blocks an SM, "
          f"{geo['registers']} registers and {geo['local_bytes']} B local "
          f"memory a thread")
    if ((geo["tile_y"], geo["tile_x"]) != fb.TILE
            or geo["threads"] != want["threads"]
            or geo["smem_bytes"] != want["smem_bytes"]):
        raise AssertionError(f"K5 WENO7's tiling {geo} is not the host's "
                             f"{want}")
    main = check_k5(grid.shape, params, dt, seed=70, timed=True,
                    zchunks=(fb.Z_CHUNK,))
    err, n_ulps = main["max_abs_err"], main["ulps"]
    for i, (name, kw, nu) in enumerate(W7_ODD_CASES):
        odd = check_k5(ODD_SHAPE, fb.stage_params(
            pflux.get(name, **kw), "js", (0.05, 0.07, 0.09), nu, order=7),
            dt, seed=71 + i, timed=False)
        err, n_ulps = max(err, odd["max_abs_err"]), max(n_ulps, odd["ulps"])
    torch.cuda.empty_cache()

    print(f"phase 43: burgers3d_512_weno7, run({W7_ITERS}) at {n}^3, fixed "
          "and adaptive dt")
    state0 = solver.initial_state()
    adaptive = BurgersSolver(dataclasses.replace(cfg, adaptive_dt=True))
    entry = {}
    for label, s in (("fixed", solver), ("adaptive", adaptive)):
        path = s.engaged_path()
        print(f"  engaged ({label}): {path}")
        if path["stepper"] != "fused-stage" or path["fallback"]:
            raise AssertionError(f"WENO7 {label} did not engage K5: {path}")
        out = drive(f"burgers3d_512_weno7 {label}", s, state0, W7_ITERS,
                    {"K5": 3 * W7_ITERS})
        print(f"  t = {float(out.t)!r}")
        in_range(f"{label} run({W7_ITERS})", out.u)
        del out
        ms, reps = run_ms(s, state0, W7_ITERS)
        mlups = grid.num_cells * W7_ITERS * 3 / (ms * 1e-3) / 1e6
        reads = count_reads(lambda: s.run(state0, W7_ITERS))
        # the profiler drops device events now and then (PERF.md §7): a
        # shorter run, three captures, else the in-run time not measured
        n_prof = 3 * W7_PROF_ITERS
        prof = retake(
            lambda: burgers_profile(lambda: s.run(state0, W7_PROF_ITERS)),
            lambda p: p["k5_launches"] == n_prof, tries=3)
        line = (f"  {label} run({W7_ITERS}): median {ms:.3f} ms of "
                f"{[round(r, 3) for r in reps]}; {ms / W7_ITERS:.4f} "
                f"ms/step; {mlups:.0f} MLUPS; host reads of device scalars "
                f"{reads}")
        if prof["k5_launches"] == n_prof:
            idle = 1.0 - prof["busy_ms"] / prof["span_ms"]
            in_run, dtoh = statistics.mean(prof["k5_ms"]), prof["dtoh"]
            print(f"{line}; profiled run({W7_PROF_ITERS}): K5 per launch "
                  f"{[round(x, 4) for x in prof['k5_ms']]} ms (mean "
                  f"{in_run:.4f}), {3 * in_run / (ms / W7_ITERS):.3f} of "
                  f"the step; idle share {idle:.4f}; device-to-host copies "
                  f"{dtoh} [{card}]")
        else:
            idle = dtoh = None
            in_run = statistics.mean(main["ms"])
            print(f"{line}; the profiler saw {prof['k5_launches']} of "
                  f"{n_prof} K5 launches in three captures: K5's time is "
                  f"its time alone, the idle share and device-to-host "
                  f"copies are not measured [{card}]")
        if label == "adaptive" and (reads > 1 or (dtoh or 0) > 1):
            raise AssertionError("the adaptive run copied to the host more "
                                 "than once")
        generic = BurgersSolver(dataclasses.replace(s.cfg, impl="xla"))
        if generic.engaged_path()["stepper"] != "generic-xla":
            raise AssertionError("impl='xla' did not run the generic path")
        f10 = s.run(state0, W7_CHECK_ITERS)
        g10 = generic.run(state0, W7_CHECK_ITERS)
        if abs(float(f10.t) - float(g10.t)) > 1e-5 * float(g10.t):
            raise AssertionError(f"t differs: {f10.t} vs {g10.t}")
        assert_matches(f"{label} run({W7_CHECK_ITERS}) against the generic "
                       "WENO7 path", f10.u, g10.u, rtol=2e-5, atol=2e-6)
        del f10, g10, generic
        torch.cuda.empty_cache()
        entry[label] = {"ms": in_run, "ms_by_stage": prof.get("k5_ms"),
                        "ms_per_step": ms / W7_ITERS, "mlups": mlups,
                        "device_idle_share": idle, "dtoh_copies": dtoh,
                        "host_reads": reads}
    del state0
    torch.cuda.empty_cache()
    fixed = entry["fixed"]
    return {
        "name": "fused_burgers_stage_weno7", "id": "K5-w7", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_burgers_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_burgers.py:352",
        "launches": 3 * W7_ITERS,
        "max_abs_err": err, "max_ulps": n_ulps,
        # per launch, mean over the stage kinds, in the fixed-dt path
        "ms": fixed["ms"], "ms_by_stage": fixed["ms_by_stage"],
        "ms_isolated": statistics.mean(main["ms"]),
        "plain_ms": statistics.mean(main["plain_ms"]),
        "bound_ms": statistics.mean(main["bound_ms"]),
        "bound_by": main["bound_by"],
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes a WENO7 "
                        "stage",
        "ms_per_step": fixed["ms_per_step"], "mlups": fixed["mlups"],
        "device_idle_share": fixed["device_idle_share"],
        "adaptive_path": entry["adaptive"],
    }


def k7_weno7_phases(card: str) -> list[dict]:
    """Phase 44: K7/K7a at order 7 against their twin, alone, the
    ``burgers2d_weno7`` paths and K7 against the generic path on the
    grids where the two packages' gates differ; returns K7's and K7a's
    entries."""
    iters = W7_2D_ITERS
    grid = Grid.make(*W7_2D_N, lengths=2.0)
    cfg = BurgersConfig(grid=grid, weno_order=7, adaptive_dt=False,
                        dtype="float32", impl="pallas")
    fixed = BurgersSolver(cfg)
    adaptive = BurgersSolver(dataclasses.replace(cfg, adaptive_dt=True))
    spacing, cfl = grid.spacing, cfg.cfl
    dt = cfl * min(spacing)
    params = fb.stage_params(fixed.flux, "js", spacing, 0.0, order=7)
    state0 = fixed.initial_state()

    def check(S0, p, sp, steps, adapt, tiles=None):
        T = [torch.empty_like(S0) for _ in range(4)]
        stage = (lambda v, u, o, d, a, b: fb2.stage_reference(
            v, u, o, d, params=p, a=a, b=b))
        got, plan = S0.clone(), {}
        if adapt:
            _, t_sum = fb2.whole_run_burgers2d(
                got, T[0], T[1], steps, params=p, spacing=sp, cfl=cfl,
                tiles=tiles, schedule=plan)
            df = p.flux.df
            want, want_t = wr.plain_run_adaptive(
                stage, lambda u: pcfl.advective_dt(u, df, sp, cfl),
                S0.clone(), T[2], T[3], steps)
        else:
            fb2.whole_run_burgers2d(got, T[0], T[1], steps, params=p,
                                    dt=cfl * min(sp), tiles=tiles,
                                    schedule=plan)
            want = wr.plain_run(stage, S0.clone(), T[2], T[3], steps,
                                cfl * min(sp))
        torch.cuda.synchronize()
        label = (f"K7{'a' if adapt else ''} WENO7 {steps} step(s) at "
                 f"{tuple(S0.shape)} ({p.flux.name}, "
                 f"{'viscous' if p.lap_taps else 'inviscid'}), "
                 f"{plan['tiles']} tiles "
                 f"({'resident' if plan['resident'] else 'reloaded'})")
        if adapt:
            if float(t_sum) != float(want_t):
                raise AssertionError(f"{label}: t_sum {float(t_sum)!r} vs "
                                     f"twin {float(want_t)!r}")
            label += f", t_sum {float(t_sum)!r} equal"
        if plan["blocks"] != plan["grid_blocks"]:
            raise AssertionError(f"{label}: plan and launch differ in blocks")
        return exact(label, got, want), plan

    print("phase 44: K7 and K7a at order 7 against their twin")
    rng = np.random.default_rng(44)

    def rand(shape):
        return torch.from_numpy(
            rng.uniform(-0.1, 1.0, shape).astype(np.float32)).cuda()

    S = rand(grid.shape)
    err = 0.0
    for steps, adapt in ((1, False), (2, True), (3, False), (5, False),
                         (5, True)):
        err = max(err, check(S, params, spacing, steps, adapt)[0])
    for adapt in (False, True):  # the main paths' state and step count
        err = max(err, check(state0.u, params, spacing, iters, adapt)[0])
    big = rand(L2_MAX_B2D)
    for steps, adapt in ((1, False), (3, True)):
        e, big_plan = check(big, params, spacing, steps, adapt)
        err = max(err, e)
    if big_plan["resident"]:
        raise AssertionError(f"{L2_MAX_B2D}: the plan is resident")
    odd_sp = (0.05, 0.07)
    for i, (name, kw, nu) in enumerate(W7_ODD_CASES):
        p = fb.stage_params(pflux.get(name, **kw), "js", odd_sp, nu,
                            order=7)
        odd = rand(ODD_2D)  # planned tiles, then one tile
        err = max(err, check(odd, p, odd_sp, 5, False)[0],
                  check(odd, p, odd_sp, 5, True)[0],
                  check(odd, p, odd_sp, 3, i % 2 == 1, (1, 1))[0])
    del big, S
    torch.cuda.empty_cache()

    T1, T2 = torch.empty_like(state0.u), torch.empty_like(state0.u)
    S = state0.u.clone()
    blocks, plan = [], {}
    alone = median_ms(lambda: fb2.whole_run_burgers2d(
        S, T1, T2, iters, params=params, dt=dt, grid_blocks=blocks,
        schedule=plan))
    alone_a = median_ms(lambda: fb2.whole_run_burgers2d(
        S, T1, T2, iters, params=params, spacing=spacing, cfl=cfl))
    floor = median_ms(lambda: fb2.whole_run_burgers2d(
        S, T1, T2, iters, params=params, dt=dt, sync_floor=True))
    stage = (lambda v, u, o, d, a, b: fb2.stage_reference(
        v, u, o, d, params=params, a=a, b=b))
    want = state0.u.clone()
    plain = cuda_ms(lambda: wr.plain_run(stage, want, T1, T2, iters, dt),
                    1)[0]
    want = state0.u.clone()
    plain_a = cuda_ms(lambda: wr.plain_run_adaptive(
        stage, lambda u: pcfl.advective_dt(u, fixed.flux.df, spacing, cfl),
        want, T1, T2, iters), 1)[0]
    del want, S
    cells = math.prod(grid.shape)
    bound = run_bound(4 * cells, k7_burgers_ops(grid.shape, iters, False,
                                                "js", False, order=7))
    bound_a = run_bound(4 * cells, k7_burgers_ops(grid.shape, iters, False,
                                                  "js", True, order=7))
    card7 = fb2.card_limits("cuda", params, False)
    card5 = fb2.card_limits("cuda", fb.stage_params(
        fixed.flux, "js", spacing, 0.0), False)
    issued = fb2.ops_issued(*grid.shape, fb2.burgers2d_schedule(
        *grid.shape, **card7, order=7), viscous=False, variant="js",
        adaptive=False, order=7)
    once = k7_burgers_ops(grid.shape, 1, False, "js", False, order=7)
    plan = {k: plan[k] for k in ("tiles", "tile", "window", "jobs", "blocks",
                                 "resident", "rounds", "smem_bytes")}
    print(f"  K7 WENO7 plan at {grid.shape}: {plan}; grid {blocks[0]} blocks "
          f"of {fb2.THREADS} threads; the order-7 instance's card numbers "
          f"{card7}, the order-5 one's {card5}")
    print(f"  issued f32 operations a step (inviscid): {issued:,} = "
          f"{issued / (3 * cells):.1f} an output cell a stage, against the "
          f"face-once count's {once / (3 * cells):.1f}: {issued / once:.3f}x")
    print(f"  alone, run({iters}) at {grid.shape}: K7 {alone:.3f} ms "
          f"({alone / iters * 1e3:.3f} us/step), K7a {alone_a:.3f} ms "
          f"({alone_a / iters * 1e3:.3f} us/step); floor {floor:.3f} ms; "
          f"bounds {bound[0]:.4f} / {bound_a[0]:.4f} ms ({bound[1]}); twins "
          f"{plain:.1f} / {plain_a:.1f} ms [{card}]")

    entry = {}
    for label, solver, key, alone_ms in (("fixed", fixed, "K7", alone),
                                         ("adaptive", adaptive, "K7a",
                                          alone_a)):
        print(f"phase 44: burgers2d_weno7, {label} dt, run({iters}) at "
              f"{grid.shape}")
        res = drive_path(f"burgers2d_weno7 {label}", solver, state0, iters,
                         key)
        generic = BurgersSolver(dataclasses.replace(solver.cfg, impl="xla"))
        gout = generic.run(state0, iters)
        in_range(f"{label} run({iters})", res["out"].u)
        print(f"  past the shock, at run({iters}): t {float(res['out'].t)!r}"
              f" (generic {float(gout.t)!r}), max|fused - generic| "
              f"{float((res['out'].u - gout.u).abs().max()):.3e} (not a "
              "check)")
        check_n = W7_2D_CHECK_ITERS
        f, g = solver.run(state0, check_n), generic.run(state0, check_n)
        if abs(float(f.t) - float(g.t)) > 1e-5 * float(g.t):
            raise AssertionError(f"t differs: {f.t} vs {g.t}")
        assert_matches(f"{label} run({check_n}) against the generic WENO7 "
                       "path", f.u, g.u, rtol=2e-5, atol=2e-6)
        del res, gout, f, g
        timing = time_path(f"burgers2d_weno7 {label}", solver, state0, iters,
                           "whole_run_kernel", card, alone_ms)
        if (timing["dtoh_copies"] or 0) > 1 or timing["host_reads"] > 1:
            raise AssertionError("the run copied to the host more than once")
        entry[key] = {"launches": 1, **timing}

    print("phase 44: K7 at order 7 against the generic path where the JAX "
          "VMEM gate declines")
    gate = {}
    for n in W7_GATE_N:
        g = Grid.make(n, n, lengths=2.0)
        fused = BurgersSolver(BurgersConfig(grid=g, weno_order=7,
                                            adaptive_dt=False,
                                            dtype="float32", impl="pallas"))
        generic = BurgersSolver(dataclasses.replace(fused.cfg, impl="xla"))
        s0 = fused.initial_state()
        label = fused.engaged_path()["stepper"]
        f_ms, f_reps = run_ms(fused, s0, W7_GATE_ITERS)
        g_ms, g_reps = run_ms(generic, s0, W7_GATE_ITERS)
        assert_matches(f"{n}^2 run({W7_GATE_ITERS})",
                       fused.run(s0, W7_GATE_ITERS).u,
                       generic.run(s0, W7_GATE_ITERS).u, rtol=2e-5,
                       atol=2e-6)
        gate[str(n)] = {"stepper": label, "ms_per_step": f_ms / W7_GATE_ITERS,
                        "generic_ms_per_step": g_ms / W7_GATE_ITERS}
        print(f"  {n}^2 fixed dt run({W7_GATE_ITERS}): {label} "
              f"{f_ms / W7_GATE_ITERS:.4f} ms/step "
              f"({[round(r, 3) for r in f_reps]} ms a run), generic-xla "
              f"{g_ms / W7_GATE_ITERS:.4f} ms/step "
              f"({[round(r, 3) for r in g_reps]}): the fused rung "
              f"{g_ms / f_ms:.2f}x faster [{card}]")
        del s0, fused, generic
        torch.cuda.empty_cache()

    common = {
        "name": "whole_run_burgers2d_weno7", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "whole_run_burgers2d.cu",
        "max_abs_err": err, "max_ulps": 0, "grid_blocks": blocks[0],
        "plan": plan, "ops_issued_per_cell": issued / (3 * cells),
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes a WENO7 "
                        "stage",
    }
    return [{
        **common, "id": "K7-w7",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "whole_run.py:28",
        **entry["K7"], "ms_isolated": alone, "sync_floor_ms": floor,
        "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
        "gate": gate,
    }, {
        **common, "id": "K7a-w7",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "whole_run.py:75",
        **entry["K7a"], "ms_isolated": alone_a, "plain_ms": plain_a,
        "bound_ms": bound_a[0], "bound_by": bound_a[1],
    }]


def k6_weno7_phase(card: str) -> dict:
    """Phase 45: K6 at order 7 against its twin, alone, and a pinned
    ``pallas_slab`` run on ``MultiGPU/Burgers3d_Baseline``'s grid;
    returns its entry."""
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    cfg = BurgersConfig(grid=grid, cfl=K6_CFL, adaptive_dt=False,
                        weno_order=7, dtype="float32", impl="pallas_slab")
    solver = BurgersSolver(cfg)
    params = fb.stage_params(solver.flux, "js", grid.spacing, 0.0, order=7)
    dt = solver.dt
    cells = grid.num_cells

    print("phase 45: K6 at order 7 against its twin")
    rng = np.random.default_rng(45)
    err = 0.0
    odd_sp = (0.05, 0.07, 0.09)
    cases = [(grid.shape, params, dt, (1,))]
    for name, kw, nu in W7_ODD_CASES:
        cases.append((ODD_SHAPE, fb.stage_params(
            pflux.get(name, **kw), "js", odd_sp, nu, order=7),
            K6_CFL * min(odd_sp), (1, 3)))
    for shape, p, dt_, step_counts in cases:
        S0 = torch.from_numpy(
            rng.uniform(-0.1, 1.0, shape).astype(np.float32)).cuda()
        for steps in step_counts:
            want = twin_steps(lambda s, d: fsr.burgers_step_reference(
                s, d, dt_, params=p), S0, steps)
            got = fsr.slab_run_burgers(S0.clone(), torch.empty_like(S0),
                                       steps, dt_, params=p)
            torch.cuda.synchronize()
            err = max(err, exact(
                f"K6 WENO7 {steps} step(s) at {shape} ({p.flux.name}, "
                f"{'viscous' if p.lap_taps else 'inviscid'})", got, want))
            del want, got
        del S0
    torch.cuda.empty_cache()

    state0 = solver.initial_state()
    A, B = state0.u.clone(), torch.empty_like(state0.u)
    blocks = []
    fsr.slab_run_burgers(A, B, 1, dt, params=params, grid_blocks=blocks)
    alone = median_ms(lambda: fsr.slab_run_burgers(
        A, B, 5, dt, params=params)) / 5
    plain_step = cuda_ms(lambda: fsr.burgers_step_reference(
        A, B, dt, params=params), 1)[0]
    del A, B
    torch.cuda.empty_cache()
    ops = k6_step_ops(grid.shape, False, "js", order=7)
    bound = 1e3 * max(8 * cells / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    planned = fsr.burgers_schedule(*grid.shape, blocks[0],
                                   order=7)["chunk_planes"]
    print(f"  K6 WENO7 alone at {grid.shape}, run(5): {alone:.4f} ms a step "
          f"(planned chunk {planned} planes); twin {plain_step:.1f} ms a "
          f"step; bound {bound:.4f} ms a step (operations: {ops / 1e9:.2f} "
          f"G, each face once) [{card}]")
    schedule_report("K6 WENO7 alone", alone, grid.shape[0], grid.shape, 1,
                    blocks[0], ops, card, order=7)

    print(f"phase 45: the pinned WENO7 slab path, fixed dt, run({W7_K6_ITERS})"
          f" at {grid.shape}")
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "fused-whole-run-slab" or path["fallback"]:
        raise AssertionError(f"pallas_slab did not engage K6: {path}")
    out = drive("pallas_slab weno7", solver, state0, W7_K6_ITERS, {"K6": 1})
    print(f"  t = {float(out.t)!r}")
    in_range(f"run({W7_K6_ITERS})", out.u)
    del out
    generic = BurgersSolver(dataclasses.replace(cfg, impl="xla"))
    f10 = solver.run(state0, K6_CHECK_ITERS)
    g10 = generic.run(state0, K6_CHECK_ITERS)
    if f10.t != g10.t:
        raise AssertionError(f"t differs: {f10.t} vs {g10.t}")
    assert_matches(f"run({K6_CHECK_ITERS}) against the generic WENO7 path",
                   f10.u, g10.u, rtol=2e-5, atol=2e-6)
    del f10, g10, generic
    torch.cuda.empty_cache()
    ms, reps = run_ms(solver, state0, W7_K6_ITERS)
    mlups = cells * W7_K6_ITERS * 3 / (ms * 1e-3) / 1e6
    print(f"  pallas_slab WENO7 run({W7_K6_ITERS}): median {ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]}; {ms / W7_K6_ITERS:.4f} ms/step; "
          f"{mlups:.0f} MLUPS; bound {bound:.4f} ms/step [{card}]")
    return {
        "name": "slab_run_burgers_weno7", "id": "K6-w7", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "slab_run_burgers.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_slab_run.py:1540",
        "launches": 1, "max_abs_err": err, "max_ulps": 0,
        "per": "step", "ms": ms / W7_K6_ITERS, "run_ms": ms,
        "ms_isolated": alone, "zchunk": planned,
        "plain_ms": plain_step, "bound_ms": bound, "bound_by": "operations",
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes an RK step",
        "ms_per_step": ms / W7_K6_ITERS, "mlups": mlups,
    }


def weno7_phases(card: str) -> list[dict]:
    """Phases 42-45; returns the four order-7 entries."""
    k5 = k5_weno7_phases(card)
    torch.cuda.empty_cache()
    k7, k7a = k7_weno7_phases(card)
    torch.cuda.empty_cache()
    k6 = k6_weno7_phase(card)
    torch.cuda.empty_cache()
    return [k5, k7, k7a, k6]


# --------------------------------------------------------------------- #
# WENO7-JS on meshes and member axes: the sharded K5, K3, K4, K2b and
# K8/K8b at order 7 (phases 46-50)
# --------------------------------------------------------------------- #
# MultiGPU/Burgers3d_Baseline (phase 14's grid) at WENO order 7 on
# {"dz": 2}, run(40); its 2-D counterpart at bench/matrix.py's
# burgers2d_weno7 grid (physical 400x408) on {"dy": 2} and {"dy": 2,
# "dx": 2}, run(200)
W7_MESH_ITERS = 40
W7_MESH_TIME_ITERS = 20  # the runs timed: run(20)
W7_2D_MESH_ITERS = 200
W7_2D_MESH_TIME_ITERS = 25  # run(100) before the script grew


def k5_sharded_w7_phase(card: str) -> dict:
    """Phase 46: K5's order-7 instance on z-slab shards of the main
    mesh path (400x400x406 on {"dz": 2}: 203 planes and 4 ghost planes a
    side) against its twin, 0 ulp: the serialized call and the split
    schedule's interior, bottom (``lo``) and top (``hi``) calls, on the
    first and the last shard, the emitted maximum folded; the
    serialized call alone and its twin, timed."""
    print("phase 46: the z-sharded K5 at order 7 against its twin")
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    params = fb.stage_params(pflux.get("burgers"), "js", grid.spacing, 0.0,
                             order=7)
    nz, ny, nx = grid.shape
    lz, r, bz = nz // MESH_SHARDS, 4, fb.SPLIT_BZ
    dt = torch.full((), K6_CFL * min(grid.spacing), device="cuda")
    rng = np.random.default_rng(46)
    err, n = 0.0, 0
    for oz in (0, nz - lz):
        v, u = (random_on_card((lz + 2 * r, ny, nx),
                               int(rng.integers(1 << 30))) for _ in range(2))
        lo, hi = (random_on_card((r, ny, nx), int(rng.integers(1 << 30)))
                  for _ in range(2))
        for role, window, ops in (("serialized", None, {}),
                                  ("interior", (bz, lz - bz), {}),
                                  ("bottom", (0, bz), {"lo": lo}),
                                  ("top", (lz - bz, lz), {"hi": hi})):
            kw = dict(params=params, a=0.75, b=0.25, zpad=r, global_nz=nz,
                      oz=oz, window=window, **ops)
            ref, mref = fb.stage_reference(v, u, torch.zeros_like(v), dt,
                                           emit=True, **kw)
            got, mx = torch.zeros_like(v), torch.full((), 7.0,
                                                      device="cuda")
            fb.fused_burgers_stage(v, u, got, dt, mx, mx_init=False, **kw)
            torch.cuda.synchronize()
            err = max(err, exact(f"K5 sharded WENO7 {role} {window} at "
                                 f"shard z {oz}", got, ref))
            if float(mx) != max(7.0, float(mref)):
                raise AssertionError(f"K5 sharded WENO7 {role}: maximum "
                                     f"{float(mx)} vs {float(mref)}")
            n += 1
            del ref, got
        del v, u, lo, hi
        torch.cuda.empty_cache()
    sets = [[random_on_card((lz + 2 * r, ny, nx), 460 + 3 * i + j)
             for j in range(3)] for i in range(3)]
    kw = dict(params=params, a=0.75, b=0.25, zpad=r, global_nz=nz, oz=0)
    ms = alone_ms(lambda s: fb.fused_burgers_stage(s[0], s[1], s[2], dt,
                                                   **kw), sets, 5)
    plain = statistics.median(cuda_ms(lambda: fb.stage_reference(
        sets[0][0], sets[0][1], sets[0][2], dt, **kw), 2))
    del sets
    torch.cuda.empty_cache()
    cells = lz * ny * nx
    bound, by = kernel_bound((lz + 2 * r) * ny * nx + cells, cells,
                             k5_stage_ops((lz, ny, nx), True, False, "js",
                                          order=7))
    print(f"  K5 sharded WENO7: {n} calls 0 ulp; alone ({lz}+2x{r} planes, "
          f"stage 2) {ms:.4f} ms; twin {plain:.2f} ms; bound {bound:.4f} ms "
          f"({by}) [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "checks": n}


def slab_w7_twin_phase(card: str) -> dict:
    """Phase 47: K3 and K4 at order 7 against their twins at the main
    shards' shapes (G = 12): K3 over every window of the per-step, split
    and k = 4 schedules on the first and the last shard, K4 at k = 1 (3
    steps) and k = 4 (5 steps, a partial block); each alone, timed."""
    print("phase 47: K3 and K4 at order 7 against their twins")
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    params = fb.stage_params(pflux.get("burgers"), "js", grid.spacing, 0.0,
                             order=7)
    dt = K6_CFL * min(grid.spacing)
    nz, ny, nx = grid.shape
    lz, G = nz // MESH_SHARDS, 12
    shape = (lz, ny, nx)
    k3 = k3_check(
        "burgers WENO7", shape,
        lambda S, o, **kw: fsr.slab_step_burgers(S, o, dt, params=params,
                                                 **kw),
        lambda S, o, **kw: fsr.slab_step_burgers_reference(
            S, o, dt, params=params, **kw), G, 0, None, card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops = k6_step_ops(shape, False, "js", order=7)
    schedule_report("K3 burgers WENO7 alone (one shard's step)", k3["ms"],
                    lz, shape, 1, sms, ops, card,
                    grid=" (one an SM; the launch: one block a job)",
                    order=7)

    def run(S0, S1, L, steps, k, **kw):
        return fsr.slab_run_dma_burgers(S0, S1, L, steps, dt, params=params,
                                        k=k, **kw)

    def ref(S, out, gnz, oz, depth, window):
        return fsr.slab_step_burgers_reference(
            S, out, dt, params=params, global_nz=gnz, oz=oz, depth=depth,
            window=window)

    k4_err = max(k4_check("burgers WENO7", run, ref, MESH_SHARDS, lz, k, G,
                          ny, nx, 0, steps, 470 + k)
                 for k, steps in ((1, 3), (K4_DEEP, 5)))
    k4 = k4_alone("burgers WENO7", run, ref, MESH_SHARDS, lz, G, ny, nx, 0,
                  W7_MESH_TIME_ITERS, card)
    schedule_report("K4 burgers WENO7 alone", k4["ms"], lz, grid.shape,
                    MESH_SHARDS, k4["grid_blocks"],
                    k6_step_ops(grid.shape, False, "js", order=7), card,
                    order=7)
    k3_bound = kernel_bound((lz + 2 * G) * ny * nx, lz * ny * nx, ops)
    k4_bound = run_bound(4 * grid.num_cells, k6_step_ops(
        grid.shape, False, "js", order=7))
    return {"K3": {**k3, "bound_ms": k3_bound[0], "bound_by": k3_bound[1]},
            "K4": {**k4, "max_abs_err": k4_err, "bound_ms": k4_bound[0],
                   "bound_by": k4_bound[1]}}


def zslab_w7_paths(card: str) -> dict:
    """Phase 48: MultiGPU/Burgers3d_Baseline at WENO order 7 on {"dz": 2}
    (cuda:0 twice), run(40): the pallas rung (K5) fixed and adaptive,
    serialized and split; pallas_slab on K3 at k = 1 and 4 and on K4
    (exchange='dma') at k = 1 and 4. Each run 0 ulp and ``t`` equal to
    the unsharded run of its rung (K5, or K6 at order 7), its launches
    as driven, ms/step over run(20)."""
    n = W7_MESH_ITERS
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    cfg = BurgersConfig(grid=grid, cfl=K6_CFL, weno_order=7,
                        adaptive_dt=False, dtype="float32", impl="pallas")
    print(f"phase 48: MultiGPU/Burgers3d_Baseline at WENO order 7 on "
          f"{{'dz': 2}} (cuda:0 twice), run({n}) at {grid.shape}")
    mesh = two_shards()
    runs = {}
    for name, kw, plain, expect, label in (
            ("K5 fixed", {}, "pallas_stage", {"K5": 6 * n},
             ("fused-stage", "serialized-refresh", 1)),
            ("K5 fixed split", {"overlap": "split"}, "pallas_stage",
             {"K5": 18 * n}, ("fused-stage", "split", 1)),
            ("K5 adaptive", {"adaptive_dt": True}, "pallas_stage",
             {"K5": 6 * n}, ("fused-stage", "serialized-refresh", 1)),
            ("K5 adaptive split", {"adaptive_dt": True, "overlap": "split"},
             "pallas_stage", {"K5": 18 * n}, ("fused-stage", "split", 1)),
            ("K3 k=1", {"impl": "pallas_slab"}, "pallas_slab",
             {"K3-burgers": 2 * n},
             ("fused-whole-run-slab", "serialized-refresh", 1)),
            (f"K3 k={K3_DEEP}", {"impl": "pallas_slab",
                                 "steps_per_exchange": K3_DEEP},
             "pallas_slab", {"K3-burgers": 2 * n},
             ("fused-whole-run-slab", "serialized-refresh", K3_DEEP))):
        c = dataclasses.replace(cfg, **kw)
        solver = BurgersSolver(c, mesh=mesh)
        one = BurgersSolver(dataclasses.replace(
            c, impl=plain, overlap="padded", steps_per_exchange=1))
        state0 = solver.initial_state()
        runs[name] = mesh_run(f"WENO7 {name}", solver, one, state0, n,
                              expect, label, card,
                              time_iters=W7_MESH_TIME_ITERS,
                              check=lambda out: in_range(
                                  "sharded run", out.u.assemble()))
        runs[name]["launches"] = sum(expect.values())
        if name in ("K5 fixed", "K3 k=1"):
            runs[name].update(mesh2d_profile(
                f"WENO7 {name}", solver, state0, n,
                "stage_kernel" if name == "K5 fixed" else "step_kernel",
                card))
        if name == "K5 adaptive":
            reads = count_reads(lambda: solver.run(state0, n))
            print(f"  WENO7 {name}: host reads of device scalars {reads}")
            if reads > 1:
                raise AssertionError("the sharded adaptive run read dt back")
            runs[name]["host_reads"] = reads
        del solver, one, state0
        torch.cuda.empty_cache()
    slab = dataclasses.replace(cfg, impl="pallas_slab")
    one = BurgersSolver(slab)
    for k in (1, K4_DEEP):
        c = dataclasses.replace(slab, steps_per_exchange=k)
        solver = BurgersSolver(dataclasses.replace(c, exchange="dma"),
                               mesh=two_shards())
        coll = BurgersSolver(c, mesh=two_shards())
        state0 = solver.initial_state()
        runs[f"K4 k={k}"] = dma_path(f"WENO7 K4 k={k}", solver, coll, one,
                                     state0, n, {"K4-burgers": 1}, card,
                                     W7_MESH_TIME_ITERS)
        del solver, coll, state0
        torch.cuda.empty_cache()
    return runs


def k2b_w7_phase(card: str) -> dict:
    """Phase 49: K2b at order 7, bench.py's Burgers ensemble row (B = 8
    at 128x64x64, nu 1e-5, fixed dt, run(30)) at WENO order 7: the
    ensemble engine's path (one K2b launch), K2b against its twin at 0
    ulp, every member equal to its single K6 run to the bit; alone,
    timed, with its bound."""
    B, n = ENSB_MEMBERS, ENSB_ITERS
    print(f"phase 49: K2b at order 7, B={B} at {ENSB_N}, run({n})")
    cfg = dataclasses.replace(ens_cfg("burgers", "pallas_slab"),
                              weno_order=7)
    es = EnsembleSolver(BurgersSolver, cfg, width_sweep(B))
    est = es.initial_state()
    reset_counts()
    out = es.run(est, n)
    torch.cuda.synchronize()
    got_counts = counts()
    print(f"  ensemble run({n}): launches {got_counts}; engaged "
          f"{es.engaged_path()['stepper']}")
    if (es.engaged_path()["stepper"] != "ensemble-fold[fused-whole-run-slab]"
            or got_counts != {k: (1 if k == "K2b-burgers" else 0)
                              for k in COUNTERS}):
        raise AssertionError("the WENO7 ensemble did not fold into K2b")
    for i in range(B):
        ms_ = es.member_solver(i)
        single = ms_.run(ms_.initial_state(), n)
        if ulps(out.u[i], single.u) != 0 or out.t[i] != single.t:
            raise AssertionError(f"member {i} differs from its single run")
    print(f"  all {B} members equal their single K6 WENO7 runs to the bit")
    in_range("the ensemble", out.u)
    del out
    st = es.solver._fused_stepper()
    S0 = st.embed_batched(est.u)
    shape = es.solver.grid.shape
    cells = es.solver.grid.num_cells
    got = st._whole_run_batched(S0.clone(), S0.clone(), n)
    want = []
    plain = cuda_ms(lambda: want.append(fsr.ping_pong_members(
        lambda s, d: fsr.burgers_step_reference(s, d, st.dt,
                                                params=st.params),
        S0.clone(), S0.clone(), n)), 1)[0]
    err = exact(f"K2b WENO7, B={B}, {n} steps at {shape}", got, want.pop())
    del got
    A, C = S0.clone(), S0.clone()
    blocks = []
    fsr.slab_run_burgers_batched(A, C, 1, st.dt, params=st.params,
                                 grid_blocks=blocks)
    reps = cuda_ms(lambda: st._whole_run_batched(A, C, n), 4)[1:]
    ms = statistics.median(reps)
    del A, C, S0
    torch.cuda.empty_cache()
    ops = k6_step_ops(shape, True, "js", order=7)
    bound, by = run_bound(4 * cells * B, ops * B * n)
    print(f"  K2b WENO7 alone, B={B}, run({n}): median {ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]} on {blocks[0]} blocks; bound "
          f"{bound:.3f} ms ({by}); twin {plain:.1f} ms [{card}]")
    schedule_report("K2b WENO7", ms / n, shape[0], shape, B, blocks[0],
                    B * ops, card, order=7)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "grid_blocks": blocks[0],
            "members": B, "steps": n}


def mesh2d_w7_phase(card: str) -> dict:
    """Phase 50: K8 and K8b at order 7 against their twin at the main
    shard's shape (204x400 of 408x400 on {"dy": 2}, halo 4) and an odd
    one, every stage kind and band, on the first, a middle and the last
    shard of dy = 4 and a pencil's corner; then burgers2d_weno7 on {"dy":
    2}, serialized (K8) and split (K8b), fixed and adaptive dt, and on
    {"dy": 2, "dx": 2}, fixed and adaptive, each run(200) 0 ulp and ``t``
    equal to the unsharded K7/K7a run."""
    print("phase 50: K8 and K8b at order 7 against their twin")
    n = W7_2D_MESH_ITERS
    grid = Grid.make(*W7_2D_N, lengths=2.0)
    params = fb.stage_params(pflux.get("burgers"), "js", grid.spacing, 0.0,
                             order=7)
    dt = torch.full((), 0.4 * min(grid.spacing), device="cuda")
    main_shape = (grid.shape[0] // MESH_SHARDS, grid.shape[1])
    rng = np.random.default_rng(50)
    err, checks = 0.0, 0
    for shape in (main_shape, K8_ODD):
        c, e = k8_check("burgers WENO7", params, shape, dt, rng)
        checks, err = checks + c, max(err, e)
    print(f"  K8/K8b WENO7: {checks} checks, 0 ulp, max|kernel - twin| "
          f"{err:.3e}")
    timing = k8_timing(params, main_shape, dt, card)
    timing["large"] = k8_timing(params, K8_LARGE, dt, card, plain=False)
    torch.cuda.empty_cache()

    print(f"phase 50: burgers2d_weno7 on {{'dy': 2}} and {{'dy': 2, 'dx': "
          f"2}}, run({n}) at {grid.shape}")
    cfg = BurgersConfig(grid=grid, weno_order=7, adaptive_dt=False,
                        dtype="float32", impl="pallas")
    pencil = (pmesh.make_mesh({"dy": 2, "dx": 2},
                              devices=[torch.device("cuda:0")] * 4),
              pmesh.Decomposition.of({0: "dy", 1: "dx"}))
    runs = {}
    for name, kw, mesh, expect, label in (
            ("K8 fixed", {}, (dy2_mesh(), None), {"K8": 6 * n},
             ("fused-stage", "serialized-refresh", 1)),
            ("K8b fixed split", {"overlap": "split"}, (dy2_mesh(), None),
             {"K8b": 12 * n}, ("fused-stage", "split", 1)),
            ("K8 adaptive", {"adaptive_dt": True}, (dy2_mesh(), None),
             {"K8": 6 * n}, ("fused-stage", "serialized-refresh", 1)),
            ("K8b adaptive split", {"adaptive_dt": True, "overlap": "split"},
             (dy2_mesh(), None), {"K8b": 12 * n}, ("fused-stage", "split",
                                                   1)),
            ("pencil fixed", {}, pencil, {"K8": 12 * n},
             ("fused-stage", "serialized-refresh", 1)),
            ("pencil adaptive", {"adaptive_dt": True}, pencil,
             {"K8": 12 * n}, ("fused-stage", "serialized-refresh", 1))):
        c = dataclasses.replace(cfg, **kw)
        solver = BurgersSolver(c, mesh=mesh[0], decomp=mesh[1])
        one = BurgersSolver(dataclasses.replace(c, overlap="padded"))
        state0 = solver.initial_state()
        r = mesh_run(f"WENO7 {name}", solver, one, state0, n, expect, label,
                     card, time_iters=W7_2D_MESH_TIME_ITERS)
        r["launches"] = sum(expect.values())
        if name in ("K8 fixed", "K8b fixed split"):
            r.update(mesh2d_profile(f"WENO7 {name}", solver, state0, n,
                                    K8_KERNELS, card))
        if "adaptive" in name and "pencil" not in name:
            r["host_reads"] = count_reads(lambda: solver.run(state0, n))
            print(f"  WENO7 {name}: host reads of device scalars "
                  f"{r['host_reads']}")
            if r["host_reads"] > 1:
                raise AssertionError("the sharded adaptive run read dt back")
        runs[name] = r
        del solver, one, state0
        torch.cuda.empty_cache()
    return {"max_abs_err": err, "checks": checks, "timing": timing,
            "paths": runs}


def weno7_mesh_phases(card: str) -> list[dict]:
    """Phases 46-50; returns the six order-7 mesh and batched entries."""
    k5 = k5_sharded_w7_phase(card)
    torch.cuda.empty_cache()
    slab = slab_w7_twin_phase(card)
    torch.cuda.empty_cache()
    paths = zslab_w7_paths(card)
    torch.cuda.empty_cache()
    k2b = k2b_w7_phase(card)
    torch.cuda.empty_cache()
    m2d = mesh2d_w7_phase(card)
    torch.cuda.empty_cache()
    src = "multigpu_advectiondiffusion_tpu_torch/csrc/"
    pallas = "multigpu_advectiondiffusion_tpu/ops/pallas/"
    none = {"library_ms": None,
            "library_call": "none: no single PyTorch call computes a WENO7 "
                            "stage"}
    t = m2d["timing"]
    bands = list(t["bands"].values())
    k3, k4 = slab["K3"], slab["K4"]
    return [{
        "name": "fused_burgers_stage_weno7 (z-sharded)", "id": "K5-w7-dz",
        "route": "cuda", "source": src + "fused_burgers_stage.cu",
        "replaces": pallas + "fused_burgers.py:352",
        "launches": paths["K5 fixed"]["launches"],
        "max_abs_err": k5["max_abs_err"], "max_ulps": 0,
        "ms": paths["K5 fixed"]["kernel_ms_in_run"] or k5["ms"],
        "ms_isolated": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], **none,
        "paths": {k: v for k, v in paths.items() if k.startswith("K5")},
    }, {
        "name": "slab_step_burgers_weno7", "id": "K3-w7", "route": "cuda",
        "source": src + "slab_run_burgers.cu",
        "replaces": pallas + "fused_slab_run.py:508",
        "launches": paths["K3 k=1"]["launches"],
        "max_abs_err": k3["max_abs_err"], "max_ulps": 0,
        "ms": paths["K3 k=1"]["kernel_ms_in_run"] or k3["ms"],
        "ms_isolated": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], **none,
        "windows_checked": k3["windows"],
        "paths": {k: v for k, v in paths.items() if k.startswith("K3")},
    }, {
        "name": "slab_run_dma_burgers_weno7", "id": "K4-w7", "route": "cuda",
        "source": src + "slab_run_burgers.cu",
        "replaces": pallas + "fused_slab_run.py:327",
        "launches": 1, "per": "step", "max_abs_err": k4["max_abs_err"],
        "max_ulps": 0, "ms": paths["K4 k=1"]["ms_per_step"],
        "ms_isolated": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], **none,
        "grid_blocks": k4["grid_blocks"],
        "paths": {k: v for k, v in paths.items() if k.startswith("K4")},
    }, {
        "name": "slab_run_burgers_batched_weno7", "id": "K2b-w7",
        "route": "cuda", "source": src + "slab_run_burgers.cu",
        "replaces": pallas + "fused_slab_run.py:933",
        "launches": 1, "max_abs_err": k2b["max_abs_err"], "max_ulps": 0,
        "ms": k2b["ms"], "plain_ms": k2b["plain_ms"],
        "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"], **none,
        "members": k2b["members"], "steps": k2b["steps"],
        "grid_blocks": k2b["grid_blocks"],
    }, {
        "name": "fused2d_stage_weno7", "id": "K8-w7", "route": "cuda",
        "source": src + "fused2d_sharded.cu",
        "replaces": pallas + "fused2d_sharded.py:195",
        "launches": m2d["paths"]["K8 fixed"]["launches"],
        "max_abs_err": m2d["max_abs_err"], "max_ulps": 0,
        "ms": m2d["paths"]["K8 fixed"]["kernel_ms_in_run"] or t["ms"],
        "ms_isolated": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], **none, "plan": t["plan"],
        "host_ms_a_launch": t["host_ms"],
        "large": {k: t["large"][k] for k in ("ms", "bound_ms", "bound_by",
                                             "plan")},
        "paths": {k: v for k, v in m2d["paths"].items()
                  if not k.startswith("K8b")},
    }, {
        "name": "fused2d_band_stage_weno7", "id": "K8b-w7", "route": "cuda",
        "source": src + "fused2d_sharded.cu",
        "replaces": pallas + "fused2d_sharded.py:231",
        "launches": m2d["paths"]["K8b fixed split"]["launches"],
        "max_abs_err": m2d["max_abs_err"], "max_ulps": 0,
        "ms": (m2d["paths"]["K8b fixed split"]["kernel_ms_in_run"]
               or statistics.mean(b["ms"] for b in bands)),
        "ms_isolated": statistics.mean(b["ms"] for b in bands),
        "plain_ms": statistics.mean(b["plain_ms"] for b in bands),
        "bound_ms": statistics.mean(b["bound_ms"] for b in bands),
        "bound_by": bands[0]["bound_by"], **none, "bands": t["bands"],
        "large": t["large"]["bands"],
        "paths": {k: v for k, v in m2d["paths"].items()
                  if k.startswith("K8b")},
    }]


# --------------------------------------------------------------------- #
# Storage precision on one device: float64 storage on K1/K2, and the bf16
# instances of K1, K2, K6 (R = 3, 4) and K9 (phases 51-56)
# --------------------------------------------------------------------- #
BF16 = torch.bfloat16
PREC_ODD_BC = 0.1  # a wall value bf16 cannot hold: the ghost ring rounds it
# the JAX package's bf16 band (diagnostics/compare.py:76-89): relative L2
# against the float32 run
BF16_BAND = 2e-2
K6_BF16_W7_ITERS = 40


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def stage_twin_run(st, u0, iters: int, reference, kw: dict):
    """The plain twin of ``iters`` steps of a per-stage bf16 stepper (K1,
    K9) on the card: its three stages through ``fd.upcast_twin`` on the
    stepper's own buffers, the last in place; returns the extracted
    state."""
    S = st.embed(u0)
    T1, T2 = S.clone(), S.clone()
    dt = np.float32(st.dt)
    for _ in range(iters):
        for v, u, out, (a, b) in ((S, None, T1, fd.STAGES[0]),
                                  (T1, S, T2, fd.STAGES[1]),
                                  (T2, S, S, fd.STAGES[2])):
            fd.upcast_twin(reference, v, u, out, dt, a=a, b=b, **kw)
    return st.extract(S)


def heat_errors(out, solver32) -> tuple[float, float]:
    """L2 (grid-weighted) and Linf of ``out`` against the exact heat
    kernel at its time, evaluated in float32."""
    ref = solver32.exact_solution(float(out.t))
    d = out.u.float() - ref
    l2 = float(torch.sqrt((d.double() ** 2).sum()
                          * math.prod(solver32.grid.spacing)))
    return l2, float(d.abs().max())


def k1_bf16_phase(card: str) -> dict:
    """Phase 51: K1's bf16 instance against its twin to the bit, every
    stage kind, at the main path's shape (wall 0) and the odd shape (a
    wall value bf16 rounds), and alone at the main shape beside its
    bytes bound (4 B a cell at stage 1, 6 at stages 2-3) and the twin."""
    print("phase 51: K1's bf16 instance against its twin")
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    dt = DiffusionSolver(DiffusionConfig(grid=grid)).dt
    taps = fd.stage_taps(grid.spacing, [1.0] * 3)
    res = {"err": 0.0, "ms": [], "plain_ms": [], "bound_ms": []}
    for shape, bc in ((grid.shape, 0.0), (ODD_SHAPE, PREC_ODD_BC)):
        for kind, (a, b) in enumerate(fd.STAGES):
            has_u = kind > 0
            v = padded_random(shape, bc, 510 + kind).to(BF16)
            u = padded_random(shape, bc, 520 + kind).to(BF16) \
                if has_u else None
            out = torch.full_like(v, fd.bf16_value(bc))
            ref = out.clone()
            kw = dict(taps=taps, a=a, b=b, band=2, bc_value=bc)
            fd.upcast_twin(fd.stage_reference, v, u, ref, dt, **kw)
            fd.fused_stage_bf16(v, u, out, dt, **kw)
            torch.cuda.synchronize()
            res["err"] = max(res["err"], exact(
                f"K1 bf16 stage {kind + 1} at {shape}, wall {bc}", out, ref))
            if shape != grid.shape:
                continue
            buffers = [(v.clone(), None if u is None else u.clone(),
                        out.clone()) for _ in range(ROTATE)]
            res["ms"].append(alone_ms(lambda bufs: fd.fused_stage_bf16(
                bufs[0], bufs[1], bufs[2], dt, **kw), buffers, 21))
            del buffers
            res["plain_ms"].append(statistics.median(cuda_ms(
                lambda: fd.upcast_twin(fd.stage_reference, v, u, ref, dt,
                                       **kw), 3)))
            res["bound_ms"].append(1e3 * max(
                stage_bytes(shape, has_u) / 2 / HBM_BYTES_PER_S,
                stage_ops(shape, has_u) / F32_OPS_PER_S))
            print(f"    K1 bf16 stage {kind + 1} alone {res['ms'][-1]:.4f} "
                  f"ms; twin {res['plain_ms'][-1]:.4f} ms; bound "
                  f"{res['bound_ms'][-1]:.4f} ms (bytes) [{card}]")
        del v, u, out, ref
        torch.cuda.empty_cache()
    return {
        "name": "fused_diffusion_stage_bf16", "id": "K1-bf16",
        "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_diffusion_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_diffusion.py:205",
        "max_abs_err": res["err"], "max_ulps": 0,
        "ms_isolated": statistics.mean(res["ms"]),
        "plain_ms": statistics.mean(res["plain_ms"]),
        "bound_ms": statistics.mean(res["bound_ms"]), "bound_by": "bytes",
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the stage",
    }


def bf16_diffusion_paths(card: str, k1b: dict) -> dict:
    """Phase 52: the diffusion main path (400x200x206, ``run(101)``) under
    ``precision="bf16"`` on K1's bf16 instance (``impl="pallas"``, 303
    launches) and K2's (``impl="pallas_slab"``, one launch), and under
    ``dtype="bfloat16"`` (K1's bf16 instance, 303 launches), each equal
    to its twin run on the card to the bit, with its error against the
    exact heat kernel beside the float32 path's; ms/step of each."""
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    f32 = DiffusionSolver(DiffusionConfig(grid=grid, impl="pallas"))
    out32 = f32.run(f32.initial_state(), ITERS)
    err32 = heat_errors(out32, f32)
    print(f"phase 52: bf16 storage on the diffusion main path, run({ITERS})"
          f"; float32 K1 path: error vs exact L2 {err32[0]:.4e}, Linf "
          f"{err32[1]:.4e}")
    del out32
    res = {}
    for name, kw, key, launches in (
            ("precision=bf16, pallas", dict(precision="bf16", impl="pallas"),
             "K1-bf16", 3 * ITERS),
            ("precision=bf16, pallas_slab",
             dict(precision="bf16", impl="pallas_slab"), "K2-bf16", 1),
            ("dtype=bfloat16, pallas", dict(dtype="bfloat16", impl="pallas"),
             "K1-bf16", 3 * ITERS)):
        solver = DiffusionSolver(DiffusionConfig(grid=grid, **kw))
        path = solver.engaged_path()
        print(f"  {name}: engaged {path}")
        if path["storage_dtype"] != "bfloat16" or path["stepper"] != (
                "fused-whole-run-slab" if key == "K2-bf16"
                else "fused-stage"):
            raise AssertionError(f"{name} did not engage {key}: {path}")
        state0 = solver.initial_state()
        out = drive(name, solver, state0, ITERS, {key: launches})
        st = solver._fused_stepper()
        skw = dict(taps=st.taps, band=st.band, bc_value=st.bc_value)
        if key == "K2-bf16":
            S0 = st.embed(state0.u)
            twin = st.extract(fsr.ping_pong(
                lambda s, d: fsr.rounded_step(
                    lambda x, y: fds.step_reference(x, y, st.dt, **skw),
                    s, d), S0, S0.clone(), ITERS))
        else:
            twin = stage_twin_run(st, state0.u, ITERS, fd.stage_reference,
                                  skw)
        torch.cuda.synchronize()
        exact(f"{name} run({ITERS}) against its twin run", out.u, twin)
        if out.t != wr.accumulate_t(state0.t, st.dt, ITERS):
            raise AssertionError(f"{name}: t {out.t!r}")
        l2, linf = heat_errors(out, f32)
        ms, reps = run_ms(solver, state0, ITERS)
        print(f"  {name}: error vs exact L2 {l2:.4e}, Linf {linf:.4e} "
              f"(float32 path {err32[0]:.4e}, {err32[1]:.4e}); run({ITERS}) "
              f"median {ms:.3f} ms of {[round(r, 3) for r in reps]}, "
              f"{ms / ITERS:.4f} ms/step [{card}]")
        res[name] = {"launches": launches, "ms_per_step": ms / ITERS,
                     "error_l2": l2, "error_linf": linf}
        del out, twin, solver, st
        torch.cuda.empty_cache()
    res["float32 K1 error (l2, linf)"] = err32
    k1b["launches"] = 3 * ITERS
    k1b["paths"] = res
    k1b["ms_per_step"] = res["precision=bf16, pallas"]["ms_per_step"]
    return res


def f64_storage_phase(card: str) -> dict:
    """Phase 53: float64 storage on the diffusion main path (400x200x206,
    ``run(101)``) under ``impl="pallas"`` (K1 at this size, 303 launches)
    and ``"pallas_slab"`` (K2, one launch): equal to the float32 kernel
    run from ``f32(u0)`` after the upcast, ``t`` by the JAX package's
    rules (K1 adds ``f32(dt)`` a step, the slab rung the float64 dt)."""
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    print(f"phase 53: float64 storage on K1 and K2, run({ITERS})")
    res = {}
    for impl, key, launches in (("pallas", "K1", 3 * ITERS),
                                ("pallas_slab", "K2", 1)):
        s64 = DiffusionSolver(DiffusionConfig(grid=grid, dtype="float64",
                                              impl=impl))
        s32 = DiffusionSolver(DiffusionConfig(grid=grid, impl=impl))
        path = s64.engaged_path()
        print(f"  {impl}: engaged {path}")
        if path["storage_dtype"] != "float32" or (
                path["stepper"] == "fused-stage") != (key == "K1"):
            raise AssertionError(f"float64 {impl} did not engage {key}")
        state0 = s64.initial_state()
        out = drive(f"float64 {impl}", s64, state0, ITERS, {key: launches})
        state32 = state0._replace(u=state0.u.float(),
                                  t=np.float32(state0.t))
        ref = s32.run(state32, ITERS)
        if out.u.dtype != torch.float64 or not torch.equal(
                out.u, ref.u.double()):
            raise AssertionError(f"float64 {impl}: not the float32 run "
                                 f"upcast")
        step = np.float64(np.float32(s64.dt) if key == "K1" else s64.dt)
        t = state0.t
        for _ in range(ITERS):
            t = t + step
        if not (isinstance(out.t, np.float64) and out.t == t):
            raise AssertionError(f"float64 {impl}: t {out.t!r}, want {t!r}")
        ms, reps = run_ms(s64, state0, ITERS)
        ms32, _ = run_ms(s32, state32, ITERS)
        print(f"  float64 {impl}: equal to the float32 {key} run upcast, t "
              f"{out.t!r}; run({ITERS}) {ms / ITERS:.4f} ms/step (float32 "
              f"{ms32 / ITERS:.4f}) [{card}]")
        res[impl] = {"kernel": key, "launches": launches,
                     "ms_per_step": ms / ITERS,
                     "f32_ms_per_step": ms32 / ITERS}
        del out, ref, s64, s32, state32
        torch.cuda.empty_cache()
    return res


def k2_bf16_phase(card: str) -> dict:
    """Phase 54 (diffusion): K2's bf16 instance against its twin to the
    bit (1 and 5 steps at the main shape, 3 at the odd shape with a wall
    value bf16 rounds); alone at the main shape, ``run(5)`` a step,
    beside its bound (the three stages' operations; 4 B a cell a step of
    bytes) and the twin."""
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    dt = DiffusionSolver(DiffusionConfig(grid=grid)).dt
    taps = fd.stage_taps(grid.spacing, [1.0] * 3)
    print("phase 54: K2's bf16 instance against its twin")
    err = 0.0
    for shape, bc, counts_ in ((grid.shape, 0.0, (1, 5)),
                               (ODD_SHAPE, PREC_ODD_BC, (3,))):
        kw = dict(taps=taps, band=2, bc_value=bc)
        S0 = padded_random(shape, bc, 540).to(BF16)
        for steps in counts_:
            want = twin_steps(lambda s, d: fsr.rounded_step(
                lambda x, y: fds.step_reference(x, y, dt, **kw), s, d),
                S0, steps)
            got = fsr.slab_run_diffusion_bf16(S0.clone(), S0.clone(),
                                              steps, dt, **kw)
            torch.cuda.synchronize()
            err = max(err, exact(f"K2 bf16 {steps} step(s) at {shape}, "
                                 f"wall {bc}", got, want))
    kw = dict(taps=taps, band=2, bc_value=0.0)
    S0 = padded_random(grid.shape, 0.0, 541).to(BF16)
    A, B = S0.clone(), S0.clone()
    blocks = []
    fsr.slab_run_diffusion_bf16(A, B, 1, dt, grid_blocks=blocks, **kw)
    alone = median_ms(lambda: fsr.slab_run_diffusion_bf16(
        A, B, 5, dt, **kw)) / 5
    plain = cuda_ms(lambda: fsr.rounded_step(
        lambda x, y: fds.step_reference(x, y, dt, **kw), A, B), 1)[0]
    cells = grid.num_cells
    bound, by = run_bound(2 * cells, 100 * cells)
    print(f"  K2 bf16 alone at {grid.shape}, run(5): {alone:.4f} ms a step "
          f"on {blocks[0]} blocks; twin {plain:.3f} ms a step; bound "
          f"{bound:.4f} ms a step ({by}; the bytes, 4 B a cell, "
          f"{1e3 * 4 * cells / HBM_BYTES_PER_S:.4f}) [{card}]")
    del S0, A, B
    torch.cuda.empty_cache()
    return {
        "name": "slab_run_diffusion_bf16", "id": "K2-bf16", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_step_diffusion.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_slab_run.py:1345",
        "max_abs_err": err, "max_ulps": 0, "per": "step",
        "ms_isolated": alone, "plain_ms": plain, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "library_call": "none: no single PyTorch call computes an RK step",
    }


def k6_bf16_phase(card: str, order: int, iters: int) -> dict:
    """Phase 54 (Burgers): K6's bf16 instance at WENO ``order`` (R = 3 or
    4) against its twin to the bit at bench.py's Burgers ensemble grid
    (128x64x64, 1 and 5 steps) and the odd shape (1 and 3 steps,
    viscous); alone, ``run(5)`` a step, beside its bound and the twin;
    that grid's single run (``run(30)``, fixed dt) under
    ``precision="bf16"``, ``impl="pallas"`` (the slab pinned, one
    launch), its distance from the float32 K6 run reported; then
    ``MultiGPU/Burgers3d_Baseline`` (400x400x406, fixed dt) ``run(iters)``
    under ``precision="bf16"``: the JAX package's decline there (its
    slab's bf16 plane gate, ``fused_slab_run.jax_bf16_slab_fits``) to
    the carried generic loop, held within the JAX package's bf16 band of
    the float32 K6 run, and K6's bf16 instance forced on that grid (the
    wrapper, no gate) reported beside it."""
    grid = Grid.make(*ENSB_N, lengths=2.0)
    cfg = BurgersConfig(grid=grid, nu=1e-5, adaptive_dt=False,
                        weno_order=order, impl="pallas", precision="bf16")
    solver = BurgersSolver(cfg)
    dt = solver.dt
    params = fb.stage_params(solver.flux, "js", grid.spacing, 1e-5,
                             order=order)
    odd_sp = (0.05, 0.07, 0.09)
    odd = fb.stage_params(pflux.burgers(), "js", odd_sp, 1e-3, order=order)
    print(f"phase 54: K6's bf16 instance at order {order} against its twin")
    rng = np.random.default_rng(540 + order)
    err = 0.0
    for shape, p, dt_, step_counts in ((grid.shape, params, dt, (1, 5)),
                                       (ODD_SHAPE, odd, K6_CFL * min(odd_sp),
                                        (1, 3))):
        S0 = torch.from_numpy(rng.uniform(-0.1, 1.0, shape).astype(
            np.float32)).cuda().to(BF16)
        for steps in step_counts:
            want = twin_steps(lambda s, d: fsr.rounded_step(
                lambda x, y: fsr.burgers_step_reference(x, y, dt_, params=p),
                s, d), S0, steps)
            got = fsr.slab_run_burgers_bf16(S0.clone(), S0.clone(), steps,
                                            dt_, params=p)
            torch.cuda.synchronize()
            err = max(err, exact(f"K6 bf16 order {order}, {steps} step(s) "
                                 f"at {shape}", got, want))
            del want, got
        del S0
    state0 = solver.initial_state()
    A, B = state0.u.to(BF16), state0.u.to(BF16)
    blocks = []
    fsr.slab_run_burgers_bf16(A, B, 1, dt, params=params, grid_blocks=blocks)
    alone = median_ms(lambda: fsr.slab_run_burgers_bf16(
        A, B, 5, dt, params=params)) / 5
    plain = cuda_ms(lambda: fsr.rounded_step(
        lambda x, y: fsr.burgers_step_reference(x, y, dt, params=params),
        A, B), 1)[0]
    del A, B
    cells = grid.num_cells
    ops = k6_step_ops(grid.shape, True, "js", order=order)
    bound = 1e3 * max(4 * cells / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    print(f"  K6 bf16 order {order} alone at {grid.shape}, run(5): "
          f"{alone:.4f} ms a step on {blocks[0]} blocks; twin {plain:.2f} ms "
          f"a step; bound {bound:.4f} ms a step (operations) [{card}]")

    print(f"phase 54: Burgers {grid.shape} at order {order}, fixed dt, "
          f"precision=bf16, run({ENSB_ITERS})")
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if (path["stepper"], path["storage_dtype"]) != (
            "fused-whole-run-slab", "bfloat16"):
        raise AssertionError(f"precision=bf16 did not engage K6: {path}")
    out = drive(f"Burgers bf16 order {order}", solver, state0, ENSB_ITERS,
                {"K6-bf16": 1})
    in_range(f"bf16 run({ENSB_ITERS})", out.u)
    f32 = BurgersSolver(dataclasses.replace(cfg, precision="native",
                                            impl="pallas_slab"))
    ref = f32.run(state0, ENSB_ITERS)
    if out.t != ref.t:
        raise AssertionError(f"t differs: {out.t} vs {ref.t}")
    band = rel_l2(out.u, ref.u)
    print(f"  bf16 K6 against the float32 K6 run({ENSB_ITERS}): relative L2 "
          f"{band:.3e} (the JAX package's bf16 band {BF16_BAND}: reported, "
          f"the rung rounds once a step with no carry)")
    ms, reps = run_ms(solver, state0, ENSB_ITERS)
    ms32, _ = run_ms(f32, state0, ENSB_ITERS)
    print(f"  precision=bf16 run({ENSB_ITERS}): median {ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]}; {ms / ENSB_ITERS:.4f} ms/step "
          f"(float32 K6 {ms32 / ENSB_ITERS:.4f}) [{card}]")
    del out, ref
    torch.cuda.empty_cache()

    big = Grid.make(*K6_N, lengths=K6_LENGTHS)
    bcfg = BurgersConfig(grid=big, cfl=K6_CFL, adaptive_dt=False,
                         weno_order=order, impl="pallas", precision="bf16")
    bsolver = BurgersSolver(bcfg)
    print(f"phase 54: MultiGPU/Burgers3d_Baseline at order {order}, "
          f"precision=bf16, run({iters})")
    bpath = bsolver.engaged_path()
    print(f"  engaged: {bpath}")
    if bpath["stepper"] not in ("per-axis-pallas", "generic-xla") or (
            "the slab declined" not in bpath["fallback"]):
        raise AssertionError(f"the 400x400x406 bf16 config did not take "
                             f"JAX's decline: {bpath}")
    bstate = bsolver.initial_state()
    t0 = time.perf_counter()
    bout = drive(f"Burgers 400x400x406 bf16 order {order}", bsolver, bstate,
                 iters, {"K12": 9 * iters} if order == 5 else {})
    carried_s = time.perf_counter() - t0
    bf32 = BurgersSolver(dataclasses.replace(bcfg, precision="native",
                                             impl="pallas_slab"))
    bref = bf32.run(bstate, iters)
    carried = rel_l2(bout.u, bref.u)
    del bout
    bparams = fb.stage_params(bsolver.flux, "js", big.spacing, 0.0,
                              order=order)
    S = bstate.u.to(BF16)
    forced = fsr.slab_run_burgers_bf16(S, S.clone(), iters, bsolver.dt,
                                       params=bparams)
    torch.cuda.synchronize()
    forced_band = rel_l2(forced.float(), bref.u)
    print(f"  against the float32 K6 run({iters}): the carried generic loop "
          f"{carried:.3e} ({carried_s:.1f} s); K6's bf16 instance forced on "
          f"this grid {forced_band:.3e} (the band {BF16_BAND}) [{card}]")
    if not carried <= BF16_BAND:
        raise AssertionError(f"the carried loop left the band: {carried}")
    del S, forced, bref
    torch.cuda.empty_cache()
    return {
        "name": f"slab_run_burgers_bf16{'_weno7' if order == 7 else ''}",
        "id": f"K6-bf16{'-w7' if order == 7 else ''}", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "slab_run_burgers.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_slab_run.py:1632",
        "launches": 1, "max_abs_err": err, "max_ulps": 0, "per": "step",
        "ms": ms / ENSB_ITERS, "run_ms": ms, "ms_isolated": alone,
        "plain_ms": plain, "bound_ms": bound, "bound_by": "operations",
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes an RK step",
        "ms_per_step": ms / ENSB_ITERS, "f32_ms_per_step": ms32 / ENSB_ITERS,
        "rel_l2_vs_f32": band, "baseline_carried_rel_l2": carried,
        "baseline_forced_k6_rel_l2": forced_band,
    }


def k9_bf16_phase(card: str) -> dict:
    """Phase 55: K9's bf16 instance against its twin to the bit, every
    stage kind, at the main path's shape (its physics) and at odd widths
    whose row pitch takes 16-, 8- and 4-byte and single-value copies;
    alone at the main shape beside its bytes bound and the twin; then the
    ADR main path (bench.py's adr3d row) ``run(404)`` under
    ``precision="bf16"``: 1,212 launches, equal to its twin run on the
    card, its distance from the float32 K9 run reported, ms/step."""
    print("phase 55: K9's bf16 instance against its twin")
    spec = registry.get("adr")
    grid = Grid.make(*ADR_N, lengths=ADR_LENGTHS)
    cfg = dataclasses.replace(spec.bench_build(grid, "float32", "pallas",
                                               None), precision="bf16")
    solver = spec.solver_cls(cfg)
    st = solver._fused_stepper()
    kw, dt = st.stage_kwargs(), st.dt
    res = {"err": 0.0, "ms": [], "plain_ms": [], "bound_ms": []}
    widths = {}
    shapes = [(grid.shape, kw)]
    for nx in (36, 32, 34, 33):
        shape = (ODD_SHAPE[0], ODD_SHAPE[1], nx)
        shapes.append((shape, fa.FusedADRStepper(
            shape, (0.1, 0.08, 0.12), 1.0, (0.5, -0.3, 0.2), 0.25, dt, 2,
            PREC_ODD_BC, "cuda", kappa_variation=0.2, dtype=BF16,
            storage_dtype=torch.float32).stage_kwargs()))
    launch = {}
    for shape, skw in shapes:
        bc = skw["bc_value"]
        for kind, (a, b) in enumerate(fd.STAGES):
            has_u = kind > 0
            v = padded_random(shape, bc, 550 + kind).to(BF16)
            u = padded_random(shape, bc, 560 + kind).to(BF16) \
                if has_u else None
            out = torch.full_like(v, fd.bf16_value(bc))
            ref = out.clone()
            fd.upcast_twin(fa.adr_stage_reference, v, u, ref, dt, a=a, b=b,
                           **skw)
            fa.fused_adr_stage_bf16(v, u, out, dt, a=a, b=b, launch=launch,
                                    **skw)
            torch.cuda.synchronize()
            widths[shape[2]] = launch["copy_width"]
            if launch["copy_width"] != fa.copy_width(shape[2], 2):
                raise AssertionError(f"K9 bf16 copies {launch} at {shape}")
            res["err"] = max(res["err"], exact(
                f"K9 bf16 stage {kind + 1} at {shape} ({launch['copy_width']}"
                f"-value copies)", out, ref))
            if shape != grid.shape:
                continue
            buffers = [(v.clone(), None if u is None else u.clone(),
                        out.clone()) for _ in range(ROTATE)]
            res["ms"].append(alone_ms(lambda bufs: fa.fused_adr_stage_bf16(
                bufs[0], bufs[1], bufs[2], dt, a=a, b=b, **skw), buffers, 21))
            del buffers
            res["plain_ms"].append(statistics.median(cuda_ms(
                lambda: fd.upcast_twin(fa.adr_stage_reference, v, u, ref, dt,
                                       a=a, b=b, **skw), 3)))
            cells = math.prod(shape)
            ops = k9_stage_ops(shape, has_u, 0.2, 0.25, 3)
            res["bound_ms"].append(1e3 * max(
                2 * cells * (3 if has_u else 2) / HBM_BYTES_PER_S,
                ops / F32_OPS_PER_S))
            print(f"    K9 bf16 stage {kind + 1} alone {res['ms'][-1]:.4f} "
                  f"ms; twin {res['plain_ms'][-1]:.4f} ms; bound "
                  f"{res['bound_ms'][-1]:.4f} ms [{card}]")
        del v, u, out, ref
        torch.cuda.empty_cache()
    print(f"  K9 bf16 copy widths (values) by nx: {widths}, blocks an SM "
          f"{launch['blocks_per_sm']}")

    n = ADR_ITERS
    print(f"phase 55: ADR 3-D main path, precision=bf16, run({n})")
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if (path["stepper"], path["storage_dtype"]) != ("fused-stage",
                                                    "bfloat16"):
        raise AssertionError(f"precision=bf16 ADR did not engage K9: {path}")
    state0 = solver.initial_state()
    out = drive("ADR bf16", solver, state0, n, {"K9-bf16": 3 * n})
    twin = stage_twin_run(st, state0.u, n, fa.adr_stage_reference, kw)
    torch.cuda.synchronize()
    exact(f"ADR bf16 run({n}) against its twin run", out.u, twin)
    del twin
    f32 = spec.solver_cls(dataclasses.replace(cfg, precision="native"))
    ref = f32.run(state0, n)
    band = rel_l2(out.u, ref.u)
    print(f"  against the float32 K9 run({n}): relative L2 {band:.3e}, "
          f"max|diff| {float((out.u - ref.u).abs().max()):.3e} (reported: "
          f"a rounding a stage stalls stability-dt increments, as in the "
          f"JAX package's rung)")
    del out, ref
    torch.cuda.empty_cache()
    ms, reps = run_ms(solver, state0, n)
    ms32, _ = run_ms(f32, state0, n)
    print(f"  precision=bf16 run({n}): median {ms:.3f} ms of "
          f"{[round(r, 3) for r in reps]}; {ms / n:.4f} ms/step (float32 K9 "
          f"{ms32 / n:.4f}) [{card}]")
    prof = run_profile(lambda: solver.run(state0, 20), "adr_stage_kernel")
    in_run = prof["kernel_ms"] if prof and prof["launches"] else None
    print(f"  profiled run(20): K9 bf16 {in_run} ms a launch in the run"
          f"{'' if prof else ' (the profiler saw no device event)'}")
    return {
        "name": "fused_adr_stage_bf16", "id": "K9-bf16", "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_adr_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_adr.py:140",
        "launches": 3 * n, "max_abs_err": res["err"], "max_ulps": 0,
        "ms": in_run if in_run else statistics.mean(res["ms"]),
        "ms_isolated": statistics.mean(res["ms"]),
        "plain_ms": statistics.mean(res["plain_ms"]),
        "bound_ms": statistics.mean(res["bound_ms"]), "bound_by": "bytes",
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the stage",
        "copy_widths": widths, "ms_per_step": ms / n,
        "f32_ms_per_step": ms32 / n, "rel_l2_vs_f32": band,
    }


def carried_generic_phase(card: str) -> dict:
    """Phase 56: one carried generic run, the diffusion main path's grid
    under ``precision="bf16"``, ``impl="pallas_axis"`` (the packed loop
    around K11, 303 launches), with the compensation carry and without
    it (``TPUCFD_BF16_NO_CARRY=1``): each one's distance from the float32
    run of the same rung, reported."""
    import os

    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    cfg = DiffusionConfig(grid=grid, impl="pallas_axis", precision="bf16")
    f32 = DiffusionSolver(dataclasses.replace(cfg, precision="native"))
    state0 = f32.initial_state()
    ref = f32.run(state0, ITERS)
    print(f"phase 56: the carried generic loop, run({ITERS})")
    res = {}
    for carry in (True, False):
        if carry:
            os.environ.pop("TPUCFD_BF16_NO_CARRY", None)
        else:
            os.environ["TPUCFD_BF16_NO_CARRY"] = "1"
        try:
            solver = DiffusionSolver(cfg)
        finally:
            os.environ.pop("TPUCFD_BF16_NO_CARRY", None)
        name = "with the carry" if carry else "without the carry"
        out = drive(f"packed generic, {name}", solver, state0, ITERS,
                    {"K11": 3 * ITERS})
        band = rel_l2(out.u, ref.u)
        ms, _ = run_ms(solver, state0, ITERS)
        print(f"  {name}: relative L2 against the float32 run {band:.3e}, "
              f"max|diff| {float((out.u - ref.u).abs().max()):.3e}; "
              f"{ms / ITERS:.4f} ms/step [{card}]")
        res[name] = {"rel_l2": band, "ms_per_step": ms / ITERS}
        del out, solver
    ms32, _ = run_ms(f32, state0, ITERS)
    print(f"  float32 per-axis rung {ms32 / ITERS:.4f} ms/step [{card}]")
    res["float32 ms_per_step"] = ms32 / ITERS
    if not res["with the carry"]["rel_l2"] < res["without the carry"][
            "rel_l2"]:
        raise AssertionError(f"the carry did not help: {res}")
    return res


def precision_phases(card: str) -> list[dict]:
    """Phases 51-56; returns the bf16 instances' entries."""
    k1b = k1_bf16_phase(card)
    torch.cuda.empty_cache()
    paths = bf16_diffusion_paths(card, k1b)
    k1b["ms"] = k1b["ms_isolated"]
    k2b = k2_bf16_phase(card)
    k2b.update(launches=1, ms=paths["precision=bf16, pallas_slab"][
        "ms_per_step"], ms_per_step=paths["precision=bf16, pallas_slab"][
        "ms_per_step"])
    k1b["f64_storage"] = f64_storage_phase(card)
    torch.cuda.empty_cache()
    k6b = k6_bf16_phase(card, 5, K6_ITERS)
    torch.cuda.empty_cache()
    k6b7 = k6_bf16_phase(card, 7, K6_BF16_W7_ITERS)
    torch.cuda.empty_cache()
    k9b = k9_bf16_phase(card)
    torch.cuda.empty_cache()
    k9b["carried_generic"] = carried_generic_phase(card)
    return [k1b, k2b, k6b, k6b7, k9b]


# --------------------------------------------------------------------- #
# Phases 57-61: the storage-precision rungs on a z-slab mesh (two shards
# on cuda:0): the sharded bf16 instances of K1 and K9, the bf16 instances
# of K3 and K4, and the bf16 halo wires of the carried generic loop
# --------------------------------------------------------------------- #
# Burgers fixed dt on {"dz": 2} (MultiGPU/Burgers3d_Baseline's inviscid
# WENO5-JS, CFL 0.3): at order 5 on the diffusion baseline's 400x200x206,
# at order 7 on 200x100x104, the largest of the probed grids whose plane
# the JAX package's order-7 bf16 slab takes (jax_bf16_slab_fits)
BF16_MESH_B5_N = (400, 200, 206)
BF16_MESH_B7_N = (200, 100, 104)
BF16_MESH_B_ITERS = 40
BF16_MESH_ADR_TIME_ITERS = 100


def halo_bytes(solver, state0, iters: int) -> int:
    """The halo bytes a ``run(iters)`` sends (the collective exchange's
    count, summed over the shards)."""
    from multigpu_advectiondiffusion_tpu_torch.parallel import halo as phalo

    before = phalo.exchange_ghosts.bytes_per_execution.value
    solver.run(state0, iters)
    torch.cuda.synchronize()
    return phalo.exchange_ghosts.bytes_per_execution.value - before


def bf16_shard_twins(card: str) -> dict:
    """Phase 57: the sharded bf16 instances against their twins to the
    bit at the main paths' shard shapes: K1 (every stage kind on both
    shards, the split roles with bf16 operands, an odd shard with a wall
    value bf16 rounds), K3 diffusion (every window of ``k3_windows``, and
    the odd shard), K3 Burgers at orders 5 and 7, K4 diffusion (k = 1 and
    ``K4_DEEP``) and Burgers at both orders, every state and landing
    buffer, and K9 (every stage kind on both shards); each alone beside
    its bound (bf16 bytes at 2 B a value, or operations) and its twin."""
    print("phase 57: the sharded bf16 instances against their twins")
    res = {}
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    dt = DiffusionSolver(DiffusionConfig(grid=grid)).dt
    taps = fd.stage_taps(grid.spacing, [1.0] * 3)
    gshape = grid.shape
    lz = gshape[0] // MESH_SHARDS
    shape = (lz,) + gshape[1:]
    # K1: every stage kind on both shards of the main path
    k1 = {"err": 0.0, "ms": [], "plain_ms": [], "bound_ms": []}
    for oz in (0, lz):
        for kind, (a, b) in enumerate(fd.STAGES):
            has_u = kind > 0
            v = padded_random(shape, 0.0, 570 + kind).to(BF16)
            u = padded_random(shape, 0.0, 575 + kind).to(BF16) \
                if has_u else None
            out = torch.zeros_like(v)
            ref = out.clone()
            kw = dict(taps=taps, a=a, b=b, band=2, bc_value=0.0,
                      global_shape=gshape, offsets=(oz, 0, 0))
            fd.upcast_twin(fd.stage_reference, v, u, ref, dt, **kw)
            fd.fused_stage_bf16(v, u, out, dt, **kw)
            torch.cuda.synchronize()
            k1["err"] = max(k1["err"], exact(
                f"K1 bf16 sharded stage {kind + 1}, shard z {oz}", out, ref))
            if oz:
                continue
            buffers = [(v.clone(), None if u is None else u.clone(),
                        out.clone()) for _ in range(ROTATE)]
            k1["ms"].append(alone_ms(lambda bufs: fd.fused_stage_bf16(
                bufs[0], bufs[1], bufs[2], dt, **kw), buffers, 21))
            del buffers
            k1["plain_ms"].append(statistics.median(cuda_ms(
                lambda: fd.upcast_twin(fd.stage_reference, v, u, ref, dt,
                                       **kw), 3)))
            k1["bound_ms"].append(1e3 * max(
                stage_bytes(shape, has_u) / 2 / HBM_BYTES_PER_S,
                stage_ops(shape, has_u) / F32_OPS_PER_S))
    # the split schedule's edge roles, their bf16 operands other data
    bz = fd.Z_CHUNK
    for window, side in (((0, bz), "lo"), ((lz - bz, lz), "hi")):
        a, b = fd.STAGES[1]
        v = padded_random(shape, 0.0, 580).to(BF16)
        u = padded_random(shape, 0.0, 581).to(BF16)
        opnd = v[:fd.R].flip(1).contiguous()
        kw = dict(taps=taps, a=a, b=b, band=2, bc_value=0.0,
                  global_shape=gshape, offsets=(lz, 0, 0), window=window)
        out = torch.zeros_like(v)
        ref = out.clone()
        fd.upcast_twin(fd.stage_reference, v, u, ref, dt,
                       **{side: opnd.float()}, **kw)
        fd.fused_stage_bf16(v, u, out, dt, **{side: opnd}, **kw)
        torch.cuda.synchronize()
        k1["err"] = max(k1["err"], exact(
            f"K1 bf16 split role {window} with its bf16 {side} operand",
            out, ref))
    # an odd shard whose wall value bf16 rounds
    odd_g = (2 * ODD_SHAPE[0],) + ODD_SHAPE[1:]
    for kind, (a, b) in enumerate(fd.STAGES):
        v = padded_random(ODD_SHAPE, PREC_ODD_BC, 585 + kind).to(BF16)
        u = v.flip(0).contiguous() if kind else None
        out = torch.full_like(v, fd.bf16_value(PREC_ODD_BC))
        ref = out.clone()
        kw = dict(taps=taps, a=a, b=b, band=2, bc_value=PREC_ODD_BC,
                  global_shape=odd_g, offsets=(ODD_SHAPE[0], 0, 0))
        fd.upcast_twin(fd.stage_reference, v, u, ref, dt, **kw)
        fd.fused_stage_bf16(v, u, out, dt, **kw)
        torch.cuda.synchronize()
        k1["err"] = max(k1["err"], exact(
            f"K1 bf16 sharded stage {kind + 1} at the odd shard {ODD_SHAPE}"
            f", wall {PREC_ODD_BC}", out, ref))
    del v, u, out, ref, opnd
    torch.cuda.empty_cache()
    print(f"  K1 bf16 sharded alone (shard {shape}, mean of the stage "
          f"kinds) {statistics.mean(k1['ms']):.4f} ms; twin "
          f"{statistics.mean(k1['plain_ms']):.4f} ms; bound "
          f"{statistics.mean(k1['bound_ms']):.4f} ms (bytes) [{card}]")
    res["K1"] = k1

    # K3 and K4, diffusion
    G = fsr.SlabRunDiffusionStepper.halo
    dkw = dict(taps=taps, band=2, bc_value=0.0)

    def dstep(S, o, **kw):
        return fsr.slab_step_diffusion_bf16(S, o, dt, **dkw, **kw)

    def dref(S, o, **kw):
        return fsr.rounded_window(fsr.slab_step_diffusion_reference, S, o,
                                  dt=dt, **dkw, **kw)

    res["K3"] = k3_check("diffusion bf16", shape, dstep, dref, G, fd.R,
                         0.0, card, dtype=BF16)
    okw = dict(taps=taps, band=2, bc_value=PREC_ODD_BC)
    odd = k3_check(
        f"diffusion bf16, wall {PREC_ODD_BC}", ODD_SHAPE,
        lambda S, o, **kw: fsr.slab_step_diffusion_bf16(S, o, dt, **okw,
                                                        **kw),
        lambda S, o, **kw: fsr.rounded_window(
            fsr.slab_step_diffusion_reference, S, o, dt=dt,
            pad_value=fd.bf16_value(PREC_ODD_BC), **okw, **kw),
        G, fd.R, PREC_ODD_BC, card, dtype=BF16, timed=False)
    res["K3"]["max_abs_err"] = max(res["K3"]["max_abs_err"],
                                   odd["max_abs_err"])

    def drun(S0, S1, L, steps, k, **kw):
        return fsr.slab_run_dma_diffusion_bf16(S0, S1, L, steps, dt, k=k,
                                               **dkw, **kw)

    def d4ref(S, out, gnz, oz, depth, window):
        return dref(S, out, global_nz=gnz, oz=oz, depth=depth,
                    window=window)

    ny, nx = gshape[1:]
    err4 = max(k4_check("diffusion bf16", drun, d4ref, MESH_SHARDS, lz, k,
                        G, ny, nx, fd.R, steps, 570 + k, BF16)
               for k, steps in ((1, 3), (K4_DEEP, 5)))
    res["K4"] = k4_alone("diffusion bf16", drun, d4ref, MESH_SHARDS, lz, G,
                         ny, nx, fd.R, ITERS, card, BF16)
    res["K4"]["max_abs_err"] = err4

    # K3 and K4, Burgers at both orders
    for order, n_xyz in ((5, BF16_MESH_B5_N), (7, BF16_MESH_B7_N)):
        bgrid = Grid.make(*n_xyz, lengths=2.0)
        bsolver = BurgersSolver(BurgersConfig(
            grid=bgrid, cfl=K6_CFL, adaptive_dt=False, weno_order=order))
        params = fb.stage_params(bsolver.flux, "js", bgrid.spacing, 0.0,
                                 order=order)
        bdt = bsolver.dt
        BG = 3 * params.r
        blz = bgrid.shape[0] // MESH_SHARDS
        bshape = (blz,) + bgrid.shape[1:]

        def bstep(S, o, **kw):
            return fsr.slab_step_burgers_bf16(S, o, bdt, params=params, **kw)

        def bref(S, o, **kw):
            return fsr.rounded_window(fsr.slab_step_burgers_reference, S, o,
                                      dt=bdt, params=params, **kw)

        k3b = k3_check(f"burgers bf16 order {order}", bshape, bstep, bref,
                       BG, 0, None, card, dtype=BF16)

        def brun(S0, S1, L, steps, k, **kw):
            return fsr.slab_run_dma_burgers_bf16(S0, S1, L, steps, bdt,
                                                 params=params, k=k, **kw)

        def b4ref(S, out, gnz, oz, depth, window):
            return bref(S, out, global_nz=gnz, oz=oz, depth=depth,
                        window=window)

        e4 = k4_check(f"burgers bf16 order {order}", brun, b4ref,
                      MESH_SHARDS, blz, 1, BG, *bgrid.shape[1:], 0, 3,
                      577 + order, BF16)
        k4b = k4_alone(f"burgers bf16 order {order}", brun, b4ref,
                       MESH_SHARDS, blz, BG, *bgrid.shape[1:], 0,
                       MESH_TIME_ITERS, card, BF16)
        k4b["max_abs_err"] = e4
        ops = k6_step_ops(bshape, False, "js", order=order)
        k3b["bound"] = kernel_bound((blz + 2 * BG) * math.prod(bshape[1:]),
                                    math.prod(bshape), ops, size=2)
        k4b["bound"] = run_bound(2 * bgrid.num_cells, k6_step_ops(
            bgrid.shape, False, "js", order=order))
        res[f"K3-burgers{order}"], res[f"K4-burgers{order}"] = k3b, k4b
        torch.cuda.empty_cache()

    # K9 on both shards of the ADR main path
    spec = registry.get("adr")
    agrid = Grid.make(*ADR_N, lengths=ADR_LENGTHS)
    acfg = dataclasses.replace(spec.bench_build(agrid, "float32", "pallas",
                                                None), precision="bf16")
    asolver = spec.solver_cls(acfg, mesh=two_shards())
    st = asolver._fused_stepper()
    alz = agrid.shape[0] // MESH_SHARDS
    ashape = (alz,) + agrid.shape[1:]
    k9 = {"err": 0.0, "ms": [], "plain_ms": [], "bound_ms": []}
    for oz in (0, alz):
        skw = st.stage_kwargs(offsets=(oz, 0, 0))
        for kind, (a, b) in enumerate(fd.STAGES):
            has_u = kind > 0
            v = padded_random(ashape, 0.0, 590 + kind).to(BF16)
            u = padded_random(ashape, 0.0, 595 + kind).to(BF16) \
                if has_u else None
            out = torch.zeros_like(v)
            ref = out.clone()
            fd.upcast_twin(fa.adr_stage_reference, v, u, ref, st.dt, a=a,
                           b=b, **skw)
            fa.fused_adr_stage_bf16(v, u, out, st.dt, a=a, b=b, **skw)
            torch.cuda.synchronize()
            k9["err"] = max(k9["err"], exact(
                f"K9 bf16 sharded stage {kind + 1}, shard z {oz}", out, ref))
            if oz:
                continue
            buffers = [(v.clone(), None if u is None else u.clone(),
                        out.clone()) for _ in range(ROTATE)]
            k9["ms"].append(alone_ms(lambda bufs: fa.fused_adr_stage_bf16(
                bufs[0], bufs[1], bufs[2], st.dt, a=a, b=b, **skw),
                buffers, 21))
            del buffers
            k9["plain_ms"].append(statistics.median(cuda_ms(
                lambda: fd.upcast_twin(fa.adr_stage_reference, v, u, ref,
                                       st.dt, a=a, b=b, **skw), 3)))
            cells = math.prod(ashape)
            k9["bound_ms"].append(1e3 * max(
                2 * cells * (3 if has_u else 2) / HBM_BYTES_PER_S,
                k9_stage_ops(ashape, has_u, 0.2, 0.25, 3) / F32_OPS_PER_S))
    del v, u, out, ref, asolver, st
    torch.cuda.empty_cache()
    print(f"  K9 bf16 sharded alone (shard {ashape}, mean of the stage "
          f"kinds) {statistics.mean(k9['ms']):.4f} ms; twin "
          f"{statistics.mean(k9['plain_ms']):.4f} ms; bound "
          f"{statistics.mean(k9['bound_ms']):.4f} ms [{card}]")
    res["K9"] = k9
    return res


def bf16_diffusion_mesh_paths(card: str) -> dict:
    """Phase 58: MultiGPU/Diffusion3d_Baseline (400x200x206, ``run(101)``)
    on ``{"dz": 2}`` under ``precision="bf16"``: the sharded K1 bf16
    (serialized, 6 launches a step; split, 18), K3 bf16 (2 a step), K4
    bf16 (1 a run) and ``dtype="bfloat16"`` on the sharded K1, each 0 ulp
    from its unsharded bf16 run with ``t`` equal; the halo bytes of the
    K1 path and K4's in-kernel bytes half the float32 paths'; ms/step of
    each beside its float32 mesh path."""
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    print(f"phase 58: the diffusion baseline on {{'dz': 2}}, bf16 storage, "
          f"run({ITERS}) at {grid.shape}")
    base = DiffusionConfig(grid=grid, impl="pallas", precision="bf16")
    mesh = two_shards()
    runs = {}
    for name, kw, plain, expect, label in (
            ("K1 bf16 serialized", {}, "pallas_stage",
             {"K1-bf16": 6 * ITERS},
             ("fused-stage", "serialized-refresh", 1)),
            ("K1 bf16 split", {"overlap": "split"}, "pallas_stage",
             {"K1-bf16": 18 * ITERS}, ("fused-stage", "split", 1)),
            ("K3 bf16", {"impl": "pallas_slab"}, "pallas_slab",
             {"K3-bf16": 2 * ITERS},
             ("fused-whole-run-slab", "serialized-refresh", 1)),
            ("K1 dtype=bfloat16", {"dtype": "bfloat16", "precision":
                                   "native"}, "pallas_stage",
             {"K1-bf16": 6 * ITERS},
             ("fused-stage", "serialized-refresh", 1))):
        cfg = dataclasses.replace(base, **kw)
        solver = DiffusionSolver(cfg, mesh=mesh)
        plain_solver = DiffusionSolver(dataclasses.replace(cfg, impl=plain,
                                                           overlap="padded"))
        state0 = solver.initial_state()
        runs[name] = mesh_run(name, solver, plain_solver, state0, ITERS,
                              expect, label, card)
        f32 = DiffusionSolver(dataclasses.replace(
            cfg, precision="native", dtype="float32"), mesh=mesh)
        f0 = f32.initial_state()
        ms32, _ = run_ms(f32, f0, ITERS)
        runs[name]["f32_ms_per_step"] = ms32 / ITERS
        if name != "K1 dtype=bfloat16":
            b16, b32 = halo_bytes(solver, state0, 2), halo_bytes(f32, f0, 2)
            print(f"  {name}: halo bytes of run(2) {b16} (float32 {b32})")
            if b16 * 2 != b32:
                raise AssertionError(f"{name}: halo bytes {b16} not half "
                                     f"of {b32}")
            runs[name]["halo_bytes_run2"] = b16
        print(f"  {name}: {runs[name]['ms_per_step']:.4f} ms/step; the "
              f"float32 mesh path {ms32 / ITERS:.4f} [{card}]")
        del solver, plain_solver, state0, f32, f0
        torch.cuda.empty_cache()
    one = DiffusionSolver(dataclasses.replace(base, impl="pallas_slab"))
    coll = DiffusionSolver(dataclasses.replace(base, impl="pallas_slab"),
                           mesh=mesh)
    solver = DiffusionSolver(dataclasses.replace(base, impl="pallas_slab",
                                                 exchange="dma"), mesh=mesh)
    f32 = DiffusionSolver(dataclasses.replace(
        base, impl="pallas_slab", exchange="dma", precision="native"),
        mesh=mesh)
    state0 = solver.initial_state()
    runs["K4 bf16"] = dma_path("K4 bf16", solver, coll, one, state0, ITERS,
                               {"K4-bf16": 1}, card, ITERS)
    if 2 * dma_bytes(solver, ITERS) != dma_bytes(f32, ITERS):
        raise AssertionError("K4 bf16 did not halve the in-kernel bytes")
    ms32, _ = run_ms(f32, f32.initial_state(), ITERS)
    runs["K4 bf16"]["f32_ms_per_step"] = ms32 / ITERS
    print(f"  K4 bf16: in-kernel bytes {runs['K4 bf16']['dma_bytes']} "
          f"(float32 {dma_bytes(f32, ITERS)}); the float32 mesh path "
          f"{ms32 / ITERS:.4f} ms/step [{card}]")
    del one, coll, solver, f32, state0
    torch.cuda.empty_cache()
    return runs


def bf16_burgers_mesh_paths(card: str) -> dict:
    """Phase 59: Burgers fixed dt on ``{"dz": 2}`` under
    ``precision="bf16"`` at order 5 (400x200x206) and order 7
    (200x100x104), ``run(BF16_MESH_B_ITERS)``: K3 bf16 (2 launches a
    step) and K4 bf16 (1 a run), each 0 ulp from the unsharded bf16 run
    (K6's bf16 instance) with ``t`` equal, K4 from the collective K3 run
    too and its in-kernel bytes half the float32 path's; ms/step beside
    the float32 mesh path."""
    runs = {}
    n = BF16_MESH_B_ITERS
    mesh = two_shards()
    for order, n_xyz in ((5, BF16_MESH_B5_N), (7, BF16_MESH_B7_N)):
        bgrid = Grid.make(*n_xyz, lengths=2.0)
        print(f"phase 59: Burgers {bgrid.shape} at order {order} on "
              f"{{'dz': 2}}, fixed dt, precision=bf16, run({n})")
        cfg = BurgersConfig(grid=bgrid, cfl=K6_CFL, adaptive_dt=False,
                            weno_order=order, impl="pallas",
                            precision="bf16")
        one = BurgersSolver(cfg)
        if one.engaged_path()["stepper"] != "fused-whole-run-slab":
            raise AssertionError("the unsharded bf16 run is not K6's")
        solver = BurgersSolver(cfg, mesh=mesh)
        state0 = solver.initial_state()
        key = f"K3 bf16 order {order}"
        runs[key] = mesh_run(key, solver, one, state0, n,
                             {"K3-burgers-bf16": 2 * n},
                             ("fused-whole-run-slab", "serialized-refresh",
                              1), card, check=lambda o: in_range(
                                  f"{key} run({n})", o.u.assemble()))
        f32 = BurgersSolver(dataclasses.replace(
            cfg, precision="native", impl="pallas_slab"), mesh=mesh)
        ms32, _ = run_ms(f32, f32.initial_state(), n)
        runs[key]["f32_ms_per_step"] = ms32 / n
        print(f"  {key}: the float32 K3 mesh path {ms32 / n:.4f} ms/step "
              f"[{card}]")
        dsolver = BurgersSolver(dataclasses.replace(cfg, exchange="dma"),
                                mesh=mesh)
        d32 = BurgersSolver(dataclasses.replace(
            cfg, exchange="dma", precision="native", impl="pallas_slab"),
            mesh=mesh)
        key4 = f"K4 bf16 order {order}"
        runs[key4] = dma_path(key4, dsolver, solver, one, state0, n,
                              {"K4-burgers-bf16": 1}, card, n)
        if 2 * dma_bytes(dsolver, n) != dma_bytes(d32, n):
            raise AssertionError(f"{key4} did not halve the bytes")
        ms32, _ = run_ms(d32, d32.initial_state(), n)
        runs[key4]["f32_ms_per_step"] = ms32 / n
        print(f"  {key4}: the float32 K4 mesh path {ms32 / n:.4f} ms/step "
              f"[{card}]")
        del one, solver, state0, f32, dsolver, d32
        torch.cuda.empty_cache()
    return runs


def bf16_adr_mesh_path(card: str) -> dict:
    """Phase 60: the ADR main path (508x204x160, ``run(404)``) on
    ``{"dz": 2}`` under ``precision="bf16"``: the sharded K9 bf16, 6
    launches a step, 0 ulp from the unsharded K9 bf16 run with ``t``
    equal; ms/step beside the float32 mesh path."""
    spec = registry.get("adr")
    grid = Grid.make(*ADR_N, lengths=ADR_LENGTHS)
    cfg = dataclasses.replace(spec.bench_build(grid, "float32", "pallas",
                                               None), precision="bf16")
    print(f"phase 60: ADR {grid.shape} on {{'dz': 2}}, precision=bf16, "
          f"run({ADR_ITERS})")
    mesh = two_shards()
    solver = spec.solver_cls(cfg, mesh=mesh)
    one = spec.solver_cls(cfg)
    state0 = solver.initial_state()
    res = mesh_run("K9 bf16 sharded", solver, one, state0, ADR_ITERS,
                   {"K9-bf16": 6 * ADR_ITERS},
                   ("fused-stage", "serialized-refresh", 1), card,
                   time_iters=BF16_MESH_ADR_TIME_ITERS)
    f32 = spec.solver_cls(dataclasses.replace(cfg, precision="native"),
                          mesh=mesh)
    n = BF16_MESH_ADR_TIME_ITERS
    ms32, _ = run_ms(f32, f32.initial_state(), n)
    res["f32_ms_per_step"] = ms32 / n
    print(f"  K9 bf16 sharded: the float32 mesh path {ms32 / n:.4f} ms/step "
          f"[{card}]")
    del solver, one, state0, f32
    torch.cuda.empty_cache()
    return res


def bf16_carried_mesh_phase(card: str) -> dict:
    """Phase 61: MultiGPU/Burgers3d_Baseline (400x400x406, fixed dt,
    ``run(267)``) on ``{"dz": 2}`` under ``precision="bf16"``: the JAX
    package's decline (its bf16 slab gate) to the carried per-axis loop,
    K12 18 launches a step, its ghosts on bf16 wires (half the float32
    per-axis path's halo bytes), held within the JAX package's bf16 band
    of the float32 run."""
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    cfg = BurgersConfig(grid=grid, cfl=K6_CFL, adaptive_dt=False,
                        impl="pallas", precision="bf16")
    print(f"phase 61: MultiGPU/Burgers3d_Baseline on {{'dz': 2}}, "
          f"precision=bf16, run({K6_ITERS}): the carried per-axis loop")
    mesh = two_shards()
    solver = BurgersSolver(cfg, mesh=mesh)
    path = solver.engaged_path()
    print(f"  engaged: {path}")
    if path["stepper"] != "per-axis-pallas" or (
            "the slab declined" not in path["fallback"]):
        raise AssertionError(f"the bf16 baseline on a mesh did not take "
                             f"JAX's decline: {path}")
    state0 = solver.initial_state()
    t0 = time.perf_counter()
    out = drive("carried per-axis loop on {'dz': 2}", solver, state0,
                K6_ITERS, {"K12": 18 * K6_ITERS})
    seconds = time.perf_counter() - t0
    ref = BurgersSolver(dataclasses.replace(
        cfg, precision="native", impl="pallas_slab")).run(
        one_state(solver, state0), K6_ITERS)
    band = rel_l2(out.u.assemble(), ref.u)
    del out, ref
    ax32 = BurgersSolver(dataclasses.replace(cfg, precision="native",
                                             impl="pallas_axis"), mesh=mesh)
    b16 = halo_bytes(solver, state0, 2)
    b32 = halo_bytes(ax32, ax32.initial_state(), 2)
    print(f"  against the float32 K6 run({K6_ITERS}): relative L2 "
          f"{band:.3e} (the band {BF16_BAND}); {seconds:.1f} s; halo bytes "
          f"of run(2) {b16} (float32 per-axis {b32}) [{card}]")
    if not band <= BF16_BAND:
        raise AssertionError(f"the carried loop on a mesh left the band: "
                             f"{band}")
    if b16 * 2 != b32:
        raise AssertionError(f"the bf16 wires moved {b16}, not half {b32}")
    n = MESH_TIME_ITERS
    ms, _ = run_ms(solver, state0, n)
    ms32, _ = run_ms(ax32, ax32.initial_state(), n)
    print(f"  run({n}): {ms / n:.4f} ms/step; the float32 per-axis mesh "
          f"path {ms32 / n:.4f} [{card}]")
    del solver, ax32, state0
    torch.cuda.empty_cache()
    return {"rel_l2_vs_f32": band, "seconds": seconds, "ms_per_step": ms / n,
            "f32_ms_per_step": ms32 / n, "halo_bytes_run2": b16}


def mesh_precision_phases(card: str) -> list[dict]:
    """Phases 57-61; returns the entries of the sharded bf16 instances."""
    twins = bf16_shard_twins(card)
    torch.cuda.empty_cache()
    dpaths = bf16_diffusion_mesh_paths(card)
    bpaths = bf16_burgers_mesh_paths(card)
    apath = bf16_adr_mesh_path(card)
    carried = bf16_carried_mesh_phase(card)
    grid = Grid.make(*REF_N, lengths=REF_LENGTHS)
    lz = grid.shape[0] // MESH_SHARDS
    dshape = (lz,) + grid.shape[1:]
    G = fsr.SlabRunDiffusionStepper.halo
    src = "multigpu_advectiondiffusion_tpu_torch/csrc/"
    pallas = "multigpu_advectiondiffusion_tpu/ops/pallas/"
    none = {"library_ms": None,
            "library_call": "none: no single PyTorch call computes it"}
    k1, k9 = twins["K1"], twins["K9"]
    d3_bound = kernel_bound((lz + 2 * G) * math.prod(dshape[1:]),
                            math.prod(dshape), 100 * math.prod(dshape),
                            size=2)
    d4_bound = run_bound(2 * grid.num_cells, 100 * grid.num_cells * ITERS)
    entries = [{
        "name": "fused_diffusion_stage_bf16 (sharded)",
        "id": "K1-bf16-sharded", "route": "cuda",
        "source": src + "fused_diffusion_stage.cu",
        "replaces": pallas + "fused_diffusion.py:281",
        "launches": 6 * ITERS, "max_abs_err": k1["err"], "max_ulps": 0,
        "ms": statistics.mean(k1["ms"]),
        "plain_ms": statistics.mean(k1["plain_ms"]),
        "bound_ms": statistics.mean(k1["bound_ms"]), "bound_by": "bytes",
        **none, "paths": {k: dpaths[k] for k in (
            "K1 bf16 serialized", "K1 bf16 split", "K1 dtype=bfloat16")},
    }, {
        "name": "slab_step_diffusion_bf16", "id": "K3-bf16",
        "route": "cuda", "source": src + "fused_step_diffusion.cu",
        "replaces": pallas + "fused_slab_run.py:508",
        "launches": 2 * ITERS, "max_abs_err": twins["K3"]["max_abs_err"],
        "max_ulps": 0, "ms": twins["K3"]["ms"],
        "plain_ms": twins["K3"]["plain_ms"], "bound_ms": d3_bound[0],
        "bound_by": d3_bound[1], **none,
        "paths": {"K3 bf16": dpaths["K3 bf16"]},
    }, {
        "name": "slab_run_dma_diffusion_bf16", "id": "K4-bf16",
        "route": "cuda", "source": src + "fused_step_diffusion.cu",
        "replaces": pallas + "fused_slab_run.py:327", "launches": 1,
        "per": "step", "max_abs_err": twins["K4"]["max_abs_err"],
        "max_ulps": 0, "ms": twins["K4"]["ms"],
        "plain_ms": twins["K4"]["plain_ms"],
        "bound_ms": d4_bound[0] / ITERS, "bound_by": d4_bound[1], **none,
        "paths": {"K4 bf16": dpaths["K4 bf16"]},
    }]
    for order in (5, 7):
        w7 = "-w7" if order == 7 else ""
        k3b, k4b = twins[f"K3-burgers{order}"], twins[f"K4-burgers{order}"]
        entries += [{
            "name": f"slab_step_burgers_bf16{'_weno7' if w7 else ''}",
            "id": f"K3-burgers-bf16{w7}", "route": "cuda",
            "source": src + "slab_run_burgers.cu",
            "replaces": pallas + "fused_slab_run.py:508",
            "launches": 2 * BF16_MESH_B_ITERS,
            "max_abs_err": k3b["max_abs_err"], "max_ulps": 0,
            "ms": k3b["ms"], "plain_ms": k3b["plain_ms"],
            "bound_ms": k3b["bound"][0], "bound_by": k3b["bound"][1],
            **none, "paths": {f"K3 bf16 order {order}": bpaths[
                f"K3 bf16 order {order}"]},
        }, {
            "name": f"slab_run_dma_burgers_bf16{'_weno7' if w7 else ''}",
            "id": f"K4-burgers-bf16{w7}", "route": "cuda",
            "source": src + "slab_run_burgers.cu",
            "replaces": pallas + "fused_slab_run.py:327", "launches": 1,
            "per": "step", "max_abs_err": k4b["max_abs_err"],
            "max_ulps": 0, "ms": k4b["ms"], "plain_ms": k4b["plain_ms"],
            "bound_ms": k4b["bound"][0], "bound_by": k4b["bound"][1],
            **none, "paths": {f"K4 bf16 order {order}": bpaths[
                f"K4 bf16 order {order}"]},
        }]
    entries.append({
        "name": "fused_adr_stage_bf16 (sharded)", "id": "K9-bf16-sharded",
        "route": "cuda", "source": src + "fused_adr_stage.cu",
        "replaces": pallas + "fused_adr.py:342",
        "launches": 6 * ADR_ITERS, "max_abs_err": k9["err"], "max_ulps": 0,
        "ms": statistics.mean(k9["ms"]),
        "plain_ms": statistics.mean(k9["plain_ms"]),
        "bound_ms": statistics.mean(k9["bound_ms"]), "bound_by": "bytes",
        **none, "paths": {"K9 bf16 sharded": apath},
        "carried_generic_on_mesh": carried,
    })
    return entries


# --------------------------------------------------------------------- #
# Phases 62-65: K5 on y- and x-cut meshes (its YX instance: r ghosts
# stored on each cut axis), every shard on cuda:0
# --------------------------------------------------------------------- #
YX_LAYOUTS = {
    "dy2": ({"dy": 2}, {1: "dy"}),
    "dx2": ({"dx": 2}, {2: "dx"}),
    "dzdy": ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"}),
    "block": ({"dz": 2, "dy": 2, "dx": 2}, {0: "dz", 1: "dy", 2: "dx"}),
}
YX_TIME_ITERS = 20  # the paths timed and profiled: run(20)
YX_GATE_N = (400, 200, 206)  # {"dy": 2} gives ly = 100: JAX's y gate
YX_GATE_ITERS = 20


def yx_solver(cfg, layout: str):
    sizes, mapping = YX_LAYOUTS[layout]
    n = math.prod(sizes.values())
    mesh = pmesh.make_mesh(sizes, devices=[torch.device("cuda:0")] * n)
    return BurgersSolver(cfg, mesh=mesh,
                         decomp=pmesh.Decomposition.of(mapping))


def yx_twin_checks(name, shape, cuts, params, dt, roles, seed: int) -> dict:
    """K5's YX instance against its twin on a shard of ``shape`` (the
    global (nz, ny, nx)) cut by ``cuts`` (the shard count of each axis):
    the first and the last shard, random data with random ghosts, each
    of ``roles`` ((role, stage kind, window, operand) tuples; stage kind
    0-2: stage 1, stage 2, stage 3 in place and emitting); 0 ulp and the
    emitted maximum equal, hard. Returns the largest difference and the
    calls checked."""
    r = params.r
    local = tuple(n // c for n, c in zip(shape, cuts))
    pads = tuple(r if c > 1 else 0 for c in cuts)
    stored = tuple(n + 2 * p for n, p in zip(local, pads))
    rng = np.random.default_rng(seed)
    err, calls = 0.0, 0
    for last in (False, True):
        offs = tuple((c - 1) * n if last else 0 for n, c in zip(local, cuts))
        geo = dict(zpad=pads[0], global_nz=shape[0], oz=offs[0],
                   ypad=pads[1], global_ny=shape[1], oy=offs[1],
                   xpad=pads[2], global_nx=shape[2], ox=offs[2])
        v, u = (random_on_card(stored, int(rng.integers(1 << 30)))
                for _ in range(2))
        lo, hi = (random_on_card((pads[0],) + stored[1:],
                                 int(rng.integers(1 << 30)))
                  for _ in range(2))
        for role, kind, window, op in roles:
            a, b = fb.STAGES[kind]
            ops = {"lo": lo} if op == "lo" else (
                {"hi": hi} if op == "hi" else {})
            kw = dict(params=params, a=a, b=b, window=window, **ops, **geo)
            base = torch.zeros_like(v)
            emit = kind == 2
            uu = u.clone() if emit else (u if kind else None)
            ref = fb.stage_reference(v, uu, u.clone() if emit else base,
                                     dt, emit=emit, **kw)
            ref, mref = ref if emit else (ref, None)
            got = u.clone() if emit else torch.zeros_like(v)
            mx = torch.full((), 7.0, device="cuda") if emit else None
            fb.fused_burgers_stage(v, got if emit else uu, got, dt, mx,
                                   mx_init=False, **kw)
            torch.cuda.synchronize()
            err = max(err, exact(
                f"K5 YX {name} {role} stage {kind + 1}{' ' + str(window) if window else ''} "
                f"at shard {offs}", got, ref))
            if emit and float(mx) != max(7.0, float(mref)):
                raise AssertionError(f"K5 YX {name} {role}: maximum "
                                     f"{float(mx)} vs {float(mref)}")
            calls += 1
            del ref, got, base
        del v, u, lo, hi
        torch.cuda.empty_cache()
    return {"err": err, "calls": calls}


def k5_yx_twin_phase(card: str) -> dict:
    """Phase 62: K5's YX instance against its twin, 0 ulp, at the shard
    shapes of phases 63-64: MultiGPU/Burgers3d_Baseline's grid on
    {"dy": 2} (order 5) and {"dx": 2} (order 7), every stage kind, and on
    {"dz": 2, "dy": 2} at both orders the split schedule's roles (the
    serialized call, the interior window, the bottom and top windows
    with the exchanged ``lo``/``hi``); the Burgers main path's 512^3
    block shard (viscous, WENO5-JS) and odd shards with WENO5-Z and the
    linear and Buckley-Leverett fluxes; then the instance alone at the
    {"dy": 2} shard (stage 2) beside the z-sharded instance on a shard of
    the same cells, its twin, and its bound."""
    print("phase 62: K5's y/x-sharded (YX) instance against its twin")
    for order in (5, 7):
        geo = fb.geometry(order, yx=True)
        print(f"  K5 YX order {order}: {geo['tile_y']}x{geo['tile_x']} tile, "
              f"{geo['threads']} threads, {geo['smem_bytes']} B static "
              f"shared memory, {geo['blocks_per_sm']} blocks an SM, "
              f"{geo['registers']} registers and {geo['local_bytes']} B "
              f"local memory a thread [{card}]")
        if geo["blocks_per_sm"] < fb.BLOCKS_PER_SM // 4:
            raise AssertionError(f"K5 YX order {order} holds "
                                 f"{geo['blocks_per_sm']} blocks an SM")
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    dt = torch.full((), K6_CFL * min(grid.spacing), device="cuda")
    bz = fb.SPLIT_BZ
    every = [("serialized", k, None, None) for k in range(3)]
    err, calls = 0.0, 0
    for name, cuts, order, roles in (
            ("dy2", (1, 2, 1), 5, every),
            ("dx2", (1, 1, 2), 7, every),
            ("dzdy", (2, 2, 1), 5, None), ("dzdy", (2, 2, 1), 7, None)):
        params = fb.stage_params(pflux.get("burgers"), "js", grid.spacing,
                                 0.0, order=order)
        if roles is None:
            lz = grid.shape[0] // 2
            roles = [("serialized", 2, None, None),
                     ("interior", 1, (bz, lz - bz), None),
                     ("bottom", 1, (0, bz), "lo"),
                     ("top", 2, (lz - bz, lz), "hi")]
        res = yx_twin_checks(f"{name} order {order}", grid.shape, cuts,
                             params, dt, roles, 620 + calls)
        err, calls = max(err, res["err"]), calls + res["calls"]
    n = BURGERS_N
    agrid = Grid.make(n, n, n, lengths=2.0)
    params = fb.stage_params(pflux.get("burgers"), "js", agrid.spacing,
                             BURGERS_NU)
    adt = torch.full((), 0.4 * min(agrid.spacing), device="cuda")
    res = yx_twin_checks("block 512^3", agrid.shape, (2, 2, 2), params, adt,
                         every, 629)
    err, calls = max(err, res["err"]), calls + res["calls"]
    for i, (fname, fkw, variant, nu) in enumerate(K5_ODD_CASES):
        params = fb.stage_params(pflux.get(fname, **fkw), variant,
                                 (0.05, 0.07, 0.09), nu)
        res = yx_twin_checks(f"odd {fname} {variant}", (46, 58, 74),
                             (2, 2, 2), params, adt, every[1:], 630 + i)
        err, calls = max(err, res["err"]), calls + res["calls"]
    print(f"  K5 YX: {calls} calls 0 ulp from the twin [{card}]")

    # alone: the {"dy": 2} shard of phase 63 (406 x 200 x 400 cells,
    # stored 406 x 206 x 400), stage 2, against the z-sharded instance
    # on a {"dz": 2} shard of 203 x 400 x 400 cells (as many)
    params = fb.stage_params(pflux.get("burgers"), "js", grid.spacing, 0.0)
    nz, ny, nx = grid.shape
    r = params.r
    yx_kw = dict(params=params, a=0.75, b=0.25, ypad=r, global_ny=ny, oy=0)
    z_kw = dict(params=params, a=0.75, b=0.25, zpad=r, global_nz=nz, oz=0)
    yx_sets = [[random_on_card((nz, ny // 2 + 2 * r, nx), 640 + 3 * i + j)
                for j in range(3)] for i in range(3)]
    ms = alone_ms(lambda s: fb.fused_burgers_stage(s[0], s[1], s[2], dt,
                                                   **yx_kw), yx_sets, 5)
    plain = cuda_ms(lambda: fb.stage_reference(
        yx_sets[0][0], yx_sets[0][1], yx_sets[0][2], dt, **yx_kw), 1)[0]
    del yx_sets
    torch.cuda.empty_cache()
    z_sets = [[random_on_card((nz // 2 + 2 * r, ny, nx), 650 + 3 * i + j)
               for j in range(3)] for i in range(3)]
    z_ms = alone_ms(lambda s: fb.fused_burgers_stage(s[0], s[1], s[2], dt,
                                                     **z_kw), z_sets, 5)
    del z_sets
    torch.cuda.empty_cache()
    # the instances on one core, (203, 400, 400): the z-sharded one, and
    # the YX one with y ghosts as well (a {"dz": 2, "dy": 2} shard's
    # geometry, the core made as large): what the y/x indexing costs
    zy_kw = dict(z_kw, ypad=r, global_ny=2 * ny, oy=ny)
    zy_sets = [[random_on_card((nz // 2 + 2 * r, ny + 2 * r, nx),
                               660 + 3 * i + j) for j in range(3)]
               for i in range(3)]
    zy_ms = alone_ms(lambda s: fb.fused_burgers_stage(s[0], s[1], s[2], dt,
                                                      **zy_kw), zy_sets, 5)
    del zy_sets
    torch.cuda.empty_cache()
    core = (nz, ny // 2, nx)
    cells = math.prod(core)
    stored = nz * (ny // 2 + 2 * r) * nx
    bound, by = kernel_bound(stored + cells, cells,
                             k5_stage_ops(core, True, False, "js"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issued = fb.ops_issued(core, fb.stage_zchunk(nz, *core[1:], sms),
                           has_u=True, viscous=False, variant="js")
    # order 7: the {"dz": 2, "dy": 2} shard of burgers3d_512_weno7
    n7 = W7_N
    g7 = Grid.make(n7, n7, n7, lengths=2.0)
    p7 = fb.stage_params(pflux.get("burgers"), "js", g7.spacing, BURGERS_NU,
                         order=7)
    r7 = p7.r
    core7 = (n7 // 2, n7 // 2, n7)
    w7_kw = dict(params=p7, a=0.75, b=0.25, zpad=r7, global_nz=n7, oz=0,
                 ypad=r7, global_ny=n7, oy=0)
    dt7 = torch.full((), K6_CFL * min(g7.spacing), device="cuda")
    w7_sets = [[random_on_card((core7[0] + 2 * r7, core7[1] + 2 * r7, n7),
                               670 + 3 * i + j) for j in range(3)]
               for i in range(3)]
    w7_ms = alone_ms(lambda s: fb.fused_burgers_stage(s[0], s[1], s[2], dt7,
                                                      **w7_kw), w7_sets, 5)
    w7_plain = cuda_ms(lambda: fb.stage_reference(
        w7_sets[0][0], w7_sets[0][1], w7_sets[0][2], dt7, **w7_kw), 1)[0]
    del w7_sets
    torch.cuda.empty_cache()
    cells7 = math.prod(core7)
    stored7 = (core7[0] + 2 * r7) * (core7[1] + 2 * r7) * n7
    w7_bound, w7_by = kernel_bound(stored7 + cells7, cells7, k5_stage_ops(
        core7, True, True, "js", order=7))
    print(f"  K5 YX order 7 alone (the {{'dz': 2, 'dy': 2}} shard {core7} "
          f"of burgers3d_512_weno7, stage 2): {w7_ms:.4f} ms; twin "
          f"{w7_plain:.2f} ms; bound {w7_bound:.4f} ms ({w7_by}) [{card}]")
    print(f"  K5 YX alone (the {{'dy': 2}} shard {core}, stage 2): "
          f"{ms:.4f} ms; the z-sharded instance on a {{'dz': 2}} shard of "
          f"as many cells {z_ms:.4f} ms, the YX instance on that core with "
          f"y ghosts too {zy_ms:.4f} ms (x{zy_ms / z_ms:.3f}); twin "
          f"{plain:.2f} ms; bound {bound:.4f} ms ({by}); issued "
          f"{issued / cells:.2f} f32 operations a cell [{card}]")
    return {"max_abs_err": err, "calls": calls, "ms_isolated": ms,
            "zsharded_ms_isolated": z_ms, "yx_same_core_ms": zy_ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "w7": {"ms_isolated": w7_ms, "plain_ms": w7_plain,
                   "bound_ms": w7_bound, "bound_by": w7_by}}


def yx_path(name, solver, want, state0, iters: int, expect: dict,
            label: tuple, card: str) -> dict:
    """One y/x-cut path: :func:`drive`, 0 ulp and ``t`` equal to
    ``want`` (the unsharded K5 run of the config), its ms/step over
    run(YX_TIME_ITERS) (median of 3 after a warm-up), one ghost
    refresh (or z-slab exchange) of every shard alone, and the profiled
    idle share and K5's time a launch in the run."""
    path = solver.engaged_path()
    got_label = (path["stepper"], path["overlap"],
                 path["steps_per_exchange"])
    print(f"  {name}: engaged {got_label}")
    if got_label != label:
        raise AssertionError(f"{name}: engaged {got_label}, not {label}")
    out = drive(name, solver, state0, iters, expect)
    n_ulps = ulps(out.u.assemble(), want.u)
    print(f"  {name}: {n_ulps} ulp from the unsharded K5 run, t {out.t!r} "
          f"vs {want.t!r}")
    if n_ulps != 0 or out.t != want.t or out.it != want.it:
        raise AssertionError(f"{name}: differs from the unsharded run")
    del out
    ms, reps = run_ms(solver, state0, YX_TIME_ITERS)
    res = {"ms_per_step": ms / YX_TIME_ITERS,
           "launches": sum(v for k, v in expect.items() if k == "K5"),
           "exchange_ms": halo_ms(solver, state0, reps=20)}
    res.update(mesh2d_profile(name, solver, state0, YX_TIME_ITERS,
                              "stage_kernel", card))
    print(f"  {name} run({YX_TIME_ITERS}): {res['ms_per_step']:.4f} ms/step "
          f"({[round(x, 3) for x in reps]} ms); one exchange of every "
          f"shard alone {res['exchange_ms']:.4f} ms (host-bound) [{card}]")
    return res


def yx_paths(name, cfg, iters: int, runs, card: str) -> dict:
    """The unsharded K5 run of ``cfg`` once, then each of ``runs``
    ((label, layout, config changes, K5 launches a step a shard,
    shards)) held to it by :func:`yx_path`; returns the results and the
    unsharded ms/step."""
    one = BurgersSolver(cfg)
    state0 = one.initial_state()
    want = drive(f"{name} unsharded", one, state0, iters,
                 {"K5": 3 * iters})
    torch.cuda.synchronize()
    ms1, _ = run_ms(one, state0, YX_TIME_ITERS)
    out = {"unsharded_ms_per_step": ms1 / YX_TIME_ITERS}
    print(f"  {name} unsharded K5 run({YX_TIME_ITERS}): "
          f"{ms1 / YX_TIME_ITERS:.4f} ms/step [{card}]")
    del one
    for label, layout, kw, per_step, shards in runs:
        c = dataclasses.replace(cfg, **kw)
        solver = yx_solver(c, layout)
        sstate = solver.initial_state()
        n = per_step * shards * iters
        overlap = "split" if c.overlap == "split" else "serialized-refresh"
        out[label] = yx_path(f"{name} {label}", solver, want, sstate, iters,
                             {"K5": n, "K5-yx": n},
                             ("fused-stage", overlap, 1), card)
        out[label]["shards"] = shards
        if c.adaptive_dt:
            reads = count_reads(lambda: solver.run(sstate, iters))
            out[label]["host_reads"] = reads
            dtoh = out[label]["dtoh_copies"]
            print(f"  {name} {label}: host reads of device scalars {reads}; "
                  f"device-to-host copies {dtoh} in the profiled run "
                  f"[{card}]")
            if reads > 1 or (dtoh is not None and dtoh > 1):
                raise AssertionError(f"{name} {label} read dt back")
        del solver, sstate
        torch.cuda.empty_cache()
    del want, state0
    torch.cuda.empty_cache()
    return out


def yx_main_paths(card: str) -> dict:
    """Phases 63-64: MultiGPU/Burgers3d_Baseline (400x400x406, inviscid,
    CFL 0.3, fixed dt) on {"dy": 2}, {"dx": 2} and {"dz": 2, "dy": 2}
    padded and split, run(267); the Burgers main path
    (SingleGPU/Burgers3d_WENO5: 512^3, nu 1e-5, adaptive dt) on
    {"dy": 2} and the block {"dz": 2, "dy": 2, "dx": 2}, run(86); and
    burgers3d_512_weno7 (fixed dt) on {"dz": 2, "dy": 2}, run(40). Each
    run 0 ulp and ``t`` equal to the unsharded K5 run of its config."""
    grid = Grid.make(*K6_N, lengths=K6_LENGTHS)
    print(f"phase 63: MultiGPU/Burgers3d_Baseline on {{'dy': 2}}, "
          f"{{'dx': 2}} and {{'dz': 2, 'dy': 2}} (cuda:0 each shard), "
          f"run({K6_ITERS}) at {grid.shape}")
    cfg = BurgersConfig(grid=grid, cfl=K6_CFL, adaptive_dt=False,
                        dtype="float32", impl="pallas")
    paths = {"baseline": yx_paths(
        "Burgers3d_Baseline", cfg, K6_ITERS, (
            ("dy2", "dy2", {}, 3, 2), ("dx2", "dx2", {}, 3, 2),
            ("dzdy", "dzdy", {}, 3, 4),
            ("dzdy split", "dzdy", {"overlap": "split"}, 9, 4)), card)}
    n = BURGERS_N
    agrid = Grid.make(n, n, n, lengths=2.0)
    print(f"phase 64: the Burgers main path {n}^3 (adaptive dt, nu = "
          f"{BURGERS_NU}) on {{'dy': 2}} and {{'dz': 2, 'dy': 2, 'dx': 2}}, "
          f"run({BURGERS_ITERS}); burgers3d_512_weno7 on {{'dz': 2, 'dy': "
          f"2}}, run({W7_ITERS})")
    acfg = BurgersConfig(grid=agrid, nu=BURGERS_NU, dtype="float32",
                         impl="pallas")
    paths["main"] = yx_paths(
        "Burgers3d_WENO5", acfg, BURGERS_ITERS,
        (("dy2", "dy2", {}, 3, 2), ("block", "block", {}, 3, 8)), card)
    wcfg = dataclasses.replace(acfg, weno_order=7, adaptive_dt=False)
    paths["weno7"] = yx_paths(
        "burgers3d_512_weno7", wcfg, W7_ITERS,
        (("dzdy", "dzdy", {}, 3, 4),), card)
    return paths


def yx_gate_phase(card: str) -> dict:
    """Phase 65: a shard JAX's y gate refuses (ly % 8 != 0): {"dy": 2} at
    400x200x206 (ly = 100), where the JAX package declines to its
    per-axis rung: K5 (0 ulp from the unsharded K5 run) against the
    per-axis rung (K12, what JAX runs) on the same mesh, fixed dt,
    inviscid, run(20) each; and the CLI with ``--mesh dy=2``."""
    grid = Grid.make(*YX_GATE_N, lengths=2.0)
    n = YX_GATE_ITERS
    print(f"phase 65: {{'dy': 2}} at {grid.shape} (ly = "
          f"{grid.shape[1] // 2}, JAX's y gate): K5 against the per-axis "
          f"rung, run({n})")
    cfg = BurgersConfig(grid=grid, cfl=K6_CFL, adaptive_dt=False,
                        dtype="float32", impl="pallas")
    res = yx_paths("y-gate shape", cfg, n, (("dy2", "dy2", {}, 3, 2),),
                   card)
    axis = yx_solver(dataclasses.replace(cfg, impl="pallas_axis"), "dy2")
    state0 = axis.initial_state()
    label = axis.engaged_path()["stepper"]
    if label != "per-axis-pallas":
        raise AssertionError(f"the per-axis rung engaged {label}")
    drive("y-gate shape per-axis", axis, state0, n, {"K12": 2 * 9 * n})
    ms, reps = run_ms(axis, state0, n)
    res["per_axis_ms_per_step"] = ms / n
    k5 = res["dy2"]["ms_per_step"]
    print(f"  y-gate shape on {{'dy': 2}}: K5 {k5:.4f} ms/step, the "
          f"per-axis rung {ms / n:.4f} ms/step ({[round(x, 3) for x in reps]}"
          f" ms): K5 x{ms / n / k5:.2f} faster [{card}]")
    if not k5 < ms / n:
        raise AssertionError("K5 did not beat the per-axis rung")
    del axis, state0
    torch.cuda.empty_cache()

    import contextlib
    import io

    from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import (
        main as cli_main,
    )

    argv = ["burgers3d", "--n", "64", "64", "64", "--iters", "3", "--impl",
            "pallas", "--mesh", "dy=2", "--device", "cuda:0"]
    print(f"  the CLI: {' '.join(argv)}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        if any(w in line for w in ("kernel path", "mesh", "launches")):
            print(f"    {line.strip()}")
    for want in ("fused-stage (impl=pallas)", "K5 fused_burgers_stage x18",
                 "of them K5's y/x-sharded instance x18"):
        if want not in text:
            raise AssertionError(f"the CLI summary lacks {want!r}")
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    return res


def yx_phases(card: str) -> list[dict]:
    """Phases 62-65; returns the ``kernels`` entries of K5's YX instance
    at orders 5 and 7."""
    twin = k5_yx_twin_phase(card)
    torch.cuda.empty_cache()
    paths = yx_main_paths(card)
    torch.cuda.empty_cache()
    gate = yx_gate_phase(card)
    main = paths["main"]["dy2"]
    # the {"dy": 2} shard of the 512^3 main path: v stored with 3 ghost
    # rows a side, u and out at its cells; the mean of the stage kinds
    cells = BURGERS_N ** 3 // 2
    bound, by = kernel_bound(
        (BURGERS_N // 2 + 2 * fb.R) * BURGERS_N ** 2 + cells, cells,
        (k5_stage_ops((BURGERS_N // 2, BURGERS_N, BURGERS_N), False, True,
                      "js") + 2 * k5_stage_ops(
                          (BURGERS_N // 2, BURGERS_N, BURGERS_N), True,
                          True, "js")) // 3)
    w7 = paths["weno7"]["dzdy"]
    entry = {
        "name": "fused_burgers_stage (YX instance: y/x-sharded)",
        "id": "K5-yx",
        "route": "cuda",
        "source": "multigpu_advectiondiffusion_tpu_torch/csrc/"
                  "fused_burgers_stage.cu",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_burgers.py:815",
        # the Burgers main path on {"dy": 2}: 3 launches a step a shard
        "launches": main["launches"],
        "max_abs_err": twin["max_abs_err"],
        "max_ulps": 0,
        # a launch in that path's profiled run (alone where the profiler
        # missed it)
        "ms": main["kernel_ms_in_run"] or twin["ms_isolated"],
        "plain_ms": twin["plain_ms"],
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes a WENO "
                        "stage",
        "ms_isolated": twin["ms_isolated"],
        "zsharded_ms_isolated": twin["zsharded_ms_isolated"],
        "yx_same_core_ms": twin["yx_same_core_ms"],
        "twin_calls": twin["calls"],
        "paths": {**paths, "y_gate": gate},
    }
    return [entry, {
        **{k: entry[k] for k in ("route", "source", "library_ms",
                                 "library_call", "max_abs_err",
                                 "max_ulps")},
        "name": "fused_burgers_stage_weno7 (YX instance: y/x-sharded)",
        "id": "K5-yx-w7",
        "replaces": "multigpu_advectiondiffusion_tpu/ops/pallas/"
                    "fused_burgers.py:352",
        # burgers3d_512_weno7 on {"dz": 2, "dy": 2}: 3 a step a shard
        "launches": w7["launches"],
        "ms": w7["kernel_ms_in_run"] or twin["w7"]["ms_isolated"],
        "plain_ms": twin["w7"]["plain_ms"],
        "bound_ms": twin["w7"]["bound_ms"],
        "bound_by": twin["w7"]["bound_by"],
        "ms_isolated": twin["w7"]["ms_isolated"],
        "paths": {"burgers3d_512_weno7 dzdy": w7},
    }]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
               (fsr.BURGERS_SOURCE, fb.NVCC_EXTRA + fsr.K6_BF16_FLAGS),
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

    t_group = time.perf_counter()
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

    def group_done(name: str) -> None:
        nonlocal t_group
        print(f"{name}: {time.perf_counter() - t_group:.1f} s")
        t_group = time.perf_counter()

    group_done("phases 1-4")
    print("phases 5-7: Burgers/WENO5 (K5)")
    k5 = burgers_phases(card)
    torch.cuda.empty_cache()
    group_done("phases 5-7")
    print("phases 8-11: the 2-D paths (K7, K7a)")
    k7d = diffusion2d_phases(card)
    k7b, k7a = burgers2d_phases(card, l2_gbs)
    torch.cuda.empty_cache()
    group_done("phases 8-11")
    print("phases 12-15: the 3-D fused-step rungs (K10, K2, K6)")
    k10, k2 = step_phases(card)
    torch.cuda.empty_cache()
    k6 = slab_burgers_phases(card)
    torch.cuda.empty_cache()
    gate_sweep(card)
    torch.cuda.empty_cache()
    group_done("phases 12-15")
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
    group_done("phases 16-19")
    print("phases 20-22: advection-diffusion-reaction (K9)")
    k9 = adr_main_phase(card, k9_phase(card, copy_gbs))
    torch.cuda.empty_cache()
    adr2d_phase(card)
    torch.cuda.empty_cache()
    group_done("phases 20-22")
    print("phases 23-27: the batched ensemble engine (K2b)")
    k2b = ensemble_phases(card)
    torch.cuda.empty_cache()
    group_done("phases 23-27")
    print("phases 28-32: the z-slab mesh (K3, sharded K1/K5)")
    k3 = mesh_phases(card)
    torch.cuda.empty_cache()
    group_done("phases 28-32")
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
    torch.cuda.empty_cache()
    print("phases 42-45: WENO7-JS on the fused rungs (K5, K7, K7a and K6 at "
          "order 7)")
    t_w7 = time.perf_counter()
    w7 = weno7_phases(card)
    print(f"phases 42-45: {time.perf_counter() - t_w7:.1f} s")
    torch.cuda.empty_cache()
    print("phases 46-50: WENO7-JS on meshes and member axes (the sharded "
          "K5, K3, K4, K2b, K8 and K8b at order 7)")
    t_w7m = time.perf_counter()
    w7m = weno7_mesh_phases(card)
    print(f"phases 46-50: {time.perf_counter() - t_w7m:.1f} s")
    torch.cuda.empty_cache()
    print("phases 51-56: storage precision on one device (float64 storage "
          "on K1/K2; the bf16 instances of K1, K2, K6 and K9)")
    t_prec = time.perf_counter()
    prec = precision_phases(card)
    print(f"phases 51-56: {time.perf_counter() - t_prec:.1f} s")
    torch.cuda.empty_cache()
    print("phases 57-61: storage precision on a z-slab mesh (the sharded "
          "bf16 instances of K1 and K9, the bf16 instances of K3 and K4, "
          "the bf16 halo wires)")
    t_mprec = time.perf_counter()
    mprec = mesh_precision_phases(card)
    print(f"phases 57-61: {time.perf_counter() - t_mprec:.1f} s")
    torch.cuda.empty_cache()
    print("phases 62-65: K5 on y- and x-cut meshes (its y/x-sharded "
          "instance)")
    t_yx = time.perf_counter()
    k5yx = yx_phases(card)
    print(f"phases 62-65: {time.perf_counter() - t_yx:.1f} s")
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
        *k3, *mesh2d, *k4, *w7, *w7m, *prec, *mprec, *k5yx]
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all, the "
          f"{len(sources)} kernels' build included")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
