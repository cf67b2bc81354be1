"""K1, K5 and K9, the port's CUDA stage kernels, K7/K7a, its 2-D
whole-run kernels, K10, K2 and K6, its 3-D fused-step kernels, K2b, the
B-folded slab kernel of the ensemble engine, K11/K11b and K12/K12b,
its per-axis kernels, and the mesh slice — K1's and K5's sharded
instances and K3, the windowed slab step, with the sharded runs of a
two-shard mesh on one card, K8/K8b, the sharded 2-D stages, and K9's
sharded instance, with the 2-D and ADR mesh runs, and K4, the sharded
run of every shard of the card with the ghost rows moved inside the
kernel — against their plain PyTorch twins on a GPU. Marked ``cuda``:
it skips where no CUDA device is present.

This file imports nothing of JAX, so it also runs on a GPU machine that
has no JAX, with the JAX-side conftest switched off::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

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
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.timestepping import cfl as pcfl
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused2d_sharded as fsh,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_adr as fa,
)
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

TOL = 32 * np.finfo(np.float32).eps


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("K1 (csrc/fused_diffusion_stage.cu), K5 "
                    "(csrc/fused_burgers_stage.cu), K7/K7a "
                    "(csrc/whole_run_{diffusion2d,burgers2d}.cu), K10 and "
                    "K2 (csrc/fused_step_diffusion.cu) and K6 "
                    "(csrc/slab_run_burgers.cu) need a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(23, 29, 37), (5, 6, 70)])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k1_matches_twin(gpu, shape, kind):
    rng = np.random.default_rng(kind)
    padded = tuple(n + 2 * fd.R for n in shape)
    v = torch.from_numpy(rng.random(padded, dtype=np.float32)).to(gpu)
    u = torch.from_numpy(rng.random(padded, dtype=np.float32)).to(gpu)
    a, b = fd.STAGES[kind]
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)),
              a=a, b=b, band=2, bc_value=0.25)
    u_arg = None if kind == 0 else u
    ref = fd.stage_reference(v, u_arg, torch.zeros_like(v), 1e-4, **kw)
    out = torch.zeros_like(v)
    before = fd.fused_stage.launches
    fd.fused_stage(v, u_arg, out, 1e-4, **kw)
    torch.cuda.synchronize()
    assert fd.fused_stage.launches == before + 1
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err <= TOL
    # the ghost ring stays as it was (zeros here)
    inner = torch.zeros_like(out, dtype=torch.bool)
    inner[2:-2, 2:-2, 2:-2] = True
    assert float(out[~inner].abs().max()) == 0.0


@pytest.mark.cuda
def test_k1_run_matches_generic_path(gpu):
    grid = Grid.make(37, 29, 23, lengths=2.0)
    fused = DiffusionSolver(DiffusionConfig(grid=grid, impl="pallas_stage"))
    generic = DiffusionSolver(DiffusionConfig(grid=grid, impl="xla"))
    s0 = fused.initial_state()
    fd.fused_stage.launches = 0
    got = fused.run(s0, 7)
    assert fd.fused_stage.launches == 21
    want = generic.run(s0, 7)
    scale = float(want.u.abs().max())
    bad = (got.u - want.u).abs() > 1e-5 * want.u.abs() + 1e-6 * scale
    assert not bool(bad.any())
    assert got.t == want.t


K5_CASES = {
    "js-burgers-viscous": ("burgers", {}, "js", 1e-5),
    "z-burgers-inviscid": ("burgers", {}, "z", 0.0),
    "js-linear": ("linear", {"c": -0.7}, "js", 1e-5),
    "z-buckley": ("buckley", {}, "z", 1e-5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k5_matches_twin(gpu, case, kind):
    """K5 against its twin on an odd shape: 0 ulp expected (both round
    every operation alike), 32 eps of max|twin| asserted; the emitted
    maximum exactly."""
    name, kw, variant, nu = K5_CASES[case]
    shape = (23, 29, 37)
    rng = np.random.default_rng(kind)
    v = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu)
    u = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu)
    params = fb.stage_params(pflux.get(name, **kw), variant,
                             (0.05, 0.07, 0.09), nu)
    a, b = fb.STAGES[kind]
    dt = torch.full((), 2e-3, device=gpu)
    u_arg = None if kind == 0 else u
    emit = kind == 2
    ref = fb.stage_reference(v, u_arg, torch.empty_like(v), dt,
                             params=params, a=a, b=b, emit=emit)
    out = u.clone() if kind == 2 else torch.empty_like(v)
    mx = torch.full((1,), -1.0, device=gpu) if emit else None
    before = fb.fused_burgers_stage.launches
    fb.fused_burgers_stage(v, out if kind == 2 else u_arg, out, dt, mx,
                           params=params, a=a, b=b)
    torch.cuda.synchronize()
    assert fb.fused_burgers_stage.launches == before + 1
    want = ref[0] if emit else ref
    err = float((out - want).abs().max()) / float(want.abs().max())
    assert err <= TOL
    if emit:
        assert float(mx[0]) == float(ref[1])


@pytest.mark.cuda
def test_k5_nan_cell_gives_nan_max(gpu):
    shape = (9, 10, 33)
    v = torch.full(shape, 0.5, device=gpu)
    v[4, 3, 20] = float("nan")
    u = torch.full(shape, 0.5, device=gpu)
    params = fb.stage_params(pflux.burgers(), "js", (0.1,) * 3, 1e-5)
    mx = torch.zeros(1, device=gpu)
    a, b = fb.STAGES[2]
    fb.fused_burgers_stage(v, u, u, torch.full((), 1e-3, device=gpu), mx,
                           params=params, a=a, b=b)
    assert bool(torch.isnan(mx[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed"])
def test_k5_run_matches_generic_path(gpu, adaptive):
    grid = Grid.make(37, 29, 23, lengths=2.0)
    kw = dict(grid=grid, nu=1e-5, adaptive_dt=adaptive)
    fused = BurgersSolver(BurgersConfig(impl="pallas", **kw))
    generic = BurgersSolver(BurgersConfig(impl="xla", **kw))
    s0 = fused.initial_state()
    fb.fused_burgers_stage.launches = 0
    got = fused.run(s0, 7)
    assert fb.fused_burgers_stage.launches == 21
    want = generic.run(s0, 7)
    scale = float(want.u.abs().max())
    bad = (got.u - want.u).abs() > 2e-5 * want.u.abs() + 2e-6 * scale
    assert not bool(bad.any())
    assert abs(float(got.t) - float(want.t)) <= 1e-5 * float(want.t)


# K5's tile edges (csrc/fused_burgers_stage.cu: a TILE (y, x) tile a
# block): ny and nx at 1, 2, 3 and one off a tile and two tiles; the
# layouts the split schedule launches on a z-slab shard of lz = 24 (3
# ghost planes a side, the middle shard of three), and nz 1, 4, 7
# unsharded and as a whole shard
K5_EDGE_Y = (1, 2, 3, fb.TILE[0] - 1, fb.TILE[0] + 1, 2 * fb.TILE[0] + 5)
K5_EDGE_X = (1, 2, 3, fb.TILE[1] - 1, fb.TILE[1] + 1, 2 * fb.TILE[1] + 5)
K5_EDGE_LAYOUTS = {"unsharded": None, "shard": ("full", ""),
                   "interior": ((8, 16), ""), "bottom": ((0, 8), "lo"),
                   "top": ((16, 24), "hi")}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(K5_EDGE_LAYOUTS))
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_tile_edges_match_twin(gpu, case, layout):
    """K5 on shapes at its tile's edges, every stage kind, z chunks of 3
    (so chunks meet), unsharded and in the split schedule's layouts with
    the exchanged operands: 0 ulp from its twin, the emitted maximum
    exactly (folded into a prior value on a shard)."""
    name, fkw, variant, nu = K5_CASES[case]
    params = fb.stage_params(pflux.get(name, **fkw), variant,
                             (0.05, 0.07, 0.09), nu)
    rng = np.random.default_rng(len(layout))
    R = fb.R
    dt = torch.full((), 2e-3, device=gpu)
    role = K5_EDGE_LAYOUTS[layout]
    depths = (1, 4, 7) if role is None or role[0] == "full" else (24,)
    for nz, ny, nx, kind in itertools.product(depths, K5_EDGE_Y, K5_EDGE_X,
                                              range(3)):
        a, b = fb.STAGES[kind]
        where = (layout, nz, ny, nx, kind)
        if role is None:
            v, u = _rand(rng, (nz, ny, nx), gpu), _rand(rng, (nz, ny, nx), gpu)
            u_arg = None if kind == 0 else u
            emit = kind == 2
            ref = fb.stage_reference(v, u_arg, torch.empty_like(v), dt,
                                     params=params, a=a, b=b, emit=emit)
            out = u.clone() if emit else torch.empty_like(v)
            mx = torch.full((1,), -1.0, device=gpu) if emit else None
            fb.fused_burgers_stage(v, out if emit else u_arg, out, dt, mx,
                                   params=params, a=a, b=b, zchunk=3)
            torch.cuda.synchronize()
            want = ref[0] if emit else ref
            assert torch.equal(out, want), where
            if emit:
                assert float(mx[0]) == float(ref[1]), where
            continue
        window, ops = role
        shape = (nz + 2 * R, ny, nx)
        v, u = _rand(rng, shape, gpu), _rand(rng, shape, gpu)
        lo = _rand(rng, (R, ny, nx), gpu) if "lo" in ops else None
        hi = _rand(rng, (R, ny, nx), gpu) if "hi" in ops else None
        kw = dict(params=params, a=a, b=b, zpad=R, global_nz=3 * nz, oz=nz,
                  window=None if window == "full" else window, lo=lo, hi=hi)
        u_arg = None if kind == 0 else u
        out0 = _rand(rng, shape, gpu)
        ref, mref = fb.stage_reference(v, u_arg, out0.clone(), dt, emit=True,
                                       **kw)
        out, mx = out0.clone(), torch.full((1,), 0.5, device=gpu)
        fb.fused_burgers_stage(v, u_arg, out, dt, mx, zchunk=3,
                               mx_init=False, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), where
        assert float(mx[0]) == max(0.5, float(mref)), where


# --------------------------------------------------------------------- #
# K7 / K7a: one cooperative launch runs the whole 2-D run
# --------------------------------------------------------------------- #
def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("shape", [(23, 37), (5, 70)])
def test_k7_diffusion_matches_twin(gpu, shape, steps):
    rng = np.random.default_rng(steps)
    padded = tuple(n + 2 * fd2.R for n in shape)
    S = torch.full(padded, 0.25, device=gpu)
    S[2:-2, 2:-2] = torch.from_numpy(rng.random(shape, dtype=np.float32))
    kw = dict(taps=fd.stage_taps((0.1, 0.2), (1.0, 0.5)), band=2,
              bc_value=0.25)
    want = wr.plain_run(
        lambda v, u, out, dt, a, b: fd2.stage_reference(
            v, u, out, dt, a=a, b=b, **kw),
        S.clone(), S.clone(), S.clone(), steps, 1e-3)
    got = S.clone()
    before = wr.whole_run.launches
    fd2.whole_run_diffusion2d(got, S.clone(), S.clone(), steps, 1e-3, **kw)
    torch.cuda.synchronize()
    assert wr.whole_run.launches == before + 1
    assert _rel(got, want) <= TOL
    assert torch.equal(got[:2], S[:2]) and torch.equal(got[:, -2:], S[:, -2:])


K7_CASES = {
    "js-burgers-viscous": ("burgers", {}, "js", 1e-5),
    "z-burgers-inviscid": ("burgers", {}, "z", 0.0),
    "js-linear": ("linear", {"c": -0.7}, "js", 1e-5),
    "z-buckley": ("buckley", {}, "z", 1e-5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True], ids=["K7", "K7a"])
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_burgers_matches_twin(gpu, case, adaptive):
    """5 steps on an odd shape: 0 ulp expected, 32 eps of max|twin|
    asserted; the adaptive time advance exactly."""
    name, kw, variant, nu = K7_CASES[case]
    shape, spacing, cfl = (23, 37), (0.05, 0.07), 0.4
    rng = np.random.default_rng(7)
    S = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu)
    params = fb.stage_params(pflux.get(name, **kw), variant, spacing, nu)
    mode = (dict(spacing=spacing, cfl=cfl) if adaptive
            else dict(dt=cfl * min(spacing)))
    stage = (lambda v, u, out, dt, a, b: fb2.stage_reference(
        v, u, out, dt, params=params, a=a, b=b))
    T = [torch.empty_like(S) for _ in range(4)]
    got = S.clone()
    counter = wr.whole_run_adaptive if adaptive else wr.whole_run
    before = counter.launches
    res = fb2.whole_run_burgers2d(got, T[0], T[1], 5, params=params, **mode)
    if adaptive:
        flux = params.flux
        want, want_t = wr.plain_run_adaptive(
            stage, lambda u: pcfl.advective_dt(u, flux.df, spacing, cfl),
            S.clone(), T[2], T[3], 5)
        assert float(res[1]) == float(want_t)
    else:
        want = wr.plain_run(stage, S.clone(), T[2], T[3], 5, mode["dt"])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert _rel(got, want) <= TOL


@pytest.mark.cuda
def test_k7a_nan_cell_poisons_the_run(gpu):
    S = torch.full((9, 40), 0.5, device=gpu)
    S[4, 20] = float("nan")
    params = fb.stage_params(pflux.burgers(), "js", (0.1, 0.1), 1e-5)
    out, t_sum = fb2.whole_run_burgers2d(
        S, torch.empty_like(S), torch.empty_like(S), 2, params=params,
        spacing=(0.1, 0.1), cfl=0.4)
    assert bool(torch.isnan(t_sum)) and bool(torch.isnan(out).all())


@pytest.mark.cuda
def test_k7_runs_match_generic_path(gpu):
    """The 2-D solvers' fused runs (one launch each) against their
    generic paths, at the JAX suite's fused-vs-generic bounds."""
    d = dict(grid=Grid.make(61, 47, lengths=10.0))
    fused = DiffusionSolver(DiffusionConfig(impl="pallas", **d))
    generic = DiffusionSolver(DiffusionConfig(impl="xla", **d))
    s0 = fused.initial_state()
    wr.whole_run.launches = 0
    got, want = fused.run(s0, 40), generic.run(s0, 40)
    assert wr.whole_run.launches == 1 and got.t == want.t
    scale = float(want.u.abs().max())
    assert not bool(((got.u - want.u).abs()
                     > 1e-5 * want.u.abs() + 1e-6 * scale).any())
    for adaptive in (False, True):
        b = dict(grid=Grid.make(61, 47, lengths=2.0), nu=1e-5,
                 adaptive_dt=adaptive)
        fused = BurgersSolver(BurgersConfig(impl="pallas", **b))
        generic = BurgersSolver(BurgersConfig(impl="xla", **b))
        s0 = fused.initial_state()
        got, want = fused.run(s0, 20), generic.run(s0, 20)
        scale = float(want.u.abs().max())
        assert not bool(((got.u - want.u).abs()
                         > 2e-5 * want.u.abs() + 2e-6 * scale).any())
        assert abs(float(got.t) - float(want.t)) <= 1e-5 * float(want.t)


# --------------------------------------------------------------------- #
# K10 / K2 / K6: the three RK stages of a step fused in one pass
# --------------------------------------------------------------------- #
def _steps(step, S0, steps):
    """``steps`` of ``step(src, dst)`` on two copies of ``S0`` in turn
    (the slab twins' loop); returns the result."""
    return fsr.ping_pong(step, S0.clone(), S0.clone(), steps)


@pytest.mark.cuda
@pytest.mark.parametrize("zchunk", [3, 32, None])
@pytest.mark.parametrize("steps", [1, 4, 5])
@pytest.mark.parametrize("shape", [(23, 29, 37), (5, 70, 6), (40, 33, 65),
                                   (11, 33, 65), (7, 3, 5), (1, 40, 70)])
def test_k10_and_k2_match_twin(gpu, shape, steps, zchunk):
    """K10 (one launch a step) and K2 (one launch a run) against their
    twin, three K1-twin stages a step, to the bit: several tiles and z
    chunks (explicit, and planned with None), ragged edges one cell past
    a 32-cell tile, a grid thinner than one tile, nz below 2G = 12, band
    2 and a nonzero wall."""
    rng = np.random.default_rng(steps)
    S0 = torch.full(tuple(n + 2 * fd.R for n in shape), 0.25, device=gpu)
    S0[2:-2, 2:-2, 2:-2] = torch.from_numpy(
        rng.random(shape, dtype=np.float32))
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)), band=2,
              bc_value=0.25)
    want = _steps(lambda s, d: fds.step_reference(s, d, 1e-3, **kw), S0,
                  steps)
    k10, k2 = fds.fused_step.launches, fsr.slab_run_diffusion.launches
    got = _steps(lambda s, d: fds.fused_step(s, d, 1e-3, zchunk=zchunk,
                                             **kw), S0, steps)
    A, B = S0.clone(), S0.clone()
    slab = fsr.slab_run_diffusion(A, B, steps, 1e-3, zchunk=zchunk, **kw)
    torch.cuda.synchronize()
    assert fds.fused_step.launches == k10 + steps
    assert fsr.slab_run_diffusion.launches == k2 + 1
    assert slab is (B if steps % 2 else A)
    assert torch.equal(got, want) and torch.equal(slab, want)


K6_SHAPES = [(23, 29, 37), (40, 33, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("shape", K6_SHAPES, ids=["23x29x37", "40x33x65"])
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k6_matches_twin(gpu, case, shape, steps):
    """K6 against its twin, three K5-twin stages a step, to the bit."""
    name, kw, variant, nu = K5_CASES[case]
    rng = np.random.default_rng(steps)
    S0 = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu)
    params = fb.stage_params(pflux.get(name, **kw), variant,
                             (0.05, 0.07, 0.09), nu)
    dt = 0.3 * 0.05
    want = _steps(lambda s, d: fsr.burgers_step_reference(
        s, d, dt, params=params), S0, steps)
    before = fsr.slab_run_burgers.launches
    got = fsr.slab_run_burgers(S0.clone(), torch.empty_like(S0), steps, dt,
                               params=params, zchunk=7)
    torch.cuda.synchronize()
    assert fsr.slab_run_burgers.launches == before + 1
    assert torch.equal(got, want)


# the Burgers slab body's edges (csrc/slab_run_burgers.cu): ny and nx
# off the 32-cell tile and below one tile, nz below one z chunk, and a
# last z chunk of one plane (13 planes at zchunk 3: 3 + 3 + 3 + 3 + 1)
K6_EDGES = {"13x5x70-last1": ((13, 5, 70), 3), "1x6x5": ((1, 6, 5), 7),
            "4x40x3": ((4, 40, 3), 64), "9x70x33": ((9, 70, 33), 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("edge", list(K6_EDGES))
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k6_tile_edges_match_twin(gpu, case, edge, steps):
    """K6 on shapes at the tiling's edges, every flux and variant, 0 ulp
    from its twin."""
    shape, zchunk = K6_EDGES[edge]
    name, kw, variant, nu = K5_CASES[case]
    rng = np.random.default_rng(10 + steps)
    S0 = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu)
    params = fb.stage_params(pflux.get(name, **kw), variant,
                             (0.05, 0.07, 0.09), nu)
    want = _steps(lambda s, d: fsr.burgers_step_reference(
        s, d, 0.015, params=params), S0, steps)
    got = fsr.slab_run_burgers(S0.clone(), torch.empty_like(S0), steps,
                               0.015, params=params, zchunk=zchunk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k6_planned_chunks_match_twin(gpu):
    """K6 with its planned z chunks (``zchunk=None``, the solvers'
    default) at a shape of several tiles and chunks: 0 ulp."""
    rng = np.random.default_rng(6)
    S0 = torch.from_numpy(
        rng.uniform(-0.2, 1.0, (70, 40, 65)).astype(np.float32)).to(gpu)
    params = fb.stage_params(pflux.get("burgers"), "js", (0.05, 0.07, 0.09),
                             1e-5)
    want = _steps(lambda s, d: fsr.burgers_step_reference(
        s, d, 0.015, params=params), S0, 2)
    got = fsr.slab_run_burgers(S0.clone(), torch.empty_like(S0), 2, 0.015,
                               params=params)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_step_runs_match_generic_path(gpu):
    """The 3-D fused-step paths against the generic paths, one K10
    launch a step, one K2 or K6 launch a run."""
    grid = Grid.make(37, 29, 23, lengths=2.0)
    generic = DiffusionSolver(DiffusionConfig(grid=grid, impl="xla"))
    s0 = generic.initial_state()
    want = generic.run(s0, 7)
    scale = float(want.u.abs().max())
    for impl, counter, launches in (("pallas_step", fds.fused_step, 7),
                                    ("pallas_slab", fsr.slab_run_diffusion,
                                     1)):
        fused = DiffusionSolver(DiffusionConfig(grid=grid, impl=impl))
        counter.launches = 0
        got = fused.run(s0, 7)
        assert counter.launches == launches and got.t == want.t
        assert not bool(((got.u - want.u).abs()
                         > 1e-5 * want.u.abs() + 1e-6 * scale).any())
    kw = dict(grid=grid, nu=1e-5, adaptive_dt=False)
    fused = BurgersSolver(BurgersConfig(impl="pallas_slab", **kw))
    generic = BurgersSolver(BurgersConfig(impl="xla", **kw))
    s0 = fused.initial_state()
    fsr.slab_run_burgers.launches = 0
    got, want = fused.run(s0, 7), generic.run(s0, 7)
    assert fsr.slab_run_burgers.launches == 1 and got.t == want.t
    scale = float(want.u.abs().max())
    assert not bool(((got.u - want.u).abs()
                     > 2e-5 * want.u.abs() + 2e-6 * scale).any())


# --------------------------------------------------------------------- #
# K11/K11b and K12/K12b, the per-axis kernels, and the per-axis rung
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu_axis():
    if not torch.cuda.is_available():
        pytest.skip("K11/K11b (csrc/laplacian_o4.cu) and K12/K12b "
                    "(csrc/weno_axis.cu) need a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("zchunk", [3, 8])
@pytest.mark.parametrize("shape", [(23, 29, 37), (5, 6, 70), (23, 37),
                                   (5, 70)])
def test_k11_matches_twin(gpu_axis, shape, zchunk):
    rng = np.random.default_rng(len(shape))
    up = torch.from_numpy(rng.standard_normal(
        tuple(n + 4 for n in shape)).astype(np.float32)).to(gpu_axis)
    spacing, k = (0.1, 0.07, 0.13)[:len(shape)], (0.7, 1.3, 0.4)[:len(shape)]
    ref = klap.laplacian_reference(up, spacing, k)
    fn = klap.laplacian_o4_3d if len(shape) == 3 else klap.laplacian_o4_2d
    before = fn.launches
    out = (fn(up, spacing, k, zchunk=zchunk) if len(shape) == 3
           else fn(up, spacing, k))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.shape == ref.shape
    assert _rel(out, ref) <= TOL


K12_CASES = {  # (flux, flux kwargs, variant, order)
    "burgers-js": ("burgers", {}, "js", 5),
    "burgers-z": ("burgers", {}, "z", 5),
    "linear-js": ("linear", {"c": -0.7}, "js", 5),
    "buckley-z": ("buckley", {}, "z", 5),
    "burgers-weno7": ("burgers", {}, "js", 7),
    "buckley-weno7": ("buckley", {}, "js", 7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K12_CASES))
@pytest.mark.parametrize("shape,axis", [((23, 37), 0), ((23, 37), 1),
                                        ((23, 29, 37), 0), ((23, 29, 37), 1),
                                        ((23, 29, 37), 2), ((5, 6, 70), 2)])
def test_k12_matches_twin(gpu_axis, shape, axis, case):
    name, kw, variant, order = K12_CASES[case]
    padded = list(shape)
    padded[axis] += 2 * kweno.HALO[order]
    rng = np.random.default_rng(axis)
    up = torch.from_numpy(rng.uniform(-0.1, 1.1, padded).astype(
        np.float32)).to(gpu_axis)
    fx = pflux.get(name, **kw)
    ref = kweno.flux_divergence_reference(up, axis, 0.05, fx, variant, order)
    fn = kweno.flux_divergence_2d if len(shape) == 2 else \
        kweno.flux_divergence_3d
    for chunk in (1, 5, None):
        before = fn.launches
        out = fn(up, axis, 0.05, fx, variant, order, chunk=chunk)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert out.shape == ref.shape
        assert _rel(out, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("family,n", [("diffusion", (24, 16, 16)),
                                      ("diffusion", (40, 30)),
                                      ("burgers", (24, 16, 16)),
                                      ("burgers", (32, 24))])
def test_per_axis_runs_match_generic_path(gpu_axis, family, n):
    """``impl="pallas_axis"`` against ``impl="xla"`` on the card: the
    kernels launched once per operator and stage, the results within the
    fused-vs-generic bounds of chip_smoke.py's phases 2 and 6."""
    if family == "diffusion":
        cfg = DiffusionConfig(grid=Grid.make(*n, lengths=10.0),
                              impl="pallas_axis")
        make = DiffusionSolver
    else:
        cfg = BurgersConfig(grid=Grid.make(*n), nu=1e-5, impl="pallas_axis")
        make = BurgersSolver
    s = make(cfg)
    g = make(dataclasses.replace(cfg, impl="xla"))
    assert s.engaged_path()["stepper"] == "per-axis-pallas"
    counters = (klap.laplacian_o4_3d, klap.laplacian_o4_2d,
                kweno.flux_divergence_3d, kweno.flux_divergence_2d)
    for c in counters:
        c.launches = 0
    s0 = s.initial_state()
    got = s.run(s0, 3)
    torch.cuda.synchronize()
    lap, weno_ = ((counters[0], counters[2]) if len(n) == 3
                  else (counters[1], counters[3]))
    assert lap.launches == 9
    assert weno_.launches == (0 if family == "diffusion" else 9 * len(n))
    want = g.run(s0, 3)
    # Burgers: the adaptive dt follows states that differ by rounding
    # (e-form against q-form WENO5), the bound of phase 6 of chip_smoke
    rtol, atol = (1e-5, 1e-6) if family == "diffusion" else (2e-5, 2e-6)
    assert abs(float(got.t) - float(want.t)) <= rtol * float(want.t)
    np.testing.assert_allclose(got.u.cpu().numpy(), want.u.cpu().numpy(),
                               rtol=rtol,
                               atol=atol * float(want.u.abs().max()))


# --------------------------------------------------------------------- #
# K9, the fused ADR stage kernel, and the ADR paths
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu_adr():
    if not torch.cuda.is_available():
        pytest.skip("K9 (csrc/fused_adr_stage.cu) needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("eps,lam,wall", [(0.0, 0.0, 0.1), (0.2, 0.25, 0.0),
                                          (0.2, 0.0, 0.3)])
@pytest.mark.parametrize("shape", [(23, 29, 37), (5, 6, 70)])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k9_matches_twin(gpu_adr, shape, kind, eps, lam, wall):
    """To the bit: K9 is built -fmad=false and rounds where its twin
    does."""
    rng = np.random.default_rng(kind)
    padded = tuple(n + 2 * fa.R for n in shape)
    v = torch.from_numpy(rng.random(padded, dtype=np.float32)).to(gpu_adr)
    u = torch.from_numpy(rng.random(padded, dtype=np.float32)).to(gpu_adr)
    a, b = fa.STAGES[kind]
    spacing, vel = (0.1, 0.2, 0.3), (0.5, -0.3, 0.0)
    cz, cy, cx = fa.kappa_axes(shape, gpu_adr)
    kw = dict(taps=fd.stage_taps(spacing, (1.0, 1.0, 1.0)), cz=cz, cy=cy,
              cx=cx, k0=1.3, eps=eps, lam=lam,
              adv_p=tuple(max(x, 0.0) / d for x, d in zip(vel, spacing)),
              adv_m=tuple(min(x, 0.0) / d for x, d in zip(vel, spacing)),
              a=a, b=b, band=2, bc_value=wall)
    u_arg = None if kind == 0 else u
    ref = fa.adr_stage_reference(v, u_arg, torch.zeros_like(v), 1e-3, **kw)
    out = torch.zeros_like(v)
    before = fa.fused_adr_stage.launches
    fa.fused_adr_stage(v, u_arg, out, 1e-3, **kw)
    torch.cuda.synchronize()
    assert fa.fused_adr_stage.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_adr_runs_match_generic_path(gpu_adr):
    """The fused path (K9, 3 launches a step, ``run`` and ``advance_to``)
    and the per-axis path (K11) against ``impl="xla"`` at the bounds of
    chip_smoke.py's phase 2."""
    cfg = ADRConfig(grid=Grid.make(37, 29, 23, lengths=(3.0, 2.5, 2.0)),
                    velocity=(0.4, -0.2, 0.3), kappa_variation=0.2,
                    reaction_rate=0.25, impl="pallas")
    generic = ADRSolver(dataclasses.replace(cfg, impl="xla"))
    s0 = generic.initial_state()
    for impl, counter in (("pallas", fa.fused_adr_stage),
                          ("pallas_axis", klap.laplacian_o4_3d)):
        s = ADRSolver(dataclasses.replace(cfg, impl=impl))
        counter.launches = 0
        got = s.run(s0, 7)
        torch.cuda.synchronize()
        assert counter.launches == 21
        want = generic.run(s0, 7)
        assert got.t == want.t
        scale = float(want.u.abs().max())
        bad = (got.u - want.u).abs() > 1e-5 * want.u.abs() + 1e-6 * scale
        assert not bool(bad.any())
    s = ADRSolver(cfg)
    t_end = float(s0.t) + 2.5 * s.dt
    got, want = s.advance_to(s0, t_end), generic.advance_to(s0, t_end)
    assert got.it == want.it == 3
    assert abs(float(got.t) - t_end) <= 1e-6 * t_end


# --------------------------------------------------------------------- #
# K2b: K2 and K6 with a member axis, one launch for the batch
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu_k2b():
    if not torch.cuda.is_available():
        pytest.skip("K2b (csrc/fused_step_diffusion.cu "
                    "slab_run_diffusion_batched, csrc/slab_run_burgers.cu "
                    "slab_run_burgers_batched) needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("zchunk", [3, 16, None])
@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("shape", [(23, 29, 37), (5, 70, 6), (11, 33, 65),
                                   (7, 3, 5)])
def test_k2b_diffusion_matches_twin_and_k2(gpu_k2b, shape, steps, zchunk):
    """Every member of K2b equals the batched twin and the single K2 run of
    that member, to the bit; one launch for the batch."""
    B = 3
    rng = np.random.default_rng(steps)
    S0 = torch.full((B, *(n + 2 * fd.R for n in shape)), 0.25,
                    device=gpu_k2b)
    S0[:, 2:-2, 2:-2, 2:-2] = torch.from_numpy(
        rng.random((B, *shape), dtype=np.float32))
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)), band=2,
              bc_value=0.25)
    want = fsr.ping_pong_members(
        lambda s, d: fds.step_reference(s, d, 1e-3, **kw), S0.clone(),
        S0.clone(), steps)
    before = fsr.slab_run_diffusion_batched.launches
    A, C = S0.clone(), S0.clone()
    got = fsr.slab_run_diffusion_batched(A, C, steps, 1e-3, zchunk=zchunk,
                                         **kw)
    torch.cuda.synchronize()
    assert fsr.slab_run_diffusion_batched.launches == before + 1
    assert got is (C if steps % 2 else A)
    assert torch.equal(got, want)
    for i in range(B):
        single = fsr.slab_run_diffusion(S0[i].clone(), S0[i].clone(), steps,
                                        1e-3, zchunk=zchunk, **kw)
        assert torch.equal(got[i], single), f"member {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k2b_burgers_matches_twin_and_k6(gpu_k2b, case, steps):
    name, kw, variant, nu = K5_CASES[case]
    B, shape = 3, (23, 29, 37)
    rng = np.random.default_rng(steps)
    S0 = torch.from_numpy(rng.uniform(-0.2, 1.0, (B, *shape)).astype(
        np.float32)).to(gpu_k2b)
    params = fb.stage_params(pflux.get(name, **kw), variant,
                             (0.05, 0.07, 0.09), nu)
    dt = 0.3 * 0.05
    want = fsr.ping_pong_members(
        lambda s, d: fsr.burgers_step_reference(s, d, dt, params=params),
        S0.clone(), S0.clone(), steps)
    before = fsr.slab_run_burgers_batched.launches
    got = fsr.slab_run_burgers_batched(S0.clone(), torch.empty_like(S0),
                                       steps, dt, params=params, zchunk=7)
    torch.cuda.synchronize()
    assert fsr.slab_run_burgers_batched.launches == before + 1
    assert torch.equal(got, want)
    for i in range(B):
        single = fsr.slab_run_burgers(S0[i].clone(), torch.empty_like(S0[i]),
                                      steps, dt, params=params, zchunk=7)
        assert torch.equal(got[i], single), f"member {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["13x5x70-last1", "4x40x3"])
@pytest.mark.parametrize("case", ["z-burgers-inviscid", "js-linear"])
def test_k2b_burgers_tile_edges_match_k6(gpu_k2b, case, edge):
    """K2b on shapes at the tiling's edges: every member 0 ulp from the
    batched twin and from its single K6 run."""
    shape, zchunk = K6_EDGES[edge]
    name, kw, variant, nu = K5_CASES[case]
    rng = np.random.default_rng(2)
    S0 = torch.from_numpy(rng.uniform(-0.2, 1.0, (2, *shape)).astype(
        np.float32)).to(gpu_k2b)
    params = fb.stage_params(pflux.get(name, **kw), variant,
                             (0.05, 0.07, 0.09), nu)
    want = fsr.ping_pong_members(
        lambda s, d: fsr.burgers_step_reference(s, d, 0.015, params=params),
        S0.clone(), S0.clone(), 3)
    got = fsr.slab_run_burgers_batched(S0.clone(), torch.empty_like(S0), 3,
                                       0.015, params=params, zchunk=zchunk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for i in range(2):
        single = fsr.slab_run_burgers(S0[i].clone(), torch.empty_like(S0[i]),
                                      3, 0.015, params=params, zchunk=zchunk)
        assert torch.equal(got[i], single), f"member {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("impl,stepper,counter,per_run", [
    ("pallas_slab", "ensemble-fold[fused-whole-run-slab]",
     fsr.slab_run_diffusion_batched, lambda B, n: 1),
    ("pallas_stage", "ensemble-vmap[fused-stage]", fd.fused_stage,
     lambda B, n: 3 * B * n),
    ("xla", "ensemble-vmap[generic-xla]", None, None),
])
def test_ensemble_rungs_match_looped_runs(gpu_k2b, impl, stepper, counter,
                                          per_run):
    """The diffusion ensemble on each rung equals the looped single runs
    to the bit, with exact launch counts (the slab fold: one K2b launch a
    run; the per-stage rung: K1 three times a step per member)."""
    B, n = 4, 5
    cfg = DiffusionConfig(grid=Grid.make(37, 29, 23,
                                         lengths=(3.0, 2.5, 2.0)),
                          ic="gaussian", impl=impl)
    es = EnsembleSolver(DiffusionSolver, cfg, [
        {"ic_params": (("width", 0.1 + 0.02 * i),)} for i in range(B)])
    est = es.initial_state()
    if counter is not None:
        counter.launches = 0
    out = es.run(est, n)
    torch.cuda.synchronize()
    assert es.engaged_path()["stepper"] == stepper
    if counter is not None:
        assert counter.launches == per_run(B, n)
    for i in range(B):
        ms = es.member_solver(i)
        ref = ms.run(ms.initial_state(), n)
        assert torch.equal(out.u[i], ref.u) and out.t[i] == ref.t


# --------------------------------------------------------------------- #
# The z-slab mesh: K1's and K5's sharded instances, K3, sharded runs
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu_mesh():
    if not torch.cuda.is_available():
        pytest.skip("K3 (csrc/fused_step_diffusion.cu slab_step_diffusion, "
                    "csrc/slab_run_burgers.cu slab_step_burgers) and the "
                    "sharded K1/K5 need a CUDA device")
    return torch.device("cuda")


def _rand(rng, shape, dev, lo=-0.2, hi=1.0):
    return torch.from_numpy(
        rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)


K1_ROLES = {  # window, operands: the split schedule's calls, a full call
    "full": ((0, 21), ""), "interior": ((8, 13), ""),
    "bottom": ((0, 8), "lo"), "top": ((13, 21), "hi"), "both": ((0, 21),
                                                               "lohi")}


@pytest.mark.cuda
@pytest.mark.parametrize("role", list(K1_ROLES))
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k1_sharded_matches_twin(gpu_mesh, role, kind):
    """K1 on a shard: global masks from the offsets, a window of planes,
    ghost planes from the exchanged operands; 0 ulp from its twin."""
    rng = np.random.default_rng(kind)
    shape = (21, 29, 37)
    padded = tuple(n + 2 * fd.R for n in shape)
    v, u = _rand(rng, padded, gpu_mesh), _rand(rng, padded, gpu_mesh)
    window, ops = K1_ROLES[role]
    lo = _rand(rng, (fd.R,) + padded[1:], gpu_mesh) if "lo" in ops else None
    hi = _rand(rng, (fd.R,) + padded[1:], gpu_mesh) if "hi" in ops else None
    a, b = fd.STAGES[kind]
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)), a=a, b=b,
              band=2, bc_value=0.25, global_shape=(63, 58, 37),
              offsets=(21, 29, 0), window=window, lo=lo, hi=hi)
    u_arg = None if kind == 0 else u
    out0 = _rand(rng, padded, gpu_mesh)
    ref = fd.stage_reference(v, u_arg, out0.clone(), 1e-3, **kw)
    out = out0.clone()
    before = fd.fused_stage.launches
    fd.fused_stage(v, u_arg, out, 1e-3, zchunk=3, **kw)
    torch.cuda.synchronize()
    assert fd.fused_stage.launches == before + 1
    assert torch.equal(out, ref)


K5_ROLES = {"full": ((0, 24), ""), "interior": ((8, 16), ""),
            "bottom": ((0, 8), "lo"), "top": ((16, 24), "hi")}


@pytest.mark.cuda
@pytest.mark.parametrize("oz,gnz", [(0, 48), (24, 48), (24, 72)],
                         ids=["first", "last", "middle"])
@pytest.mark.parametrize("role", list(K5_ROLES))
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_sharded_matches_twin(gpu_mesh, case, role, oz, gnz):
    """K5 on a z-slab shard: 3 ghost planes a side, z clamped at the
    global edges only, a window, the exchanged operands, the emitted
    maximum folded; 0 ulp from its twin."""
    name, fkw, variant, nu = K5_CASES[case]
    rng = np.random.default_rng(oz)
    R = fb.R
    shape = (24 + 2 * R, 29, 37)
    v, u = _rand(rng, shape, gpu_mesh), _rand(rng, shape, gpu_mesh)
    window, ops = K5_ROLES[role]
    lo = _rand(rng, (R,) + shape[1:], gpu_mesh) if "lo" in ops else None
    hi = _rand(rng, (R,) + shape[1:], gpu_mesh) if "hi" in ops else None
    params = fb.stage_params(pflux.get(name, **fkw), variant,
                             (0.05, 0.07, 0.09), nu)
    dt = torch.full((1,), 0.01, device=gpu_mesh)
    kw = dict(params=params, a=0.75, b=0.25, zpad=R, global_nz=gnz, oz=oz,
              window=window, lo=lo, hi=hi)
    out0 = _rand(rng, shape, gpu_mesh)
    ref, mref = fb.stage_reference(v, u, out0.clone(), dt, emit=True, **kw)
    out, mx = out0.clone(), torch.full((1,), 7.0, device=gpu_mesh)
    fb.fused_burgers_stage(v, u, out, dt, mx, zchunk=5, mx_init=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float(mx) == max(7.0, float(mref))


def _k3_diffusion_case(rng, dev, lz, depth, plane=(29, 37)):
    Y, X = (n + 2 * fd.R for n in plane)
    S = torch.full((lz + 2 * depth, Y, X), 0.25, device=dev)
    S[:, fd.R:-fd.R, fd.R:-fd.R] = _rand(rng, (lz + 2 * depth, *plane), dev)
    return S


K3_WINDOWS = {  # (window, operands, depth): per step, split, deep (k = 2)
    "full": ((0, 24), "", 6), "interior": ((6, 18), "", 6),
    "bottom": ((0, 6), "lo", 6), "top": ((18, 24), "hi", 6),
    "deep0": ((-6, 30), "", 12), "deep1": ((0, 24), "", 12),
    "deep-bottom": ((-6, 6), "lo", 12), "deep-top": ((18, 30), "hi", 12)}


@pytest.mark.cuda
@pytest.mark.parametrize("plane,zchunk", [((29, 37), 5), ((5, 70), None),
                                          ((33, 3), 3)],
                         ids=["29x37", "5x70-planned", "33x3"])
@pytest.mark.parametrize("oz,gnz", [(0, 48), (24, 48), (24, 72)],
                         ids=["first", "last", "middle"])
@pytest.mark.parametrize("window", list(K3_WINDOWS))
def test_k3_diffusion_matches_twin(gpu_mesh, window, oz, gnz, plane,
                                   zchunk):
    """K3 (diffusion) over per-step, split and deep windows of a shard,
    planes outside the global domain at the wall value, on planes inside
    one tile and at the tile's ragged edges; 0 ulp from its twin, and the
    cells outside the window untouched."""
    rng = np.random.default_rng(oz + gnz)
    win, ops, depth = K3_WINDOWS[window]
    S = _k3_diffusion_case(rng, gpu_mesh, 24, depth, plane)
    op_shape = (depth,) + tuple(S.shape[1:])
    lo = _rand(rng, op_shape, gpu_mesh) if "lo" in ops else None
    hi = _rand(rng, op_shape, gpu_mesh) if "hi" in ops else None
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)), band=2,
              bc_value=0.25, global_nz=gnz, oz=oz, depth=depth, window=win,
              lo=lo, hi=hi)
    out0 = _rand(rng, S.shape, gpu_mesh)
    want = fsr.slab_step_diffusion_reference(S, out0.clone(), 1e-3, **kw)
    before = fsr.slab_step_diffusion.launches
    got = fsr.slab_step_diffusion(S, out0.clone(), 1e-3, zchunk=zchunk,
                                  **kw)
    torch.cuda.synchronize()
    assert fsr.slab_step_diffusion.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(23, 29, 37), (40, 33, 65)])
def test_k3_full_window_is_k2s_step(gpu_mesh, shape):
    """K3 over a whole unsharded grid (depth R, offset 0) is K2's step."""
    rng = np.random.default_rng(3)
    S0 = torch.full(tuple(n + 2 * fd.R for n in shape), 0.25, device=gpu_mesh)
    S0[2:-2, 2:-2, 2:-2] = _rand(rng, shape, gpu_mesh)
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)), band=2,
              bc_value=0.25)
    k2 = fsr.slab_run_diffusion(S0.clone(), S0.clone(), 1, 1e-3, **kw)
    k3 = fsr.slab_step_diffusion(S0, S0.clone(), 1e-3, global_nz=shape[0],
                                 oz=0, depth=fd.R, window=(0, shape[0]),
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(k3, k2)


K3B_WINDOWS = {  # (window, operands, depth) with G = 9
    "full": ((0, 27), "", 9), "interior": ((9, 18), "", 9),
    "bottom": ((0, 9), "lo", 9), "top": ((18, 27), "hi", 9),
    "deep0": ((-9, 36), "", 18), "deep-bottom": ((-9, 9), "lo", 18),
    "deep-top": ((18, 36), "hi", 18)}


@pytest.mark.cuda
@pytest.mark.parametrize("oz,gnz", [(0, 54), (27, 54), (27, 81)],
                         ids=["first", "last", "middle"])
@pytest.mark.parametrize("window", list(K3B_WINDOWS))
@pytest.mark.parametrize("case", ["js-burgers-viscous", "z-buckley"])
def test_k3_burgers_matches_twin(gpu_mesh, case, window, oz, gnz):
    """K3 (Burgers/WENO5) over per-step, split and deep windows of a
    shard, z clamped at the global edges; 0 ulp from its twin."""
    name, fkw, variant, nu = K5_CASES[case]
    rng = np.random.default_rng(oz + gnz)
    win, ops, depth = K3B_WINDOWS[window]
    shape = (27 + 2 * depth, 29, 37)
    S = _rand(rng, shape, gpu_mesh)
    lo = _rand(rng, (depth,) + shape[1:], gpu_mesh) if "lo" in ops else None
    hi = _rand(rng, (depth,) + shape[1:], gpu_mesh) if "hi" in ops else None
    params = fb.stage_params(pflux.get(name, **fkw), variant,
                             (0.05, 0.07, 0.09), nu)
    kw = dict(params=params, global_nz=gnz, oz=oz, depth=depth, window=win,
              lo=lo, hi=hi)
    out0 = _rand(rng, shape, gpu_mesh)
    want = fsr.slab_step_burgers_reference(S, out0.clone(), 0.015, **kw)
    before = fsr.slab_step_burgers.launches
    got = fsr.slab_step_burgers(S, out0.clone(), 0.015, zchunk=7, **kw)
    torch.cuda.synchronize()
    assert fsr.slab_step_burgers.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [(5, 70), (40, 3)], ids=["5x70", "40x3"])
@pytest.mark.parametrize("window", ["full", "deep0", "deep-top"])
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k3_burgers_tile_edges_match_twin(gpu_mesh, case, window, plane):
    """K3 (Burgers) on planes at the tiling's edges, a shard in the
    middle of three, z chunks of 3 planes; 0 ulp from its twin."""
    name, fkw, variant, nu = K5_CASES[case]
    rng = np.random.default_rng(3)
    win, ops, depth = K3B_WINDOWS[window]
    shape = (27 + 2 * depth, *plane)
    S = _rand(rng, shape, gpu_mesh)
    hi = _rand(rng, (depth,) + shape[1:], gpu_mesh) if "hi" in ops else None
    params = fb.stage_params(pflux.get(name, **fkw), variant,
                             (0.05, 0.07, 0.09), nu)
    kw = dict(params=params, global_nz=81, oz=27, depth=depth, window=win,
              hi=hi)
    out0 = _rand(rng, shape, gpu_mesh)
    want = fsr.slab_step_burgers_reference(S, out0.clone(), 0.015, **kw)
    got = fsr.slab_step_burgers(S, out0.clone(), 0.015, zchunk=3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


MESH_RUNS = [  # (family, impl, config, shards, launches a step summed)
    ("diffusion", "pallas", {}, 2, {"K1": 6}),
    ("diffusion", "pallas", {"overlap": "split"}, 2, {"K1": 18}),
    ("diffusion", "pallas_slab", {}, 2, {"K3d": 2}),
    ("diffusion", "pallas_slab", {"overlap": "split"}, 2, {"K3d": 6}),
    ("diffusion", "pallas_slab", {"steps_per_exchange": 2}, 2, {"K3d": 2}),
    ("diffusion", "xla", {"overlap": "split"}, 4, {}),
    ("diffusion", "pallas_axis", {}, 2, {"K11": 6}),
    ("burgers", "pallas", {"adaptive_dt": False}, 2, {"K5": 6}),
    ("burgers", "pallas", {"overlap": "split"}, 2, {"K5": 18}),
    ("burgers", "pallas_slab", {"adaptive_dt": False}, 2, {"K3b": 2}),
    ("burgers", "pallas_slab", {"adaptive_dt": False,
                                "steps_per_exchange": 2}, 2, {"K3b": 2}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("family,impl,extra,shards,launches", MESH_RUNS)
def test_sharded_run_on_one_card_matches_unsharded(gpu_mesh, family, impl,
                                                   extra, shards, launches):
    """Every rung on a z-slab mesh of shards on one card equals the
    unsharded run of the same rung (K2/K6 for K3) to the bit, with
    ``t`` equal and the launches summed over the shards."""
    from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import make_mesh
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        laplacian as klap_,
    )

    counters = {"K1": fd.fused_stage, "K5": fb.fused_burgers_stage,
                "K3d": fsr.slab_step_diffusion, "K3b": fsr.slab_step_burgers,
                "K11": klap_.laplacian_o4_3d}
    grid = Grid.make(37, 29, 48, lengths=2.0)
    cls, cfg_cls = ((DiffusionSolver, DiffusionConfig) if family == "diffusion"
                    else (BurgersSolver, BurgersConfig))
    cfg = cfg_cls(grid=grid, impl=impl, **extra)
    plain = dataclasses.replace(cfg, steps_per_exchange=1, overlap="padded")
    mesh = make_mesh({"dz": shards}, devices=[gpu_mesh] * shards, timeout=60)
    one, sharded = cls(plain), cls(cfg, mesh=mesh)
    s0 = one.initial_state()
    want = one.run(s0, 5)
    for c in counters.values():
        c.launches = 0
    got = sharded.run(sharded.initial_state(), 5)
    torch.cuda.synchronize()
    assert {k: counters[k].launches for k in launches} == {
        k: 5 * n for k, n in launches.items()}
    assert got.t == want.t
    assert torch.equal(got.u.assemble(), want.u)


# --------------------------------------------------------------------- #
# The 2-D mesh: K8 and K8b; ADR on meshes: K9's sharded instance
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu_2d_mesh():
    if not torch.cuda.is_available():
        pytest.skip("K8 and K8b (csrc/fused2d_sharded.cu) and K9's sharded "
                    "instance (csrc/fused_adr_stage.cu) need a CUDA device")
    return torch.device("cuda")


K8_PARAMS = {  # the stage kinds of both families
    "diffusion": None,
    "js-burgers-inviscid": ("burgers", {}, "js", 0.0),
    "z-burgers-viscous": ("burgers", {}, "z", 1e-5),
    "js-linear": ("linear", {"c": -0.7}, "js", 1e-5),
    "z-buckley": ("buckley", {}, "z", 1e-5),
}
K8_SHARDS = {  # (offsets, local shape, global shape)
    "dy4-first": ((0, 0), (25, 37), (100, 37)),
    "dy4-middle": ((50, 0), (25, 37), (100, 37)),
    "dy4-last": ((75, 0), (25, 37), (100, 37)),
    "pencil-corner": ((25, 37), (25, 37), (50, 74)),
}


def _k8_params(case):
    if K8_PARAMS[case] is None:
        return fsh.DiffusionParams(fd.stage_taps((0.05, 0.07), (1.0, 0.5)),
                                   2, 0.25)
    name, fkw, variant, nu = K8_PARAMS[case]
    return fb.stage_params(pflux.get(name, **fkw), variant, (0.05, 0.07), nu)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", list(K8_SHARDS))
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
@pytest.mark.parametrize("case", list(K8_PARAMS))
def test_k8_matches_twin(gpu_2d_mesh, case, kind, shard):
    """K8 over a whole padded shard, global walls and edges from the
    offsets: 0 ulp from its twin; Burgers' emitted maximum exactly."""
    params = _k8_params(case)
    h = fsh.halo_of(params)
    offsets, (ly, lx), gshape = K8_SHARDS[shard]
    rng = np.random.default_rng(kind)
    padded = (ly + 2 * h, lx + 2 * h)
    v, u = _rand(rng, padded, gpu_2d_mesh), _rand(rng, padded, gpu_2d_mesh)
    u_arg = None if kind == 0 else u
    a, b = fd.STAGES[kind]
    burgers = case != "diffusion"
    dt = torch.full((1,), 0.004, device=gpu_2d_mesh) if burgers else 0.004
    kw = dict(params=params, a=a, b=b, global_shape=gshape)
    out0 = _rand(rng, padded, gpu_2d_mesh)
    ref = fsh.stage_reference(v, u_arg, out0.clone(), dt, offsets,
                              emit=burgers, **kw)
    out = out0.clone()
    mx = torch.full((1,), 7.0, device=gpu_2d_mesh) if burgers else None
    before = fsh.fused2d_stage.launches
    fsh.fused2d_stage(v, u_arg, out, dt, offsets, mx=mx, **kw)
    torch.cuda.synchronize()
    assert fsh.fused2d_stage.launches == before + 1
    assert torch.equal(out, ref[0] if burgers else ref)
    if burgers:
        assert float(mx) == float(ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shard", ["dy4-first", "dy4-middle", "dy4-last"])
@pytest.mark.parametrize("band", [0, 1, 2], ids=["interior", "bottom",
                                                 "top"])
@pytest.mark.parametrize("case", list(K8_PARAMS))
def test_k8b_matches_twin(gpu_2d_mesh, case, band, shard):
    """K8b over each band of the split schedule, the edge bands reading
    the exchanged rows: 0 ulp from its twin; the rows outside the band
    untouched; the emitted maximum folded."""
    params = _k8_params(case)
    h = fsh.halo_of(params)
    offsets, (ly, lx), gshape = K8_SHARDS[shard]
    rng = np.random.default_rng(band)
    padded = (ly + 2 * h, lx + 2 * h)
    v, u = _rand(rng, padded, gpu_2d_mesh), _rand(rng, padded, gpu_2d_mesh)
    rows, op = fsh.split_bands(ly, h)[band]
    ops = {op: _rand(rng, (h, padded[1]), gpu_2d_mesh)} if op else {}
    burgers = case != "diffusion"
    dt = torch.full((1,), 0.004, device=gpu_2d_mesh) if burgers else 0.004
    kw = dict(params=params, a=0.75, b=0.25, global_shape=gshape)
    out0 = _rand(rng, padded, gpu_2d_mesh)
    ref = fsh.stage_reference(v, u, out0.clone(), dt, offsets, window=rows,
                              emit=burgers, **ops, **kw)
    out = out0.clone()
    mx = torch.full((1,), 7.0, device=gpu_2d_mesh) if burgers else None
    before = fsh.fused2d_band_stage.launches
    fsh.fused2d_band_stage(v, u, out, dt, offsets, rows=rows, mx=mx,
                           mx_init=False, **ops, **kw)
    torch.cuda.synchronize()
    assert fsh.fused2d_band_stage.launches == before + 1
    assert torch.equal(out, ref[0] if burgers else ref)
    r0, r1 = rows
    assert torch.equal(out[:h + r0], out0[:h + r0])
    assert torch.equal(out[h + r1:], out0[h + r1:])
    if burgers:
        assert float(mx) == max(7.0, float(ref[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k9_sharded_matches_twin(gpu_2d_mesh, kind):
    """K9's sharded instance: global walls from the offsets, the factors
    of K(x) at the shard's cells; 0 ulp from its twin, and the unsharded
    launch unchanged by the sharded one's existence."""
    rng = np.random.default_rng(kind)
    shape, gshape, offs = (13, 21, 37), (39, 42, 37), (13, 21, 0)
    padded = tuple(n + 2 * fa.R for n in shape)
    v, u = _rand(rng, padded, gpu_2d_mesh), _rand(rng, padded, gpu_2d_mesh)
    cz, cy, cx = (c[o:o + n] for c, o, n in zip(
        fa.kappa_axes(gshape, gpu_2d_mesh), offs, shape))
    a, b = fd.STAGES[kind]
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 1.0, 1.0)), cz=cz,
              cy=cy, cx=cx, k0=0.7, eps=0.2, adv_p=(0.5, 0.0, 1.0),
              adv_m=(0.0, -0.3, 0.0), lam=0.25, a=a, b=b, band=2,
              bc_value=0.1, global_shape=gshape, offsets=offs)
    u_arg = None if kind == 0 else u
    out0 = _rand(rng, padded, gpu_2d_mesh)
    ref = fa.adr_stage_reference(v, u_arg, out0.clone(), 1e-3, **kw)
    out = out0.clone()
    before = fa.fused_adr_stage.launches
    fa.fused_adr_stage(v, u_arg, out, 1e-3, **kw)
    torch.cuda.synchronize()
    assert fa.fused_adr_stage.launches == before + 1
    assert torch.equal(out, ref)


MESH_2D_RUNS = [  # (family, config, mesh sizes, decomposition, launches)
    ("diffusion", {}, {"dy": 2}, {0: "dy"}, {"K8": 6}),
    ("diffusion", {"overlap": "split"}, {"dy": 2}, {0: "dy"}, {"K8b": 18}),
    ("diffusion", {}, {"dy": 2, "dx": 2}, {0: "dy", 1: "dx"}, {"K8": 12}),
    ("burgers", {"adaptive_dt": False}, {"dy": 2}, {0: "dy"}, {"K8": 6}),
    ("burgers", {"overlap": "split"}, {"dy": 2}, {0: "dy"}, {"K8b": 18}),
    ("burgers", {"nu": 1e-5}, {"dx": 4}, {1: "dx"}, {"K8": 12}),
    ("adr", {}, {"dz": 2}, {0: "dz"}, {"K9": 6}),
    ("adr", {}, {"dz": 2, "dy": 2}, {0: "dz", 1: "dy"}, {"K9": 12}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("family,extra,sizes,mapping,launches", MESH_2D_RUNS)
def test_2d_and_adr_mesh_runs_match_unsharded(gpu_2d_mesh, family, extra,
                                              sizes, mapping, launches):
    """The 2-D mesh paths on shards of one card equal K7's (K7a's)
    unsharded run, and ADR's K9 mesh path K9's, to the bit, ``t`` equal,
    with the launches summed over the shards."""
    from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
        Decomposition,
        make_mesh,
    )

    counters = {"K8": fsh.fused2d_stage, "K8b": fsh.fused2d_band_stage,
                "K9": fa.fused_adr_stage}
    if family == "adr":
        cls, cfg = ADRSolver, ADRConfig(
            grid=Grid.make(37, 30, 48, lengths=(3.7, 3.0, 4.8)),
            impl="pallas", velocity=0.5, kappa_variation=0.2,
            reaction_rate=0.25, **extra)
    else:
        cls, cfg_cls = ((DiffusionSolver, DiffusionConfig)
                        if family == "diffusion"
                        else (BurgersSolver, BurgersConfig))
        cfg = cfg_cls(grid=Grid.make(64, 72, lengths=2.0), impl="pallas",
                      **extra)
    n = int(np.prod(list(sizes.values())))
    mesh = make_mesh(sizes, devices=[gpu_2d_mesh] * n, timeout=60)
    one = cls(dataclasses.replace(cfg, overlap="padded"))
    sharded = cls(cfg, mesh=mesh, decomp=Decomposition.of(mapping))
    want = one.run(one.initial_state(), 5)
    for c in counters.values():
        c.launches = 0
    got = sharded.run(sharded.initial_state(), 5)
    torch.cuda.synchronize()
    assert {k: c.launches for k, c in counters.items()} == {
        k: 5 * launches.get(k, 0) for k in counters}
    assert got.t == want.t
    assert torch.equal(got.u.assemble(), want.u)


# --------------------------------------------------------------------- #
# K4: the whole sharded run, every shard of the card in one launch
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu_k4():
    if not torch.cuda.is_available():
        pytest.skip("K4 (csrc/fused_step_diffusion.cu slab_run_dma_diffusion,"
                    " csrc/slab_run_burgers.cu slab_run_dma_burgers) needs a "
                    "CUDA device")
    return torch.device("cuda")


K4_CASES = [  # (family, shards, core planes, k, steps)
    ("diffusion", 2, 24, 1, 3), ("diffusion", 2, 24, 4, 7),
    ("diffusion", 3, 26, 2, 5), ("diffusion", 4, 24, 1, 2),
    ("js-burgers-viscous", 2, 27, 1, 3), ("js-burgers-viscous", 3, 27, 2, 5),
    ("z-buckley", 2, 27, 1, 3), ("z-buckley", 3, 27, 2, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("family,shards,lz,k,steps", K4_CASES)
def test_k4_matches_twin(gpu_k4, family, shards, lz, k, steps):
    """K4 on random shard buffers: every state and landing buffer 0 ulp
    from its twin's after a run with a partial block, one launch."""
    rng = np.random.default_rng(shards * 100 + k)
    diffusion = family == "diffusion"
    G = 3 * (fd.R if diffusion else fb.R)
    depth, ring = k * G, fd.R if diffusion else 0
    shape = (lz + 2 * depth, 29 + 2 * ring, 37 + 2 * ring)
    S0 = [_rand(rng, shape, gpu_k4) for _ in range(shards)]
    if diffusion:
        for S in S0:
            S[:, :ring] = S[:, -ring:] = 0.25
            S[:, :, :ring] = S[:, :, -ring:] = 0.25
    S1 = [_rand(rng, shape, gpu_k4) for _ in range(shards)]
    lands = [_rand(rng, (2, 2, depth) + shape[1:], gpu_k4)
             for _ in range(shards)]
    gnz = shards * lz
    if diffusion:
        kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)),
                  band=2, bc_value=0.25)
        run, dt, zchunk = fsr.slab_run_dma_diffusion, 1e-3, 5

        def step(S, out, window, oz):
            fsr.slab_step_diffusion_reference(
                S, out, dt, global_nz=gnz, oz=oz, depth=depth,
                window=window, **kw)
    else:
        name, fkw, variant, nu = K5_CASES[family]
        kw = dict(params=fb.stage_params(pflux.get(name, **fkw), variant,
                                         (0.05, 0.07, 0.09), nu))
        run, dt, zchunk = fsr.slab_run_dma_burgers, 0.015, 7

        def step(S, out, window, oz):
            fsr.slab_step_burgers_reference(
                S, out, dt, global_nz=gnz, oz=oz, depth=depth,
                window=window, **kw)
    got = [[t.clone() for t in ts] for ts in (S0, S1, lands)]
    want = [[t.clone() for t in ts] for ts in (S0, S1, lands)]
    before = run.launches
    run(*got, steps, dt, k=k, zchunk=zchunk, **kw)
    torch.cuda.synchronize()
    assert run.launches == before + 1
    fsr.slab_run_dma_reference(step, *want, steps, k=k, G=G)
    for a, b in zip(sum(got, []), sum(want, [])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [(5, 70), (40, 3)], ids=["5x70", "40x3"])
@pytest.mark.parametrize("case,shards,lz,k,steps", [
    ("z-burgers-inviscid", 2, 13, 1, 3), ("js-linear", 3, 19, 2, 5)])
def test_k4_burgers_tile_edges_match_twin(gpu_k4, case, shards, lz, k,
                                          steps, plane):
    """K4 (Burgers) on planes at the tiling's edges, z chunks of 4
    planes with a last one of 1 plane (13 core planes; at k = 2 the
    widest window, 37 planes): every state and landing buffer 0 ulp from
    its twin's."""
    rng = np.random.default_rng(4)
    G = 3 * fb.R
    depth = k * G
    shape = (lz + 2 * depth, *plane)
    bufs = [[_rand(rng, shape, gpu_k4) for _ in range(shards)]
            for _ in range(2)]
    bufs.append([_rand(rng, (2, 2, depth) + shape[1:], gpu_k4)
                 for _ in range(shards)])
    name, fkw, variant, nu = K5_CASES[case]
    params = fb.stage_params(pflux.get(name, **fkw), variant,
                             (0.05, 0.07, 0.09), nu)
    got = [[t.clone() for t in ts] for ts in bufs]
    want = [[t.clone() for t in ts] for ts in bufs]
    fsr.slab_run_dma_burgers(*got, steps, 0.015, params=params, k=k,
                             zchunk=3)
    torch.cuda.synchronize()
    fsr.slab_run_dma_reference(
        lambda S, out, window, oz: fsr.slab_step_burgers_reference(
            S, out, 0.015, params=params, global_nz=shards * lz, oz=oz,
            depth=depth, window=window), *want, steps, k=k, G=G)
    for a, b in zip(sum(got, []), sum(want, [])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("zchunk", [3, None])
@pytest.mark.parametrize("plane", [(5, 70), (33, 3)], ids=["5x70", "33x3"])
@pytest.mark.parametrize("shards,lz,k,steps", [(2, 24, 1, 3), (2, 24, 4, 7)],
                         ids=["k1", "k4"])
def test_k4_diffusion_tile_edges_match_twin(gpu_k4, shards, lz, k, steps,
                                            plane, zchunk):
    """K4 (diffusion) on planes at the tiling's edges, k = 1 and k = 4
    (a partial block), explicit and planned z chunks, the wall value
    0.25: every state and landing buffer 0 ulp from its twin's."""
    rng = np.random.default_rng(5)
    depth = 3 * k * fd.R
    shape = (lz + 2 * depth, *(n + 2 * fd.R for n in plane))
    S0 = [_rand(rng, shape, gpu_k4) for _ in range(shards)]
    for S in S0:
        S[:, :fd.R] = S[:, -fd.R:] = 0.25
        S[:, :, :fd.R] = S[:, :, -fd.R:] = 0.25
    bufs = [S0, [_rand(rng, shape, gpu_k4) for _ in range(shards)],
            [_rand(rng, (2, 2, depth) + shape[1:], gpu_k4)
             for _ in range(shards)]]
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)), band=2,
              bc_value=0.25)
    got = [[t.clone() for t in ts] for ts in bufs]
    want = [[t.clone() for t in ts] for ts in bufs]
    fsr.slab_run_dma_diffusion(*got, steps, 1e-3, k=k, zchunk=zchunk, **kw)
    torch.cuda.synchronize()
    fsr.slab_run_dma_reference(
        lambda S, out, window, oz: fsr.slab_step_diffusion_reference(
            S, out, 1e-3, global_nz=shards * lz, oz=oz, depth=depth,
            window=window, **kw), *want, steps, k=k, G=3 * fd.R)
    for a, b in zip(sum(got, []), sum(want, [])):
        assert torch.equal(a, b)


DMA_RUNS = [  # (family, config, shards)
    ("diffusion", {}, 2), ("diffusion", {"steps_per_exchange": 4}, 2),
    ("diffusion", {"steps_per_exchange": 2}, 4),
    ("burgers", {}, 2), ("burgers", {"weno_variant": "z",
                                     "steps_per_exchange": 2}, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("family,extra,shards", DMA_RUNS)
def test_dma_run_on_one_card_matches_collective_and_unsharded(
        gpu_k4, family, extra, shards):
    """``exchange="dma"`` on a z-slab mesh of shards on one card: one K4
    launch a run, no K3 launch, and the collective K3 run and the
    unsharded K2/K6 run to the bit, ``t`` equal."""
    from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import make_mesh

    grid = Grid.make(37, 29, 96, lengths=2.0)
    if family == "diffusion":
        cls, cfg = DiffusionSolver, DiffusionConfig(
            grid=grid, impl="pallas_slab", **extra)
        k4, k3 = fsr.slab_run_dma_diffusion, fsr.slab_step_diffusion
    else:
        cls, cfg = BurgersSolver, BurgersConfig(
            grid=grid, impl="pallas_slab", adaptive_dt=False, nu=1e-5,
            **extra)
        k4, k3 = fsr.slab_run_dma_burgers, fsr.slab_step_burgers

    def mesh():
        return make_mesh({"dz": shards}, devices=[gpu_k4] * shards,
                         timeout=60)

    dma = cls(dataclasses.replace(cfg, exchange="dma"), mesh=mesh())
    coll = cls(cfg, mesh=mesh())
    one = cls(dataclasses.replace(cfg, steps_per_exchange=1))
    k4.launches = k3.launches = 0
    got = dma.run(dma.initial_state(), 7)
    torch.cuda.synchronize()
    assert (k4.launches, k3.launches) == (1, 0)
    want = coll.run(coll.initial_state(), 7)
    ref = one.run(one.initial_state(), 7)
    assert got.t == want.t == ref.t
    assert torch.equal(got.u.assemble(), want.u.assemble())
    assert torch.equal(got.u.assemble(), ref.u)
