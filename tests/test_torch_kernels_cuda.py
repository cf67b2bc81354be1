"""K1, K5 and K9, the port's CUDA stage kernels (K5 at WENO5 and
WENO7), K7/K7a, its 2-D
whole-run kernels, K10, K2 and K6, its 3-D fused-step kernels, K2b, the
B-folded slab kernel of the ensemble engine, K11/K11b and K12/K12b,
its per-axis kernels, and the mesh slice — K1's and K5's sharded
instances and K3, the windowed slab step, with the sharded runs of a
two-shard mesh on one card, K8/K8b, the sharded 2-D stages, and K9's
sharded instance, with the 2-D and ADR mesh runs, and K4, the sharded
run of every shard of the card with the ghost rows moved inside the
kernel, and the WENO7 instances of K3, K4, K2b, the sharded K5 and
K8/K8b with their mesh runs, and the bf16 instances of K1, K2, K6 and K9
with float64 storage on K1/K2, and the sharded bf16 instances of K1 and
K9 and the bf16 instances of K3 and K4 with their mesh runs, and K5's
y/x-sharded instance with its runs on y/x-cut meshes — against
their plain PyTorch twins on a GPU. Marked ``cuda``:
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
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
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


# (shape, tiles): the planned tiles, one tile, one row or column of tiles,
# many of each, and more tiles than resident blocks (every job reloads
# its window each step)
K7_TILINGS = [((23, 37), None), ((23, 37), (1, 1)), ((23, 37), (3, 6)),
              ((23, 37), (2, 1)), ((5, 70), None), ((5, 70), (1, 11)),
              ((200, 200), (20, 20))]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3, 5])
@pytest.mark.parametrize("shape,tiles", K7_TILINGS,
                         ids=[f"{s[0]}x{s[1]}-{t}" for s, t in K7_TILINGS])
def test_k7_diffusion_matches_twin(gpu, shape, tiles, steps):
    """To the bit, odd step counts too (the result comes back from the
    second buffer)."""
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
    plan = {}
    fd2.whole_run_diffusion2d(got, S.clone(), S.clone(), steps, 1e-3,
                              tiles=tiles, schedule=plan, **kw)
    torch.cuda.synchronize()
    assert wr.whole_run.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got[:2], S[:2]) and torch.equal(got[:, -2:], S[:, -2:])
    if tiles is not None:
        assert plan["tiles"] == tiles
    assert plan["resident"] == (plan["jobs"] <= plan["grid_blocks"])
    assert plan["blocks"] == plan["grid_blocks"]  # the planner's count


K7_CASES = {
    "js-burgers-viscous": ("burgers", {}, "js", 1e-5),
    "z-burgers-inviscid": ("burgers", {}, "z", 0.0),
    "js-linear": ("linear", {"c": -0.7}, "js", 1e-5),
    "z-buckley": ("buckley", {}, "z", 1e-5),
}


# (shape, tiles) of K7 Burgers: the planned tiles, one tile, a grid of
# tiles, one column of tiles, one row, and more tiles than resident blocks
# (every job reloads its window each step); each side 9 cells or more
K7B_TILINGS = [((23, 37), None), ((23, 37), (1, 1)), ((23, 37), (2, 4)),
               ((23, 37), (2, 1)), ((5, 70), None), ((5, 70), (1, 7)),
               ((200, 200), (20, 20))]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3, 5])
@pytest.mark.parametrize("shape,tiles", K7B_TILINGS,
                         ids=[f"{s[0]}x{s[1]}-{t}" for s, t in K7B_TILINGS])
@pytest.mark.parametrize("adaptive", [False, True], ids=["K7", "K7a"])
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_burgers_matches_twin(gpu, case, adaptive, shape, tiles, steps):
    """To the bit, odd step counts too (the result comes back from the
    second buffer), on every tiling; the adaptive time advance exactly;
    the plan's blocks are the launch's."""
    name, kw, variant, nu = K7_CASES[case]
    spacing, cfl = (0.05, 0.07), 0.4
    rng = np.random.default_rng(steps)
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
    plan = {}
    res = fb2.whole_run_burgers2d(got, T[0], T[1], steps, params=params,
                                  tiles=tiles, schedule=plan, **mode)
    if adaptive:
        flux = params.flux
        want, want_t = wr.plain_run_adaptive(
            stage, lambda u: pcfl.advective_dt(u, flux.df, spacing, cfl),
            S.clone(), T[2], T[3], steps)
        assert float(res[1]) == float(want_t)
    else:
        want = wr.plain_run(stage, S.clone(), T[2], T[3], steps, mode["dt"])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(got, want)
    if tiles is not None:
        assert plan["tiles"] == tiles
    assert plan["resident"] == (plan["jobs"] <= plan["grid_blocks"])
    assert plan["blocks"] == plan["grid_blocks"]  # the planner's count


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


# --------------------------------------------------------------------- #
# The WENO7-JS instances of K5, K7/K7a and K6 (reach 4): each against its
# twin on bounded data (uniform(-0.2, 1.0): the e-form's alphas scale as
# beta^6), to the bit
# --------------------------------------------------------------------- #
W7_CASES = {
    "burgers-viscous": ("burgers", {}, 1e-5),
    "linear": ("linear", {"c": -0.7}, 1e-5),
    "buckley-inviscid": ("buckley", {}, 0.0),
}


@pytest.fixture
def gpu7():
    if not torch.cuda.is_available():
        pytest.skip("the WENO7 instances of K5 (csrc/fused_burgers_stage.cu),"
                    " K7/K7a (csrc/whole_run_burgers2d.cu) and K6 "
                    "(csrc/slab_run_burgers.cu) need a CUDA device")
    return torch.device("cuda")


def _params7(case, spacing):
    name, kw, nu = W7_CASES[case]
    return fb.stage_params(pflux.get(name, **kw), "js", spacing, nu, order=7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,zchunk", [((23, 29, 37), None),
                                          ((9, 15, 33), 3), ((5, 1, 70), 2),
                                          ((4, 70, 1), None)])
@pytest.mark.parametrize("case", list(W7_CASES))
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k5_order7_matches_twin(gpu7, kind, case, shape, zchunk):
    """K5's order-7 instance, every stage kind, at shapes off its 14x32
    tile and with short z chunks: 0 ulp from its twin; the emitted
    maximum exactly."""
    rng = np.random.default_rng(kind)
    v = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu7)
    u = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu7)
    params = _params7(case, (0.05, 0.07, 0.09))
    a, b = fb.STAGES[kind]
    dt = torch.full((), 2e-3, device=gpu7)
    u_arg = None if kind == 0 else u
    emit = kind == 2
    ref = fb.stage_reference(v, u_arg, torch.empty_like(v), dt,
                             params=params, a=a, b=b, emit=emit)
    out = u.clone() if kind == 2 else torch.empty_like(v)
    mx = torch.full((1,), -1.0, device=gpu7) if emit else None
    before = fb.fused_burgers_stage.launches
    fb.fused_burgers_stage(v, out if kind == 2 else u_arg, out, dt, mx,
                           params=params, a=a, b=b, zchunk=zchunk)
    torch.cuda.synchronize()
    assert fb.fused_burgers_stage.launches == before + 1
    want = ref[0] if emit else ref
    assert torch.equal(out, want)
    if emit:
        assert float(mx[0]) == float(ref[1])


@pytest.mark.cuda
def test_k5_order7_geometry(gpu7):
    """The built order-7 instance's tiling is fused_burgers.tile_geometry's
    at order 7, and it spills nothing."""
    geo, want = fb.geometry(7), fb.tile_geometry(7)
    assert (geo["tile_y"], geo["tile_x"]) == fb.TILE
    assert geo["threads"] == want["threads"]
    assert geo["smem_bytes"] == want["smem_bytes"]
    assert geo["blocks_per_sm"] >= 1


# tilings of K7's order-7 instance: every side 12 cells or more
K7W7_TILINGS = [((25, 37), None), ((25, 37), (1, 1)), ((25, 37), (2, 3)),
                ((25, 37), (2, 1)), ((5, 70), None), ((5, 70), (1, 5)),
                ((200, 200), (16, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3, 5])
@pytest.mark.parametrize("shape,tiles", K7W7_TILINGS,
                         ids=[f"{s[0]}x{s[1]}-{t}" for s, t in K7W7_TILINGS])
@pytest.mark.parametrize("adaptive", [False, True], ids=["K7", "K7a"])
@pytest.mark.parametrize("case", list(W7_CASES))
def test_k7_order7_matches_twin(gpu7, case, adaptive, shape, tiles, steps):
    """K7/K7a at order 7 to the bit on every tiling, odd step counts too;
    the adaptive time advance exactly; the plan is the order-7 plan."""
    spacing, cfl = (0.05, 0.07), 0.4
    rng = np.random.default_rng(steps)
    S = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu7)
    params = _params7(case, spacing)
    mode = (dict(spacing=spacing, cfl=cfl) if adaptive
            else dict(dt=cfl * min(spacing)))
    stage = (lambda v, u, out, dt, a, b: fb2.stage_reference(
        v, u, out, dt, params=params, a=a, b=b))
    T = [torch.empty_like(S) for _ in range(4)]
    got = S.clone()
    counter = wr.whole_run_adaptive if adaptive else wr.whole_run
    before = counter.launches
    plan = {}
    res = fb2.whole_run_burgers2d(got, T[0], T[1], steps, params=params,
                                  tiles=tiles, schedule=plan, **mode)
    if adaptive:
        flux = params.flux
        want, want_t = wr.plain_run_adaptive(
            stage, lambda u: pcfl.advective_dt(u, flux.df, spacing, cfl),
            S.clone(), T[2], T[3], steps)
        assert float(res[1]) == float(want_t)
    else:
        want = wr.plain_run(stage, S.clone(), T[2], T[3], steps, mode["dt"])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(got, want)
    if tiles is not None:
        assert plan["tiles"] == tiles
    h, w = plan["window"]
    assert plan["smem_bytes"] == fb2.PLANES * (h + 2) * (w + 2) * 4
    assert plan["resident"] == (plan["jobs"] <= plan["grid_blocks"])
    assert plan["blocks"] == plan["grid_blocks"]


# the order-7 slab body's edges: 24-cell tiles, ny and nx off one and
# two tiles and below one, a last z chunk of one plane
K6W7_EDGES = {"13x5x70-last1": ((13, 5, 70), 3), "1x6x5": ((1, 6, 5), 7),
              "4x25x3": ((4, 25, 3), 64), "9x49x23": ((9, 49, 23), None),
              "23x29x37": ((23, 29, 37), 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("edge", list(K6W7_EDGES))
@pytest.mark.parametrize("case", list(W7_CASES))
def test_k6_order7_matches_twin(gpu7, case, edge, steps):
    """K6's order-7 instance against its twin (three K5-twin stages a
    step at reach 4), 0 ulp."""
    shape, zchunk = K6W7_EDGES[edge]
    rng = np.random.default_rng(20 + steps)
    S0 = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu7)
    params = _params7(case, (0.05, 0.07, 0.09))
    want = _steps(lambda s, d: fsr.burgers_step_reference(
        s, d, 0.015, params=params), S0, steps)
    before = fsr.slab_run_burgers.launches
    got = fsr.slab_run_burgers(S0.clone(), torch.empty_like(S0), steps,
                               0.015, params=params, zchunk=zchunk)
    torch.cuda.synchronize()
    assert fsr.slab_run_burgers.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_weno7_runs_match_generic_path(gpu7):
    """Each WENO7 fused rung (K5 adaptive and fixed, K6, K7, K7a) against
    the generic WENO7 path, at the fused-vs-generic bound, one launch
    where a run is one."""
    runs = [((37, 29, 23), "pallas", True, "fused-stage"),
            ((37, 29, 23), "pallas_stage", False, "fused-stage"),
            ((37, 29, 23), "pallas_slab", False, "fused-whole-run-slab"),
            ((61, 47), "pallas", False, "fused-whole-run"),
            ((61, 47), "pallas", True, "fused-whole-run")]
    for n, impl, adaptive, label in runs:
        kw = dict(grid=Grid.make(*n, lengths=2.0), nu=1e-5, weno_order=7,
                  adaptive_dt=adaptive)
        fused = BurgersSolver(BurgersConfig(impl=impl, **kw))
        generic = BurgersSolver(BurgersConfig(impl="xla", **kw))
        assert fused.engaged_path()["stepper"] == label
        s0 = fused.initial_state()
        got, want = fused.run(s0, 7), generic.run(s0, 7)
        scale = float(want.u.abs().max())
        assert not bool(((got.u - want.u).abs()
                         > 2e-5 * want.u.abs() + 2e-6 * scale).any()), label
        assert abs(float(got.t) - float(want.t)) <= 1e-5 * float(want.t)


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


K12_GHOSTS = {  # the ghost source: a boundary, or a halo exchange's slabs
    "edge": Boundary("edge"),
    "periodic": Boundary("periodic"),
    "dirichlet": Boundary("dirichlet", 0.37),
    "slabs": None,
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K12_CASES))
@pytest.mark.parametrize("shape,axis", [((23, 37), 0), ((23, 37), 1),
                                        ((23, 29, 37), 0), ((23, 29, 37), 1),
                                        ((23, 29, 37), 2), ((5, 6, 70), 2),
                                        ((9, 31, 40), 1), ((26, 40), 0)])
def test_k12_matches_twin(gpu_axis, shape, axis, case):
    """K12/K12b on unpadded arrays against their twin at 0 ulp: every
    ghost source, the three stores, the planned chunk and forced ones
    (1, 5, 13); along the last axis the planned segment and a short one
    (8)."""
    name, kw, variant, order = K12_CASES[case]
    r = kweno.HALO[order]
    rng = np.random.default_rng(axis)
    u = torch.from_numpy(rng.uniform(-0.1, 1.1, shape).astype(
        np.float32)).to(gpu_axis)
    acc0 = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(gpu_axis)
    slab = list(shape)
    slab[axis] = r
    slabs = tuple(torch.from_numpy(rng.uniform(-0.1, 1.1, slab).astype(
        np.float32)).to(gpu_axis) for _ in range(2))
    fx = pflux.get(name, **kw)
    fn = kweno.flux_divergence_2d if len(shape) == 2 else \
        kweno.flux_divergence_3d
    last = axis == len(shape) - 1
    plans = [{}, {"chunk": 8}] if last else [{}, {"chunk": 1},
                                             {"chunk": 5}, {"chunk": 13}]
    for source, bc in K12_GHOSTS.items():
        src = {"ghosts": slabs} if bc is None else {"bc": bc}
        for store in ("div", "sum", "negated-sum"):
            acc = None if store == "div" else acc0
            ref = kweno.flux_divergence_axis_reference(
                u, axis, 0.05, fx, variant, order, acc=acc,
                negate=store == "negated-sum", **src)
            for plan in plans:
                before = fn.launches
                out = fn(u, axis, 0.05, fx, variant, order,
                         acc=None if acc is None else acc.clone(),
                         negate=store == "negated-sum", **src, **plan)
                torch.cuda.synchronize()
                assert fn.launches == before + 1
                assert out.shape == ref.shape
                assert torch.equal(out, ref), (source, store, plan)


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


# z chunks: the planned one and chunks that leave a short last one
K9_ZCHUNKS = [None, 3, 5]


@pytest.mark.cuda
@pytest.mark.parametrize("zchunk", K9_ZCHUNKS,
                         ids=[f"z{z}" for z in K9_ZCHUNKS])
@pytest.mark.parametrize("eps,lam,wall", [(0.0, 0.0, 0.1), (0.2, 0.25, 0.0),
                                          (0.2, 0.0, 0.3)])
@pytest.mark.parametrize("shape", [(23, 29, 37), (5, 6, 70), (13, 21, 60)])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k9_matches_twin(gpu_adr, shape, kind, eps, lam, wall, zchunk):
    """To the bit: K9 is built -fmad=false and rounds where its twin
    does; a row pitch of a multiple of 16 bytes (60 + 4 floats) takes
    16-byte copies, the others 4-byte ones."""
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
    launch = {}
    fa.fused_adr_stage(v, u_arg, out, 1e-3, zchunk=zchunk, launch=launch,
                       **kw)
    torch.cuda.synchronize()
    assert fa.fused_adr_stage.launches == before + 1
    assert torch.equal(out, ref)
    assert launch["copy_floats"] == fa.copy_floats(shape[2])
    assert launch["blocks_per_sm"] == fa.BLOCKS_PER_SM


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
    # an even pitch at both reaches, clear of the global x edges: window
    # loads of several floats
    "pencil-middle-even": ((26, 40), (26, 40), (78, 120)),
}


def _k8_params(case):
    if K8_PARAMS[case] is None:
        return fsh.DiffusionParams(fd.stage_taps((0.05, 0.07), (1.0, 0.5)),
                                   2, 0.25)
    name, fkw, variant, nu = K8_PARAMS[case]
    return fb.stage_params(pflux.get(name, **fkw), variant, (0.05, 0.07), nu)


K8_BODIES = {"planned": None, "cell": {"body": fsh.CELL},
             "tiled": {"body": fsh.TILED},
             "tiled-scalar": {"body": fsh.TILED, "vec": 1},
             "tiled-7x9-64": {"body": fsh.TILED, "tile": (7, 9),
                              "threads": 64},
             "tiled-5x8-64": {"body": fsh.TILED, "tile": (5, 8),
                              "threads": 64},
             # WENO7's tile on a large shard: over 48 KB at reach 4
             "tiled-32x64-256": {"body": fsh.TILED, "tile": (32, 64),
                                 "threads": 256}}


def _force(monkeypatch, body):
    """Launches planned on ``K8_BODIES[body]`` in place of the planner's
    rule (``fused2d_sharded.plan_tiles``, which every launch plan asks)."""
    forced = K8_BODIES[body]
    if forced:
        plan = fsh.plan_tiles
        monkeypatch.setattr(fsh, "plan_tiles",
                            lambda *a, **k: plan(*a, **{**k, **forced}))


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(K8_BODIES))
@pytest.mark.parametrize("shard", list(K8_SHARDS))
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
@pytest.mark.parametrize("case", list(K8_PARAMS))
def test_k8_matches_twin(monkeypatch, gpu_2d_mesh, case, kind, shard,
                         body):
    """K8 over a whole padded shard, global walls and edges from the
    offsets, on the planned tiles and on each body, other tilings and
    one-float window loads (diffusion refuses the TILED body, which only
    Burgers has): 0 ulp from its twin; Burgers' emitted maximum
    exactly."""
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
    if not burgers and body.startswith("tiled"):  # a CELL body only
        with monkeypatch.context() as m:
            _force(m, body)
            with pytest.raises(ValueError, match="no TILED body"):
                fsh.fused2d_stage(v, u_arg, out, dt, offsets, **kw)
        assert fsh.fused2d_stage.launches == before
        body = "cell"
    _force(monkeypatch, body)
    fsh.fused2d_stage(v, u_arg, out, dt, offsets, mx=mx, **kw)
    torch.cuda.synchronize()
    assert fsh.fused2d_stage.launches == before + 1
    assert torch.equal(out, ref[0] if burgers else ref)
    if burgers:
        assert float(mx) == float(ref[1])


def _k8b_call(params, shard, band, dev, seed, mx_value=7.0):
    """Operands of a K8b call on ``shard``: band 0-2 of
    :func:`split_bands` or 3, both edge bands; the twin's result (the
    single-band twin calls in the schedule's order) and its maximum
    folded into ``mx_value``."""
    h = fsh.halo_of(params)
    offsets, (ly, lx), gshape = K8_SHARDS[shard]
    rng = np.random.default_rng(seed)
    padded = (ly + 2 * h, lx + 2 * h)
    v, u = _rand(rng, padded, dev), _rand(rng, padded, dev)
    ops = {k: _rand(rng, (h, padded[1]), dev) for k in ("lo", "hi")}
    bands = fsh.split_bands(ly, h)
    chosen = bands[1:] if band == 3 else (bands[band],)
    burgers = isinstance(params, fb.StageParams)
    dt = torch.full((1,), 0.004, device=dev) if burgers else 0.004
    kw = dict(params=params, a=0.75, b=0.25, global_shape=gshape)
    out0 = _rand(rng, padded, dev)
    ref, m = out0.clone(), mx_value
    for rows, op in chosen:
        res = fsh.stage_reference(v, u, ref, dt, offsets, window=rows,
                                  emit=burgers,
                                  **({op: ops[op]} if op else {}), **kw)
        if burgers:
            m = max(m, float(res[1]))
    if band == 3:
        rows, given = fsh.edge_bands(ly, h), ops
    else:
        rows, op = chosen[0]
        given = {op: ops[op]} if op else {}
    return dict(v=v, u=u, dt=dt, offsets=offsets, kw=kw, out0=out0,
                rows=rows, ops=given, ref=ref, mref=m, h=h,
                chosen=chosen, burgers=burgers)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["planned", "cell", "tiled"])
@pytest.mark.parametrize("shard", ["dy4-first", "dy4-middle", "dy4-last"])
@pytest.mark.parametrize("band", [0, 1, 2, 3], ids=["interior", "bottom",
                                                    "top", "edges"])
@pytest.mark.parametrize("case", list(K8_PARAMS))
def test_k8b_matches_twin(monkeypatch, gpu_2d_mesh, case, band, shard,
                          body):
    """K8b over each band of the split schedule and over both edge bands
    in one launch, the edge bands reading the exchanged rows, on each
    body: 0 ulp from its twin (the edge bands' two single-band twin
    calls); the rows outside the bands untouched; the emitted maximum
    folded."""
    c = _k8b_call(_k8_params(case), shard, band, gpu_2d_mesh, band)
    out = c["out0"].clone()
    mx = (torch.full((1,), 7.0, device=gpu_2d_mesh) if c["burgers"]
          else None)
    before = fsh.fused2d_band_stage.launches
    if not c["burgers"] and body == "tiled":  # a CELL body only
        with monkeypatch.context() as m:
            _force(m, body)
            with pytest.raises(ValueError, match="no TILED body"):
                fsh.fused2d_band_stage(c["v"], c["u"], out, c["dt"],
                                       c["offsets"], rows=c["rows"],
                                       **c["ops"], **c["kw"])
        body = "cell"
    _force(monkeypatch, body)
    fsh.fused2d_band_stage(c["v"], c["u"], out, c["dt"], c["offsets"],
                           rows=c["rows"], mx=mx, mx_init=False,
                           **c["ops"], **c["kw"])
    torch.cuda.synchronize()
    assert fsh.fused2d_band_stage.launches == before + 1
    assert torch.equal(out, c["ref"])
    h, written = c["h"], torch.zeros(out.shape[0], dtype=torch.bool,
                                       device=out.device)
    for (r0, r1), _ in c["chosen"]:
        written[h + r0:h + r1] = True
    assert torch.equal(out[~written], c["out0"][~written])
    if c["burgers"]:
        assert float(mx) == c["mref"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K8_PARAMS))
def test_k8_lean_entry_matches_twin(gpu_2d_mesh, case):
    """The stepper's lean entry on the plans of a split stage and of a
    whole stage: 0 ulp from the twin, the maximum of a stage replaced by
    its first launch and folded by its second, one launch each counted;
    a buffer or operand the plan was not built for raises."""
    params = _k8_params(case)
    c = _k8b_call(params, "dy4-middle", 0, gpu_2d_mesh, 5)
    e = _k8b_call(params, "dy4-middle", 3, gpu_2d_mesh, 5)
    v, u, out = c["v"], c["u"], c["out0"].clone()
    pk = dict(params=params, a=0.75, b=0.25, padded=v.shape,
              offsets=c["offsets"], global_shape=c["kw"]["global_shape"],
              device=v.device,
              buffers=(v.data_ptr(), u.data_ptr(), out.data_ptr()))
    ly = v.shape[0] - 2 * c["h"]
    mid, bottom, top = fsh.split_bands(ly, c["h"])
    p_mid = fsh.StagePlan(fsh.fused2d_band_stage, bands=(mid,), **pk)
    p_edges = fsh.StagePlan(fsh.fused2d_band_stage, bands=(bottom, top),
                            **pk)
    p_all = fsh.StagePlan(fsh.fused2d_stage, bands=(((0, ly), None),), **pk)
    mx = (torch.full((1,), 7.0, device=gpu_2d_mesh) if c["burgers"]
          else None)
    before = fsh.fused2d_band_stage.launches
    fsh.launch(p_mid, v, u, out, c["dt"], mx=mx)
    fsh.launch(p_edges, v, u, out, c["dt"], mx=mx, mx_init=False,
               **e["ops"])
    torch.cuda.synchronize()
    assert fsh.fused2d_band_stage.launches == before + 2
    want = c["out0"].clone()
    m = 0.0
    for rows, op in fsh.split_bands(ly, c["h"]):
        res = fsh.stage_reference(v, u, want, c["dt"], c["offsets"],
                                  window=rows, emit=c["burgers"],
                                  **({op: e["ops"][op]} if op else {}),
                                  **c["kw"])
        if c["burgers"]:
            m = max(m, float(res[1]))
    assert torch.equal(out, want)
    if c["burgers"]:
        assert float(mx) == m
    out.copy_(c["out0"])
    ref = fsh.stage_reference(v, u, c["out0"].clone(), c["dt"],
                              c["offsets"], emit=c["burgers"], **c["kw"])
    fsh.launch(p_all, v, u, out, c["dt"], mx=mx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref[0] if c["burgers"] else ref)
    with pytest.raises(ValueError, match="not built for"):
        fsh.launch(p_all, v, u, out.clone(), c["dt"], mx=mx)
    with pytest.raises(ValueError, match="the plan reads"):
        fsh.launch(p_mid, v, u, out, c["dt"], mx=mx, **e["ops"])


@pytest.mark.cuda
def test_k8_prepare_raises_the_shared_memory_limit_only(monkeypatch,
                                                        gpu_2d_mesh):
    """Two TILED plans of one kernel instance over 48 KB of shared
    memory, the larger prepared first: both launch and match the twin
    (preparing the smaller leaves the kernel's limit where the larger
    set it)."""
    params = _k8_params("js-burgers-inviscid")
    h, (ly, lx) = fsh.halo_of(params), (64, 128)
    rng = np.random.default_rng(64)
    padded = (ly + 2 * h, lx + 2 * h)
    v, u = _rand(rng, padded, gpu_2d_mesh), _rand(rng, padded, gpu_2d_mesh)
    dt = torch.full((1,), 0.004, device=gpu_2d_mesh)
    kw = dict(params=params, a=0.75, b=0.25, global_shape=(2 * ly, lx))
    plan = fsh.plan_tiles
    plans = []
    for tile in ((32, 64), (32, 56)):
        monkeypatch.setattr(fsh, "plan_tiles", lambda *a, tile=tile, **k:
                            plan(*a, **{**k, "body": fsh.TILED,
                                        "tile": tile}))
        plans.append(fsh.StagePlan(fsh.fused2d_stage, a=0.75, b=0.25,
                                   padded=padded, offsets=(0, 0),
                                   bands=(((0, ly), None),),
                                   device=gpu_2d_mesh, **{
                                       k: kw[k] for k in ("params",
                                                          "global_shape")}))
    assert plans[0].tiles["smem"] > plans[1].tiles["smem"] > 48 * 1024
    ref = fsh.stage_reference(v, u, _rand(rng, padded, gpu_2d_mesh), dt,
                              (0, 0), **kw)
    for p in plans:
        out = torch.zeros_like(v)
        fsh.launch(p, v, u, out, dt)
        torch.cuda.synchronize()
        assert torch.equal(out[h:-h, h:-h], ref[h:-h, h:-h])


@pytest.mark.cuda
@pytest.mark.parametrize("zchunk", [None, 4, 5])
@pytest.mark.parametrize("nx", [37, 60])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k9_sharded_matches_twin(gpu_2d_mesh, kind, nx, zchunk):
    """K9's sharded instance: global walls from the offsets, the factors
    of K(x) at the shard's cells; 0 ulp from its twin in several z
    chunks, with 4-byte (nx 37) and 16-byte (nx 60) copies."""
    rng = np.random.default_rng(kind)
    shape, gshape, offs = (13, 21, nx), (39, 42, nx), (13, 21, 0)
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
    fa.fused_adr_stage(v, u_arg, out, 1e-3, zchunk=zchunk, **kw)
    torch.cuda.synchronize()
    assert fa.fused_adr_stage.launches == before + 1
    assert torch.equal(out, ref)


MESH_2D_RUNS = [  # (family, config, mesh sizes, decomposition, launches)
    ("diffusion", {}, {"dy": 2}, {0: "dy"}, {"K8": 6}),
    ("diffusion", {"overlap": "split"}, {"dy": 2}, {0: "dy"}, {"K8b": 12}),
    ("diffusion", {}, {"dy": 2, "dx": 2}, {0: "dy", 1: "dx"}, {"K8": 12}),
    ("burgers", {"adaptive_dt": False}, {"dy": 2}, {0: "dy"}, {"K8": 6}),
    ("burgers", {"overlap": "split"}, {"dy": 2}, {0: "dy"}, {"K8b": 12}),
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


# --------------------------------------------------------------------- #
# WENO7-JS on meshes and member axes: K3, K4, K2b, the sharded K5 and
# K8/K8b at order 7
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu7_mesh():
    if not torch.cuda.is_available():
        pytest.skip("the WENO7 instances of K3, K4 and K2b "
                    "(csrc/slab_run_burgers.cu), of the sharded K5 "
                    "(csrc/fused_burgers_stage.cu) and of K8/K8b "
                    "(csrc/fused2d_sharded.cu) need a CUDA device")
    return torch.device("cuda")


K3W7_WINDOWS = {  # (window, operands, depth) with G = 12
    "full": ((0, 36), "", 12), "interior": ((12, 24), "", 12),
    "bottom": ((0, 12), "lo", 12), "top": ((24, 36), "hi", 12),
    "deep0": ((-12, 48), "", 24), "deep-bottom": ((-12, 12), "lo", 24),
    "deep-top": ((24, 48), "hi", 24)}


@pytest.mark.cuda
@pytest.mark.parametrize("oz,gnz", [(0, 72), (36, 72), (36, 108)],
                         ids=["first", "last", "middle"])
@pytest.mark.parametrize("window", list(K3W7_WINDOWS))
@pytest.mark.parametrize("case", ["burgers-viscous", "buckley-inviscid"])
def test_k3_order7_matches_twin(gpu7_mesh, case, window, oz, gnz):
    """K3 at order 7 over per-step, split and deep windows of a shard,
    the box 12 planes a side, z clamped at the global edges, 24x24 tiles
    off the plane (29x37), z chunks of 7; 0 ulp from its twin."""
    rng = np.random.default_rng(oz + gnz)
    win, ops, depth = K3W7_WINDOWS[window]
    shape = (36 + 2 * depth, 29, 37)
    S = _rand(rng, shape, gpu7_mesh)
    lo = _rand(rng, (depth,) + shape[1:], gpu7_mesh) if "lo" in ops else None
    hi = _rand(rng, (depth,) + shape[1:], gpu7_mesh) if "hi" in ops else None
    kw = dict(params=_params7(case, (0.05, 0.07, 0.09)), global_nz=gnz,
              oz=oz, depth=depth, window=win, lo=lo, hi=hi)
    out0 = _rand(rng, shape, gpu7_mesh)
    want = fsr.slab_step_burgers_reference(S, out0.clone(), 0.015, **kw)
    before = fsr.slab_step_burgers.launches
    got = fsr.slab_step_burgers(S, out0.clone(), 0.015, zchunk=7, **kw)
    torch.cuda.synchronize()
    assert fsr.slab_step_burgers.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("oz,gnz", [(0, 48), (24, 48), (24, 72)],
                         ids=["first", "last", "middle"])
@pytest.mark.parametrize("role", list(K5_ROLES))
@pytest.mark.parametrize("case", list(W7_CASES))
def test_k5_sharded_order7_matches_twin(gpu7_mesh, case, role, oz, gnz):
    """K5 at order 7 on a z-slab shard: 4 ghost planes a side, z clamped
    at the global edges only, a window, the exchanged operands, the
    emitted maximum folded; 0 ulp from its twin."""
    rng = np.random.default_rng(oz + 1)
    r = 4
    shape = (24 + 2 * r, 29, 37)
    v, u = _rand(rng, shape, gpu7_mesh), _rand(rng, shape, gpu7_mesh)
    window, ops = K5_ROLES[role]
    lo = _rand(rng, (r,) + shape[1:], gpu7_mesh) if "lo" in ops else None
    hi = _rand(rng, (r,) + shape[1:], gpu7_mesh) if "hi" in ops else None
    dt = torch.full((1,), 0.01, device=gpu7_mesh)
    kw = dict(params=_params7(case, (0.05, 0.07, 0.09)), a=0.75, b=0.25,
              zpad=r, global_nz=gnz, oz=oz, window=window, lo=lo, hi=hi)
    out0 = _rand(rng, shape, gpu7_mesh)
    ref, mref = fb.stage_reference(v, u, out0.clone(), dt, emit=True, **kw)
    out, mx = out0.clone(), torch.full((1,), 7.0, device=gpu7_mesh)
    before = fb.fused_burgers_stage.launches
    fb.fused_burgers_stage(v, u, out, dt, mx, zchunk=5, mx_init=False, **kw)
    torch.cuda.synchronize()
    assert fb.fused_burgers_stage.launches == before + 1
    assert torch.equal(out, ref)
    assert float(mx) == max(7.0, float(mref))


@pytest.mark.cuda
@pytest.mark.parametrize("case,shards,lz,k,steps,plane", [
    ("burgers-viscous", 2, 24, 1, 3, (29, 37)),
    ("burgers-viscous", 2, 24, 2, 5, (29, 37)),
    ("linear", 3, 26, 2, 5, (5, 70)),
    ("buckley-inviscid", 2, 48, 4, 5, (40, 3))])
def test_k4_order7_matches_twin(gpu7_mesh, case, shards, lz, k, steps,
                                plane):
    """K4 at order 7 (G = 12, depth 12k) on random shard buffers: every
    state and landing buffer 0 ulp from its twin's after a run with a
    partial block, one launch."""
    rng = np.random.default_rng(shards * 10 + k)
    G = 12
    depth = k * G
    shape = (lz + 2 * depth, *plane)
    bufs = [[_rand(rng, shape, gpu7_mesh) for _ in range(shards)]
            for _ in range(2)]
    bufs.append([_rand(rng, (2, 2, depth) + shape[1:], gpu7_mesh)
                 for _ in range(shards)])
    params = _params7(case, (0.05, 0.07, 0.09))
    got = [[t.clone() for t in ts] for ts in bufs]
    want = [[t.clone() for t in ts] for ts in bufs]
    before = fsr.slab_run_dma_burgers.launches
    fsr.slab_run_dma_burgers(*got, steps, 0.015, params=params, k=k,
                             zchunk=7)
    torch.cuda.synchronize()
    assert fsr.slab_run_dma_burgers.launches == before + 1
    fsr.slab_run_dma_reference(
        lambda S, out, window, oz: fsr.slab_step_burgers_reference(
            S, out, 0.015, params=params, global_nz=shards * lz, oz=oz,
            depth=depth, window=window), *want, steps, k=k, G=G)
    for a, b in zip(sum(got, []), sum(want, [])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("shape,zchunk", [((23, 29, 37), 7),
                                          ((13, 5, 70), 3),
                                          ((4, 49, 23), None)])
@pytest.mark.parametrize("case", list(W7_CASES))
def test_k2b_order7_matches_twin_and_k6(gpu7_mesh, case, shape, zchunk,
                                        steps):
    """K2b at order 7, B = 3: every member 0 ulp from the batched twin
    and from its single K6 run, one launch for the batch."""
    B = 3
    rng = np.random.default_rng(steps)
    S0 = _rand(rng, (B, *shape), gpu7_mesh)
    params = _params7(case, (0.05, 0.07, 0.09))
    want = fsr.ping_pong_members(
        lambda s, d: fsr.burgers_step_reference(s, d, 0.015, params=params),
        S0.clone(), S0.clone(), steps)
    before = fsr.slab_run_burgers_batched.launches
    got = fsr.slab_run_burgers_batched(S0.clone(), torch.empty_like(S0),
                                       steps, 0.015, params=params,
                                       zchunk=zchunk)
    torch.cuda.synchronize()
    assert fsr.slab_run_burgers_batched.launches == before + 1
    assert torch.equal(got, want)
    for i in range(B):
        single = fsr.slab_run_burgers(S0[i].clone(), torch.empty_like(S0[i]),
                                      steps, 0.015, params=params,
                                      zchunk=zchunk)
        assert torch.equal(got[i], single), f"member {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("shard", list(K8_SHARDS))
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
@pytest.mark.parametrize("case", list(W7_CASES))
def test_k8_order7_matches_twin(gpu7_mesh, case, kind, shard):
    """K8 at order 7, the shard padded by 4: 0 ulp from its twin; the
    emitted maximum exactly."""
    params = _params7(case, (0.05, 0.07))
    h = fsh.halo_of(params)
    assert h == 4
    offsets, (ly, lx), gshape = K8_SHARDS[shard]
    rng = np.random.default_rng(kind)
    padded = (ly + 2 * h, lx + 2 * h)
    v, u = _rand(rng, padded, gpu7_mesh), _rand(rng, padded, gpu7_mesh)
    u_arg = None if kind == 0 else u
    a, b = fd.STAGES[kind]
    dt = torch.full((1,), 0.004, device=gpu7_mesh)
    kw = dict(params=params, a=a, b=b, global_shape=gshape)
    out0 = _rand(rng, padded, gpu7_mesh)
    ref, mref = fsh.stage_reference(v, u_arg, out0.clone(), dt, offsets,
                                    emit=True, **kw)
    out = out0.clone()
    mx = torch.full((1,), 7.0, device=gpu7_mesh)
    before = fsh.fused2d_stage.launches
    fsh.fused2d_stage(v, u_arg, out, dt, offsets, mx=mx, **kw)
    torch.cuda.synchronize()
    assert fsh.fused2d_stage.launches == before + 1
    assert torch.equal(out, ref)
    assert float(mx) == float(mref)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", ["dy4-first", "dy4-middle", "dy4-last"])
@pytest.mark.parametrize("band", [0, 1, 2, 3], ids=["interior", "bottom",
                                                    "top", "edges"])
@pytest.mark.parametrize("case", list(W7_CASES))
def test_k8b_order7_matches_twin(gpu7_mesh, case, band, shard):
    """K8b at order 7 over each band of the split schedule (3h = 12
    rows at least) and over both edge bands in one launch, the edge bands
    reading the exchanged rows: 0 ulp from its twin; the rows outside the
    bands untouched."""
    c = _k8b_call(_params7(case, (0.05, 0.07)), shard, band, gpu7_mesh,
                  band)
    assert c["h"] == 4
    out = c["out0"].clone()
    mx = torch.full((1,), 7.0, device=gpu7_mesh)
    before = fsh.fused2d_band_stage.launches
    fsh.fused2d_band_stage(c["v"], c["u"], out, c["dt"], c["offsets"],
                           rows=c["rows"], mx=mx, mx_init=False,
                           **c["ops"], **c["kw"])
    torch.cuda.synchronize()
    assert fsh.fused2d_band_stage.launches == before + 1
    assert torch.equal(out, c["ref"])
    h, written = c["h"], torch.zeros(out.shape[0], dtype=torch.bool,
                                       device=out.device)
    for (r0, r1), _ in c["chosen"]:
        written[h + r0:h + r1] = True
    assert torch.equal(out[~written], c["out0"][~written])
    assert float(mx) == c["mref"]


MESH_W7_RUNS = [  # (grid (nx, ny, nz), mesh, config, launches a run summed)
    ((37, 29, 96), {"dz": 2}, {"impl": "pallas"}, {"K5": 30}),
    ((37, 29, 96), {"dz": 2}, {"impl": "pallas", "overlap": "split"},
     {"K5": 90}),
    ((37, 29, 96), {"dz": 2}, {"impl": "pallas", "adaptive_dt": False},
     {"K5": 30}),
    ((37, 29, 96), {"dz": 2}, {"impl": "pallas_slab", "adaptive_dt": False},
     {"K3": 10}),
    ((37, 29, 96), {"dz": 2}, {"impl": "pallas_slab", "adaptive_dt": False,
                               "overlap": "split"}, {"K3": 30}),
    ((37, 29, 96), {"dz": 2}, {"impl": "pallas_slab", "adaptive_dt": False,
                               "steps_per_exchange": 4}, {"K3": 10}),
    ((37, 29, 96), {"dz": 2}, {"impl": "pallas_slab", "adaptive_dt": False,
                               "exchange": "dma", "steps_per_exchange": 4},
     {"K4": 1, "K3": 0}),
    ((60, 48), {"dy": 2}, {"impl": "pallas", "adaptive_dt": False},
     {"K8": 30}),
    ((60, 48), {"dy": 4}, {"impl": "pallas", "overlap": "split"},
     {"K8b": 120, "K8": 0}),
    ((60, 48), {"dy": 2, "dx": 2}, {"impl": "pallas"}, {"K8": 60}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,sizes,extra,launches", MESH_W7_RUNS)
def test_weno7_mesh_run_on_one_card_matches_unsharded(gpu7_mesh, n, sizes,
                                                      extra, launches):
    """Every order-7 mesh rung, shards on one card, 5 steps: the
    unsharded run of its rung (K5, K6 or K7/K7a) to the bit, ``t``
    equal, the launches summed over the shards."""
    from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
        Decomposition,
        make_mesh,
    )

    counters = {"K5": fb.fused_burgers_stage, "K3": fsr.slab_step_burgers,
                "K4": fsr.slab_run_dma_burgers, "K8": fsh.fused2d_stage,
                "K8b": fsh.fused2d_band_stage}
    cfg = BurgersConfig(grid=Grid.make(*n, lengths=2.0), weno_order=7,
                        nu=1e-5, **extra)
    plain = dataclasses.replace(cfg, steps_per_exchange=1, overlap="padded",
                                exchange="collective")
    shards = int(np.prod(list(sizes.values())))
    mapping = {0: "dz"} if "dz" in sizes else {
        i: a for i, a in enumerate(("dy", "dx")) if a in sizes}
    mesh = make_mesh(sizes, devices=[gpu7_mesh] * shards, timeout=60)
    one = BurgersSolver(plain)
    sharded = BurgersSolver(cfg, mesh=mesh,
                            decomp=Decomposition.of(mapping))
    want = one.run(one.initial_state(), 5)
    for c in counters.values():
        c.launches = 0
    got = sharded.run(sharded.initial_state(), 5)
    torch.cuda.synchronize()
    assert {k: counters[k].launches for k in launches} == launches
    assert got.t == want.t
    assert torch.equal(got.u.assemble(), want.u)


# --------------------------------------------------------------------- #
# The bf16 instances of K1, K2, K6 (R = 3, 4) and K9, and float64
# storage on K1/K2: each kernel against its twin (the float32 twin on the
# upcast buffers, rounded to bf16 where the kernel rounds) to the bit
# --------------------------------------------------------------------- #
BF16 = torch.bfloat16


def _bf16_padded(shape, bc, seed):
    S = torch.full(tuple(n + 2 * fd.R for n in shape), fd.bf16_value(bc),
                   dtype=BF16)
    S[2:-2, 2:-2, 2:-2] = torch.from_numpy(np.random.default_rng(
        seed).random(shape, dtype=np.float32)).to(BF16)
    return S.cuda()


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bc", [((23, 29, 37), 0.1), ((8, 10, 12), 0.0)])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k1_bf16_matches_twin(gpu, kind, shape, bc):
    a, b = fd.STAGES[kind]
    taps = fd.stage_taps((0.1, 0.12, 0.09), (1.0,) * 3)
    v, u = _bf16_padded(shape, bc, kind), _bf16_padded(shape, bc, 9 + kind)
    kw = dict(taps=taps, a=a, b=b, band=2, bc_value=bc)
    got = (u if kind == 2 else v).clone()
    want = got.clone()
    uu = (None, u, None)[kind]
    fd.upcast_twin(fd.stage_reference, v, want if kind == 2 else uu, want,
                   1e-3, **kw)
    fd.fused_stage_bf16(v, got if kind == 2 else uu, got, 1e-3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("shape,bc", [((23, 29, 37), 0.1), ((40, 70, 90), 0.0)])
def test_k2_bf16_matches_twin(gpu, shape, bc, steps):
    kw = dict(taps=fd.stage_taps((0.1, 0.12, 0.09), (1.0,) * 3), band=2,
              bc_value=bc)
    S = _bf16_padded(shape, bc, steps)
    want = fsr.ping_pong(lambda s, d: fsr.rounded_step(
        lambda x, y: fds.step_reference(x, y, 2e-4, **kw), s, d),
        S.clone(), S.clone(), steps)
    got = fsr.slab_run_diffusion_bf16(S.clone(), S.clone(), steps, 2e-4,
                                      **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("order,nu", [(5, 0.0), (5, 1e-3), (7, 0.0),
                                      (7, 1e-3)])
def test_k6_bf16_matches_twin(gpu, order, nu, steps):
    params = fb.stage_params(pflux.burgers(), "js", (0.05, 0.06, 0.07), nu,
                             order)
    S = torch.from_numpy(np.random.default_rng(order).random(
        (20, 40, 50), dtype=np.float32)).to(BF16).cuda()
    want = fsr.ping_pong(lambda s, d: fsr.rounded_step(
        lambda x, y: fsr.burgers_step_reference(x, y, 5e-3, params=params),
        s, d), S.clone(), S.clone(), steps)
    got = fsr.slab_run_burgers_bf16(S.clone(), S.clone(), steps, 5e-3,
                                    params=params)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [60, 64, 62, 61])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k9_bf16_matches_twin(gpu, kind, nx):
    """Every copy width: 16-, 8- and 4-byte and single-value copies."""
    shape = (13, 19, nx)
    st = fa.FusedADRStepper(shape, (0.1, 0.08, 0.12), 1.0, (0.5, -0.3, 0.2),
                            0.25, 2e-4, 2, 0.1, "cuda", kappa_variation=0.2,
                            dtype=BF16, storage_dtype=torch.float32)
    a, b = fd.STAGES[kind]
    v, u = _bf16_padded(shape, 0.1, kind), _bf16_padded(shape, 0.1, 7 + kind)
    got = (u if kind == 2 else v).clone()
    want = got.clone()
    uu = (None, u, None)[kind]
    launch = {}
    fd.upcast_twin(fa.adr_stage_reference, v, want if kind == 2 else uu,
                   want, 2e-4, a=a, b=b, **st.stage_kwargs())
    fa.fused_adr_stage_bf16(v, got if kind == 2 else uu, got, 2e-4, a=a, b=b,
                            launch=launch, **st.stage_kwargs())
    torch.cuda.synchronize()
    assert launch["copy_width"] == fa.copy_width(nx, 2)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_stage", "pallas_slab"])
def test_f64_storage_is_the_f32_kernel_run(gpu, impl):
    grid = Grid.make(24, 16, 16, lengths=(10.0, 5.0, 5.15))
    s64 = DiffusionSolver(DiffusionConfig(grid=grid, dtype="float64",
                                          impl=impl))
    s32 = DiffusionSolver(DiffusionConfig(grid=grid, impl=impl))
    s0 = s64.initial_state()
    got = s64.run(s0, 4)
    want = s32.run(s0._replace(u=s0.u.float(), t=np.float32(s0.t)), 4)
    assert got.u.dtype == torch.float64
    assert torch.equal(got.u, want.u.double())


# --------------------------------------------------------------------- #
# The storage rungs on a z-slab mesh: the sharded bf16 instances of K1
# and K9, K3 and K4 on bf16 buffers (operands and landing buffers bf16),
# each against its twin to the bit, and the bf16 mesh runs against the
# unsharded bf16 runs
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("role", ["shard", "lo", "hi"])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k1_bf16_sharded_matches_twin(gpu_mesh, kind, role):
    a, b = fd.STAGES[kind]
    shape = (23, 29, 37)
    taps = fd.stage_taps((0.1, 0.12, 0.09), (1.0,) * 3)
    v, u = _bf16_padded(shape, 0.1, kind), _bf16_padded(shape, 0.1, 5 + kind)
    kw = dict(taps=taps, a=a, b=b, band=2, bc_value=0.1,
              global_shape=(46,) + shape[1:], offsets=(23, 0, 0))
    if role != "shard":
        kw["window"] = (0, 8) if role == "lo" else (15, 23)
        kw[role] = v[:fd.R].flip(1).contiguous()
    got = torch.full_like(v, fd.bf16_value(0.1))
    want = got.clone()
    uu = None if kind == 0 else u
    twin = {k: (x.float() if k in ("lo", "hi") else x) for k, x in kw.items()}
    fd.upcast_twin(fd.stage_reference, v, uu, want, 1e-3, **twin)
    fd.fused_stage_bf16(v, uu, got, 1e-3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["diffusion", "burgers5", "burgers7"])
@pytest.mark.parametrize("window,op", [((0, 24), None), ((-12, 36), None),
                                       ((0, 12), "lo"), ((12, 24), "hi")])
def test_k3_bf16_matches_twin(gpu_mesh, family, window, op):
    rng = np.random.default_rng(len(family))
    depth, lz, gnz, oz = 24, 24, 48, 24
    if family == "diffusion":
        ring, G = fd.R, 3 * fd.R
        kw = dict(taps=fd.stage_taps((0.1, 0.12, 0.09), (1.0,) * 3), band=2,
                  bc_value=0.1)
        step, ref = fsr.slab_step_diffusion_bf16, (
            fsr.slab_step_diffusion_reference)
        twin_kw = dict(kw, pad_value=fd.bf16_value(0.1))
    else:
        order = int(family[-1])
        ring = 0
        kw = dict(params=fb.stage_params(pflux.burgers(), "js",
                                         (0.05, 0.06, 0.07), 1e-3, order))
        G = 3 * kw["params"].r
        step, ref, twin_kw = (fsr.slab_step_burgers_bf16,
                              fsr.slab_step_burgers_reference, kw)
    S = _rand(rng, (lz + 2 * depth, 20 + 2 * ring, 30 + 2 * ring),
              gpu_mesh).to(BF16)
    opnd = S[:depth].flip(1).contiguous() if op else None
    win = dict(global_nz=gnz, oz=oz, depth=depth, window=window,
               lo=opnd if op == "lo" else None,
               hi=opnd if op == "hi" else None)
    want = fsr.rounded_window(ref, S, torch.zeros_like(S), dt=2e-4,
                              **twin_kw, **win)
    got = step(S, torch.zeros_like(S), 2e-4, **kw, **win)
    torch.cuda.synchronize()
    assert G <= depth and torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("family,k", [("diffusion", 1), ("diffusion", 2),
                                      ("burgers5", 1), ("burgers7", 1)])
def test_k4_bf16_matches_twin(gpu_mesh, family, k):
    rng = np.random.default_rng(k)
    if family == "diffusion":
        ring, G = fd.R, 3 * fd.R
        kw = dict(taps=fd.stage_taps((0.1, 0.12, 0.09), (1.0,) * 3), band=2,
                  bc_value=0.0)
        run, ref = fsr.slab_run_dma_diffusion_bf16, (
            fsr.slab_step_diffusion_reference)
    else:
        ring = 0
        kw = dict(params=fb.stage_params(pflux.burgers(), "js",
                                         (0.05, 0.06, 0.07), 0.0,
                                         int(family[-1])))
        G = 3 * kw["params"].r
        run, ref = fsr.slab_run_dma_burgers_bf16, (
            fsr.slab_step_burgers_reference)
    lz, depth = 26, k * G
    shape = (lz + 2 * depth, 20 + 2 * ring, 30 + 2 * ring)

    def bufs():
        r = np.random.default_rng(3)
        return [[_rand(r, s, gpu_mesh).to(BF16) for _ in range(2)]
                for s in (shape, shape, (2, 2, depth) + shape[1:])]

    got, want = bufs(), bufs()
    run(*got, 3, 2e-4, k=k, **kw)
    fsr.slab_run_dma_reference(
        lambda S, out, window, oz: fsr.rounded_window(
            ref, S, out, dt=2e-4, global_nz=2 * lz, oz=oz, depth=depth,
            window=window, **kw), *want, 3, k=k, G=G)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(torch.stack(g)), _bits(torch.stack(w)))
    del rng


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k9_bf16_sharded_matches_twin(gpu_mesh, kind):
    st = fa.FusedADRStepper((13, 19, 61), (0.1, 0.08, 0.12), 1.0,
                            (0.5, -0.3, 0.2), 0.25, 2e-4, 2, 0.1, "cuda",
                            kappa_variation=0.2, global_shape=(26, 19, 61),
                            dtype=BF16, storage_dtype=torch.float32)
    a, b = fd.STAGES[kind]
    shape = (13, 19, 61)
    v, u = _bf16_padded(shape, 0.1, kind), _bf16_padded(shape, 0.1, 3 + kind)
    skw = st.stage_kwargs(offsets=(13, 0, 0))
    uu = None if kind == 0 else u
    got = torch.full_like(v, fd.bf16_value(0.1))
    want = got.clone()
    fd.upcast_twin(fa.adr_stage_reference, v, uu, want, 2e-4, a=a, b=b,
                   **skw)
    fa.fused_adr_stage_bf16(v, uu, got, 2e-4, a=a, b=b, **skw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("family,extra,plain,counter,launches", [
    ("diffusion", dict(impl="pallas"), "pallas_stage", "K1", 6),
    ("diffusion", dict(impl="pallas_stage", overlap="split"),
     "pallas_stage", "K1", 18),
    ("diffusion", dict(impl="pallas_slab"), "pallas_slab", "K3d", 2),
    ("diffusion", dict(impl="pallas_slab", exchange="dma"), "pallas_slab",
     "K4d", 0),
    ("burgers", dict(impl="pallas", adaptive_dt=False), "pallas", "K3b", 2),
    ("burgers", dict(impl="pallas", adaptive_dt=False, weno_order=7,
                     exchange="dma"), "pallas", "K4b", 0),
    ("adr", dict(impl="pallas"), "pallas", "K9", 6),
])
def test_bf16_mesh_run_matches_unsharded(gpu_mesh, family, extra, plain,
                                         counter, launches):
    """``precision="bf16"`` on a two-shard z mesh of one card equals the
    unsharded bf16 run to the bit, ``t`` equal; the launches summed over
    the shards (K4: one a run)."""
    from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import make_mesh

    counters = {"K1": fd.fused_stage_bf16, "K9": fa.fused_adr_stage_bf16,
                "K3d": fsr.slab_step_diffusion_bf16,
                "K3b": fsr.slab_step_burgers_bf16,
                "K4d": fsr.slab_run_dma_diffusion_bf16,
                "K4b": fsr.slab_run_dma_burgers_bf16}
    cls, cfg_cls = {"diffusion": (DiffusionSolver, DiffusionConfig),
                    "burgers": (BurgersSolver, BurgersConfig),
                    "adr": (ADRSolver, ADRConfig)}[family]
    grid = Grid.make(37, 29, 48 if family != "burgers" else 96,
                     lengths=2.0)
    cfg = cfg_cls(grid=grid, precision="bf16", **extra)
    mesh = make_mesh({"dz": 2}, devices=[gpu_mesh] * 2, timeout=60)
    one = cls(dataclasses.replace(cfg, impl=plain, overlap="padded",
                                  exchange="collective"))
    sharded = cls(cfg, mesh=mesh)
    assert sharded.engaged_path()["storage_dtype"] == "bfloat16"
    s0 = one.initial_state()
    want = one.run(s0, 4)
    counters[counter].launches = 0
    got = sharded.run(sharded.initial_state(), 4)
    torch.cuda.synchronize()
    assert torch.equal(got.u.assemble(), want.u)
    assert (got.t, got.it) == (want.t, want.it)
    assert counters[counter].launches == (launches * 4 if launches else 1)


# --------------------------------------------------------------------- #
# K5's YX instance: shards of y-, x-, y-x-, z-y- and z-y-x-cut meshes
# --------------------------------------------------------------------- #
@pytest.fixture
def gpu_yx():
    if not torch.cuda.is_available():
        pytest.skip("K5's y/x-sharded (YX) instance "
                    "(csrc/fused_burgers_stage.cu) needs a CUDA device")
    return torch.device("cuda")


# shards a side of (z, y, x) on each cut
K5_YX_CUTS = {"dy2": (1, 2, 1), "dx2": (1, 1, 2), "dydx": (1, 2, 2),
              "dzdy": (2, 2, 1), "block": (2, 2, 2)}
# a shard's core: one off the tile in y, over a tile in x, z chunks of 3
K5_YX_CORE = (18, fb.TILE[0] + 1, fb.TILE[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [5, 7])
@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("cut", list(K5_YX_CUTS))
def test_k5_yx_matches_twin(gpu_yx, cut, case, order):
    """K5's YX instance on the first and the last shard of a cut, every
    stage kind (and on a cut z the split schedule's interior, bottom and
    top windows with the exchanged operands), z chunks of 3, random
    ghosts: 0 ulp from its twin, the emitted maximum exactly (folded into
    a prior value); every launch counted by ``fb.yx_instance``."""
    name, fkw, variant, nu = K5_CASES[case]
    params = fb.stage_params(pflux.get(name, **fkw),
                             variant if order == 5 else "js",
                             (0.05, 0.07, 0.09), nu, order=order)
    r = params.r
    cuts = K5_YX_CUTS[cut]
    pads = tuple(r if c > 1 else 0 for c in cuts)
    stored = tuple(n + 2 * p for n, p in zip(K5_YX_CORE, pads))
    lz = K5_YX_CORE[0]
    roles = [(None, None)]
    if cuts[0] > 1:
        roles += [((6, lz - 6), None), ((0, 6), "lo"), ((lz - 6, lz), "hi")]
    rng = np.random.default_rng(order)
    dt = torch.full((), 2e-3, device=gpu_yx)
    for last, kind, (window, op) in itertools.product((False, True),
                                                      range(3), roles):
        offs = tuple((c - 1) * n if last else 0
                     for n, c in zip(K5_YX_CORE, cuts))
        a, b = fb.STAGES[kind]
        v, u = _rand(rng, stored, gpu_yx), _rand(rng, stored, gpu_yx)
        opnd = _rand(rng, (pads[0],) + stored[1:], gpu_yx) if op else None
        kw = dict(params=params, a=a, b=b, window=window,
                  lo=opnd if op == "lo" else None,
                  hi=opnd if op == "hi" else None,
                  zpad=pads[0], global_nz=cuts[0] * lz, oz=offs[0],
                  ypad=pads[1], global_ny=cuts[1] * K5_YX_CORE[1],
                  oy=offs[1], xpad=pads[2],
                  global_nx=cuts[2] * K5_YX_CORE[2], ox=offs[2])
        u_arg = None if kind == 0 else u
        out0 = _rand(rng, stored, gpu_yx)
        ref, mref = fb.stage_reference(v, u_arg, out0.clone(), dt, emit=True,
                                       **kw)
        out, mx = out0.clone(), torch.full((1,), 0.5, device=gpu_yx)
        before = fb.yx_instance.launches
        fb.fused_burgers_stage(v, u_arg, out, dt, mx, zchunk=3,
                               mx_init=False, **kw)
        torch.cuda.synchronize()
        where = (cut, last, kind, window)
        assert torch.equal(out, ref), where
        assert float(mx[0]) == max(0.5, float(mref)), where
        assert fb.yx_instance.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cut,extra,launches", [
    ("dy2", {}, 6), ("dx2", {"weno_order": 7, "adaptive_dt": False}, 6),
    ("dzdy", {"overlap": "split", "nu": 1e-5}, 36),
    ("block", {"weno_variant": "z"}, 24)])
def test_k5_yx_run_matches_unsharded(gpu_yx, cut, extra, launches):
    """Burgers on a y/x-cut mesh of one card equals the unsharded K5 run
    to the bit, ``t`` equal; K5's YX instance launched 3 times a step a
    shard (9 under the split schedule)."""
    from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
        Decomposition,
        make_mesh,
    )

    cuts = K5_YX_CUTS[cut]
    names = ("dz", "dy", "dx")
    sizes = {names[ax]: c for ax, c in enumerate(cuts) if c > 1}
    mapping = {ax: names[ax] for ax, c in enumerate(cuts) if c > 1}
    mesh = make_mesh(sizes, devices=[gpu_yx] * int(np.prod(cuts)),
                     timeout=60)
    cfg = BurgersConfig(grid=Grid.make(38, 30, 56, lengths=2.0),
                        impl="pallas", **extra)
    one = BurgersSolver(dataclasses.replace(cfg, overlap="padded"))
    sharded = BurgersSolver(cfg, mesh=mesh,
                            decomp=Decomposition.of(mapping))
    assert sharded.engaged_path()["stepper"] == "fused-stage"
    want = one.run(one.initial_state(), 4)
    fb.yx_instance.launches = 0
    got = sharded.run(sharded.initial_state(), 4)
    torch.cuda.synchronize()
    assert torch.equal(got.u.assemble(), want.u)
    assert (got.t, got.it) == (want.t, want.it)
    assert fb.yx_instance.launches == launches * 4
