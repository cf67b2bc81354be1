"""The port's whole-run slab rung on the CPU against the JAX package: the
plain twins of K2 (diffusion) and K6 (Burgers/WENO5, fixed dt) against
the JAX ``SlabRunDiffusionStepper``/``SlabRunBurgersStepper``
(``fused_slab_run._whole_run_kernel``, run in Pallas interpret mode),
the twins' identities with the per-stage twins, the solvers' runs, and
the dispatch: the JAX suite's ladder cases (``tests/test_slab_run.py:
95-136``) plus ``pallas_step``, the ``t_end`` and adaptive declines, and
the shapes on which the port's gates (measured on the H100) and the JAX
package's TPU VMEM gates agree and disagree.

Tolerances: states within ``32 eps_f32 * max|u|`` of the JAX kernels,
the JAX suite's fused bound (``tests/test_pallas.py``), as the K1/K5
twins are held: both sides evaluate the same terms in the same order,
and XLA's compilation of the interpret-mode kernels may contract
multiply-adds the twins round separately. ``t`` and ``it`` equal. Inside
the port, K2's twin equals K10's and K6's equals three K5-twin stages,
to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.burgers import (
    BurgersConfig as JBConfig,
    BurgersSolver as JBSolver,
)
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JDConfig,
    DiffusionSolver as JDSolver,
)
from multigpu_advectiondiffusion_tpu.ops import flux as jflux
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_slab_run as jsr
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersSolver as PBSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PDConfig,
    DiffusionSolver as PDSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as pfb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as pfd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion_step as pfds,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS


def _assert_fused_close(got, want):
    """Within 32 eps of max|want|; prints the gap in eps (``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    assert gap <= TOL


def _port_state(s0):
    return convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                    int(s0.it), device="cpu")


# --------------------------------------------------------------------- #
# The steppers: the twins against the JAX slab kernels
# --------------------------------------------------------------------- #
def test_k2_twin_matches_jax_slab():
    """The JAX suite's multi-slab case (``tests/test_slab_run.py:47-58``):
    24x28x36, ``block_z=4`` (9 slabs), 9 steps."""
    grid = JGrid.make(24, 28, 36, lengths=10.0)
    js = JDSolver(JDConfig(grid=grid, dtype="float32", impl="xla"))
    s0 = js.initial_state()
    st = jsr.SlabRunDiffusionStepper(grid.shape, jnp.float32, grid.spacing,
                                     [1.0] * 3, js.dt, 2, 0.0, block_z=4)
    assert st.n_slabs == 9
    want_u, want_t = jax.jit(lambda u, t: st.run(u, t, 9))(s0.u, s0.t)
    p0 = _port_state(s0)
    pst = psr.SlabRunDiffusionStepper(grid.shape, grid.spacing, [1.0] * 3,
                                      js.dt, 2, 0.0, "cpu")
    psr.slab_run_diffusion.launches = 0
    got_u, got_t = pst.run(p0.u, p0.t, 9)
    assert psr.slab_run_diffusion.launches == 0  # the CPU launches none
    assert isinstance(got_t, np.float32) and got_t == np.float32(want_t)
    _assert_fused_close(got_u.numpy(), want_u)


# (flux, flux kwargs, variant, steps): the JAX suite's multi-slab case
# (``tests/test_slab_run.py:61-91``: 24x16x16, block_z=4, nu=1e-3, 5
# steps) for both variants, and one step of each other flux
K6_CASES = {
    "burgers-js-5": ("burgers", {}, "js", 5),
    "burgers-z-5": ("burgers", {}, "z", 5),
    "linear-js-1": ("linear", {"c": -0.7}, "js", 1),
    "buckley-z-1": ("buckley", {}, "z", 1),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_twin_matches_jax_slab(case):
    name, kw, variant, steps = K6_CASES[case]
    grid = JGrid.make(24, 16, 16, lengths=[4.0, 4.0, 6.0])
    js = JBSolver(JBConfig(grid=grid, cfl=0.3, nu=1e-3, adaptive_dt=False,
                           dtype="float32", impl="xla"))
    s0 = js.initial_state()
    st = jsr.SlabRunBurgersStepper(grid.shape, jnp.float32, grid.spacing,
                                   jflux.get(name, **kw), variant, 1e-3,
                                   dt=js.dt, order=5, block_z=4)
    assert st.n_slabs == 4
    want_u, want_t = jax.jit(lambda u, t: st.run(u, t, steps))(s0.u, s0.t)
    p0 = _port_state(s0)
    pst = psr.SlabRunBurgersStepper(grid.shape, grid.spacing,
                                    pflux.get(name, **kw), variant, 1e-3,
                                    js.dt, "cpu")
    psr.slab_run_burgers.launches = 0
    got_u, got_t = pst.run(p0.u, p0.t, steps)
    assert psr.slab_run_burgers.launches == 0
    assert isinstance(got_t, np.float32) and got_t == np.float32(want_t)
    _assert_fused_close(got_u.numpy(), want_u)


def test_k2_twin_equals_k10_twin():
    """K2's twin is K10's step looped on two buffers, to the bit, and
    hands back the buffer of the right parity."""
    shape = (7, 9, 11)
    kw = dict(taps=pfd.stage_taps((0.3, 0.25, 0.2), (1.0, 0.5, 2.0)),
              band=2, bc_value=0.25)
    rng = np.random.default_rng(2)
    S0 = torch.full(tuple(n + 4 for n in shape), 0.25)
    S0[2:-2, 2:-2, 2:-2] = torch.from_numpy(
        rng.random(shape, dtype=np.float32))
    for steps in (0, 1, 4, 5):
        A, B = S0.clone(), S0.clone()
        got = psr.slab_run_diffusion(A, B, steps, 2e-3, **kw)
        assert got is (B if steps % 2 else A)
        want, other = S0.clone(), S0.clone()
        for _ in range(steps):
            pfds.fused_step(want, other, 2e-3, **kw)
            want, other = other, want
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant,nu", [("js", 1e-3), ("z", 0.0)])
def test_k6_twin_equals_three_k5_stages(variant, nu):
    """K6's twin is three K5-twin stages a step, the per-stage path's own
    arithmetic (the bound is 0 ulp); its steps looped on two buffers
    equal the K5 stepper's fixed-dt run."""
    shape, spacing, dt = (6, 9, 11), (0.1, 0.09, 0.08), 0.02
    u0 = torch.from_numpy(np.random.default_rng(6).uniform(
        -0.1, 1.0, shape).astype(np.float32))
    params = pfb.stage_params(pflux.burgers(), variant, spacing, nu)
    got = psr.slab_run_burgers(u0.clone(), torch.empty_like(u0), 3, dt,
                               params=params)
    k5 = pfb.FusedBurgersStepper(spacing, pflux.burgers(), variant, nu, 0.4,
                                 "cpu", dt=dt)
    want, t = k5.run(u0, np.float32(0.0), 3)
    assert torch.equal(got, want)
    st = psr.SlabRunBurgersStepper(shape, spacing, pflux.burgers(), variant,
                                   nu, dt, "cpu")
    got_u, got_t = st.run(u0, np.float32(0.0), 3)
    assert torch.equal(got_u, want) and got_t == t


def test_slab_wrappers_reject_bad_operands():
    S = torch.zeros((9, 8, 7))
    kw = dict(taps=(0.0,) * 15, band=2, bc_value=0.0)
    with pytest.raises(ValueError, match="different buffers"):
        psr.slab_run_diffusion(S, S, 1, 1e-3, **kw)
    with pytest.raises(TypeError, match="float32"):
        psr.slab_run_diffusion(S.double(), S.double().clone(), 1, 1e-3, **kw)
    params = pfb.stage_params(pflux.burgers(), "js", (0.1,) * 3, 0.0)
    with pytest.raises(ValueError, match="different buffers"):
        psr.slab_run_burgers(S, S, 1, 1e-3, params=params)
    with pytest.raises(ValueError, match="expected"):
        psr.slab_run_burgers(S, torch.zeros((9, 8, 6)), 1, 1e-3,
                             params=params)
    with pytest.raises(ValueError, match="3-D"):
        psr.slab_run_burgers(S[0], S[1].clone(), 1, 1e-3, params=params)
    with pytest.raises(NotImplementedError, match="WENO7"):
        psr.SlabRunBurgersStepper((4, 4, 4), (0.1,) * 3, pflux.burgers(),
                                  "js", 0.0, 0.01, "cpu", order=7)


def test_slab_run_of_zero_steps_returns_its_input():
    u = torch.rand(5, 6, 7)
    st = psr.SlabRunBurgersStepper(u.shape, (0.1,) * 3, pflux.burgers(),
                                   "js", 0.0, 0.01, "cpu")
    assert st.run(u, np.float32(0.5), 0) == (u, np.float32(0.5))


# --------------------------------------------------------------------- #
# Solver runs: impl="pallas_slab" in both packages
# --------------------------------------------------------------------- #
def _jax_and_port(family, n, lengths, **kw):
    jcfg_cls, jsol, psol, port_cfg = {
        "diffusion": (JDConfig, JDSolver, PDSolver,
                      convert.config_from_fields),
        "burgers": (JBConfig, JBSolver, PBSolver,
                    convert.burgers_config_from_fields),
    }[family]
    jcfg = jcfg_cls(grid=JGrid.make(*n, lengths=lengths), dtype="float32",
                    **kw)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return jsol(jcfg), psol(port_cfg(fields), device="cpu")


@pytest.mark.parametrize("family,kw", [
    ("diffusion", {}),
    ("burgers", {"nu": 1e-5, "adaptive_dt": False, "weno_variant": "z"}),
], ids=["diffusion", "burgers"])
def test_pallas_slab_run_matches_jax(family, kw):
    js, ps = _jax_and_port(family, (24, 16, 16), 2.0, impl="pallas_slab",
                           **kw)
    assert js.engaged_path()["stepper"] == "fused-whole-run-slab"
    assert ps.engaged_path()["stepper"] == "fused-whole-run-slab"
    assert ps.engaged_path()["fallback"] is None
    s0 = js.initial_state()
    want = js.run(s0, 5)
    got = ps.run(_port_state(s0), 5)
    assert got.it == int(want.it) == 5
    assert got.t == np.float32(want.t)
    _assert_fused_close(got.u.numpy(), want.u)


@pytest.mark.parametrize("family,kw,rtol,atol", [
    ("diffusion", {}, 1e-5, 1e-6),
    ("burgers", {"nu": 1e-5, "adaptive_dt": False}, 2e-5, 2e-6),
], ids=["diffusion", "burgers"])
def test_pallas_slab_matches_port_generic(family, kw, rtol, atol):
    """The JAX suite's fused-vs-generic bounds."""
    _, ps = _jax_and_port(family, (19, 13, 11), 2.0, impl="pallas_slab",
                          **kw)
    generic = type(ps)(dataclasses.replace(ps.cfg, impl="xla"), device="cpu")
    p0 = ps.initial_state()
    got, want = ps.run(p0, 6), generic.run(p0, 6)
    assert got.t == want.t and got.it == want.it == 6
    scale = float(want.u.abs().max())
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=rtol,
                               atol=atol * scale)


# --------------------------------------------------------------------- #
# Dispatch parity with the JAX package
# --------------------------------------------------------------------- #
G3 = ((24, 16, 16), 2.0)
# name: (family, config, mode) -- tests/test_slab_run.py:95-136, and
# impl="pallas_step"
LADDER = {
    "diffusion-pallas": ("diffusion", {"impl": "pallas"}, "iters"),
    "diffusion-pallas-t_end": ("diffusion", {"impl": "pallas"}, "t_end"),
    "diffusion-pallas_stage": ("diffusion", {"impl": "pallas_stage"},
                               "iters"),
    "diffusion-pallas_slab": ("diffusion", {"impl": "pallas_slab"}, "iters"),
    "diffusion-pallas_slab-t_end": ("diffusion", {"impl": "pallas_slab"},
                                    "t_end"),
    "diffusion-pallas_step": ("diffusion", {"impl": "pallas_step"}, "iters"),
    "diffusion-pallas_step-t_end": ("diffusion", {"impl": "pallas_step"},
                                    "t_end"),
    "burgers-fixed-pallas": ("burgers", {"impl": "pallas", "nu": 1e-5,
                                         "adaptive_dt": False}, "iters"),
    "burgers-fixed-pallas-t_end": ("burgers", {"impl": "pallas", "nu": 1e-5,
                                               "adaptive_dt": False},
                                   "t_end"),
    "burgers-adaptive-pallas": ("burgers", {"impl": "pallas", "nu": 1e-5},
                                "iters"),
    "burgers-fixed-pallas_slab": ("burgers", {"impl": "pallas_slab",
                                              "nu": 1e-5,
                                              "adaptive_dt": False},
                                  "iters"),
    "burgers-adaptive-pallas_slab": ("burgers", {"impl": "pallas_slab",
                                                 "nu": 1e-5}, "iters"),
    "burgers-fixed-pallas_slab-t_end": ("burgers", {"impl": "pallas_slab",
                                                    "nu": 1e-5,
                                                    "adaptive_dt": False},
                                        "t_end"),
}
# the JAX package's reasons for a pinned slab rung that declines; it runs
# the per-stage stepper then, and so does the port, saying why
DECLINES = {
    "diffusion-pallas_slab-t_end": "the slab stepper has no run_to "
                                   "(use --iters)",
    "burgers-adaptive-pallas_slab": "adaptive dt rides the per-stage "
                                    "stepper",
    "burgers-fixed-pallas_slab-t_end": "the slab stepper has no run_to "
                                       "(use --iters)",
}


def _port_slab_gate(family, shape) -> bool:
    cls = (psr.SlabRunDiffusionStepper if family == "diffusion"
           else psr.SlabRunBurgersStepper)
    return (cls.supported(shape, torch.float32)
            and cls.profitable(shape, torch.float32))


@pytest.mark.parametrize("name", list(LADDER))
def test_slab_engagement_matches_jax(name):
    family, kw, mode = LADDER[name]
    js, ps = _jax_and_port(family, *G3, **kw)
    want, got = js.engaged_path(mode), ps.engaged_path(mode)
    stepper = want["stepper"]
    gated = kw["impl"] == "pallas" and mode == "iters" and (
        stepper == "fused-whole-run-slab")
    if gated and not _port_slab_gate(family, ps.grid.shape):
        # the grid on which the port's measured gate prefers the
        # per-stage kernel (GATE_SHAPES)
        stepper = "fused-stage"
    assert got["stepper"] == stepper
    assert got["fallback"] == (DECLINES.get(name) or want["fallback"])


def test_bf16_storage_raises_where_jax_declines_to_the_per_stage_rung():
    """JAX's ladder case for bf16 storage (``fused-stage``): the port
    has no bf16 storage yet and says so at construction."""
    grid = PGrid.make(*G3[0], lengths=G3[1])
    with pytest.raises(NotImplementedError, match="bfloat16"):
        PDSolver(PDConfig(grid=grid, dtype="bfloat16", impl="pallas"),
                 device="cpu")


# interior (nz, ny, nx): (JAX diffusion, port diffusion, JAX Burgers,
# port Burgers) -- each package's slab gate, supported and profitable,
# float32 on one device. The port's gates are the H100's (PERF.md); the
# JAX package's its TPU VMEM model.
GATE_SHAPES = {
    (16, 16, 24): (True, True, True, False),
    (11, 13, 19): (True, True, True, False),
    (64, 64, 64): (False, True, True, False),
    (40, 128, 128): (True, False, False, False),
    (128, 128, 128): (False, False, False, False),
    (162, 160, 160): (False, False, False, False),
    (206, 200, 400): (False, False, False, False),
    (160, 204, 508): (False, False, False, False),
    (406, 400, 400): (False, False, False, False),
    (512, 512, 512): (False, False, False, False),
}


@pytest.mark.parametrize("shape", list(GATE_SHAPES))
def test_gate_lists_against_jax(shape):
    """Where the two packages' slab gates agree and where they differ."""
    jd, pd, jb, pb = GATE_SHAPES[shape]
    assert (jsr.SlabRunDiffusionStepper.supported(shape, jnp.float32)
            and jsr.SlabRunDiffusionStepper.profitable(
                shape, jnp.float32)) is jd
    assert (jsr.SlabRunBurgersStepper.supported(shape, jnp.float32)
            and jsr.SlabRunBurgersStepper.profitable(
                shape, jnp.float32)) is jb
    assert _port_slab_gate("diffusion", shape) is pd
    assert _port_slab_gate("burgers", shape) is pb


@pytest.mark.parametrize("shape", [(406, 400, 400), (512, 512, 512)])
def test_port_supports_what_jax_rejects(shape):
    """Tiling y and x removes the JAX package's row-size limit: K6 takes
    400x400x406 and 512^3, where JAX's pinned ``pallas_slab`` declines to
    K5."""
    assert not jsr.SlabRunBurgersStepper.supported(shape, jnp.float32)
    assert psr.SlabRunBurgersStepper.supported(shape, torch.float32)
    assert psr.SlabRunDiffusionStepper.supported(shape, torch.float32)
    for cls in (psr.SlabRunBurgersStepper, psr.SlabRunDiffusionStepper):
        assert not cls.supported(shape, torch.float64)
        assert not cls.supported((1300, 1300, 1300), torch.float32)


@pytest.mark.parametrize("args,want", [
    # K6 at 400x400x406 on an H100's 132 SMs, one block an SM: 13 x 13
    # tiles of 32 (the last 16 wide), 406 planes in 3 chunks of 136
    # (136 + 136 + 134): 507 jobs, 3.84 a block; the next splits cost
    # 3 waves x (203 + 10), 6 x (102 + 10), 8 x (68 + 10) planes against
    # 4 x (136 + 10)
    ((406, 400, 400, 132), dict(tiles=169, chunk_planes=136, chunks=3,
                                jobs=507, waves=507 / 132)),
    # K4 on {"dz": 2}: two shards of 203 planes, 3 chunks of 68 each
    # (68 + 68 + 67), 2 x 169 x 3 = 1014 jobs, 7.68 a block: 8 waves x
    # (68 + 10) against 3 x (203 + 10) for one chunk a shard
    ((203, 400, 400, 132, 2), dict(tiles=169, chunk_planes=68, chunks=3,
                                   jobs=1014, waves=1014 / 132)),
    # an explicit 64: six chunks of 64 and a remnant of 22 planes,
    # 169 x 7 = 1183 jobs, 8.96 a block
    ((406, 400, 400, 132, 1, 64), dict(tiles=169, chunk_planes=64,
                                       chunks=7, jobs=1183,
                                       waves=1183 / 132)),
    # below one tile: with blocks to spare, 3 jobs of one plane each
    # (one wave of 1 + 10 planes against 3 + 10 for one job)
    ((3, 5, 7, 132), dict(tiles=1, chunk_planes=1, chunks=3, jobs=3,
                          waves=3 / 132)),
], ids=["k6-400x400x406", "k4-dz2", "k6-zchunk64", "tiny"])
def test_burgers_schedule_hand_counted(args, want):
    """The slab Burgers kernels' job plan (``burgers_schedule``), counted
    by hand: the z chunks the planner picks and the jobs and waves."""
    assert psr.burgers_schedule(*args) == pytest.approx(want)


@pytest.mark.parametrize("args,kw,want", [
    # K10 at 400x200x206 on an H100's 132 SMs, two blocks an SM: 13 x 7
    # tiles of 32, 206 planes in 7 chunks of 30 (6 x 30 + 26): 637 jobs,
    # two rounds of 264 and 109 jobs alone on their SMs, (2 + 0.6) x (30
    # + 5) = 91; 52-plane chunks (364 jobs) cost (1 + 0.6) x 57 = 91.2,
    # 26 (728 jobs, 200 left over: two on some SMs) 3 x 31 = 93
    ((206, 200, 400, 264), {}, dict(tiles=91, chunk_planes=30, chunks=7,
                                    jobs=637, waves=637 / 264)),
    # K2 there: a chunk end costs 6 planes, so 52 planes: (1 + 0.6) x 58
    # = 92.8 against (2 + 0.6) x 36 = 93.6 for 30
    ((206, 200, 400, 264), {"cooperative": True},
     dict(tiles=91, chunk_planes=52, chunks=4, jobs=364, waves=364 / 264)),
    # K2b, 64 members of 256x128x64: 8 x 4 tiles, one chunk of 64 planes
    # a job, 2048 jobs: 7 rounds and 200 left, 8 x 70 = 560 against 16 x
    # 38 = 608 for two chunks (4096 jobs: 15 rounds and 136 left)
    ((64, 128, 256, 264, 64), {"cooperative": True},
     dict(tiles=32, chunk_planes=64, chunks=1, jobs=2048,
          waves=2048 / 264)),
    # K4 on {"dz": 2}: two shards of 103 planes, 2 chunks of 52 each (52
    # + 51), 2 x 91 x 2 = 364 jobs: (1 + 0.6) x 58 = 92.8 against 3 x 32
    # = 96 for 4 chunks a shard
    ((103, 200, 400, 264, 2), {"cooperative": True},
     dict(tiles=91, chunk_planes=52, chunks=2, jobs=364, waves=364 / 264)),
    # K3, one shard's 103-plane window: 4 chunks of 26 (3 x 26 + 25), 364
    # jobs, (1 + 0.6) x 31 = 49.6 against 2 x 26 = 52 for 5 chunks of 21
    ((103, 200, 400, 264), {}, dict(tiles=91, chunk_planes=26, chunks=4,
                                    jobs=364, waves=364 / 264)),
    # 128^3: 4 x 4 tiles, 8 chunks of 16, 128 jobs, one an SM: 0.6 x 21
    # = 12.6 against 1 x 13 for 16 chunks of 8 (256 jobs)
    ((128, 128, 128, 264), {}, dict(tiles=16, chunk_planes=16, chunks=8,
                                    jobs=128, waves=128 / 264)),
    # an explicit 64: three chunks of 64 and a remnant of 14
    ((206, 200, 400, 264, 1, 64), {}, dict(tiles=91, chunk_planes=64,
                                           chunks=4, jobs=364,
                                           waves=364 / 264)),
    # a grid thinner than one tile, below 2G = 12 planes: with blocks to
    # spare, one plane a job
    ((5, 3, 7, 264), {}, dict(tiles=1, chunk_planes=1, chunks=5, jobs=5,
                              waves=5 / 264)),
], ids=["k10-400x200x206", "k2-400x200x206", "k2b-b64", "k4-dz2",
        "k3-dz2", "k10-128cubed", "k2-zchunk64", "thin"])
def test_diffusion_schedule_hand_counted(args, kw, want):
    """The diffusion body's job plan (``diffusion_schedule``), counted by
    hand: the z chunks the planner picks and the jobs and waves."""
    assert pfds.diffusion_schedule(*args, **kw) == pytest.approx(want)


@pytest.mark.parametrize("window,zchunk,chunks", [
    (406, 64, 7), (13, 3, 5), (23, 7, 4), (1, 7, 1), (9, 64, 1)])
def test_explicit_zchunk_is_the_planes_a_job(window, zchunk, chunks):
    """An explicit z chunk is the planes a job marches, the last chunk
    the rest: 13 planes at 3 leave a last chunk of one plane."""
    plan = psr.burgers_schedule(window, 40, 70, 132, zchunk=zchunk)
    assert (plan["chunk_planes"], plan["chunks"]) == (zchunk, chunks)
    assert plan["jobs"] == 6 * chunks
