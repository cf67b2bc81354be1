"""The port's fused Burgers rung (K5's plain twin on the CPU) against the
JAX K5 kernel (``fused_burgers._stage_kernel``, run in Pallas interpret
mode), and against the port's own generic path.

The JAX side pins ``impl="pallas_stage"``: at these small grids its
fixed-dt ``impl="pallas"`` engages the slab rung (K6) instead.

Tolerances: one stage and 5-step runs within ``32 eps_f32 * max|u|``,
the JAX suite's fused bound (``tests/test_pallas.py:512-518``) — both
evaluate K5's e-form in the same order; XLA's compilation of the
interpret-mode kernel may contract multiply-adds the twin rounds
separately. The fused rung against the generic path: the JAX suite's
fused-vs-generic bound ``rtol=2e-5, atol=2e-6 max|u|``
(``tests/test_pallas.py:500-502``); the two combine the RK stages in
different forms.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.burgers import (
    BurgersConfig as JConfig,
    BurgersSolver as JSolver,
)
from multigpu_advectiondiffusion_tpu.ops import flux as jflux
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_burgers as jfb
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PConfig,
    BurgersSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as pfb,
)
from multigpu_advectiondiffusion_tpu_torch.timestepping import cfl as pcfl

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS


def _assert_fused_close(got, want):
    """Within 32 eps of max|want|; prints the gap in eps (``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    assert gap <= TOL


def _spacing(shape):
    return tuple(2.0 / (n - 1) for n in shape)


# --------------------------------------------------------------------- #
# One stage: the twin against the JAX kernel on the same input
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(24, 16, 16), (24, 19, 16)],
                         ids=["24x16x16", "24x19x16"])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_stage_twin_matches_jax_k5(kind, shape):
    """WENO5-JS, Burgers flux, nu = 1e-5; ny = 19 is not a multiple of
    the TPU's 8-row tile. The final stage also emits max|f'(u_next)|."""
    spacing, nu, dt = _spacing(shape), 1e-5, 2e-3
    a, b = pfb.STAGES[kind]
    rng = np.random.default_rng(kind)
    v = rng.uniform(-0.1, 1.0, shape).astype(np.float32)
    u = rng.uniform(-0.1, 1.0, shape).astype(np.float32)

    # the port: unpadded, written in place for stage 3
    out = torch.from_numpy(u.copy() if kind == 2 else np.zeros_like(v))
    mx = torch.zeros(1) if kind == 2 else None
    got = pfb.fused_burgers_stage(
        torch.from_numpy(v), None if kind == 0 else out if kind == 2
        else torch.from_numpy(u), out, dt, mx,
        params=pfb.stage_params(pflux.burgers(), "js", spacing, nu),
        a=a, b=b)
    assert got is out

    # JAX K5 on its padded layout, built as FusedBurgersStepper builds it
    st = jfb.FusedBurgersStepper(shape, jnp.float32, spacing, jflux.burgers(),
                                 "js", nu, dt=dt)
    src = ("none", "operand", "target")[kind]
    stage = jfb._make_stage(
        st.padded_shape, shape, jnp.float32, bz=st.block[0], by=st.block[1],
        inv_dx=[1.0 / h for h in spacing],
        nu_scales=[nu / (12.0 * h * h) for h in spacing],
        flux=jflux.burgers(), variant="js", a=a, b=b, u_source=src,
        emit_max=kind == 2)
    dt_arr = jnp.asarray([dt], jnp.float32)
    V, U = st.embed(jnp.asarray(v)), st.embed(jnp.asarray(u))
    if src == "none":
        want = stage(dt_arr, V, V)
    elif src == "operand":
        want = stage(dt_arr, V, U, V)
    else:
        want, jmx = stage(dt_arr, V, U)
    want = np.asarray(st.extract(want))
    _assert_fused_close(out.numpy(), want)
    if kind == 2:
        # the emitted maximum is max|out| of each side's own output
        assert float(mx[0]) == float(out.abs().max())
        assert abs(float(mx[0]) - float(jmx[0])) <= TOL * float(jmx[0])


# --------------------------------------------------------------------- #
# Whole runs: port impl="pallas" (twin) against JAX "pallas_stage" (K5)
# --------------------------------------------------------------------- #
def _pair(impl="pallas", n=(16, 16, 24), **kw):
    jcfg = JConfig(grid=JGrid.make(*n, lengths=2.0), dtype="float32",
                   impl="pallas_stage", **kw)
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["impl"] = impl
    ps = PSolver(convert.burgers_config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


RUNS = {
    "adaptive-js-viscous": {"nu": 1e-5},
    "fixed-z": {"weno_variant": "z", "adaptive_dt": False},
    "adaptive-buckley": {"flux": "buckley"},
}


@pytest.mark.parametrize("name", list(RUNS))
def test_fused_run_matches_jax_k5(name):
    js, ps, s0, p0 = _pair(**RUNS[name])
    assert js.engaged_path()["stepper"] == "fused-stage"
    assert ps.engaged_path()["stepper"] == "fused-stage"
    pfb.fused_burgers_stage.launches = 0
    want = js.run(s0, 5)
    got = ps.run(p0, 5)
    assert pfb.fused_burgers_stage.launches == 0  # the CPU runs the twin
    assert got.it == int(want.it) == 5
    assert isinstance(got.t, np.float32)
    assert abs(float(got.t) - float(want.t)) <= 1e-6 * float(want.t)
    _assert_fused_close(got.u.numpy(), want.u)


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
def test_fused_advance_to_matches_jax_k5(adaptive):
    """t_end 4.5 fixed steps on: 5 steps (the first dt differs by
    1/max|u0| when adaptive), the last trimmed through the device dt,
    landing on the JAX time."""
    js, ps, s0, p0 = _pair(nu=1e-5, adaptive_dt=adaptive)
    t_end = 4.5 * 0.4 * min(js.grid.spacing)
    want = js.advance_to(s0, t_end)
    got = ps.advance_to(p0, t_end)
    assert ps.engaged_path("t_end")["stepper"] == "fused-stage"
    assert got.it == int(want.it) == 5
    assert abs(float(got.t) - t_end) <= 1e-6 * t_end
    assert abs(float(got.t) - float(want.t)) <= 1e-6 * t_end
    _assert_fused_close(got.u.numpy(), want.u)


# --------------------------------------------------------------------- #
# Inside the port: fused (twin) against generic
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    {"nu": 1e-5},
    {"weno_variant": "z", "adaptive_dt": False},
    {"flux": "linear", "flux_params": (("c", -0.8),)},
    {"flux": "buckley", "nu": 1e-5},
], ids=["js-viscous", "z-fixed", "linear-inviscid", "buckley-viscous"])
def test_fused_run_matches_port_generic(kw):
    grid = PGrid.make(13, 11, 17, lengths=2.0)
    fused = PSolver(PConfig(grid=grid, impl="pallas", **kw), device="cpu")
    generic = PSolver(PConfig(grid=grid, impl="xla", **kw), device="cpu")
    s0 = fused.initial_state()
    got, want = fused.run(s0, 5), generic.run(s0, 5)
    assert abs(float(got.t) - float(want.t)) <= 1e-5 * float(want.t)
    scale = float(want.u.abs().max())
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=2e-5,
                               atol=2e-6 * scale)


# --------------------------------------------------------------------- #
# The emitted wave speed and the device scalars
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [("burgers", {}), ("linear", {"c": 0.6}),
                                     ("buckley", {})])
def test_emitted_max_is_max_wave_speed_of_the_output(name, kw):
    shape = (7, 9, 11)
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.uniform(-0.5, 1.0, shape).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-0.5, 1.0, shape).astype(np.float32))
    flux = pflux.get(name, **kw)
    params = pfb.stage_params(flux, "z", _spacing(shape), 0.0)
    a, b = pfb.STAGES[2]
    mx = torch.full((1,), -1.0)
    out = pfb.fused_burgers_stage(v, u, u, 1e-3, mx, params=params, a=a, b=b)
    assert float(mx[0]) == float(flux.df(out).abs().max())


def test_nan_cell_poisons_the_emitted_max_and_dt():
    shape = (6, 7, 8)
    v = torch.full(shape, 0.5)
    v[3, 2, 5] = float("nan")
    u = torch.full(shape, 0.5)
    params = pfb.stage_params(pflux.burgers(), "js", _spacing(shape), 1e-5)
    mx = torch.zeros(1)
    a, b = pfb.STAGES[2]
    pfb.fused_burgers_stage(v, u, u, 1e-3, mx, params=params, a=a, b=b)
    assert bool(torch.isnan(mx[0]))
    assert bool(torch.isnan(pcfl.dt_from_wave_speed(mx[0], (0.1,), 0.4)))


def test_run_reads_the_device_time_once(monkeypatch):
    """``run`` keeps m, dt and t on the device and reads t back once;
    ``run_to`` reads t once a step for its loop test."""
    s = PSolver(PConfig(grid=PGrid.make(10, 9, 8), impl="pallas", nu=1e-5),
                device="cpu")
    s0 = s.initial_state()
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: reads.append(1) or item(self))
    out = s.run(s0, 4)
    assert len(reads) == 1 and out.it == 4
    reads.clear()
    adv = s.advance_to(s0, float(out.t))
    assert len(reads) == adv.it


def test_fused_stage_on_cpu_runs_the_twin_and_counts_nothing():
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.random((9, 8, 7), dtype=np.float32))
    u = torch.from_numpy(rng.random((9, 8, 7), dtype=np.float32))
    params = pfb.stage_params(pflux.burgers(), "js", (0.1, 0.2, 0.3), 1e-5)
    kw = dict(params=params, a=0.75, b=0.25)
    before = pfb.fused_burgers_stage.launches
    out = pfb.fused_burgers_stage(v, u, torch.zeros_like(v), 1e-3, **kw)
    ref = pfb.stage_reference(v, u, torch.zeros_like(v), 1e-3, **kw)
    assert pfb.fused_burgers_stage.launches == before
    assert torch.equal(out, ref)


def test_fused_stage_rejects_bad_operands():
    v = torch.zeros((9, 8, 7))
    kw = dict(params=pfb.stage_params(pflux.burgers(), "js", (0.1,) * 3, 0.0),
              a=0.0, b=1.0)
    with pytest.raises(TypeError, match="float32"):
        pfb.fused_burgers_stage(v.double(), None, v.double().clone(), 1e-3,
                                **kw)
    with pytest.raises(ValueError, match="different buffers"):
        pfb.fused_burgers_stage(v, None, v, 1e-3, **kw)
    with pytest.raises(ValueError, match="expected"):
        pfb.fused_burgers_stage(v, None, torch.zeros((9, 8, 6)), 1e-3, **kw)
    with pytest.raises(ValueError, match="variant"):
        pfb.stage_params(pflux.burgers(), "w", (0.1,) * 3, 0.0)


# --------------------------------------------------------------------- #
# K5's tiling, operation count and z chunks (host helpers), by hand
# --------------------------------------------------------------------- #
def test_tile_geometry_matches_hand_count():
    """14 x 32 tile: 448 threads; a plane with its 3-cell halo 20 x 38 =
    760 cells, 312 of them halo; 14 rows of 11 x runs and 32 columns of
    5 y runs; shared memory 4 (6 * 760 + 14 * 33 + 15 * 32 + 14) bytes."""
    assert pfb.TILE == (14, 32)
    assert pfb.tile_geometry() == {
        "threads": 448, "plane": 760, "halo": 312, "runs": 314,
        "smem_bytes": 22064}


def test_issued_operations_match_hand_count():
    """One plane of one block, stage 1, inviscid, WENO5-JS: each of 448
    threads splits 8 values (6 each) and computes 2 z faces (119) and one
    cell (12); the block splits 312 halo cells and computes 314 runs of
    three faces (305). Then a 40 x 15 x 33 grid, stage 2, viscous,
    WENO5-Z, z chunks of 32 and 8 on 2 x 2 tiles."""
    one = 448 * (8 * 6 + 2 * 119 + 12) + 312 * 6 + 314 * 305
    assert one == 231_146
    assert pfb.ops_issued((1, 14, 32), 32, has_u=False, viscous=False,
                          variant="js") == one
    cell = 6 + 3 + 30 + 5
    run = 312 * 6 + 314 * 335
    chunk32 = 448 * (39 * 6 + 33 * 129 + 32 * cell) + 32 * run
    chunk8 = 448 * (15 * 6 + 9 * 129 + 8 * cell) + 8 * run
    assert 4 * (chunk32 + chunk8) == 30_573_504
    assert pfb.ops_issued((40, 15, 33), 32, has_u=True, viscous=True,
                          variant="z") == 30_573_504


def test_stage_zchunk_matches_hand_count():
    """132 SMs want 8 x 132 = 1,056 blocks. 512^3 has 37 x 16 = 592 tiles,
    so 2 chunks of 256 planes, capped at Z_CHUNK = 64; 64^3 has 5 x 2 =
    10, so 106 chunks, at least MIN_ZCHUNK = 4 planes each; 160 x 160 x
    162 has 12 x 5 = 60, so 18 chunks of 9 planes."""
    assert (pfb.Z_CHUNK, pfb.MIN_ZCHUNK, pfb.BLOCKS_PER_SM) == (64, 4, 8)
    assert pfb.stage_zchunk(512, 512, 512, 132) == 64
    assert pfb.stage_zchunk(64, 64, 64, 132) == 4
    assert pfb.stage_zchunk(162, 160, 160, 132) == 9
