"""The port's 2-D diffusion slice on the CPU against the JAX package: the
whole-run stepper (K7's plain twin) against the JAX K7
(``whole_run._kernel`` with ``fused_diffusion2d._stage``, run in Pallas
interpret mode), the solver's runs and dispatch, the generic path in
float64 and the ``diffusion2d`` CLI verb.

Tolerances: the fused runs within ``32 eps_f32 * max|u|``, the JAX
suite's fused bound (``tests/test_pallas.py``): both evaluate the same
taps in the same order, and XLA's compilation of the interpret-mode
kernel may contract multiply-adds that the twin rounds separately. The
float64 generic path within ``1e-12`` relative, as the 3-D tests hold
it. Pointwise pieces (grid, IC, exact solution) within ``1e-14``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JConfig,
    DiffusionSolver as JSolver,
)
from multigpu_advectiondiffusion_tpu.ops.pallas import (
    fused_diffusion2d as jfd2,
)
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as cli
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PConfig,
    DiffusionSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion2d as pfd2,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as pwr
from multigpu_advectiondiffusion_tpu_torch.utils import io as pio

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS


def _assert_fused_close(got, want):
    """Within 32 eps of max|want|; prints the gap in eps (``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    assert gap <= TOL


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


# --------------------------------------------------------------------- #
# The stepper: the twin against the JAX K7 on the same input
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,bc_value,steps", [
    ((16, 32), 0.0, 1), ((16, 32), 0.0, 5), ((23, 29), 0.5, 5),
], ids=["32x16-1", "32x16-5", "23x29-5"])
def test_stepper_twin_matches_jax_k7(shape, bc_value, steps):
    spacing, diffusivity, dt, band = (0.3, 0.25), (1.0, 1.0), 5e-3, 2
    u = np.random.default_rng(steps).random(shape, dtype=np.float32)
    want_u, want_t = jfd2.FusedDiffusion2DStepper(
        shape, jnp.float32, spacing, diffusivity, dt, band, bc_value,
    ).run(jnp.asarray(u), jnp.float32(0.1), steps)
    st = pfd2.FusedDiffusion2DStepper(shape, spacing, diffusivity, dt, band,
                                      bc_value, "cpu")
    pwr.whole_run.launches = 0
    got_u, got_t = st.run(torch.from_numpy(u), np.float32(0.1), steps)
    assert pwr.whole_run.launches == 0  # the CPU runs the twin
    assert got_t == np.float32(want_t)
    _assert_fused_close(got_u.numpy(), want_u)


def test_stepper_zero_steps_and_layout():
    st = pfd2.FusedDiffusion2DStepper((5, 7), (0.1, 0.1), (1.0, 1.0), 1e-4,
                                      2, 0.25, "cpu")
    u = torch.rand(5, 7)
    same, t = st.run(u, np.float32(1.0), 0)
    assert same is u and t == np.float32(1.0)
    S = st.embed(u)
    assert S.shape == (9, 11) and float(S[0, 0]) == 0.25
    assert torch.equal(st.extract(S), u)
    assert st.stencil_spec()["kernel"] == "fused-whole-run"


def test_whole_run_rejects_bad_buffers():
    S = torch.zeros((9, 11))
    kw = dict(taps=(0.0,) * 10, band=2, bc_value=0.0)
    with pytest.raises(ValueError, match="different buffers"):
        pfd2.whole_run_diffusion2d(S, S, S.clone(), 1, 1e-3, **kw)
    with pytest.raises(TypeError, match="float32"):
        pfd2.whole_run_diffusion2d(S.double(), S.double().clone(),
                                   S.double().clone(), 1, 1e-3, **kw)
    with pytest.raises(ValueError, match="padded 2-D"):
        pfd2.whole_run_diffusion2d(S[None], S[None].clone(),
                                   S[None].clone(), 1, 1e-3, **kw)


# --------------------------------------------------------------------- #
# The solver: port against JAX, fused and generic
# --------------------------------------------------------------------- #
def _pair(n=(32, 24), lengths=10.0, dtype="float32", impl="pallas"):
    jcfg = JConfig(grid=JGrid.make(*n, lengths=lengths), dtype=dtype,
                   impl=impl)
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    ps = PSolver(convert.config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


def test_fused_run_matches_jax():
    js, ps, s0, p0 = _pair()
    assert js.engaged_path()["stepper"] == "fused-whole-run"
    assert ps.engaged_path()["stepper"] == "fused-whole-run"
    want = js.run(s0, 20)
    got = ps.run(p0, 20)
    assert got.it == int(want.it) == 20
    assert got.t == np.float32(want.t)
    _assert_fused_close(got.u.numpy(), want.u)


def test_generic_f64_matches_jax():
    """float64 declines the whole-run rung in both packages: the generic
    path runs, fixed steps and a trimmed ``advance_to`` alike."""
    js, ps, s0, p0 = _pair(n=(17, 13), dtype="float64")
    assert ps.engaged_path()["stepper"] == "generic-xla"
    want, got = js.run(s0, 4), ps.run(p0, 4)
    assert isinstance(got.t, np.float64) and got.t == np.float64(want.t)
    assert _rel(got.u.numpy(), want.u) <= 1e-12
    t_end = float(s0.t) + 2.5 * js.dt
    want, got = js.advance_to(s0, t_end), ps.advance_to(p0, t_end)
    assert got.it == int(want.it) == 3 and got.t == np.float64(want.t)
    assert _rel(got.u.numpy(), want.u) <= 1e-12
    assert _rel(ps.exact_solution(float(got.t)).numpy(),
                js.exact_solution(float(want.t))) <= 1e-14


def test_pointwise_pieces_match_jax_in_2d():
    """Grid coordinates, ``radius_sq``, the heat-kernel IC and the state
    hand-over on a 2-D grid with unequal extents."""
    jg = JGrid.make(9, 7, lengths=(2.0, 1.5))
    pg = PGrid.make(9, 7, lengths=(2.0, 1.5))
    assert pg.shape == jg.shape and pg.spacing == jg.spacing
    assert _rel(pg.radius_sq(torch.float64).numpy(),
                jg.radius_sq(jnp.float64)) <= 1e-14
    js, ps, s0, p0 = _pair(n=(9, 7), lengths=(2.0, 1.5), dtype="float64",
                           impl="xla")
    assert _rel(ps.initial_state().u.numpy(), s0.u) <= 1e-14
    assert p0.u.shape == (7, 9) and isinstance(p0.t, np.float64)
    u, t, it = convert.state_to_numpy(p0)
    np.testing.assert_array_equal(u, np.asarray(s0.u))


def test_fused_run_matches_port_generic():
    """Inside the port: the whole-run rung against the generic path, at
    the JAX suite's fused-vs-generic bound."""
    ps = PSolver(PConfig(grid=PGrid.make(23, 19, lengths=10.0),
                         impl="pallas"), device="cpu")
    generic = PSolver(dataclasses.replace(ps.cfg, impl="xla"), device="cpu")
    p0 = ps.initial_state()
    got, want = ps.run(p0, 12), generic.run(p0, 12)
    assert got.t == want.t
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want.u.abs().max()))


def test_advance_to_runs_the_generic_loop():
    """The whole-run stepper has no ``run_to``: ``advance_to`` takes the
    generic loop and says why, as the JAX package does; the loop runs
    the per-axis stencil kernel (K11b), whose twin computes the generic
    path's sums."""
    ps = PSolver(PConfig(grid=PGrid.make(20, 16, lengths=10.0),
                         impl="pallas"), device="cpu")
    generic = PSolver(dataclasses.replace(ps.cfg, impl="xla"), device="cpu")
    p0 = ps.initial_state()
    t_end = float(p0.t) + 3.5 * ps.dt
    pwr.whole_run.launches = 0
    got, want = ps.advance_to(p0, t_end), generic.advance_to(p0, t_end)
    assert got.it == want.it == 4 and got.t == want.t
    assert torch.equal(got.u, want.u)
    path = ps.engaged_path("t_end")
    assert path["stepper"] == "per-axis-pallas"
    assert path["fallback"] == ("fused-whole-run stepper has no run_to; "
                                "t_end mode runs the generic loop")


# --------------------------------------------------------------------- #
# Dispatch parity with the JAX package (tests/test_pallas.py:144-149)
# --------------------------------------------------------------------- #
PARITY = {
    "f32-pallas": ((32, 24), {"impl": "pallas"}),
    "pallas_stage": ((32, 24), {"impl": "pallas_stage"}),
    "pallas_step": ((32, 24), {"impl": "pallas_step"}),
    "pallas_slab": ((32, 24), {"impl": "pallas_slab"}),
    "f64": ((16, 12), {"impl": "pallas", "dtype": "float64"}),
    "order2": ((16, 12), {"impl": "pallas", "order": 2}),
    "edge-bc": ((16, 12), {"impl": "pallas", "bc": "edge"}),
    "reference-grid": ((1001, 1001), {"impl": "pallas"}),
    "8192sq": ((8192, 8192), {"impl": "pallas"}),
}


@pytest.mark.parametrize("mode", ["iters", "t_end"])
@pytest.mark.parametrize("name", list(PARITY))
def test_engaged_path_matches_jax(name, mode):
    n, kw = PARITY[name]
    kw = {"dtype": "float32", **kw}
    jcfg = JConfig(grid=JGrid.make(*n, lengths=10.0), **kw)
    pcfg = PConfig(grid=PGrid.make(*n, lengths=10.0), **kw)
    want = JSolver(jcfg).engaged_path(mode)
    got = PSolver(pcfg, device="cpu").engaged_path(mode)
    assert got["stepper"] == want["stepper"]
    assert got["storage_dtype"] == want["storage_dtype"]
    if want["fallback"] is None:
        assert got["fallback"] is None
    elif name == "8192sq":
        # each package's own memory gate (TPU VMEM, H100 L2) declines
        assert "exceeds the whole-run" in got["fallback"]
        assert "exceeds the whole-run" in want["fallback"]
    else:  # the same reason; each package may add what then runs
        assert (got["fallback"].split(";")[0]
                == want["fallback"].split(";")[0])


def test_l2_gate_against_jax_vmem_gate():
    """Where the port's L2 gate and the JAX VMEM gate agree and where
    they differ (PERF.md): square grids up to n = 1404 fit both, n in
    1405..1474 only the port's, n >= 1475 neither."""
    for n, port, jax_ in [(1001, True, True), (1404, True, True),
                          (1440, True, False), (1474, True, False),
                          (1475, False, False), (8192, False, False)]:
        assert pfd2.FusedDiffusion2DStepper.supported(
            (n, n), torch.float32) is port
        assert jfd2.FusedDiffusion2DStepper.supported(
            (n, n), jnp.float32) is jax_


def test_unported_rungs_raise_in_2d():
    grid = PGrid.make(16, 12)
    for kw, match in [({"impl": "auto"}, "tuner"),
                      ({"geometry": "axisymmetric"}, "axisymmetric")]:
        with pytest.raises(NotImplementedError, match=match):
            PSolver(PConfig(grid=grid, **kw), device="cpu")


def test_pallas_axis_runs_the_per_axis_kernel_in_2d():
    s = PSolver(PConfig(grid=PGrid.make(16, 12), impl="pallas_axis"),
                device="cpu")
    path = s.engaged_path()
    assert (path["stepper"], path["fallback"]) == ("per-axis-pallas", None)
    out = s.run(s.initial_state(), 2)
    assert out.it == 2 and bool(torch.isfinite(out.u).all())


# --------------------------------------------------------------------- #
# The diffusion2d CLI verb
# --------------------------------------------------------------------- #
def test_cli_diffusion2d_runs_and_saves(tmp_path, capsys):
    assert cli(["diffusion2d", "--n", "20", "16", "--lengths", "10", "10",
                "--iters", "3", "--impl", "pallas", "--device", "cpu",
                "--save", str(tmp_path), "--check-error"]) == 0
    out = capsys.readouterr().out
    assert "kernel path        : fused-whole-run (impl=pallas)" in out
    assert "kernel launches    : none" in out  # the CPU runs no kernel
    assert "error L1/L2/Linf" in out
    grid = PGrid.make(20, 16, lengths=10.0)
    s = PSolver(PConfig(grid=grid, impl="pallas"), device="cpu")
    s0 = s.initial_state()
    np.testing.assert_array_equal(
        pio.load_binary(str(tmp_path / "initial.bin"), grid.shape),
        s0.u.numpy())
    np.testing.assert_array_equal(
        pio.load_binary(str(tmp_path / "result.bin"), grid.shape),
        s.run(s0, 3).u.numpy())
