"""The port's 2-D Burgers slice on the CPU against the JAX package: the
whole-run stepper (the plain twin of K7 and K7a) against the JAX
``FusedBurgers2DStepper`` (``whole_run._kernel``/``_kernel_adaptive``
with ``fused_burgers2d._stage``, run in Pallas interpret mode), the
solver's runs and dispatch, and the ``burgers2d`` CLI verb.

Tolerances: states within ``32 eps_f32 * max|u|`` after 1 and after 5
steps, the JAX suite's fused bound (``tests/test_pallas.py:512-518``),
which the 3-D K5 tests hold for 5 steps too: both sides evaluate the
e-form WENO5 in the same order, and XLA's compilation of the
interpret-mode kernel may contract multiply-adds that the twin rounds
separately. Fixed dt: ``t`` and ``it`` equal. Adaptive dt: ``t`` within
``1e-6`` relative (dt follows max|u|, which may differ in its last bit).
The fused rung against the port's generic path: the JAX suite's
fused-vs-generic bound ``rtol=2e-5, atol=2e-6 max|u|``.
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
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_burgers2d as jfb2
from multigpu_advectiondiffusion_tpu.timestepping import cfl as jcfl
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as cli
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PConfig,
    BurgersSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers2d as pfb2,
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


# --------------------------------------------------------------------- #
# The stepper: the twin against the JAX whole-run stepper
# --------------------------------------------------------------------- #
# (flux, flux kwargs, variant, nu, adaptive, steps)
STEPPER_CASES = {
    "fixed-js-viscous-1": ("burgers", {}, "js", 1e-5, False, 1),
    "adaptive-js-viscous-1": ("burgers", {}, "js", 1e-5, True, 1),
    "adaptive-js-viscous-5": ("burgers", {}, "js", 1e-5, True, 5),
    "adaptive-z-linear-5": ("linear", {"c": -0.7}, "z", 0.0, True, 5),
    "fixed-z-buckley-5": ("buckley", {}, "z", 1e-5, False, 5),
}


@pytest.mark.parametrize("case", list(STEPPER_CASES))
def test_stepper_twin_matches_jax(case):
    name, kw, variant, nu, adaptive, steps = STEPPER_CASES[case]
    shape, spacing, cfl = (16, 20), (0.1, 0.08), 0.4
    u = np.random.default_rng(steps).uniform(-0.2, 1.0, shape).astype(
        np.float32)
    jf = jflux.get(name, **kw)
    mode = ({"dt_fn": lambda x: jcfl.advective_dt(x, jf.df, spacing, cfl)}
            if adaptive else {"dt": cfl * min(spacing)})
    want_u, want_t = jfb2.FusedBurgers2DStepper(
        shape, jnp.float32, spacing, jf, variant, nu, **mode,
    ).run(jnp.asarray(u), jnp.float32(0.25), steps)
    st = pfb2.FusedBurgers2DStepper(
        shape, spacing, pflux.get(name, **kw), variant, nu, "cpu",
        **({"cfl": cfl} if adaptive else {"dt": cfl * min(spacing)}))
    pwr.whole_run.launches = pwr.whole_run_adaptive.launches = 0
    got_u, got_t = st.run(torch.from_numpy(u), np.float32(0.25), steps)
    assert pwr.whole_run.launches == pwr.whole_run_adaptive.launches == 0
    assert isinstance(got_t, np.float32)
    if adaptive:
        assert abs(float(got_t) - float(want_t)) <= 1e-6 * float(want_t)
    else:
        assert got_t == np.float32(want_t)
    _assert_fused_close(got_u.numpy(), want_u)


def test_stepper_takes_exactly_one_dt_mode():
    args = ((8, 9), (0.1, 0.1), pflux.burgers(), "js", 0.0, "cpu")
    with pytest.raises(ValueError, match="exactly one"):
        pfb2.FusedBurgers2DStepper(*args)
    with pytest.raises(ValueError, match="exactly one"):
        pfb2.FusedBurgers2DStepper(*args, dt=0.01, cfl=0.4)
    st = pfb2.FusedBurgers2DStepper(*args, dt=0.01)
    u = torch.rand(8, 9)
    assert st.run(u, np.float32(0.0), 0) == (u, np.float32(0.0))
    assert st.stencil_spec()["ghost_depth"] == 3


def test_adaptive_nan_poisons_the_time():
    st = pfb2.FusedBurgers2DStepper((6, 7), (0.1, 0.1), pflux.burgers(),
                                    "js", 1e-5, "cpu", cfl=0.4)
    u = torch.full((6, 7), 0.5)
    u[2, 3] = float("nan")
    out, t = st.run(u, np.float32(0.0), 2)
    assert np.isnan(t) and bool(torch.isnan(out).all())


# --------------------------------------------------------------------- #
# The solver: port against JAX, and against the port's generic path
# --------------------------------------------------------------------- #
def _pair(impl="pallas", n=(32, 24), **kw):
    jcfg = JConfig(grid=JGrid.make(*n, lengths=2.0), dtype="float32",
                   impl=impl, **kw)
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    ps = PSolver(convert.burgers_config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


def test_fused_run_matches_jax():
    """The CUDA-parity configuration of ``multigpu_burgers2d.sh`` at a
    small size: WENO5-JS, inviscid, fixed dt."""
    js, ps, s0, p0 = _pair(adaptive_dt=False)
    assert js.engaged_path()["stepper"] == "fused-whole-run"
    assert ps.engaged_path()["stepper"] == "fused-whole-run"
    want, got = js.run(s0, 5), ps.run(p0, 5)
    assert got.it == int(want.it) == 5
    assert got.t == np.float32(want.t)
    _assert_fused_close(got.u.numpy(), want.u)


@pytest.mark.parametrize("kw", [
    {"nu": 1e-5},
    {"weno_variant": "z", "adaptive_dt": False},
    {"flux": "linear", "flux_params": (("c", -0.8),)},
    {"flux": "buckley", "nu": 1e-5},
], ids=["js-viscous", "z-fixed", "linear-inviscid", "buckley-viscous"])
def test_fused_run_matches_port_generic(kw):
    grid = PGrid.make(23, 19, lengths=2.0)
    fused = PSolver(PConfig(grid=grid, impl="pallas", **kw), device="cpu")
    generic = PSolver(PConfig(grid=grid, impl="xla", **kw), device="cpu")
    assert fused.engaged_path()["stepper"] == "fused-whole-run"
    s0 = fused.initial_state()
    got, want = fused.run(s0, 5), generic.run(s0, 5)
    assert abs(float(got.t) - float(want.t)) <= 1e-5 * float(want.t)
    scale = float(want.u.abs().max())
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=2e-5,
                               atol=2e-6 * scale)


def test_run_reads_the_device_time_once(monkeypatch):
    """Adaptive ``run`` reads the time advance back once; fixed dt never
    does."""
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: reads.append(1) or item(self))
    for adaptive, want in ((True, 1), (False, 0)):
        reads.clear()
        s = PSolver(PConfig(grid=PGrid.make(12, 10), impl="pallas",
                            adaptive_dt=adaptive), device="cpu")
        out = s.run(s.initial_state(), 3)
        assert len(reads) == want and out.it == 3


def test_advance_to_runs_the_generic_loop():
    """The whole-run stepper has no ``run_to``: ``advance_to`` takes the
    generic loop, on the per-axis kernels (K12b) as in the JAX package:
    equal to the bit to the ``pallas_axis`` rung's, and within the fused
    bound of the plain generic path (e-form against q-form WENO5)."""
    s = PSolver(PConfig(grid=PGrid.make(14, 12), impl="pallas"),
                device="cpu")
    per_axis = PSolver(PConfig(grid=PGrid.make(14, 12), impl="pallas_axis"),
                       device="cpu")
    generic = PSolver(PConfig(grid=PGrid.make(14, 12), impl="xla"),
                      device="cpu")
    s0 = s.initial_state()
    got, want = s.advance_to(s0, 0.1), generic.advance_to(s0, 0.1)
    assert got.it == want.it and got.t == want.t
    assert torch.equal(got.u, per_axis.advance_to(s0, 0.1).u)
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want.u.abs().max()))
    assert s.engaged_path("t_end")["stepper"] == "per-axis-pallas"
    assert s.engaged_path("t_end")["fallback"] == (
        "fused-whole-run stepper has no run_to; t_end mode runs the "
        "generic loop")


# --------------------------------------------------------------------- #
# Dispatch parity with the JAX package
# --------------------------------------------------------------------- #
PARITY = {
    "adaptive": ((32, 24), {"impl": "pallas"}),
    "fixed": ((32, 24), {"impl": "pallas", "adaptive_dt": False}),
    "pallas_stage": ((32, 24), {"impl": "pallas_stage"}),
    "pallas_step": ((32, 24), {"impl": "pallas_step"}),
    "pallas_slab": ((32, 24), {"impl": "pallas_slab", "adaptive_dt": False}),
    "f64": ((16, 12), {"impl": "pallas", "dtype": "float64"}),
    "dirichlet": ((16, 12), {"impl": "pallas", "bc": "dirichlet"}),
    "o2-viscous": ((16, 12), {"impl": "pallas", "nu": 1e-5,
                              "laplacian_order": 2}),
    "reference-grid": ((400, 400), {"impl": "pallas"}),
    "8192sq": ((8192, 8192), {"impl": "pallas"}),
}


@pytest.mark.parametrize("mode", ["iters", "t_end"])
@pytest.mark.parametrize("name", list(PARITY))
def test_engaged_path_matches_jax(name, mode):
    n, kw = PARITY[name]
    kw = {"dtype": "float32", **kw}
    want = JSolver(JConfig(grid=JGrid.make(*n), **kw)).engaged_path(mode)
    got = PSolver(PConfig(grid=PGrid.make(*n), **kw),
                  device="cpu").engaged_path(mode)
    assert got["stepper"] == want["stepper"]
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
    """The port's L2 gate and the JAX VMEM gate (24 live buffers) agree
    on the reference grid and at 8192², and differ at 1001², where only
    the port engages the whole-run stepper (PERF.md). At WENO order 7
    the JAX gate (its order-7 budget) refuses 1001² and 1478² too, where
    it runs the generic path; the port keeps the one L2 gate for both
    orders, since K7 at order 7 ran 163x (1001²) and 128x (1478²) faster
    than the generic WENO7 path there (chip_smoke.py phase 44, H100)."""
    for n, port, jax_ in [(400, True, True), (1001, True, False),
                          (1478, True, False), (1479, False, False),
                          (8192, False, False)]:
        assert pfb2.FusedBurgers2DStepper.supported(
            (n, n), torch.float32) is port
        assert jfb2.FusedBurgers2DStepper.supported(
            (n, n), jnp.float32) is jax_
        assert jfb2.FusedBurgers2DStepper.supported(
            (n, n), jnp.float32, order=7) is jax_


@pytest.mark.parametrize("impl", ["pallas", "pallas_stage", "pallas_step",
                                  "pallas_slab"])
def test_weno7_on_a_fused_rung_raises(impl):
    """Every fused flavor runs WENO7-JS on K7's order-7 instance (its twin
    here), as in the JAX package; the same steps as the generic path
    within the fused-vs-generic bound. (Before K7's order-7 instance was
    ported, construction raised here.)"""
    s = PSolver(PConfig(grid=PGrid.make(16, 12), weno_order=7, impl=impl),
                device="cpu")
    path = s.engaged_path()
    assert path["stepper"] == "fused-whole-run" and path["fallback"] is None
    assert s._fused_stepper().params.order == 7
    got = s.run(s.initial_state(), 2)
    generic = PSolver(PConfig(grid=PGrid.make(16, 12), weno_order=7),
                      device="cpu")
    want = generic.run(generic.initial_state(), 2)
    assert got.it == want.it == 2
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=2e-5,
                               atol=2e-6 * float(want.u.abs().max()))
    # the generic path runs WENO7 in 2-D
    s = PSolver(PConfig(grid=PGrid.make(16, 12), weno_order=7, impl="xla"),
                device="cpu")
    assert bool(torch.isfinite(s.run(s.initial_state(), 1).u).all())


# --------------------------------------------------------------------- #
# The burgers2d CLI verb
# --------------------------------------------------------------------- #
def test_cli_burgers2d_runs_and_saves(tmp_path, capsys):
    assert cli(["burgers2d", "--n", "20", "16", "--iters", "3",
                "--fixed-dt", "--impl", "pallas", "--device", "cpu",
                "--save", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "kernel path        : fused-whole-run (impl=pallas)" in out
    grid = PGrid.make(20, 16)
    s = PSolver(PConfig(grid=grid, impl="pallas", adaptive_dt=False),
                device="cpu")
    s0 = s.initial_state()
    np.testing.assert_array_equal(
        pio.load_binary(str(tmp_path / "initial.bin"), grid.shape),
        s0.u.numpy())
    np.testing.assert_array_equal(
        pio.load_binary(str(tmp_path / "result.bin"), grid.shape),
        s.run(s0, 3).u.numpy())
