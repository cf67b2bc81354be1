"""The port's 3-D Burgers family on its generic path (plain PyTorch)
against the JAX package, plus its rung dispatch and ``burgers3d`` CLI.

Tolerances: float64, ``1e-14`` relative for the pointwise pieces (flux,
IC, CFL dt) and ``1e-12`` relative for divergences and whole runs — the
two packages evaluate the same expressions in the same order, and XLA's
CPU compiler may contract a product and a sum that PyTorch rounds
separately. The JAX side passes ``dtype`` explicitly (conftest turns
x64 on).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.core.bc import Boundary as JBoundary
from multigpu_advectiondiffusion_tpu.models.burgers import (
    BurgersConfig as JConfig,
    BurgersSolver as JSolver,
)
from multigpu_advectiondiffusion_tpu.ops import flux as jflux
from multigpu_advectiondiffusion_tpu.ops import weno as jweno
from multigpu_advectiondiffusion_tpu.timestepping import cfl as jcfl
from multigpu_advectiondiffusion_tpu.utils import ic as jic
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary as PBoundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PConfig,
    BurgersSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops import weno as pweno
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh
from multigpu_advectiondiffusion_tpu_torch.timestepping import cfl as pcfl
from multigpu_advectiondiffusion_tpu_torch.utils import ic as pic
from multigpu_advectiondiffusion_tpu_torch.utils import io as pio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUXES = [("burgers", {}), ("linear", {"c": -0.7}), ("buckley", {})]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-300)


def _field(shape, seed, lo=-0.2, hi=1.1):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


# --------------------------------------------------------------------- #
# Pointwise pieces: flux, IC, CFL dt
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", FLUXES, ids=[f for f, _ in FLUXES])
def test_flux_matches_jax(name, kw):
    w = _field((5, 6, 7), 0)
    jf, pf = jflux.get(name, **kw), pflux.get(name, **kw)
    assert (pf.name, pf.cfl_max) == (jf.name, jf.cfl_max)
    for fn in ("f", "df"):
        want = np.asarray(getattr(jf, fn)(jnp.asarray(w)))
        got = getattr(pf, fn)(torch.from_numpy(w)).numpy()
        assert _rel(got, want) <= 1e-14, fn
    if name == "linear":
        assert pf.c == kw["c"]


def test_gaussian_ic_matches_jax():
    jg = JGrid.make(9, 7, 5, lengths=(2.0, 1.5, 1.0))
    pg = PGrid.make(9, 7, 5, lengths=(2.0, 1.5, 1.0))
    for kw in ({}, {"amplitude": 0.5, "width": 0.3}):
        want = np.asarray(jic.gaussian(jg, dtype=jnp.float64, **kw))
        got = pic.initial_condition("gaussian", pg, dtype=torch.float64,
                                    device="cpu", **kw).numpy()
        assert _rel(got, want) <= 1e-14


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_advective_dt_matches_jax(dtype):
    spacing = (0.02, 0.03, 0.025)
    u = _field((4, 5, 6), 1).astype(dtype)
    for name, kw in FLUXES:
        jf, pf = jflux.get(name, **kw), pflux.get(name, **kw)
        want = jcfl.advective_dt(jnp.asarray(u), jf.df, spacing, 0.4)
        got = pcfl.advective_dt(torch.from_numpy(u), pf.df, spacing, 0.4)
        assert got.dtype == getattr(torch, dtype) and got.dim() == 0
        # float32: bit for bit (float32(cfl min dx) / max(a, 1e-12))
        assert float(got) == float(want), name
    # the floor and NaN propagation of the wave speed
    zero = torch.zeros((), dtype=torch.float32)
    assert float(pcfl.dt_from_wave_speed(zero, spacing, 0.4)) == float(
        jcfl.dt_from_wave_speed(jnp.zeros((), jnp.float32), spacing, 0.4))
    nan = torch.full((), float("nan"))
    assert bool(torch.isnan(pcfl.dt_from_wave_speed(nan, spacing, 0.4)))


# --------------------------------------------------------------------- #
# Generic WENO flux divergence, per axis
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", FLUXES, ids=[f for f, _ in FLUXES])
@pytest.mark.parametrize("order,variant", [(5, "js"), (5, "z"), (7, "js")],
                         ids=["weno5js", "weno5z", "weno7"])
def test_flux_divergence_matches_jax(order, variant, name, kw):
    u = _field((9, 10, 11), 2, lo=0.0, hi=1.0)
    jf, pf = jflux.get(name, **kw), pflux.get(name, **kw)
    for axis, dx in enumerate((0.05, 0.07, 0.09)):
        want = jweno.flux_divergence(
            jnp.asarray(u), axis, dx, jf, order=order, variant=variant,
            bc=JBoundary("edge"))
        got = pweno.flux_divergence(
            torch.from_numpy(u), axis, dx, pf, order=order,
            variant=variant, bc=PBoundary("edge"))
        assert _rel(got.numpy(), want) <= 1e-12, axis


# --------------------------------------------------------------------- #
# Generic runs: port impl="xla" against JAX impl="xla", float64
# --------------------------------------------------------------------- #
def _pair(dtype="float64", impl="xla", n=(16, 16, 24), **kw):
    jcfg = JConfig(grid=JGrid.make(*n, lengths=2.0), dtype=dtype, impl=impl,
                   **kw)
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    ps = PSolver(convert.burgers_config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


@pytest.mark.parametrize("kw", [
    {"nu": 1e-5, "adaptive_dt": False},
    {"nu": 1e-5},
    {"weno_order": 7, "flux": "buckley"},
], ids=["fixed-viscous", "adaptive-viscous", "adaptive-weno7-buckley"])
def test_generic_run_matches_jax(kw):
    js, ps, s0, p0 = _pair(**kw)
    assert ps.engaged_path()["stepper"] == "generic-xla"
    want = js.run(s0, 5)
    got = ps.run(p0, 5)
    assert got.it == int(want.it) == 5
    assert isinstance(got.t, np.float64)
    assert _rel(got.u.numpy(), want.u) <= 1e-12
    if kw.get("adaptive_dt", True):
        # dt follows max|u|, which may differ in its last bit
        assert abs(float(got.t) - float(want.t)) <= 1e-12 * float(want.t)
    else:
        assert got.t == np.float64(want.t)


def test_stencil_and_cfl_contracts_match_jax():
    for kw in ({}, {"nu": 1e-5, "weno_order": 7, "adaptive_dt": False}):
        js, ps, _, _ = _pair(n=(8, 8, 8), **kw)
        assert ps.stencil_spec() == js.stencil_spec()
        assert ps.cfl_rule() == js.cfl_rule()


def test_burgers_config_from_jax_fields():
    jcfg = JConfig(grid=JGrid.make(8, 7, 6), flux="linear",
                   flux_params=(("c", 0.5),), weno_variant="z", nu=1e-5,
                   adaptive_dt=False, impl="pallas_stage",
                   bc=JBoundary("edge"))
    pcfg = convert.burgers_config_from_fields(dataclasses.asdict(jcfg))
    assert pcfg.bc == PBoundary("edge")
    for f in dataclasses.fields(jcfg):
        if f.name not in ("grid", "bc"):
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert PSolver(pcfg, device="cpu").flux.c == 0.5
    with pytest.raises(ValueError, match="lacks"):
        convert.burgers_config_from_fields({"grid": jcfg.grid, "mesh": 2})


# --------------------------------------------------------------------- #
# Dispatch: engaged_path labels, declines, unported configs
# --------------------------------------------------------------------- #
def _solver(n=(12, 10, 8), **kw):
    kw.setdefault("dtype", "float32")
    return PSolver(PConfig(grid=PGrid.make(*n), **kw), device="cpu")


def test_engaged_path_labels():
    assert _solver(impl="xla").engaged_path() == {
        "impl": "xla", "stepper": "generic-xla", "overlap": None,
        "steps_per_exchange": 1, "exchange": "collective",
        "storage_dtype": "float32", "precision": "native",
        "fallback": None,
    }
    adaptive = _solver(impl="pallas").engaged_path()
    assert (adaptive["stepper"], adaptive["fallback"]) == ("fused-stage",
                                                           None)
    # fixed dt: the port's measured gate prefers K5 to the slab rung K6
    # on every grid (PERF.md), so no fallback is reported
    fixed = _solver(impl="pallas", adaptive_dt=False)
    assert fixed.engaged_path()["stepper"] == "fused-stage"
    assert fixed.engaged_path()["fallback"] is None
    assert fixed.engaged_path("t_end")["fallback"] is None
    slab = _solver(impl="pallas_slab", adaptive_dt=False).engaged_path()
    assert (slab["stepper"], slab["fallback"]) == ("fused-whole-run-slab",
                                                   None)
    pinned = _solver(impl="pallas_stage", adaptive_dt=False).engaged_path()
    assert (pinned["stepper"], pinned["fallback"]) == ("fused-stage", None)


@pytest.mark.parametrize("kw,reason,per_axis", [
    ({"integrator": "euler"}, "SSP-RK3", True),
    ({"bc": "dirichlet"}, "edge BCs", True),
    ({"nu": 1e-5, "laplacian_order": 2}, "O4 Laplacian", True),
    ({"dtype": "float64"}, "float32-only", False),
    ({"weno_order": 7, "bc": "periodic"}, "edge BCs", False),
])
def test_fused_declines_name_their_reason(kw, reason, per_axis):
    """A fused decline runs the generic loop: on the per-axis kernels
    (K12, K11 for the viscous term) in float32, as in the JAX package,
    and in plain PyTorch where they decline too."""
    s = _solver(impl="pallas", **kw)
    path = s.engaged_path()
    assert path["stepper"] == ("per-axis-pallas" if per_axis
                               else "generic-xla")
    assert reason in path["fallback"]
    out = s.run(s.initial_state(), 2)
    assert out.it == 2 and bool(torch.isfinite(out.u).all())


@pytest.mark.parametrize("kw,stepper", [
    ({"impl": "pallas_step"}, "fused-stage"),
    ({"impl": "pallas_axis"}, "per-axis-pallas"),
])
def test_pallas_step_and_pallas_axis_run(kw, stepper):
    """``pallas_step`` takes the fused stage kernel K5, as ``pallas``
    does (the JAX package's dispatch); ``pallas_axis`` the per-axis
    kernels K12/K11."""
    s = _solver(**kw)
    assert s.engaged_path() == {
        "impl": kw["impl"], "stepper": stepper, "overlap": None,
        "steps_per_exchange": 1, "exchange": "collective",
        "storage_dtype": "float32", "precision": "native",
        "fallback": None,
    }
    out = s.run(s.initial_state(), 2)
    assert out.it == 2 and bool(torch.isfinite(out.u).all())


@pytest.mark.parametrize("kw,match", [
    ({"impl": "auto"}, "tuner"),
    ({"impl": "pallas", "weno_order": 7}, "order-7"),
    ({"impl": "pallas_slab", "weno_order": 7, "adaptive_dt": False},
     "K6's order-7"),
    ({"impl": "pallas_stage", "weno_order": 7}, "order-7"),
    # precision="bf16" runs on one device (tests/test_torch_precision.py)
    # and on a mesh, its ghosts on bf16 wires
    # (tests/test_torch_precision_mesh.py)
    ({"impl": "xla", "precision": "bf16"}, "bf16"),
    # dtype="bfloat16" runs too; with precision="bf16" it is the JAX
    # package's "redundant" ValueError
    ({"impl": "xla", "dtype": "bfloat16", "precision": "bf16"},
     "bfloat16"),
    ({"impl": "xla", "steps_per_exchange": 2}, "mesh"),
    ({"impl": "xla", "exchange": "dma"}, "mesh"),
])
def test_unported_configs_raise(kw, match):
    # the mesh knobs without a mesh: the JAX package's construction gate
    # (a ValueError saying a mesh is needed) since meshes are ported
    exc = (ValueError if {"steps_per_exchange", "exchange"} & set(kw)
           or kw.get("dtype") == "bfloat16" else NotImplementedError)
    place = {"device": "cpu"}
    if "precision" in kw:
        place = {"mesh": pmesh.make_mesh(
            {"dz": 2}, devices=[torch.device("cpu")] * 2, timeout=60.0)}
    if kw == {"impl": "xla", "precision": "bf16"}:
        s = PSolver(PConfig(grid=PGrid.make(12, 10, 8), dtype="float32",
                            **kw), **place)
        path = s.engaged_path()
        assert (path["stepper"], path["storage_dtype"]) == ("generic-xla",
                                                            "bfloat16")
        out = s.run(s.initial_state(), 1)
        assert out.it == 1 and out.u.dtype == torch.float32
        return
    if kw.get("weno_order") == 7:
        # WENO7 runs its fused rung on one device and on a z-slab mesh
        # (the order-7 instances of K5 and K6, and of the sharded K5 and
        # K3: tests/test_torch_weno7_fused.py, test_torch_weno7_mesh.py);
        # the slab pin engages the slab rung (K6, K3 on a shard of at
        # least G = 12 planes)
        mesh = pmesh.make_mesh({"dz": 2}, devices=[torch.device("cpu")] * 2,
                               timeout=60.0)
        slab = "K6" in match
        for s in (_solver(**kw), PSolver(PConfig(
                grid=PGrid.make(12, 10, 24), **{"dtype": "float32", **kw}),
                mesh=mesh)):
            assert s.engaged_path()["stepper"] == (
                "fused-whole-run-slab" if slab else "fused-stage")
            assert s.engaged_path()["fallback"] is None
        return
    with pytest.raises(exc, match=match):
        PSolver(PConfig(grid=PGrid.make(12, 10, 8),
                        **{"dtype": "float32", **kw}), **place)


def test_unported_dimensions_raise():
    """1-D grids are not ported; 2-D grids are
    (``tests/test_torch_fused_burgers2d.py``), and there ``pallas_slab``/
    ``pallas_step`` run the whole-run stepper."""
    with pytest.raises(NotImplementedError, match="1-D"):
        PSolver(PConfig(grid=PGrid.make(16)), device="cpu")
    for impl in ("pallas_slab", "pallas_step"):
        s = PSolver(PConfig(grid=PGrid.make(16, 12), impl=impl),
                    device="cpu")
        assert s.engaged_path()["stepper"] == "fused-whole-run"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSolver(PConfig(grid=PGrid.make(8, 8, 8), impl="pallas"))


def test_weno7_runs_on_the_generic_path():
    s = _solver(impl="xla", weno_order=7, nu=1e-5)
    out = s.run(s.initial_state(), 2)
    assert bool(torch.isfinite(out.u).all())


# --------------------------------------------------------------------- #
# The burgers3d CLI verb
# --------------------------------------------------------------------- #
def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "multigpu_advectiondiffusion_tpu_torch.cli",
         "burgers3d", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


@pytest.mark.parametrize("impl,stepper,extra", [
    ("xla", "generic-xla", ["--weno-order", "7", "--flux", "buckley"]),
    ("pallas", "fused-stage", ["--weno-variant", "z", "--fixed-dt"]),
    ("pallas_slab", "fused-whole-run-slab", ["--fixed-dt"]),
])
def test_cli_burgers3d_runs_and_saves(tmp_path, impl, stepper, extra):
    proc = _cli("--n", "12", "10", "8", "--iters", "3", "--nu", "1e-5",
                "--device", "cpu", "--impl", impl, "--save", str(tmp_path),
                *extra)
    assert proc.returncode == 0, proc.stderr
    assert f"kernel path        : {stepper} (impl={impl})" in proc.stdout
    grid = PGrid.make(12, 10, 8)
    cfg = PConfig(grid=grid, nu=1e-5, impl=impl,
                  weno_order=7 if "7" in extra else 5,
                  weno_variant="z" if "z" in extra else "js",
                  flux="buckley" if "buckley" in extra else "burgers",
                  adaptive_dt="--fixed-dt" not in extra)
    s = PSolver(cfg, device="cpu")
    s0 = s.initial_state()
    np.testing.assert_array_equal(
        pio.load_binary(str(tmp_path / "initial.bin"), grid.shape),
        s0.u.numpy())
    np.testing.assert_array_equal(
        pio.load_binary(str(tmp_path / "result.bin"), grid.shape),
        s.run(s0, 3).u.numpy())
