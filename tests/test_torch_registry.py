"""The port's model registry and the CLI verbs it generates, against
the JAX package's registry: the same families, the registration
contract enforced, the four contract methods declared by every solver
and answering as the JAX solvers answer on the same config, and the
JAX package's ``ADRConfig`` checks."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models import registry as jreg
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import build_parser
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.diagnostics import physics
from multigpu_advectiondiffusion_tpu_torch.models import registry as preg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_and_specs_match_jax():
    assert set(preg.names()) == set(jreg.names()) == {
        "adr", "burgers", "diffusion"}
    for name in preg.names():
        p, j = preg.get(name), jreg.get(name)
        assert p.solver_cls.__name__ == j.solver_cls.__name__
        assert p.config_cls.__name__ == j.config_cls.__name__
        assert p.config_cls.__module__.startswith(
            "multigpu_advectiondiffusion_tpu_torch.")
        assert (p.check_error, dict(p.sweep_aliases), p.family_kind) == (
            j.check_error, dict(j.sweep_aliases), j.family_kind)
        assert p.cli_dims == (2, 3)  # 1-D is not ported yet
        assert preg.family_of_run_name(f"{name}3d_mlups") == name
        assert preg.solver_for_run_name(f"{name}2d") is p.solver_cls
    assert [s.name for s in preg.specs()] == list(preg.names())
    with pytest.raises(KeyError, match="registered models"):
        preg.get("navier_stokes")
    with pytest.raises(KeyError, match="no registered model"):
        preg.solver_for_run_name("euler3d")


def test_register_model_rejects_a_half_wired_solver():
    class Half:
        def stencil_spec(self):
            return {}

        def cfl_rule(self):
            return {}

    class Inherits(preg.get("diffusion").solver_cls):
        pass

    for cls, missing in ((Half, "diagnostics_spec"),
                         (Inherits, "stencil_spec")):
        spec = preg.ModelSpec(name="half", config_cls=object, solver_cls=cls,
                              description="half-wired")
        with pytest.raises(ValueError, match=missing):
            preg.register_model(spec)
    assert "half" not in preg.names()


# one config per family, built by each package's bench_build hook
CASES = [("diffusion", (24, 16, 16), "float32"),
         ("burgers", (24, 16, 16), "float32"),
         ("adr", (24, 16, 16), "float32"),
         ("adr", (40, 30), "float64")]


@pytest.mark.parametrize("name,n,dtype", CASES)
def test_contract_methods_answer_as_jax(name, n, dtype):
    p, j = preg.get(name), jreg.get(name)
    for m in preg.REQUIRED_SOLVER_CONTRACT:
        assert m in vars(p.solver_cls), m
    pcfg = p.bench_build(PGrid.make(*n), dtype, "pallas", None)
    jcfg = j.bench_build(JGrid.make(*n), dtype, "pallas", None)
    for f in dataclasses.fields(jcfg):
        if f.name not in ("grid", "source"):
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    ps = p.solver_cls(pcfg, device="cpu")
    js = j.solver_cls(jcfg)
    assert ps.stencil_spec() == js.stencil_spec()
    assert ps.cfl_rule() == js.cfl_rule()
    assert ps.ensemble_operands() == js.ensemble_operands()
    pd, jd = ps.diagnostics_spec(), js.diagnostics_spec()
    assert [r.name for r in pd["rules"]] == [r.name for r in jd["rules"]]
    assert [r.tolerance for r in pd["rules"]] == [
        r.tolerance for r in jd["rules"]]
    assert pd["meta"] == jd["meta"]
    assert p.stage_radius(pcfg) == j.stage_radius(jcfg)
    assert p.key_extras(pcfg) == j.key_extras(jcfg)
    assert p.cost_kwargs(pcfg) == j.cost_kwargs(jcfg)


def test_violation_rules():
    """The host-side rules as the JAX package states them."""
    base = {"max": 1.0, "min": 0.0, "tv": 2.0}
    rules = [physics.max_principle_rule(), physics.positivity_rule(),
             physics.tv_monotone_rule()]
    assert physics.check_violations(rules, dict(base), base) == []
    assert physics.check_violations(rules, {"max": 2.0}, None) == []
    out = physics.check_violations(
        rules, {"max": 1.01, "min": -0.01, "tv": 2.2}, base)
    assert [v["rule"] for v in out] == [
        "max_principle", "positivity", "tv_monotone"]
    # signed initial data: positivity is not a property
    assert physics.positivity_rule().check(
        {"min": -0.5}, {"min": -0.4, "max": 1.0}, 1e-3) is None


def test_generated_verbs():
    sub = next(a for a in build_parser()._actions
               if isinstance(a.choices, dict))
    assert set(sub.choices) == {f"{n}{d}d" for n in preg.names()
                                for d in (2, 3)}
    adr = sub.choices["adr3d"]
    flags = {s for a in adr._actions for s in a.option_strings}
    assert {"--K", "--velocity", "--kappa-variation", "--reaction",
            "--advect", "--order", "--cfl", "--t0", "--check-error",
            "--n", "--iters", "--t-end", "--impl", "--dtype", "--save",
            "--device"} <= flags
    burgers = sub.choices["burgers3d"]
    assert "--check-error" not in {s for a in burgers._actions
                                   for s in a.option_strings}


def test_cli_adr3d_runs_the_fused_stage():
    proc = subprocess.run(
        [sys.executable, "-m", "multigpu_advectiondiffusion_tpu_torch.cli",
         "adr3d", "--n", "16", "12", "10", "--iters", "3", "--impl",
         "pallas", "--device", "cpu", "--check-error"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "kernel path        : fused-stage (impl=pallas)" in proc.stdout
    assert "kernel launches    : none" in proc.stdout  # the CPU: the twin
    assert "iterations         : 3 x 3 RK stages" in proc.stdout
    assert "error L1/L2/Linf   : " in proc.stdout


BAD_ADR = [
    {"impl": "mosaic"}, {"overlap": "ring"}, {"advect": "weno7"},
    {"order": 6}, {"kappa_variation": 1.0}, {"kappa_variation": -1.5},
    {"reaction_rate": -0.1}, {"steps_per_exchange": 2},
    {"exchange": "dma"}, {"velocity": (0.1, 0.2)}, {"precision": "fp8"},
]


@pytest.mark.parametrize("kw", BAD_ADR, ids=[next(iter(k)) + "-" + str(
    next(iter(k.values()))) for k in BAD_ADR])
def test_adr_config_raises_where_jax_raises(kw):
    with pytest.raises(ValueError) as want:
        jreg.get("adr").config_cls(grid=JGrid.make(8, 6, 4), **kw)
    with pytest.raises(ValueError) as got:
        preg.get("adr").config_cls(grid=PGrid.make(8, 6, 4), **kw)
    assert str(got.value) == str(want.value)
