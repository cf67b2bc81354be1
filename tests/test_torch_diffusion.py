"""Port generic diffusion path (``impl="xla"``) against the JAX generic
path, from the same initial state (handed over as numpy).

Tolerances: float64 within 1e-12 relative (same formulas, same term
order; XLA may contract a multiply-add); float32 within rtol 1e-5 /
atol 1e-6, the JAX suite's own fused-vs-generic bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JConfig,
    DiffusionSolver as JSolver,
)
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionSolver as PSolver,
)

torch.set_num_threads(1)

GRID = dict(n=(24, 16, 16), lengths=(10.0, 5.0, 5.15))


def _pair(dtype, **kw):
    """A JAX solver and the port solver built from its fields, plus the
    JAX initial state and the same state in the port."""
    jcfg = JConfig(grid=JGrid.make(*GRID["n"], lengths=GRID["lengths"]),
                   dtype=dtype, **kw)
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    ps = PSolver(convert.config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def test_initial_state_matches_jax_f64():
    js, ps, s0, _ = _pair("float64")
    p0 = ps.initial_state()
    assert p0.u.dtype == torch.float64 and type(p0.t) is np.float64
    assert p0.t == float(s0.t) and p0.it == 0
    assert _rel(p0.u.numpy(), s0.u) <= 1e-15


@pytest.mark.parametrize("kw", [
    {},
    {"order": 2},
    {"integrator": "ssp_rk2"},
    {"integrator": "euler", "safety": 0.4},
    {"bc": "edge"},
    {"bc": ("dirichlet", "periodic", "dirichlet")},
    {"reference_parity": False},
    {"diffusivity": 0.27, "t0": 0.05},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_generic_run_f64_matches_jax(kw):
    js, ps, s0, p0 = _pair("float64", **kw)
    want = js.run(s0, 9)
    got = ps.run(p0, 9)
    assert ps.engaged_path()["stepper"] == "generic-xla"
    assert got.it == int(want.it) == 9
    assert got.t == float(want.t)
    assert _rel(got.u.numpy(), want.u) <= 1e-12


def test_generic_run_f32_matches_jax():
    js, ps, s0, p0 = _pair("float32")
    want = js.run(s0, 9)
    got = ps.run(p0, 9)
    assert got.u.dtype == torch.float32 and type(got.t) is np.float32
    assert got.t == np.float32(want.t)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                               rtol=1e-5, atol=1e-6)


def test_generic_step_matches_jax():
    js, ps, s0, p0 = _pair("float64")
    want = js.step(s0)
    got = ps.step(p0)
    assert got.it == 1 and got.t == float(want.t)
    assert _rel(got.u.numpy(), want.u) <= 1e-12


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generic_advance_to_trims_like_jax(dtype):
    """A t_end half a step past the 4th step: both take 5 steps, the last
    one trimmed, and land on the same t."""
    js, ps, s0, p0 = _pair(dtype)
    t_end = float(s0.t) + 4.5 * js.dt
    want = js.advance_to(s0, t_end)
    got = ps.advance_to(p0, t_end)
    assert got.it == int(want.it) == 5
    if dtype == "float64":
        assert abs(float(got.t) - float(want.t)) <= 1e-12
        assert _rel(got.u.numpy(), want.u) <= 1e-12
    else:
        assert got.t == np.float32(want.t)
        np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                                   rtol=1e-5, atol=1e-6)
    land = 1e-12 if dtype == "float64" else 1e-6
    assert abs(float(got.t) - t_end) <= land * t_end


def test_exact_solution_and_error_norms_match_jax():
    js, ps, s0, p0 = _pair("float64")
    for t in (0.1, 0.1234):
        assert _rel(ps.exact_solution(t).numpy(),
                    js.exact_solution(t)) <= 1e-15
    want = js.run(s0, 6)
    got = ps.run(p0, 6)
    jn = js.error_norms(want)
    pn = ps.error_norms(got)
    for a, b in zip(pn, jn):
        assert a == pytest.approx(b, rel=1e-9)
    assert pn.linf < 1e-2  # the heat kernel is tracked closely
