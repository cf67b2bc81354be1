"""The port's whole-step rung (the plain twin of K10 on the CPU) against
the JAX K10 kernel (``fused_diffusion_step._step_kernel``, run in Pallas
interpret mode), the twin's identity with three K1-twin stages, and the
``impl="pallas_step"`` solver path.

Tolerances: against the JAX kernel, ``32 eps_f32 * max|u|``, the JAX
suite's fused bound (``tests/test_pallas.py``): both sides sum K1's
terms in K1's order with K folded into each tap, and XLA's compilation
of the interpret-mode kernel may contract multiply-adds that the twin
rounds separately. Inside the port, the twin is three K1-twin stages
and equals them to the bit. Against the generic path, the JAX suite's
fused-vs-generic bound ``rtol=1e-5, atol=1e-6 max|u|``.
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
from multigpu_advectiondiffusion_tpu.ops.pallas.fused_diffusion_step import (
    StepFusedDiffusionStepper as JStepper,
)
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as pfd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion_step as pfds,
)

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS
R = pfd.R


def _assert_fused_close(got, want):
    """Within 32 eps of max|want|; prints the gap in eps (``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    assert gap <= TOL


def _padded(shape, bc, seed):
    rng = np.random.default_rng(seed)
    S = torch.full(tuple(n + 2 * R for n in shape), bc)
    S[R:-R, R:-R, R:-R] = torch.from_numpy(
        rng.random(shape, dtype=np.float32))
    return S


# --------------------------------------------------------------------- #
# The stepper: the twin against the JAX whole-step kernel
# --------------------------------------------------------------------- #
def test_step_twin_matches_jax_k10():
    """The JAX suite's K10 case (``tests/test_pallas.py:1769-1774``):
    36x28x24, ``block_z=8``, 7 steps, from the same initial state."""
    grid = JGrid.make(36, 28, 24, lengths=10.0)
    js = JSolver(JConfig(grid=grid, dtype="float32"))
    s0 = js.initial_state()
    want_u, want_t = JStepper(grid.shape, jnp.float32, grid.spacing,
                              [1.0] * 3, js.dt, 2, 0.0, block_z=8
                              ).run(s0.u, s0.t, 7)
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t), 0,
                                  device="cpu")
    st = pfds.StepFusedDiffusionStepper(grid.shape, grid.spacing, [1.0] * 3,
                                        js.dt, 2, 0.0, "cpu")
    pfds.fused_step.launches = 0
    got_u, got_t = st.run(p0.u, p0.t, 7)
    assert pfds.fused_step.launches == 0  # the CPU launches no kernel
    assert isinstance(got_t, np.float32) and got_t == np.float32(want_t)
    _assert_fused_close(got_u.numpy(), want_u)


@pytest.mark.parametrize("bc_value", [0.0, 0.25])
@pytest.mark.parametrize("band", [1, 2])
def test_step_twin_is_three_k1_stages(band, bc_value):
    """K10's twin is three K1-twin stages, ``_stage_rows``' order, to the
    bit: the fused step ``S -> out`` against ``T1 = s1(S)``,
    ``T2 = s2(T1, S)``, ``S = s3(T2, S)`` in place, as K1's path runs."""
    shape = (9, 11, 13)
    kw = dict(taps=pfd.stage_taps((0.3, 0.25, 0.2), (1.0, 0.5, 2.0)),
              band=band, bc_value=bc_value)
    S = _padded(shape, bc_value, band)
    got = pfds.step_reference(S, S.clone(), 2e-3, **kw)
    want, T1, T2 = S.clone(), S.clone(), S.clone()
    (a1, b1), (a2, b2), (a3, b3) = pfd.STAGES
    pfd.stage_reference(want, None, T1, 2e-3, a=a1, b=b1, **kw)
    pfd.stage_reference(T1, want, T2, 2e-3, a=a2, b=b2, **kw)
    pfd.stage_reference(T2, want, want, 2e-3, a=a3, b=b3, **kw)
    assert torch.equal(got, want)


def test_fused_step_on_cpu_runs_the_twin_and_counts_nothing():
    S = _padded((6, 7, 8), 0.0, 3)
    kw = dict(taps=pfd.stage_taps((0.1, 0.2, 0.3), (1.0,) * 3), band=2,
              bc_value=0.0)
    before = pfds.fused_step.launches
    out = S.clone()
    assert pfds.fused_step(S, out, 1e-3, **kw) is out
    assert pfds.fused_step.launches == before
    assert torch.equal(out, pfds.step_reference(S, S.clone(), 1e-3, **kw))
    assert torch.equal(S, _padded((6, 7, 8), 0.0, 3))  # S is not written


def test_fused_step_rejects_bad_operands():
    S = torch.zeros((9, 8, 7))
    kw = dict(taps=(0.0,) * 15, band=2, bc_value=0.0)
    with pytest.raises(TypeError, match="float32"):
        pfds.fused_step(S.double(), S.double().clone(), 1e-3, **kw)
    with pytest.raises(ValueError, match="different buffers"):
        pfds.fused_step(S, S, 1e-3, **kw)
    with pytest.raises(ValueError, match="expected"):
        pfds.fused_step(S, torch.zeros((9, 8, 6)), 1e-3, **kw)
    with pytest.raises(ValueError, match="padded 3-D"):
        pfds.fused_step(torch.zeros((9, 8)), torch.zeros((9, 8)), 1e-3,
                        **kw)


# --------------------------------------------------------------------- #
# Solver runs: impl="pallas_step" in both packages
# --------------------------------------------------------------------- #
GRIDS = [((24, 16, 16), (10.0, 5.0, 5.15)), ((19, 13, 11), 2.0)]


def _pair(n, lengths, impl="pallas_step"):
    jcfg = JConfig(grid=JGrid.make(*n, lengths=lengths), dtype="float32",
                   impl=impl)
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    ps = PSolver(convert.config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


@pytest.mark.parametrize("n,lengths", GRIDS, ids=["24x16x16", "19x13x11"])
def test_pallas_step_run_matches_jax(n, lengths):
    js, ps, s0, p0 = _pair(n, lengths)
    assert js.engaged_path()["stepper"] == "fused-step"
    assert ps.engaged_path() == {**js.engaged_path(), "fallback": None,
                                 "storage_dtype": "float32"}
    want = js.run(s0, 5)
    got = ps.run(p0, 5)
    assert got.it == int(want.it) == 5
    assert got.t == np.float32(want.t)
    _assert_fused_close(got.u.numpy(), want.u)


def test_pallas_step_advance_to_runs_the_generic_loop():
    """The whole-step stepper has no ``run_to`` in either package:
    ``advance_to`` takes the generic loop and says why."""
    js, ps, s0, p0 = _pair(*GRIDS[1])
    want, got = js.engaged_path("t_end"), ps.engaged_path("t_end")
    reason = ("fused-step stepper has no run_to; t_end mode runs the "
              "generic loop")
    # the generic loop runs the per-axis stencil kernel (K11) in both
    assert got["stepper"] == want["stepper"] == "per-axis-pallas"
    assert got["fallback"] == want["fallback"] == reason
    generic = PSolver(dataclasses.replace(ps.cfg, impl="xla"), device="cpu")
    t_end = float(p0.t) + 2.5 * ps.dt
    pfds.fused_step.launches = 0
    out = ps.advance_to(p0, t_end)
    assert out.it == 3 and pfds.fused_step.launches == 0
    assert torch.equal(out.u, generic.advance_to(p0, t_end).u)


def test_pallas_step_matches_port_generic():
    _, ps, _, p0 = _pair(*GRIDS[0])
    generic = PSolver(dataclasses.replace(ps.cfg, impl="xla"), device="cpu")
    got, want = ps.run(p0, 9), generic.run(p0, 9)
    assert got.t == want.t and got.it == want.it == 9
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(),
                               rtol=1e-5, atol=1e-6)
