"""Float64 storage on the port's float32 kernels (K1, K2), on the CPU.

A float64 3-D diffusion state under ``impl="pallas_stage"`` (K1) or
``"pallas"``/``"pallas_slab"`` (K2) runs the float32 kernels as the JAX
package runs them (``fused_diffusion.py:417-432``, ``fused_slab_run.py::
SlabRunDiffusionStepper(storage_dtype=)``): ``embed`` rounds the state to
float32, the kernels take ``f32(dt)``, ``extract`` restores float64, and
``t`` stays float64, advanced a step by ``f64(f32(dt))`` on K1 and by the
float64 ``dt`` on the slab rung, the JAX package's two rules.

Tolerances:

* against the JAX package's float64-storage runs: 32 float32 eps of
  max|u| after 5 steps, the float32 kernels' own bound
  (``tests/test_torch_fused_diffusion.py``: the JAX kernels fold the
  taps as the port does but XLA may round a product differently); ``t``
  bit-equal;
* against the port's own float32 kernel run from ``f32(u0)`` with the
  same ``f32(dt)``: bit-equal after the upcast, the claim that the
  rung adds nothing but the two casts.

The JAX oracles run under ``jax.enable_x64(True)``, a context manager
(this JAX's spelling of ``jax.experimental.enable_x64``), never a
process-wide config update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JConfig,
    DiffusionSolver as JSolver,
)
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PConfig,
    DiffusionSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
GRID = ((24, 16, 16), (10.0, 5.0, 5.15))
RUNGS = [("pallas_stage", "fused-stage"),
         ("pallas_slab", "fused-whole-run-slab"),
         ("pallas", "fused-whole-run-slab")]


def _pair(impl):
    n, lengths = GRID
    kw = dict(dtype="float64", impl=impl)
    js = JSolver(JConfig(grid=JGrid.make(*n, lengths=lengths), **kw))
    ps = PSolver(PConfig(grid=PGrid.make(*n, lengths=lengths), **kw),
                 device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t), 0,
                                  device="cpu")
    return js, ps, s0, p0


@pytest.mark.parametrize("impl,stepper", RUNGS)
def test_f64_storage_runs_match_jax(impl, stepper):
    with jax.enable_x64(True):
        js, ps, s0, p0 = _pair(impl)
        for path in (js.engaged_path(), ps.engaged_path()):
            assert (path["stepper"], path["storage_dtype"]) == (
                stepper, "float32")
        want = js.run(s0, 5)
        got = ps.run(p0, 5)
        assert want.u.dtype == jnp.float64 and got.u.dtype == torch.float64
        assert isinstance(got.t, np.float64)
        assert got.t == np.float64(want.t) and got.it == int(want.it) == 5
        w = np.asarray(want.u)
        gap = float(np.max(np.abs(got.u.numpy() - w)) / np.max(np.abs(w)))
        print(f"{impl}: {gap / EPS32:.2f} float32 eps of max|u|")
        assert gap <= 32 * EPS32


@pytest.mark.parametrize("impl,stepper", RUNGS[:2])
def test_f64_storage_is_the_f32_kernel_run_upcast(impl, stepper):
    """The float64-storage run equals the float32 kernel run from
    ``f32(u0)`` with the same ``f32(dt)``, to the bit after the upcast.
    ``t`` follows the JAX package's rules: K1's stepper adds ``f32(dt)``
    a step (``stepper_base.py``), the slab stepper the float64 ``dt``
    (``whole_run.accumulate_t``)."""
    _, ps, _, p0 = _pair(impl)
    ps32 = PSolver(dataclasses.replace(ps.cfg, dtype="float32"),
                   device="cpu")
    assert ps.dt == ps32.dt  # one Python float; both kernels take f32(dt)
    got = ps.run(p0, 4)
    ref = ps32.run(convert.state_from_numpy(
        p0.u.numpy().astype(np.float32), np.float32(p0.t), 0, device="cpu"),
        4)
    assert ps.engaged_path()["stepper"] == ps32.engaged_path()["stepper"] \
        == stepper
    assert torch.equal(got.u, ref.u.double())
    t = p0.t
    step = np.float64(np.float32(ps.dt) if impl == "pallas_stage" else ps.dt)
    for _ in range(4):
        t = t + step
    assert got.t == t


def test_f64_storage_advance_to_lands_as_jax():
    """``advance_to`` on K1 (the slab stepper has no ``run_to``): the last
    step trimmed through the by-value dt, ``t`` landing where the JAX
    package's float64 run lands."""
    with jax.enable_x64(True):
        js, ps, s0, p0 = _pair("pallas_stage")
        te = float(s0.t) + 3.5 * js.dt
        want, got = js.advance_to(s0, te), ps.advance_to(p0, te)
        assert got.it == int(want.it)
        assert got.t == np.float64(want.t)
        w = np.asarray(want.u)
        assert float(np.max(np.abs(got.u.numpy() - w))
                     / np.max(np.abs(w))) <= 32 * EPS32


def test_f64_storage_steppers_cast_at_the_boundary():
    """``embed`` rounds a float64 state to the float32 buffer, ``extract``
    gives float64 back; the stepper reports float32 buffers."""
    _, ps, _, p0 = _pair("pallas_slab")
    st = ps._fused_stepper()
    assert isinstance(st, psr.SlabRunDiffusionStepper)
    assert (st.dtype, st.storage_dtype) == (torch.float32, torch.float64)
    S = st.embed(p0.u)
    assert S.dtype == torch.float32
    back = st.extract(S)
    assert back.dtype == torch.float64
    assert torch.equal(back, p0.u.float().double())
