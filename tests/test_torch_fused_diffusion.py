"""The port's fused per-stage rung (K1's plain twin on the CPU) against
the JAX K1 kernel (``fused_diffusion._stage_kernel``, run in Pallas
interpret mode), plus the port's rung dispatch.

The JAX side pins ``impl="pallas_stage"`` wherever it means K1: at
these small grids its ``impl="pallas"`` engages the slab rung (K2), and
so does the port's where its measured gate prefers K2 (whose twin is
three K1-twin stages a step, so the bound is the same).

Tolerance: ``32 eps_f32 * max|u|``, the JAX suite's fused bound
(``tests/test_pallas.py``). Both evaluate K1's term order with K folded
into each tap; XLA's compilation of the interpret-mode kernel may
contract multiply-adds the twin rounds separately.
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
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_diffusion as jfd
from multigpu_advectiondiffusion_tpu.ops.pallas.fused_slab_run import (
    SlabRunDiffusionStepper,
)
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.models import base as pbase
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PConfig,
    DiffusionSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as pfd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)

torch.set_num_threads(1)

TOL = 32 * np.finfo(np.float32).eps
R = pfd.R


def _assert_fused_close(got, want):
    """Within 32 eps of max|want|; prints the gap in eps (``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want)))
    gap = float(np.max(np.abs(got - want))) / scale
    print(f"max|port - jax| = {gap / np.finfo(np.float32).eps:.2f} eps "
          "of max|u|")
    assert gap <= TOL


# --------------------------------------------------------------------- #
# One stage: the twin against the JAX kernel on the same padded input
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bc_value", [0.0, 0.5])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_stage_twin_matches_jax_kernel(kind, bc_value):
    nz, ny, nx = 8, 10, 12
    spacing, diffusivity, dt, band = (0.3, 0.25, 0.2), (1.0,) * 3, 2e-3, 2
    a, b = pfd.STAGES[kind]
    rng = np.random.default_rng(kind)
    padded = (nz + 2 * R, ny + 2 * R, nx + 2 * R)
    v = np.full(padded, bc_value, np.float32)
    u = np.full(padded, bc_value, np.float32)
    v[R:-R, R:-R, R:-R] = rng.random((nz, ny, nx), dtype=np.float32)
    u[R:-R, R:-R, R:-R] = rng.random((nz, ny, nx), dtype=np.float32)

    # the port: (nz+4, ny+4, nx+4), written in place for stage 3
    out = torch.from_numpy(u.copy() if kind == 2 else v.copy())
    got = pfd.fused_stage(
        torch.from_numpy(v), None if kind == 0 else torch.from_numpy(u),
        out, dt, taps=pfd.stage_taps(spacing, diffusivity), a=a, b=b,
        band=band, bc_value=bc_value)
    assert got is out

    # JAX K1 on its tile-rounded layout, the port's state embedded
    jshape = (nz + 2 * R, 16, 128)

    def embed(x):
        full = np.full(jshape, bc_value, np.float32)
        full[:, :ny + 2 * R, :nx + 2 * R] = x
        return jnp.asarray(full)

    scales = [diffusivity[i] / (12.0 * spacing[i] ** 2) for i in range(3)]
    src = ("none", "operand", "target")[kind]
    stage = jfd._make_stage(jshape, (nz, ny, nx), jnp.float32, bz=4,
                            scales=scales, a=a, b=b, band=band,
                            bc_value=bc_value, u_source=src)
    dt_arr = jnp.asarray([dt], jnp.float32)
    if src == "none":
        want = stage(dt_arr, embed(v), embed(v))
    elif src == "operand":
        want = stage(dt_arr, embed(v), embed(u), embed(v))
    else:
        want = stage(dt_arr, embed(v), embed(u))
    want = np.asarray(want)[:nz + 2 * R, :ny + 2 * R, :nx + 2 * R]
    _assert_fused_close(out[R:-R, R:-R, R:-R].numpy(),
                        want[R:-R, R:-R, R:-R])
    # the ghost ring is never written
    ring = np.ones(padded, bool)
    ring[R:-R, R:-R, R:-R] = False
    before = u if kind == 2 else v
    np.testing.assert_array_equal(out.numpy()[ring], before[ring])


def test_fused_stage_on_cpu_runs_the_twin_and_counts_nothing():
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.random((9, 8, 7), dtype=np.float32))
    u = torch.from_numpy(rng.random((9, 8, 7), dtype=np.float32))
    taps = pfd.stage_taps((0.1, 0.2, 0.3), (1.0, 1.0, 1.0))
    kw = dict(taps=taps, a=0.75, b=0.25, band=2, bc_value=0.0)
    before = pfd.fused_stage.launches
    out = pfd.fused_stage(v, u, torch.zeros_like(v), 1e-3, **kw)
    ref = pfd.stage_reference(v, u, torch.zeros_like(v), 1e-3, **kw)
    assert pfd.fused_stage.launches == before
    assert torch.equal(out, ref)


def test_fused_stage_rejects_bad_operands():
    v = torch.zeros((9, 8, 7))
    kw = dict(taps=(0.0,) * 15, a=0.0, b=1.0, band=2, bc_value=0.0)
    with pytest.raises(TypeError, match="float32"):
        pfd.fused_stage(v.double(), None, v.double().clone(), 1e-3, **kw)
    with pytest.raises(ValueError, match="different buffers"):
        pfd.fused_stage(v, None, v, 1e-3, **kw)
    with pytest.raises(ValueError, match="expected"):
        pfd.fused_stage(v, None, torch.zeros((9, 8, 6)), 1e-3, **kw)


# --------------------------------------------------------------------- #
# Whole runs: port impl="pallas" (twin) against JAX "pallas_stage" (K1)
# --------------------------------------------------------------------- #
def _k2_gate(solver) -> bool:
    """The port's gate: whether ``impl="pallas"`` engages K2 here."""
    shape = solver.grid.shape
    return (psr.SlabRunDiffusionStepper.supported(shape, torch.float32)
            and psr.SlabRunDiffusionStepper.profitable(shape, torch.float32))


def _pair(n, lengths, impl="pallas"):
    jcfg = JConfig(grid=JGrid.make(*n, lengths=lengths), dtype="float32",
                   impl="pallas_stage")
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["impl"] = impl
    ps = PSolver(convert.config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


GRIDS = [((24, 16, 16), (10.0, 5.0, 5.15)), ((19, 13, 11), 2.0)]


@pytest.mark.parametrize("impl", ["pallas", "pallas_stage"])
@pytest.mark.parametrize("n,lengths", GRIDS, ids=["24x16x16", "19x13x11"])
def test_fused_run_matches_jax_k1(n, lengths, impl):
    js, ps, s0, p0 = _pair(n, lengths, impl)
    assert js.engaged_path()["stepper"] == "fused-stage"
    assert ps.engaged_path()["stepper"] == (
        "fused-whole-run-slab" if impl == "pallas" and _k2_gate(ps)
        else "fused-stage")
    want = js.run(s0, 5)
    got = ps.run(p0, 5)
    assert got.it == int(want.it) == 5
    assert got.t == np.float32(want.t)
    _assert_fused_close(got.u.numpy(), want.u)


@pytest.mark.parametrize("n,lengths", GRIDS, ids=["24x16x16", "19x13x11"])
def test_fused_advance_to_matches_jax_k1(n, lengths):
    """t_end half a step past the 4th step: 5 steps, the last trimmed
    through the by-value dt, landing on the JAX time."""
    js, ps, s0, p0 = _pair(n, lengths)
    t_end = float(s0.t) + 4.5 * js.dt
    want = js.advance_to(s0, t_end)
    got = ps.advance_to(p0, t_end)
    assert ps.engaged_path("t_end")["stepper"] == "fused-stage"
    assert got.it == int(want.it) == 5
    assert got.t == np.float32(want.t)
    assert abs(float(got.t) - t_end) <= 1e-6 * t_end
    _assert_fused_close(got.u.numpy(), want.u)


def test_fused_run_matches_port_generic():
    """Inside the port: the fused rung against the generic path, at the
    JAX suite's fused-vs-generic bound."""
    _, ps, _, p0 = _pair(*GRIDS[0])
    generic = PSolver(dataclasses.replace(ps.cfg, impl="xla"), device="cpu")
    got = ps.run(p0, 9)
    want = generic.run(p0, 9)
    assert got.t == want.t
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# Dispatch: engaged_path labels, declines, unported rungs
# --------------------------------------------------------------------- #
def _solver(n=(24, 16, 16), **kw):
    grid = PGrid.make(*n, lengths=(10.0, 5.0, 5.15))
    kw.setdefault("dtype", "float32")
    return PSolver(PConfig(grid=grid, **kw), device="cpu")


def test_engaged_path_labels():
    assert _solver(impl="xla").engaged_path() == {
        "impl": "xla", "stepper": "generic-xla", "overlap": None,
        "steps_per_exchange": 1, "exchange": "collective",
        "storage_dtype": "float32", "precision": "native",
        "fallback": None,
    }
    # a small grid: the port's measured gate prefers the slab rung K2,
    # as the JAX package's does; advance_to has no slab rung in either
    small = _solver(impl="pallas")
    assert _k2_gate(small)
    assert small.engaged_path()["stepper"] == "fused-whole-run-slab"
    assert small.engaged_path()["fallback"] is None
    assert small.engaged_path("t_end")["stepper"] == "fused-stage"
    assert small.engaged_path("t_end")["fallback"] is None
    pinned = _solver(impl="pallas_stage").engaged_path()
    assert (pinned["stepper"], pinned["fallback"]) == ("fused-stage", None)
    # the reference grid: K1 in both packages
    ref = _solver(n=(400, 200, 206), impl="pallas").engaged_path()
    assert (ref["stepper"], ref["fallback"]) == ("fused-stage", None)
    step = _solver(impl="pallas_step").engaged_path()
    assert (step["stepper"], step["fallback"]) == ("fused-step", None)


# physical (nx, ny, nz) on which the port's gate (measured on the H100)
# and the JAX package's TPU VMEM gate pick different rungs for
# impl="pallas" (PERF.md); on the others they agree
GATES_DISAGREE = {(64, 64, 64), (128, 128, 40)}


@pytest.mark.parametrize("n", [(24, 16, 16), (400, 200, 206), (64, 64, 64),
                               (128, 128, 40), (300, 40, 96), (17, 9, 33),
                               (64, 64, 40)])
def test_slab_rung_selection_matches_jax(n):
    """The port's slab gate against the JAX package's on one device:
    equal picks except on ``GATES_DISAGREE``."""
    shape = tuple(reversed(n))
    jax_pick = (SlabRunDiffusionStepper.supported(shape, jnp.float32)
                and SlabRunDiffusionStepper.profitable(shape, jnp.float32))
    port_pick = (psr.SlabRunDiffusionStepper.supported(shape, torch.float32)
                 and psr.SlabRunDiffusionStepper.profitable(shape,
                                                            torch.float32))
    assert (port_pick == jax_pick) is (n not in GATES_DISAGREE)


@pytest.mark.parametrize("kw,reason", [
    ({"order": 2}, "O4"),
    ({"integrator": "euler"}, "SSP-RK3"),
    ({"source": lambda u: 0.0 * u}, "source-term"),
    ({"reference_parity": False}, "reference_parity"),
    ({"bc": "edge"}, "uniform Dirichlet"),
])
def test_fused_declines_name_their_reason(kw, reason):
    """A fused decline runs the generic loop on the per-axis stencil
    kernel (K11), as in the JAX package."""
    s = _solver(impl="pallas", **kw)
    path = s.engaged_path()
    assert path["stepper"] == "per-axis-pallas"
    assert reason in path["fallback"]
    out = s.run(s.initial_state(), 2)
    assert out.it == 2 and bool(torch.isfinite(out.u).all())


def test_pallas_axis_runs_the_per_axis_kernel():
    s = _solver(impl="pallas_axis")
    path = s.engaged_path()
    assert (path["stepper"], path["fallback"]) == ("per-axis-pallas", None)
    out = s.run(s.initial_state(), 2)
    assert out.it == 2 and bool(torch.isfinite(out.u).all())


@pytest.mark.parametrize("kw,match", [
    ({"impl": "auto"}, "tuner"),
    ({"impl": "pallas", "dtype": "float64"}, "float64"),
    ({"impl": "pallas_stage", "dtype": "float64"}, "float64"),
    ({"impl": "xla", "dtype": "bfloat16"}, "bfloat16"),
    ({"impl": "xla", "precision": "bf16"}, "bf16"),
    ({"impl": "xla", "steps_per_exchange": 2}, "mesh"),
])
def test_unported_rungs_raise(kw, match):
    # steps_per_exchange without a mesh: the JAX package's construction
    # gate (a ValueError saying a mesh is needed) since meshes are ported
    exc = ValueError if "steps_per_exchange" in kw else NotImplementedError
    with pytest.raises(exc, match=match):
        _solver(**kw)


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("impl", ["pallas", "pallas_stage", "pallas_step",
                                  "pallas_slab"])
def test_float64_3d_dispatch_matches_jax(impl, bc, order, parity):
    """Float64 3-D diffusion under a fused flavor: where the JAX package's
    fused rung declines, the port runs what JAX runs (the generic path,
    as ``_pallas_f32_gate`` sends float64 off the per-axis kernels) with
    JAX's reason; it raises only where that rung engages (float64
    storage on the float32 kernels, not ported)."""
    kw = dict(impl=impl, bc=bc, order=order, reference_parity=parity,
              dtype="float64")
    grid = (24, 16, 16)
    for mode in ("iters", "t_end"):
        want = JSolver(JConfig(grid=JGrid.make(*grid), **kw)).engaged_path(
            mode)
        if want["stepper"].startswith("fused"):
            with pytest.raises(NotImplementedError, match="float64"):
                PSolver(PConfig(grid=PGrid.make(*grid), **kw), device="cpu")
            continue
        got = PSolver(PConfig(grid=PGrid.make(*grid), **kw),
                      device="cpu").engaged_path(mode)
        assert (got["stepper"], got["fallback"]) == (
            want["stepper"], want["fallback"])


def test_unported_dimensions_raise():
    """1-D grids and the 2-D axisymmetric geometry are not ported; 2-D
    Cartesian grids are (``tests/test_torch_fused_diffusion2d.py``), and
    there ``pallas_slab``/``pallas_step`` run the whole-run stepper."""
    with pytest.raises(NotImplementedError, match="1-D"):
        PSolver(PConfig(grid=PGrid.make(16)), device="cpu")
    with pytest.raises(NotImplementedError, match="axisymmetric"):
        PSolver(PConfig(grid=PGrid.make(16, 12), geometry="axisymmetric"),
                device="cpu")
    for impl in ("pallas_slab", "pallas_step"):
        s = PSolver(PConfig(grid=PGrid.make(16, 12), impl=impl),
                    device="cpu")
        assert s.engaged_path()["stepper"] == "fused-whole-run"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = PGrid.make(24, 16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSolver(PConfig(grid=grid, impl="pallas"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_numpy(np.zeros((3, 3, 3), np.float32), 0.0)
    assert pbase.resolve_device("cpu") == torch.device("cpu")
