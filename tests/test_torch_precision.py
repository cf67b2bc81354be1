"""The port's bf16 storage rungs against the JAX package, on the CPU.

``precision="bf16"`` keeps a float32 compute state in bfloat16 between
steps: the fused rungs' buffers are bf16 (K1, K2, K6 and K9's bf16
instances; here their plain twins, :func:`fused_diffusion.upcast_twin`
and :func:`fused_slab_run.rounded_step`) and the generic loop keeps the
packed ``(hi, lo)`` state with its compensation carry
(``models/base.py``). ``dtype="bfloat16"`` is the all-bf16 experiment.

Tolerances, each with its reason:

* a bf16-buffer twin against the JAX kernel with bf16 buffers (interpret
  mode): at most 1 bf16 ulp a cell. Both compute the same float32 value
  from the same bf16 inputs, up to the few float32 ulps by which the
  float32 kernels already differ (``tests/test_torch_fused_diffusion.py``,
  32 eps), and both round to nearest even once, so a cell can differ
  only where that float32 value sits within those ulps of a rounding
  tie. (On these states none does: the runs agree to the bit.)
* the packed generic loop against the JAX package's: ``2^-15`` of
  max|u|. The float32 steps differ by a few float32 ulps, and the
  packed state is ``hi + lo`` with ``lo`` rounded to bf16: its rounding
  is at most ``2^-9`` of ``|u - hi| <= 2^-9 |u|``, ``2^-18`` of |u|, per
  pack, on either side.
* ``dtype="bfloat16"`` on the generic path: at most 2 bf16 ulps a cell
  a step. Eager PyTorch rounds every operation to bf16; XLA may keep
  float32 intermediates inside a fusion, so each of a step's roundings
  may land on the other neighbour.

The states are bounded random fields (``[0, 1)``), as the fused WENO7
tests use, away from the subnormal tails where XLA's CPU backend
flushes what the port keeps.
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
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_adr as jfa
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_diffusion as jfd
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as cli_main
from multigpu_advectiondiffusion_tpu_torch.core.dtypes import (
    bf16_carry_enabled,
)
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.adr import (
    ADRConfig as PAConfig,
    ADRSolver as PASolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PConfig,
    DiffusionSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import EnsembleState
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import fused_adr as pfa
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as pfd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

R = pfd.R
BF16 = torch.bfloat16
G3 = ((24, 16, 16), (10.0, 5.0, 5.15))


def _ordered(a) -> np.ndarray:
    """bf16 values (held in float32) as integers that count bf16 ulps:
    the top 16 bits of the float32 pattern, sign-magnitude made
    monotonic (+0 and -0 both 0)."""
    bits = (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16
            ).astype(np.int64)
    return np.where(bits >= 0x8000, 0x8000 - bits, bits)


def bf16_ulps(got, want) -> int:
    """The largest distance, in bf16 ulps, between two arrays of
    bf16-representable values."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(got, np.asarray(
        torch.from_numpy(got).to(BF16).float()))
    return int(np.max(np.abs(_ordered(got) - _ordered(want))))


def _bf16_array(x) -> np.ndarray:
    """``x`` rounded to bf16, as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16).float(
        ).numpy()


def _random_state(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# --------------------------------------------------------------------- #
# K1's bf16 twin, a stage at a time, against the JAX kernel's bf16 stage
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bc_value", [0.0, 0.3])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k1_bf16_stage_twin_matches_jax(kind, bc_value):
    nz, ny, nx = 8, 10, 12
    spacing, diffusivity, dt, band = (0.3, 0.25, 0.2), (1.0,) * 3, 2e-3, 2
    a, b = pfd.STAGES[kind]
    padded = (nz + 2 * R, ny + 2 * R, nx + 2 * R)
    ghost = pfd.bf16_value(bc_value)
    v = np.full(padded, ghost, np.float32)
    u = np.full(padded, ghost, np.float32)
    v[R:-R, R:-R, R:-R] = _bf16_array(_random_state((nz, ny, nx), kind))
    u[R:-R, R:-R, R:-R] = _bf16_array(_random_state((nz, ny, nx), 9 + kind))

    out = torch.from_numpy(u.copy() if kind == 2 else v.copy()).to(BF16)
    vt, ut = torch.from_numpy(v).to(BF16), torch.from_numpy(u).to(BF16)
    before = pfd.fused_stage_bf16.launches
    got = pfd.fused_stage_bf16(
        vt, None if kind == 0 else (out if kind == 2 else ut), out, dt,
        taps=pfd.stage_taps(spacing, diffusivity), a=a, b=b, band=band,
        bc_value=bc_value)
    assert got is out and pfd.fused_stage_bf16.launches == before

    jshape = (nz + 2 * R, 16, 128)  # bf16's (16, 128) tile

    def embed(x):
        full = np.full(jshape, ghost, np.float32)
        full[:, :ny + 2 * R, :nx + 2 * R] = x
        return jnp.asarray(full).astype(jnp.bfloat16)

    scales = [diffusivity[i] / (12.0 * spacing[i] ** 2) for i in range(3)]
    src = ("none", "operand", "target")[kind]
    stage = jfd._make_stage(jshape, (nz, ny, nx), jnp.bfloat16, bz=4,
                            scales=scales, a=a, b=b, band=band,
                            bc_value=bc_value, u_source=src,
                            compute_dtype=jnp.float32)
    dt_arr = jnp.asarray([dt], jnp.float32)
    if src == "none":
        want = stage(dt_arr, embed(v), embed(v))
    elif src == "operand":
        want = stage(dt_arr, embed(v), embed(u), embed(v))
    else:
        want = stage(dt_arr, embed(v), embed(u))
    want = np.asarray(want.astype(jnp.float32))[
        :nz + 2 * R, :ny + 2 * R, :nx + 2 * R]
    assert bf16_ulps(out.float().numpy(), want) <= 1
    # the ghost ring keeps its bf16 wall value
    ring = np.ones(padded, bool)
    ring[R:-R, R:-R, R:-R] = False
    assert (out.float().numpy()[ring] == ghost).all()


def test_bf16_wrappers_check_their_buffers():
    v = torch.zeros((9, 8, 7), dtype=BF16)
    kw = dict(taps=(0.0,) * 15, a=0.0, b=1.0, band=2, bc_value=0.0)
    with pytest.raises(TypeError, match="bfloat16"):
        pfd.fused_stage_bf16(v.float(), None, v.float().clone(), 1e-3, **kw)
    with pytest.raises(ValueError, match="different buffers"):
        pfd.fused_stage_bf16(v, None, v, 1e-3, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        psr.slab_run_diffusion_bf16(v.float(), v.float().clone(), 1, 1e-3,
                                    taps=(0.0,) * 15, band=2, bc_value=0.0)
    # the split schedule's operands share the buffers' bf16
    with pytest.raises(TypeError, match="bfloat16"):
        pfd.fused_stage_bf16(v, None, v.clone(), 1e-3, lo=v[:R].float(),
                             **kw)
    # a shard's stepper runs the sharded bf16 instances (K1's and K9's)
    st = pfd.FusedDiffusionStepper((4, 4, 4), (1.0,) * 3, (1.0,) * 3, 1e-3,
                                   2, 0.0, "cpu", global_shape=(8, 4, 4),
                                   dtype=BF16)
    assert st.sharded and st.stage is pfd.fused_stage_bf16


# --------------------------------------------------------------------- #
# Whole runs: the port's bf16 rungs against the JAX package's
# --------------------------------------------------------------------- #
def _diffusion_pair(precision="bf16", dtype="float32", impl="pallas_stage",
                    seed=0):
    n, lengths = G3
    kw = dict(dtype=dtype, impl=impl, precision=precision)
    js = JSolver(JConfig(grid=JGrid.make(*n, lengths=lengths), **kw))
    ps = PSolver(PConfig(grid=PGrid.make(*n, lengths=lengths), **kw),
                 device="cpu")
    u0 = _random_state(js.grid.shape, seed)
    if dtype == "bfloat16":
        u0 = _bf16_array(u0)
    s0 = js.initial_state()
    s0 = s0._replace(u=jnp.asarray(u0).astype(s0.u.dtype))
    p0 = convert.state_from_numpy(u0, np.float32(s0.t), 0, device="cpu",
                                  dtype=dtype)
    return js, ps, s0, p0


def _as_f32(u):
    if isinstance(u, torch.Tensor):
        return u.float().numpy()
    return np.asarray(u.astype(jnp.float32))


@pytest.mark.parametrize("impl,stepper", [
    ("pallas_stage", "fused-stage"), ("pallas_slab", "fused-whole-run-slab"),
])
def test_bf16_diffusion_runs_match_jax(impl, stepper):
    """K1's and K2's bf16 twins, ``run(3)``: the facing state float32, the
    buffers bf16, one rounding a stage (K1) or a step (K2), as the JAX
    kernels round."""
    js, ps, s0, p0 = _diffusion_pair(impl=impl)
    for got in (ps.engaged_path(), js.engaged_path()):
        assert (got["stepper"], got["storage_dtype"], got["precision"]) == (
            stepper, "bfloat16", "bf16")
    want, got = js.run(s0, 3), ps.run(p0, 3)
    assert got.u.dtype == torch.float32 and got.t == np.float32(want.t)
    assert bf16_ulps(_as_f32(got.u), _as_f32(want.u)) <= 1


def test_bf16_dtype_runs_k1_as_jax():
    """``dtype="bfloat16"``: K1's bf16 instance on a bf16 state."""
    js, ps, s0, p0 = _diffusion_pair(precision="native", dtype="bfloat16",
                                     impl="pallas")
    assert ps.engaged_path()["stepper"] == "fused-stage"
    want, got = js.run(s0, 3), ps.run(p0, 3)
    assert got.u.dtype == BF16 and got.t == np.float32(want.t)
    assert bf16_ulps(_as_f32(got.u), _as_f32(want.u)) <= 1


def test_k2_bf16_twin_rounds_once_a_step():
    """K2's bf16 twin: a step is the float32 step on the upcast buffer,
    rounded once (not three K1 bf16 stages), and the run ping-pongs."""
    _, ps, _, p0 = _diffusion_pair(impl="pallas_slab")
    st = ps._fused_stepper()
    S0 = st.embed(p0.u)
    assert S0.dtype == BF16
    out = psr.slab_run_diffusion_bf16(S0.clone(), S0.clone(), 1, st.dt,
                                      taps=st.taps, band=st.band,
                                      bc_value=st.bc_value)
    ref = psr.fds.step_reference(S0.float(), S0.float(), st.dt,
                                 taps=st.taps, band=st.band,
                                 bc_value=st.bc_value)
    assert torch.equal(pfd._interior(out).float(),
                       pfd._interior(ref).to(BF16).float())
    three = pfd.FusedDiffusionStepper(
        st.interior_shape, ps.grid.spacing, [1.0] * 3, st.dt, st.band,
        st.bc_value, "cpu", dtype=BF16, storage_dtype=torch.float32)
    per_stage, _ = three.run(p0.u, np.float32(0), 1)
    assert not torch.equal(per_stage, st.extract(out))


def test_k9_bf16_runs_match_jax():
    """K9's bf16 twin: the stepper's stages on bf16 buffers against the
    JAX kernel's (``compute_dtype`` f32), a run of 3 steps."""
    shape, spacing, wall = (16, 12, 12), (0.1, 0.08, 0.12), 0.1
    vel, eps, lam = (0.5, -0.3, 0.0), 0.2, 0.3
    dt = float(np.float32(2e-4))
    u = _random_state(shape, 7)
    jst = jfa.FusedADRStepper(shape, jnp.bfloat16, spacing, 1.0, vel, lam,
                              dt, 2, wall, kappa_variation=eps,
                              storage_dtype=jnp.float32)
    pst = pfa.FusedADRStepper(shape, spacing, 1.0, vel, lam, dt, 2, wall,
                              "cpu", kappa_variation=eps, dtype=BF16,
                              storage_dtype=torch.float32)
    before = pfa.fused_adr_stage_bf16.launches
    for steps in (1, 3):
        want, wt = jst.run(jnp.asarray(u), jnp.float32(0.0), steps)
        got, gt = pst.run(torch.from_numpy(u), np.float32(0.0), steps)
        assert got.dtype == torch.float32 and gt == np.float32(wt)
        assert bf16_ulps(got.numpy(), _as_f32(want)) <= 1
    assert pfa.fused_adr_stage_bf16.launches == before


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k9_bf16_stage_twin_matches_jax(kind):
    """One K9 stage on bf16 buffers against the JAX kernel's, the ADR
    solver's own physics (eps, lambda, mixed velocities)."""
    n = (10, 12, 16)
    kw = dict(kappa_variation=0.2, reaction_rate=0.25, velocity=(0.5, -0.3,
                                                                 0.2))
    ps = PASolver(PAConfig(grid=PGrid.make(16, 12, 10), impl="pallas",
                           precision="bf16", **kw), device="cpu")
    st = ps._fused_stepper()
    assert st.dtype == BF16
    a, b = pfd.STAGES[kind]
    v = st.embed(torch.from_numpy(_random_state(n, kind)))
    u = st.embed(torch.from_numpy(_random_state(n, 5 + kind)))
    out = (u if kind == 2 else v).clone()
    pfa.fused_adr_stage_bf16(v, None if kind == 0 else out if kind == 2
                             else u, out, st.dt, a=a, b=b,
                             **st.stage_kwargs())
    jshape = (n[0] + 2 * R, 16, 128)

    def embed(x):
        full = np.full(jshape, st.bc_value, np.float32)
        full[:, :n[1] + 2 * R, :n[2] + 2 * R] = x.float().numpy()
        return jnp.asarray(full).astype(jnp.bfloat16)

    phys = dict(
        lap_scales=tuple(1.0 / (12.0 * dx * dx) for dx in ps.grid.spacing),
        adv_p=st.adv_p, adv_m=st.adv_m, lam=st.lam, k0=st.k0, k_eps=st.eps,
        band=st.band, bc_value=st.bc_value)
    src = ("none", "operand", "target")[kind]
    stage = jfa._make_stage(jshape, n, jnp.bfloat16, bz=2, a=a, b=b,
                            u_source=src, compute_dtype=jnp.float32, **phys)
    dt_arr = jnp.asarray([st.dt], jnp.float32)
    if src == "none":
        want = stage(dt_arr, embed(v), embed(v))
    elif src == "operand":
        want = stage(dt_arr, embed(v), embed(u), embed(v))
    else:
        want = stage(dt_arr, embed(v), embed(u))
    want = _as_f32(want)[:n[0] + 2 * R, :n[1] + 2 * R, :n[2] + 2 * R]
    assert bf16_ulps(out.float().numpy(), want) <= 1


def test_k9_copy_width_rule():
    """The bf16 instance's copies: 16 bytes (8 values) where the row pitch
    nx + 4 is a multiple of 8, else 8 or 4 bytes as it allows, else one
    value; float32's rule is unchanged."""
    assert pfa.copy_width(508, 2) == 8      # pitch 512
    assert pfa.copy_width(204, 2) == 8      # 208
    assert pfa.copy_width(8, 2) == 4        # 12
    assert pfa.copy_width(10, 2) == 2       # 14
    assert pfa.copy_width(11, 2) == 1       # 15
    for nx in (508, 8, 10, 11):
        assert pfa.copy_width(nx, 4) == pfa.copy_floats(nx)


# --------------------------------------------------------------------- #
# The packed generic loop: pack/unpack, the carry, the runs
# --------------------------------------------------------------------- #
def test_carry_toggle_env(monkeypatch):
    monkeypatch.delenv("TPUCFD_BF16_NO_CARRY", raising=False)
    assert bf16_carry_enabled()
    for val in ("1", "true", "YES"):
        monkeypatch.setenv("TPUCFD_BF16_NO_CARRY", val)
        assert not bf16_carry_enabled()
    monkeypatch.setenv("TPUCFD_BF16_NO_CARRY", "0")
    assert bf16_carry_enabled()


@pytest.mark.parametrize("carry", [True, False])
def test_pack_unpack_bit_equal_to_jax(carry, monkeypatch):
    if carry:
        monkeypatch.delenv("TPUCFD_BF16_NO_CARRY", raising=False)
    else:
        monkeypatch.setenv("TPUCFD_BF16_NO_CARRY", "1")
    js, ps, _, _ = _diffusion_pair(impl="xla")
    rng = np.random.default_rng(3)
    u = (rng.standard_normal(js.grid.shape) * 1.7).astype(np.float32)
    # signed zeros and two ties; no subnormal (XLA's CPU backend flushes
    # the subnormal u - f32(hi) that the port keeps)
    u.flat[:4] = (0.0, -0.0, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8))
    jp = js._bf16_pack(jnp.asarray(u))
    pp = ps._bf16_pack(torch.from_numpy(u))
    assert len(jp) == len(pp) == (2 if carry else 1)
    for j, p in zip(jp, pp):
        assert p.dtype == BF16
        np.testing.assert_array_equal(
            p.view(torch.int16).numpy(),
            np.asarray(j).view(np.int16))
    np.testing.assert_array_equal(
        ps._bf16_unpack(pp).numpy().view(np.uint32),
        np.asarray(js._bf16_unpack(jp)).view(np.uint32))


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_compensated_accumulation_bounded(monkeypatch):
    """The port's copy of the JAX suite's test (``tests/test_precision.py
    ::test_compensated_accumulation_bounded``, same grid and bounds): on
    the generic loop the compensated bf16 run stays within a few bf16
    round-offs of the native float32 run, while the uncompensated one is
    more than 20x further off and grows with the horizon."""
    cfg32 = PConfig(grid=PGrid.make(16, 14, 12, lengths=10.0),
                    dtype="float32", impl="xla")
    cfg16 = dataclasses.replace(cfg32, precision="bf16")

    def run(cfg, iters):
        s = PSolver(cfg, device="cpu")
        return s.run(s.initial_state(), iters).u.numpy()

    errs = {}
    for iters in (60, 120):
        ref = run(cfg32, iters)
        monkeypatch.delenv("TPUCFD_BF16_NO_CARRY", raising=False)
        carry = _rel_l2(run(cfg16, iters), ref)
        monkeypatch.setenv("TPUCFD_BF16_NO_CARRY", "1")
        nocarry = _rel_l2(run(cfg16, iters), ref)
        errs[iters] = (carry, nocarry)
        print(f"{iters} steps: carry {carry:.3e}, no carry {nocarry:.3e}")
        assert carry < 1e-4, (iters, carry)
        assert nocarry > 20 * carry, (iters, carry, nocarry)
    assert errs[120][1] > 1.5 * errs[60][1]


@pytest.mark.parametrize("mode", ["iters", "t_end"])
def test_packed_generic_run_matches_jax(mode, monkeypatch):
    """The packed generic loop (``impl="xla"``, and ``"pallas_step"``,
    which declines to it with JAX's reason) against the JAX package's,
    ``run(3)`` and ``advance_to``, within ``2^-15`` of max|u|."""
    monkeypatch.delenv("TPUCFD_BF16_NO_CARRY", raising=False)
    for impl in ("xla", "pallas_step"):
        js, ps, s0, p0 = _diffusion_pair(impl=impl)
        if mode == "iters":
            want, got = js.run(s0, 3), ps.run(p0, 3)
        else:
            te = float(s0.t) + 2.5 * js.dt
            want, got = js.advance_to(s0, te), ps.advance_to(p0, te)
        assert got.it == int(want.it) and got.t == np.float32(want.t)
        assert got.u.dtype == torch.float32
        w = np.asarray(want.u)
        gap = float(np.max(np.abs(got.u.numpy() - w)) / np.max(np.abs(w)))
        print(f"{impl} {mode}: {gap * 2 ** 15:.3f} x 2^-15 of max|u|")
        assert gap <= 2.0 ** -15


def test_bf16_dtype_generic_run_matches_jax():
    """``dtype="bfloat16"`` on the generic path (the per-axis kernels are
    float32-only): within 2 bf16 ulps a cell a step of the JAX run."""
    js, ps, s0, p0 = _diffusion_pair(precision="native", dtype="bfloat16",
                                     impl="pallas_axis")
    assert ps.engaged_path() == js.engaged_path()
    want, got = js.run(s0, 3), ps.run(p0, 3)
    assert got.u.dtype == BF16 and got.t == np.float32(want.t)
    ulps = bf16_ulps(_as_f32(got.u), _as_f32(want.u))
    print(f"dtype=bfloat16 generic run(3): {ulps} bf16 ulps")
    assert ulps <= 2 * 3


# --------------------------------------------------------------------- #
# Validation, meshes, conversion, the CLI
# --------------------------------------------------------------------- #
def test_validation_texts_match_jax():
    grid = dict(grid=PGrid.make(16, 14, 12, lengths=10.0))
    with pytest.raises(ValueError, match="redundant"):
        PSolver(PConfig(dtype="bfloat16", precision="bf16", **grid),
                device="cpu")
    with pytest.raises(ValueError, match="must be float32, got float64"):
        PSolver(PConfig(dtype="float64", precision="bf16", **grid),
                device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        PConfig(precision="fp8", **grid)
    # on a mesh the same configs run the sharded bf16 rungs (the JAX
    # package's; tests/test_torch_precision_mesh.py holds the runs)
    for cls, cfg, stepper in (
            (PASolver, PAConfig(precision="bf16", **grid), "generic-xla"),
            (PSolver, PConfig(precision="bf16", impl="pallas", **grid),
             "fused-stage"),
            (PSolver, PConfig(dtype="bfloat16", impl="pallas", **grid),
             "fused-stage")):
        mesh = pmesh.make_mesh({"dz": 2}, devices=[torch.device("cpu")] * 2,
                               timeout=30.0)
        s = cls(cfg, mesh=mesh)
        path = s.engaged_path()
        assert (path["stepper"], path["storage_dtype"]) == (stepper,
                                                            "bfloat16")
        assert s.run(s.initial_state(), 1).u.dtype == s.dtype
    mesh = pmesh.make_mesh({"dz": 2}, devices=[torch.device("cpu")] * 2,
                           timeout=30.0)
    s = PSolver(PConfig(dtype="bfloat16", impl="xla", **grid), mesh=mesh)
    assert s.run(s.initial_state(), 1).u.dtype == BF16
    with pytest.raises(ValueError, match="single-run rung"):
        PSolver(PConfig(precision="bf16", **grid),
                device="cpu").run_ensemble(EnsembleState(
                    u=torch.zeros((2, 12, 14, 16)),
                    t=np.zeros(2, np.float32), it=np.zeros(2, np.int32)), 1)


def test_convert_carries_bf16_states():
    u = _bf16_array(_random_state((4, 5, 6), 1))
    s = convert.state_from_numpy(u, 0.25, 3, device="cpu", dtype="bfloat16")
    assert s.u.dtype == BF16 and s.t == np.float32(0.25) and s.it == 3
    back, t, it = convert.state_to_numpy(s)
    assert back.dtype == np.float32 and np.array_equal(back, u)
    with pytest.raises(ValueError, match="not bf16-representable"):
        convert.state_from_numpy(u + 1e-4, 0.0, device="cpu",
                                 dtype="bfloat16")
    with pytest.raises(TypeError, match="float32 array"):
        convert.state_from_numpy(u.astype(np.float64), 0.0, device="cpu",
                                 dtype="bfloat16")


@pytest.mark.parametrize("flags,summary", [
    (["--precision", "bf16", "--impl", "pallas_stage"],
     "float32 (storage bfloat16, precision=bf16)"),
    (["--dtype", "bfloat16", "--impl", "pallas"], "bfloat16"),
    (["--precision", "bf16", "--impl", "xla"],
     "float32 (storage bfloat16, precision=bf16)"),
])
def test_cli_precision_flags(flags, summary, capsys):
    assert cli_main(["diffusion3d", "--n", "12", "10", "8", "--iters", "3",
                     "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    assert f" dtype              : {summary}\n" in out
    assert ("fused-stage" in out) == ("xla" not in flags)
