"""The port's advection–diffusion–reaction family against the JAX
package: K9's plain twin against the JAX kernel
(``ops/pallas/fused_adr.py``, Pallas interpret mode), the coefficient
``K(x)``, the generic path in float64, the slice as a whole, and the
rung dispatch.

Tolerances:

* K9's twin within ``8 eps`` of ``max|u|`` after one step and ``32 eps``
  after four (float32 eps; the JAX suite's fused bound is 32). Both
  evaluate the JAX kernel's term order; XLA's compilation of the
  interpret-mode kernel may contract multiply-adds the twin rounds
  separately, and the CPU's ``cos`` may round the coefficient's factors
  an ulp apart.
* The coefficient: ``2 eps`` (one ``cos`` and a product or two).
* The generic path in float64: ``1e-12`` relative to ``max|u|`` — the
  same operations in the same order.
* The solver on K9's twin against JAX's fused run: ``32 eps`` of
  ``max|u|``; against the analytic solution, the JAX suite's own bound.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.core.bc import Boundary as JBoundary
from multigpu_advectiondiffusion_tpu.models import adr as jadr
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_adr as jfa
from multigpu_advectiondiffusion_tpu.timestepping import cfl as jcfl
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary as PBoundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models import adr as padr
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import fused_adr as pfa
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh
from multigpu_advectiondiffusion_tpu_torch.timestepping import cfl as pcfl

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
VELOCITY = (0.5, -0.3, 0.0)  # (z, y, x): mixed signs and a zero axis


def _gap(got, want):
    """``max|got - want| / max|want|`` in float32 eps."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want))) \
        / EPS


# --------------------------------------------------------------------- #
# K9's twin against the JAX kernel
# --------------------------------------------------------------------- #
# (eps, lambda, wall value): every pairing of eps and lambda, each wall
# value twice
K9_CASES = [(0.0, 0.0, 0.0), (0.2, 0.3, 0.1), (0.2, 0.0, 0.0),
            (0.0, 0.3, 0.1)]


@pytest.mark.parametrize("eps,lam,wall", K9_CASES)
def test_k9_twin_matches_jax_kernel(eps, lam, wall):
    shape, spacing = (16, 12, 12), (0.1, 0.08, 0.12)
    dt = pcfl.advection_diffusion_dt(VELOCITY, 1.0 + eps, spacing,
                                     reaction=lam)
    u = np.random.default_rng(7).random(shape, dtype=np.float32)
    jst = jfa.FusedADRStepper(shape, jnp.float32, spacing, 1.0, VELOCITY,
                              lam, dt, 2, wall, kappa_variation=eps)
    pst = pfa.FusedADRStepper(shape, spacing, 1.0, VELOCITY, lam, dt, 2,
                              wall, "cpu", kappa_variation=eps)
    launches = pfa.fused_adr_stage.launches
    for steps, bound in ((1, 8), (4, 32)):
        want, wt = jst.run(jnp.asarray(u), jnp.float32(0.0), steps)
        got, gt = pst.run(torch.from_numpy(u), np.float32(0.0), steps)
        gap = _gap(got, want)
        print(f"K9 eps={eps} lam={lam} wall={wall}, {steps} step(s): "
              f"{gap:.2f} eps")
        assert gap <= bound
        assert gt == np.float32(wt)
    assert pfa.fused_adr_stage.launches == launches  # the CPU runs the twin


def test_k9_wrapper_checks_its_arguments():
    v = torch.zeros((9, 8, 7))
    cz, cy, cx = pfa.kappa_axes((5, 4, 3))
    kw = dict(taps=(0.0,) * 15, cz=cz, cy=cy, cx=cx, k0=1.0, eps=0.0,
              adv_p=(0.0,) * 3, adv_m=(0.0,) * 3, lam=0.0, a=0.0, b=1.0,
              band=2, bc_value=0.0)
    with pytest.raises(ValueError, match="different buffers"):
        pfa.fused_adr_stage(v, None, v, 0.1, **kw)
    with pytest.raises(TypeError, match="float32"):
        pfa.fused_adr_stage(v.double(), None, v.double().clone(), 0.1, **kw)
    with pytest.raises(ValueError, match="cy"):
        pfa.fused_adr_stage(v, None, v.clone(), 0.1,
                            **{**kw, "cy": torch.zeros(5)})
    with pytest.raises(ValueError, match=r"cz: expected \(5,\) on cpu"):
        pfa.fused_adr_stage(v, None, v.clone(), 0.1,
                            **{**kw, "cz": cz.to("meta")})


# --------------------------------------------------------------------- #
# The coefficient K(x)
# --------------------------------------------------------------------- #
def test_kappa_profile_matches_jax():
    shape = (16, 12, 10)
    want = np.asarray(jadr.kappa_profile(shape, shape, (0, 0, 0), 0.3,
                                         jnp.float32))
    got = padr.kappa_profile(shape, shape, (0, 0, 0), 0.3, torch.float32)
    assert got.dtype == torch.float32
    assert _gap(got, want) <= 2
    assert padr.kappa_profile(shape, shape, (0, 0, 0), 0.0,
                              torch.float32) is None


def test_k9_coefficient_factors():
    """K9's factors are the JAX kernel's ``chat`` in float32, and the
    product the twin forms per cell is the generic path's profile to
    rounding."""
    shape = (16, 12, 10)
    cz, cy, cx = pfa.kappa_axes(shape)
    pi = jnp.asarray(np.pi, jnp.float32)
    for c, n in zip((cz, cy, cx), shape):
        g = jnp.arange(n, dtype=jnp.float32)
        want = np.asarray(jnp.cos(pi * (g / (n - 1) - 0.5)))
        np.testing.assert_allclose(c.numpy(), want, rtol=0, atol=EPS)
    eps = 0.3
    kernel = ((cz * eps).reshape(-1, 1, 1) * cy.reshape(1, -1, 1)
              * cx.reshape(1, 1, -1) + 1.0)
    generic = padr.kappa_profile(shape, shape, (0, 0, 0), eps, torch.float32)
    assert _gap(kernel, generic) <= 2


# --------------------------------------------------------------------- #
# The generic path in float64
# --------------------------------------------------------------------- #
GENERIC = {
    "3d-upwind-o4-dirichlet": ((24, 16, 16), {"kappa_variation": 0.2,
                                             "reaction_rate": 0.3}),
    "3d-upwind-o2-periodic-noparity": ((24, 16, 16), {
        "order": 2, "bc": "periodic", "reference_parity": False,
        "velocity": (0.4, -0.2, 0.3)}),
    "3d-weno5-o4-periodic": ((24, 16, 16), {"advect": "weno5",
                                           "bc": "periodic",
                                           "kappa_variation": -0.3}),
    "2d-upwind-o2-dirichlet-noparity": ((40, 30), {
        "order": 2, "reference_parity": False, "reaction_rate": 0.5}),
    "2d-weno5-o4-dirichlet": ((40, 30), {"advect": "weno5",
                                        "velocity": (-0.5, 0.25),
                                        "kappa_variation": 0.2}),
}


def _pair(n, **kw):
    jcfg = jadr.ADRConfig(grid=JGrid.make(*n), **kw)
    js = jadr.ADRSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    ps = padr.ADRSolver(convert.adr_config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


@pytest.mark.parametrize("name", list(GENERIC))
def test_generic_path_matches_jax_float64(name):
    n, kw = GENERIC[name]
    js, ps, s0, p0 = _pair(n, dtype="float64", **kw)
    assert ps.engaged_path()["stepper"] == "generic-xla"
    assert ps.dt == js.dt
    want = js.run(s0, 3)
    got = ps.run(p0, 3)
    assert got.it == int(want.it) == 3
    assert got.t == np.float64(want.t)
    assert _gap(got.u.numpy(), want.u) * EPS <= 1e-12


def test_advection_diffusion_dt_matches_jax():
    for vel, k, dx, lam in [((0.5, -0.3, 0.0), 1.2, (0.1, 0.2, 0.05), 0.3),
                            ((0.0, 0.0), 0.7, (0.3, 0.1), 0.0),
                            ((1.5,), 2.0, (0.01,), 2.5)]:
        want = float(jcfl.advection_diffusion_dt(vel, k, dx, cfl=0.3,
                                                 safety=0.7, reaction=lam))
        got = pcfl.advection_diffusion_dt(vel, k, dx, cfl=0.3, safety=0.7,
                                          reaction=lam)
        assert abs(got - want) <= 1e-14 * want


def test_exact_solution_and_error_norms_match_jax():
    js, ps, s0, p0 = _pair((24, 16, 16), dtype="float64",
                           velocity=(0.6, 0.3, 0.15), reaction_rate=0.5)
    np.testing.assert_allclose(ps.exact_solution(0.1).numpy(),
                               np.asarray(s0.u), rtol=0, atol=1e-15)
    np.testing.assert_allclose(ps.exact_solution(0.17).numpy(),
                               np.asarray(js.exact_solution(0.17)),
                               rtol=1e-13, atol=1e-15)
    want = js.run(s0, 4)
    got = ps.run(p0, 4)
    np.testing.assert_allclose(tuple(ps.error_norms(got)),
                               tuple(js.error_norms(want)), rtol=1e-10)
    with pytest.raises(ValueError, match="spatially varying"):
        _pair((8, 8, 8), kappa_variation=0.1)[1].exact_solution(0.2)


# --------------------------------------------------------------------- #
# The slice as a whole
# --------------------------------------------------------------------- #
def test_fused_solver_matches_jax():
    """``impl="pallas"`` in both packages: JAX's K9 in interpret mode,
    the port's K9 twin (``run`` and ``advance_to``)."""
    js, ps, s0, p0 = _pair((16, 12, 12), dtype="float32", impl="pallas",
                           velocity=(0.0, -0.3, 0.5), kappa_variation=0.2,
                           reaction_rate=0.25)
    assert js.engaged_path()["stepper"] == "fused-stage"
    assert ps.engaged_path()["stepper"] == "fused-stage"
    assert ps.engaged_path("t_end")["stepper"] == "fused-stage"
    for got, want in ((ps.run(p0, 4), js.run(s0, 4)),
                      (ps.advance_to(p0, 0.1123),
                       js.advance_to(s0, 0.1123))):
        assert got.it == int(want.it)
        assert abs(float(got.t) - float(want.t)) <= 4 * EPS * float(want.t)
        gap = _gap(got.u.numpy(), want.u)
        print(f"ADR fused, {got.it} steps: {gap:.2f} eps of max|u|")
        assert gap <= 32


def test_fused_analytic_gaussian():
    """The JAX suite's ``test_adr_analytic_gaussian_fused_stage_f32`` on
    the port's K9 twin: L-inf < 2.5e-2 against the advecting, decaying
    heat kernel (first-order upwind smears)."""
    s = padr.ADRSolver(padr.ADRConfig(
        grid=PGrid.make(48, 32, 32, lengths=10.0),
        velocity=(0.6, 0.3, 0.15), reaction_rate=0.5, advect="upwind",
        dtype="float32", impl="pallas"), device="cpu")
    assert s.engaged_path()["stepper"] == "fused-stage"
    out = s.advance_to(s.initial_state(), 0.18)
    assert abs(float(out.t) - 0.18) <= 1e-6
    norms = s.error_norms(out)
    print(f"ADR analytic 48x32x32: {norms}")
    assert norms.linf < 2.5e-2


def test_2d_per_axis_matches_jax():
    """2-D ``impl="pallas"``: the fused rung declines (3-D only) and the
    Laplacian runs on the per-axis kernel (K11b twin here), in both
    packages."""
    js, ps, s0, p0 = _pair((40, 30), dtype="float32", impl="pallas",
                           kappa_variation=0.2, reaction_rate=0.25)
    want_path, got_path = js.engaged_path(), ps.engaged_path()
    assert got_path["stepper"] == want_path["stepper"] == "per-axis-pallas"
    assert got_path["fallback"] == want_path["fallback"]
    want, got = js.run(s0, 3), ps.run(p0, 3)
    gap = _gap(got.u.numpy(), want.u)
    print(f"ADR 2-D per-axis: {gap:.2f} eps of max|u|")
    assert gap <= 32


# --------------------------------------------------------------------- #
# Dispatch parity
# --------------------------------------------------------------------- #
IMPLS = ("xla", "pallas", "pallas_axis", "pallas_step", "pallas_slab",
         "pallas_stage")
# per array axis, the last axis first: (kind, value) of the other axes,
# then of the last
WALLS = {
    "dirichlet": (("dirichlet", 0.0), ("dirichlet", 0.0)),
    "periodic": (("periodic", 0.0), ("periodic", 0.0)),
    "mixed": (("dirichlet", 0.0), ("periodic", 0.0)),
    "dirichlet-values": (("dirichlet", 0.0), ("dirichlet", 0.5)),
}


def _walls(name, ndim):
    """One wall spec as each package's per-axis ``Boundary`` tuple."""
    rest, last = WALLS[name]
    kinds = [rest] * (ndim - 1) + [last]
    return (tuple(JBoundary(k, v) for k, v in kinds),
            tuple(PBoundary(k, v) for k, v in kinds))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_engaged_path_matches_jax(ndim, dtype):
    """Every impl but ``auto`` × upwind/WENO5 × O2/O4 × SSP-RK3/Euler ×
    walls (Dirichlet, periodic, mixed, non-uniform values) ×
    ``reference_parity``, in both modes: the same ``(stepper,
    fallback)``. Where an order-2 Laplacian runs in plain PyTorch under
    the per-axis rung, the port says so after JAX's reason (the JAX
    package falls back inside the operator without a word)."""
    n = (24, 16, 16) if ndim == 3 else (40, 30)
    o2_note = ("K11 computes the O4 Laplacian only; the order-2 "
               "Laplacian runs in plain PyTorch")
    count = 0
    for impl, advect, order, integ, walls, parity in itertools.product(
            IMPLS, ("upwind", "weno5"), (2, 4), ("ssp_rk3", "euler"),
            WALLS, (True, False)):
        jbc, pbc = _walls(walls, ndim)
        kw = dict(impl=impl, advect=advect, order=order, integrator=integ,
                  reference_parity=parity, dtype=dtype)
        js = jadr.ADRSolver(jadr.ADRConfig(grid=JGrid.make(*n), bc=jbc, **kw))
        ps = padr.ADRSolver(padr.ADRConfig(grid=PGrid.make(*n), bc=pbc,
                                           **kw), device="cpu")
        for mode in ("iters", "t_end"):
            want, got = js.engaged_path(mode), ps.engaged_path(mode)
            assert got["stepper"] == want["stepper"], (kw, walls, mode)
            fallback = want["fallback"]
            if (order == 2 and dtype == "float32" and impl != "xla"
                    and got["stepper"] == "per-axis-pallas"):
                fallback = o2_note if fallback is None else \
                    f"{fallback}; {o2_note}"
            assert got["fallback"] == fallback, (kw, walls, mode)
            count += 1
    assert count == 6 * 2 * 2 * 2 * len(WALLS) * 2 * 2


@pytest.mark.parametrize("kw,match", [
    ({"impl": "auto"}, "tuner"),
    # precision="bf16" runs on one device (K9's bf16 instance,
    # tests/test_torch_precision.py) and on a mesh: K9's sharded bf16
    # instance (tests/test_torch_precision_mesh.py)
    ({"precision": "bf16"}, "bf16"),
])
def test_unported_rungs_raise(kw, match):
    place = {"device": "cpu"}
    if "precision" in kw:
        place = {"mesh": pmesh.make_mesh(
            {"dz": 2}, devices=[torch.device("cpu")] * 2, timeout=60.0)}
        s = padr.ADRSolver(padr.ADRConfig(grid=PGrid.make(16, 12, 10),
                                          impl="pallas", **kw), **place)
        path = s.engaged_path()
        assert (path["stepper"], path["storage_dtype"]) == ("fused-stage",
                                                            "bfloat16")
        assert s.run(s.initial_state(), 1).it == 1
    else:
        with pytest.raises(NotImplementedError, match=match):
            padr.ADRSolver(padr.ADRConfig(grid=PGrid.make(16, 12, 10),
                                          **kw), **place)
    with pytest.raises(NotImplementedError, match="1-D"):
        padr.ADRSolver(padr.ADRConfig(grid=PGrid.make(16)), device="cpu")
