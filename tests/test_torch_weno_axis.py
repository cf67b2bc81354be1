"""The port's per-axis WENO rung on the CPU against the JAX package: the
K12/K12b twin against the JAX kernels
(``ops/pallas/weno.py::flux_divergence_pallas``, run in Pallas
interpret mode), both packages' gates, the ``flux_divergence``
dispatch, and the Burgers solver's ``impl="pallas_axis"`` runs and
engaged paths.

Tolerances, relative to float32 eps:

* WENO5 within ``8 eps`` of the JAX kernel. On random-normal data the
  scale is ``max|ref|``. On a smooth Gaussian it is the face scale
  ``max|f±| / dx``: there the divergence is the small difference of two
  faces of that size, so a face that rounds one ulp apart moves the
  divergence by that much, however small the divergence is.
* WENO7 within the JAX suite's own per-axis bound on its random-normal
  data (``rtol=1e-4, atol=1e-5 max|ref|``, ``tests/test_pallas.py``),
  and within ``32 eps`` of ``max|ref|`` on the solver's smooth initial
  state. The WENO7 betas are sums of 1e5-scale products that cancel, so
  the two packages' evaluations (XLA's CPU compiler contracts
  multiply-adds; the twin, like the kernel, rounds each one) part by
  more than WENO5's.
* Solver runs within ``32 eps * max|u|``.
"""

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
from multigpu_advectiondiffusion_tpu.ops.pallas import weno as jweno
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as cli
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PConfig,
    BurgersSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops import weno as pweno
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import weno as kweno
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_burgers import (
    _split,
)

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
FLUXES = {"burgers": {}, "linear": {"c": -0.7}, "buckley": {}}
SHAPES = {2: (16, 24), 3: (8, 12, 32)}
SWEEPS = [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2)]
DX = 0.05


def _padded(ndim, axis, order, data, seed):
    """A float32 field padded by the order's radius on ``axis``: numpy's
    standard normal, or a smooth Gaussian bump."""
    shape = list(SHAPES[ndim])
    shape[axis] += 2 * kweno.HALO[order]
    if data == "normal":
        return np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32)
    axes = np.meshgrid(*[np.linspace(-1.0, 1.0, n) for n in shape],
                       indexing="ij")
    return np.exp(-4.0 * sum(a * a for a in axes)).astype(np.float32)


def _both(up, axis, name, variant, order):
    want = np.asarray(jweno.flux_divergence_pallas(
        jnp.asarray(up), axis, DX, jflux.get(name, **FLUXES[name]), variant,
        order=order))
    fn = kweno.flux_divergence_2d if up.ndim == 2 else \
        kweno.flux_divergence_3d
    launches = fn.launches
    # the kernel's entry takes the interior and the two ghost slabs
    t, r = torch.from_numpy(up), kweno.HALO[order]
    n = t.shape[axis] - 2 * r
    got = kweno.flux_divergence_kernel(
        t.narrow(axis, r, n).contiguous(), axis, DX,
        pflux.get(name, **FLUXES[name]), variant, order,
        ghosts=(t.narrow(axis, 0, r).contiguous(),
                t.narrow(axis, n + r, r).contiguous()))
    assert fn.launches == launches  # the CPU runs the twin, no kernel
    assert got.shape == want.shape and got.dtype == torch.float32
    return got.numpy(), want


# --------------------------------------------------------------------- #
# The twin against the JAX kernel
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("data", ["normal", "smooth"])
@pytest.mark.parametrize("name", list(FLUXES))
@pytest.mark.parametrize("variant", ["js", "z"])
@pytest.mark.parametrize("ndim,axis", SWEEPS)
def test_weno5_twin_matches_jax_kernel(ndim, axis, variant, name, data):
    up = _padded(ndim, axis, 5, data, seed=10 * ndim + axis)
    got, want = _both(up, axis, name, variant, 5)
    if data == "normal":
        scale = float(np.max(np.abs(want)))
    else:
        P, M = _split(pflux.get(name, **FLUXES[name]), torch.from_numpy(up))
        scale = max(float(P.abs().max()), float(M.abs().max())) / DX
    gap = float(np.max(np.abs(got - want))) / scale / EPS
    print(f"WENO5-{variant} {ndim}-D axis {axis} {name} {data}: "
          f"{gap:.2f} eps")
    assert gap <= 8


@pytest.mark.parametrize("name", list(FLUXES))
@pytest.mark.parametrize("ndim,axis", SWEEPS)
def test_weno7_twin_matches_jax_kernel(ndim, axis, name):
    up = _padded(ndim, axis, 7, "normal", seed=20 + axis)
    got, want = _both(up, axis, name, "js", 7)
    scale = float(np.max(np.abs(want)))
    print(f"WENO7 {ndim}-D axis {axis} {name}: "
          f"{np.max(np.abs(got - want)) / scale / EPS:.2f} eps")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("ndim,axis", SWEEPS)
def test_weno7_twin_on_a_smooth_solver_state(ndim, axis):
    """The solver's Gaussian initial state, edge-padded by 4 on the sweep
    axis: the tighter bound."""
    n = (24, 16, 16) if ndim == 3 else (32, 24)
    u = np.asarray(JSolver(JConfig(grid=JGrid.make(*n), dtype="float32",
                                   weno_order=7)).initial_state().u)
    pad = [(0, 0)] * ndim
    pad[axis] = (4, 4)
    up = np.pad(u, pad, mode="edge")
    got, want = _both(up, axis, "burgers", "js", 7)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"WENO7 {ndim}-D axis {axis} on the solver state: "
          f"{gap / EPS:.2f} eps")
    assert gap <= 32 * EPS


@pytest.mark.parametrize("ndim,axis", SWEEPS)
def test_weno7_buckley_smooth_against_float64(ndim, axis):
    """WENO7-JS with the Buckley–Leverett flux on a smooth Gaussian, the
    case where value-form betas cancel away their digits in float32:
    the twin within ``8 eps`` of the face scale ``max|f±| / dx`` of the
    JAX kernel run in float64, and no further from the JAX float32
    result than that result is from float64, plus ``8 eps``."""
    up = _padded(ndim, axis, 7, "smooth", 0)
    fx = jflux.get("buckley")
    exact = np.asarray(jweno.flux_divergence_pallas(
        jnp.asarray(up, jnp.float64), axis, DX, fx, "js", order=7))
    got, jax32 = _both(up, axis, "buckley", "js", 7)
    P, M = _split(pflux.get("buckley"), torch.from_numpy(up))
    scale = max(float(P.abs().max()), float(M.abs().max())) / DX
    port_err = float(np.max(np.abs(got - exact))) / scale / EPS
    jax_err = float(np.max(np.abs(jax32 - exact))) / scale / EPS
    to_jax = float(np.max(np.abs(got - jax32))) / scale / EPS
    print(f"WENO7 buckley smooth {ndim}-D axis {axis}: port {port_err:.2f}"
          f" eps, JAX f32 {jax_err:.2f} eps, port-JAX {to_jax:.2f} eps")
    assert port_err <= 8
    assert to_jax <= jax_err + 8


def test_flux_divergence_dispatch():
    """``impl="pallas"`` runs the twin on the CPU, the sweep axis padded
    by its boundary; what the kernel does not compute raises instead of
    running something else."""
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.standard_normal((8, 12, 10)).astype(np.float32))
    fx = pflux.burgers()
    bc = Boundary("edge")
    for axis in range(3):
        up = torch.cat([u.narrow(axis, 0, 1).expand(
            *[3 if a == axis else s for a, s in enumerate(u.shape)]), u,
            u.narrow(axis, u.shape[axis] - 1, 1).expand(
            *[3 if a == axis else s for a, s in enumerate(u.shape)])],
            dim=axis)
        want = kweno.flux_divergence_reference(up, axis, DX, fx)
        got = pweno.flux_divergence(u, axis, DX, fx, bc=bc, impl="pallas")
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="variant 'z'"):
        pweno.flux_divergence(u, 0, DX, fx, order=7, variant="z", bc=bc,
                              impl="pallas")
    with pytest.raises(ValueError, match="float64"):
        pweno.flux_divergence(u.double(), 0, DX, fx, bc=bc, impl="pallas")
    with pytest.raises(ValueError, match="unknown WENO impl"):
        pweno.flux_divergence(u, 0, DX, fx, bc=bc, impl="mosaic")
    with pytest.raises(ValueError, match="exactly one ghost source"):
        kweno.flux_divergence_3d(u, 2, DX, fx)
    with pytest.raises(ValueError, match="cannot wrap"):
        kweno.flux_divergence_3d(u[:, :, :2], 2, DX, fx,
                                 bc=Boundary("periodic"))
    with pytest.raises(ValueError, match="device"):
        kweno.flux_divergence_3d(u.to("meta"), 0, DX, fx, bc=bc)


# (ndim, order, variant, shape, port, jax): the port's kernel has no
# fast-memory block to size; the JAX package's TPU VMEM model declines
# large 2-D grids and wide 3-D planes, and JAX then runs XLA inside
# flux_divergence() while engaged_path() still says per-axis-pallas
GATES = [
    (3, 5, "js", (512, 512, 512), True, True),
    (3, 7, "js", (512, 512, 512), True, True),
    (3, 5, "z", (35, 2000, 4000), True, False),
    (2, 5, "js", (400, 400), True, True),
    (2, 5, "js", (1001, 1001), True, False),
    (2, 7, "js", (400, 406), True, True),
    (2, 7, "js", (8192, 8192), True, False),
    (3, 7, "z", (64, 64, 64), False, False),
    (3, 3, "js", (64, 64, 64), False, False),
    (1, 5, "js", (1000,), False, False),
]


@pytest.mark.parametrize("ndim,order,variant,shape,port,jax_", GATES)
def test_gates_against_jax(ndim, order, variant, shape, port, jax_):
    assert kweno.supported(ndim, order, variant, shape) is port
    assert jweno.supported(ndim, order, variant, shape) is jax_
    assert not kweno.supported(ndim, order, variant, shape, torch.float64)


# --------------------------------------------------------------------- #
# The solver on the per-axis rung
# --------------------------------------------------------------------- #
def _pair(n, impl="pallas_axis", **kw):
    jcfg = JConfig(grid=JGrid.make(*n), dtype="float32", impl=impl, **kw)
    js = JSolver(jcfg)
    ps = PSolver(PConfig(grid=PGrid.make(*n), dtype="float32", impl=impl,
                         **kw), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


RUNS = {
    "3d-js": ((24, 16, 16), "pallas_axis", {}),
    "3d-z-fixed": ((24, 16, 16), "pallas_axis",
                   {"weno_variant": "z", "adaptive_dt": False}),
    "3d-weno7": ((24, 16, 16), "pallas_axis", {"weno_order": 7}),
    "3d-viscous": ((24, 16, 16), "pallas_axis", {"nu": 1e-5}),
    "3d-buckley": ((24, 16, 16), "pallas_axis", {"flux": "buckley"}),
    "3d-periodic": ((24, 16, 16), "pallas", {"bc": "periodic"}),
    "2d-js": ((32, 24), "pallas_axis", {}),
    "2d-weno7-viscous": ((32, 24), "pallas_axis",
                         {"weno_order": 7, "nu": 1e-5}),
    "2d-dirichlet": ((32, 24), "pallas", {"bc": "dirichlet"}),
    "3d-dirichlet": ((24, 16, 16), "pallas", {"bc": "dirichlet"}),
    "2d-periodic": ((32, 24), "pallas", {"bc": "periodic"}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_per_axis_run_matches_jax(name):
    n, impl, kw = RUNS[name]
    js, ps, s0, p0 = _pair(n, impl, **kw)
    assert js.engaged_path()["stepper"] == "per-axis-pallas"
    assert ps.engaged_path()["stepper"] == "per-axis-pallas"
    want = js.run(s0, 3)
    got = ps.run(p0, 3)
    assert got.it == int(want.it) == 3
    assert abs(float(got.t) - float(want.t)) <= 4 * EPS * float(want.t)
    gap = float(np.max(np.abs(got.u.numpy() - np.asarray(want.u)))) / float(
        np.max(np.abs(np.asarray(want.u))))
    print(f"{name}: max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    assert gap <= 32 * EPS


def test_per_axis_run_matches_port_generic():
    """Inside the port: the per-axis rung (e-form WENO5) against the
    generic path (q-form), at the JAX suite's fused-vs-generic bound."""
    _, ps, _, p0 = _pair((24, 16, 16), nu=1e-5)
    generic = PSolver(PConfig(grid=ps.grid, dtype="float32", nu=1e-5),
                      device="cpu")
    got, want = ps.run(p0, 5), generic.run(p0, 5)
    assert got.it == want.it == 5
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=1e-5,
                               atol=1e-6)


# both packages' engaged paths: the fused-declined configs the JAX
# package runs per-axis, the pinned per-axis rung, Burgers'
# pallas_step in 3-D (the fused stage kernel in both), WENO7 under a
# fused flavor whose fused rung declines, and float64 under pallas_axis
PARITY = {
    "periodic": ((24, 16, 16), {"impl": "pallas", "bc": "periodic"}),
    "dirichlet": ((24, 16, 16), {"impl": "pallas", "bc": "dirichlet"}),
    "euler": ((24, 16, 16), {"impl": "pallas_stage",
                             "integrator": "euler"}),
    "o2-viscous": ((24, 16, 16), {"impl": "pallas", "nu": 1e-5,
                                  "laplacian_order": 2}),
    "pallas_axis-3d": ((24, 16, 16), {"impl": "pallas_axis"}),
    "pallas_axis-3d-weno7": ((24, 16, 16), {"impl": "pallas_axis",
                                            "weno_order": 7}),
    "pallas_axis-2d": ((32, 24), {"impl": "pallas_axis"}),
    "pallas_step-3d": ((24, 16, 16), {"impl": "pallas_step"}),
    "pallas_step-3d-fixed": ((24, 16, 16), {"impl": "pallas_step",
                                            "adaptive_dt": False}),
    "weno7-periodic": ((24, 16, 16), {"impl": "pallas", "weno_order": 7,
                                      "bc": "periodic"}),
    "weno7-8192sq": ((8192, 8192), {"impl": "pallas", "weno_order": 7}),
    "pallas_axis-f64": ((24, 16, 16), {"impl": "pallas_axis",
                                       "dtype": "float64"}),
    "pallas_axis-f64-2d": ((32, 24), {"impl": "pallas_axis",
                                      "dtype": "float64"}),
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
    if name == "o2-viscous":
        # K11 declines the order-2 Laplacian, which the JAX package runs
        # in XLA without a word: the port names it
        assert got["fallback"].endswith(
            "the order-2 Laplacian runs in plain PyTorch")
    elif want["fallback"] is None:
        assert got["fallback"] is None
    else:
        first, *rest = got["fallback"].split("; ")
        jfirst, *jrest = want["fallback"].split("; ")
        if name == "weno7-8192sq":
            # each package's own memory gate (TPU VMEM, H100 L2) declines
            assert "exceeds the whole-run" in first
            assert "exceeds the whole-run" in jfirst
        else:
            assert first == jfirst
        assert rest == jrest


@pytest.mark.parametrize("verb,n", [("burgers3d", (16, 12, 10)),
                                    ("burgers2d", (20, 16))])
def test_cli_pallas_axis(verb, n, capsys):
    assert cli([verb, "--n", *map(str, n), "--iters", "2", "--nu", "1e-5",
                "--impl", "pallas_axis", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "kernel path        : per-axis-pallas (impl=pallas_axis)" in out
    assert "kernel launches    : none" in out  # the CPU runs no kernel
