"""The port's per-axis O4 Laplacian rung on the CPU against the JAX
package: the K11/K11b twin against the JAX kernels
(``ops/pallas/laplacian.py::laplacian_o4_3d/_2d``, run in Pallas
interpret mode), both packages' gates, the ``laplacian`` dispatch, and
the diffusion solver's ``impl="pallas_axis"`` runs and engaged paths.

Tolerances: the twin within ``4 eps_f32 * max|ref|`` of the JAX kernel
(both evaluate the same taps in the same order; XLA's compilation of the
interpret-mode kernel may contract multiply-adds that the twin rounds
separately). Solver runs within ``32 eps_f32 * max|u|``, the JAX suite's
fused bound (``tests/test_pallas.py``).
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
from multigpu_advectiondiffusion_tpu.ops.pallas import laplacian as jlap
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as cli
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary, pad_axis
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PConfig,
    DiffusionSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import laplacian as plap
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    laplacian as klap,
)

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)


def _gap(got, want) -> float:
    """``max|got - want| / max|want|`` in float32 eps, printed (``-s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|ref|")
    return gap / EPS


# --------------------------------------------------------------------- #
# The twin against the JAX kernel (shapes of tests/test_pallas.py)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(16, 24), (8, 12, 32), (23, 29, 37)])
@pytest.mark.parametrize("coeffs", ["uniform", "per-axis"])
def test_twin_matches_jax_kernel(shape, coeffs):
    ndim = len(shape)
    rng = np.random.default_rng(len(shape))
    up = rng.standard_normal(tuple(n + 4 for n in shape)).astype(np.float32)
    if coeffs == "uniform":
        spacing, k = [0.1] * ndim, [0.7] * ndim
    else:
        spacing, k = [0.1, 0.07, 0.13][:ndim], [0.7, 1.3, 0.4][:ndim]
    jfn = jlap.laplacian_o4_3d if ndim == 3 else jlap.laplacian_o4_2d
    pfn = klap.laplacian_o4_3d if ndim == 3 else klap.laplacian_o4_2d
    want = np.asarray(jfn(jnp.asarray(up), spacing, k))
    launches = pfn.launches
    got = pfn(torch.from_numpy(up), spacing, k)
    assert pfn.launches == launches  # the CPU runs the twin, no kernel
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _gap(got.numpy(), want) <= 4


def test_twin_is_the_generic_laplacian():
    """On one padded array the twin and the generic path's sum agree to
    the bit: the per-axis rung changes no arithmetic, only where it
    runs."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((9, 10, 11)).astype(np.float32))
    bc = Boundary("dirichlet", 0.25)

    def padder(x, axis, halo):
        return pad_axis(x, axis, halo, bc)

    spacing, k = (0.1, 0.2, 0.3), (1.0, 0.5, 2.0)
    generic = plap.laplacian(u, spacing, padder, k, impl="xla")
    per_axis = plap.laplacian(u, spacing, padder, k, impl="pallas")
    assert torch.equal(generic, per_axis)


def test_kernel_rejects_what_it_cannot_compute():
    u = torch.zeros((6, 7))
    with pytest.raises(ValueError, match="order 2"):
        plap.laplacian(u, (0.1, 0.1), lambda x, a, h: x, order=2,
                       impl="pallas")
    with pytest.raises(ValueError, match="unknown laplacian impl"):
        plap.laplacian(u, (0.1, 0.1), lambda x, a, h: x, impl="mosaic")
    with pytest.raises(TypeError, match="float32"):
        klap.laplacian_o4_2d(torch.zeros((8, 9), dtype=torch.float64),
                             (0.1, 0.1), (1.0, 1.0))
    with pytest.raises(ValueError, match="padded 3-D"):
        klap.laplacian_o4_3d(torch.zeros((8, 9)), (0.1,) * 3, (1.0,) * 3)
    with pytest.raises(ValueError, match="device"):
        klap.laplacian_o4_2d(torch.zeros((8, 9), device="meta"),
                             (0.1, 0.1), (1.0, 1.0))


# --------------------------------------------------------------------- #
# The gates: the port's supported() and the JAX package's
# --------------------------------------------------------------------- #
# (shape, order, port, jax): the port's kernel has no fast-memory block
# to size, so it takes every 2-D and 3-D float32 O4 problem; the JAX
# package's TPU VMEM model declines the wide planes and large 2-D grids,
# and JAX then runs XLA inside laplacian() while engaged_path() still
# says per-axis-pallas
GATES = [
    ((400, 200, 206), 4, True, True),
    ((512, 512, 512), 4, True, True),
    ((35, 986, 1601), 4, True, True),
    ((35, 2000, 4000), 4, True, False),  # tests/test_pallas.py:160
    ((1001, 1001), 4, True, True),
    ((8192, 8192), 4, True, False),
    ((64, 64, 64), 2, False, False),
    ((4096,), 4, False, False),
]


@pytest.mark.parametrize("shape,order,port,jax_", GATES)
def test_gates_against_jax(shape, order, port, jax_):
    assert klap.supported(shape, order, 4) is port
    assert jlap.supported(shape, order, 4) is jax_
    assert not klap.supported(shape, order, 8)


# --------------------------------------------------------------------- #
# The solver on the per-axis rung
# --------------------------------------------------------------------- #
def _pair(n, lengths, impl="pallas_axis", **kw):
    jcfg = JConfig(grid=JGrid.make(*n, lengths=lengths), dtype="float32",
                   impl=impl, **kw)
    js = JSolver(jcfg)
    ps = PSolver(PConfig(grid=PGrid.make(*n, lengths=lengths),
                         dtype="float32", impl=impl, **kw), device="cpu")
    s0 = js.initial_state()
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


RUNS = {
    "3d": ((24, 16, 16), (10.0, 5.0, 5.15), "pallas_axis", {}),
    "3d-periodic": ((24, 16, 16), 10.0, "pallas", {"bc": "periodic"}),
    "3d-no-parity": ((19, 13, 11), 2.0, "pallas",
                     {"reference_parity": False}),
    "2d": ((40, 30), 10.0, "pallas_axis", {}),
    "2d-edge": ((40, 30), 10.0, "pallas", {"bc": "edge"}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_per_axis_run_matches_jax(name):
    n, lengths, impl, kw = RUNS[name]
    js, ps, s0, p0 = _pair(n, lengths, impl, **kw)
    assert js.engaged_path()["stepper"] == "per-axis-pallas"
    assert ps.engaged_path()["stepper"] == "per-axis-pallas"
    want = js.run(s0, 3)
    got = ps.run(p0, 3)
    assert got.it == int(want.it) == 3
    assert got.t == np.float32(want.t)
    assert _gap(got.u.numpy(), want.u) <= 32


def test_per_axis_advance_to_matches_jax():
    js, ps, s0, p0 = _pair((24, 16, 16), 10.0)
    t_end = float(s0.t) + 2.5 * js.dt
    want = js.advance_to(s0, t_end)
    got = ps.advance_to(p0, t_end)
    assert ps.engaged_path("t_end")["stepper"] == "per-axis-pallas"
    assert got.it == int(want.it) == 3
    assert _gap(got.u.numpy(), want.u) <= 32


def test_per_axis_run_equals_port_generic():
    """Inside the port the per-axis rung and the generic path compute the
    same sums on the CPU: equal to the bit."""
    _, ps, _, p0 = _pair((19, 13, 11), 2.0)
    generic = PSolver(dataclasses.replace(ps.cfg, impl="xla"), device="cpu")
    got, want = ps.run(p0, 4), generic.run(p0, 4)
    assert got.t == want.t and torch.equal(got.u, want.u)


# configs on which both packages' engaged paths are compared: the
# fused-declined configs the JAX package runs per-axis, the pinned
# per-axis rung, and float64 under it
PARITY = {
    "periodic": ((24, 16, 16), {"impl": "pallas", "bc": "periodic"}),
    "no-parity": ((24, 16, 16), {"impl": "pallas",
                                 "reference_parity": False}),
    "edge": ((24, 16, 16), {"impl": "pallas", "bc": "edge"}),
    "source": ((24, 16, 16), {"impl": "pallas_stage",
                              "source": lambda u: 0.0 * u}),
    "euler": ((24, 16, 16), {"impl": "pallas_step", "integrator": "euler"}),
    "pallas_axis-3d": ((24, 16, 16), {"impl": "pallas_axis"}),
    "pallas_axis-2d": ((40, 30), {"impl": "pallas_axis"}),
    "pallas_axis-f64": ((24, 16, 16), {"impl": "pallas_axis",
                                       "dtype": "float64"}),
    "pallas_axis-f64-2d": ((40, 30), {"impl": "pallas_axis",
                                      "dtype": "float64"}),
    "f64-2d": ((40, 30), {"impl": "pallas", "dtype": "float64"}),
}


@pytest.mark.parametrize("mode", ["iters", "t_end"])
@pytest.mark.parametrize("name", list(PARITY))
def test_engaged_path_matches_jax(name, mode):
    n, kw = PARITY[name]
    kw = {"dtype": "float32", **kw}
    want = JSolver(JConfig(grid=JGrid.make(*n, lengths=10.0),
                           **kw)).engaged_path(mode)
    got = PSolver(PConfig(grid=PGrid.make(*n, lengths=10.0), **kw),
                  device="cpu").engaged_path(mode)
    assert got["stepper"] == want["stepper"]
    if want["fallback"] is None:
        assert got["fallback"] is None
    else:
        assert (got["fallback"].split(";")[0]
                == want["fallback"].split(";")[0])


@pytest.mark.parametrize("impl", ["pallas", "pallas_axis"])
def test_order2_names_the_plain_laplacian(impl):
    """Where K11 declines the operator (order 2), the JAX package runs
    XLA inside ``laplacian()`` and reports ``per-axis-pallas`` with no
    word of it; the port reports the same rung and names the decline,
    and the run matches the generic path to the bit."""
    grid = PGrid.make(40, 30, lengths=10.0)
    s = PSolver(PConfig(grid=grid, impl=impl, order=2), device="cpu")
    want = JSolver(JConfig(grid=JGrid.make(40, 30, lengths=10.0),
                           dtype="float32", impl=impl,
                           order=2)).engaged_path()
    path = s.engaged_path()
    assert path["stepper"] == want["stepper"] == "per-axis-pallas"
    assert path["fallback"].endswith(
        "K11 computes the O4 Laplacian only; the order-2 Laplacian runs "
        "in plain PyTorch")
    generic = PSolver(PConfig(grid=grid, impl="xla", order=2), device="cpu")
    s0 = s.initial_state()
    assert torch.equal(s.run(s0, 2).u, generic.run(s0, 2).u)


@pytest.mark.parametrize("n", [(16, 12, 10), (20, 16)])
def test_cli_pallas_axis(n, capsys):
    verb = f"diffusion{len(n)}d"
    assert cli([verb, "--n", *map(str, n), "--iters", "2", "--impl",
                "pallas_axis", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "kernel path        : per-axis-pallas (impl=pallas_axis)" in out
    assert "kernel launches    : none" in out  # the CPU runs no kernel
