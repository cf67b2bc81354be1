"""WENO7-JS on the port's fused rungs against the JAX package's Pallas
kernels at order 7 (run in interpret mode): the e-form side
(``ops/weno._weno7_side_nd_e``), K5's twin a stage, whole runs on K5,
K6 and K7/K7a, the engaged paths over a sweep of grids, and the
order-7 configs of meshes and of the ensemble engine naming their
kernels.

Data: the fused kernels' e-form raises the betas to the 6th power and
overflows in float32 for split-flux jumps above about 3.6 (the JAX
note, ``ops/weno.py``), so kernel inputs are bounded states, as the
solvers keep them: seeded ``uniform(-0.1, 1.0)`` cells. The side itself
is checked on windows of the same range.

The other end of the same power: on a smooth state whose split-flux
differences lie between about 1e-8 and 1e-5 (the tails of the solvers'
Gaussian), the alphas are near 3e-38 and their products with the
candidates fall below the smallest normal float32. The port keeps those
products as subnormals, as the CUDA kernels do (built ``-ftz=false``);
XLA's CPU backend, which runs the JAX kernels in interpret mode, flushes
them to zero (and may contract a multiply-add around them), so on the
Gaussian the JAX kernels move 57-78 eps of max|u| away from a float64
evaluation of the same scheme in ONE step, where the port stays within
1 eps. So the comparison with the JAX kernels runs on the bounded random
states, and :func:`test_order7_gaussian_matches_float64_and_jax_generic`
holds the port on the Gaussian to its float64 evaluation and to the JAX
package's generic WENO7 path (the q-form, which does not underflow).

Tolerances: the side within 2 ulp of JAX's in float32 and float64 (both
evaluate the same expression in the same order; XLA may contract a
multiply-add); stages and 5-step runs within ``32 eps_f32 * max|u|``,
the bound of ``tests/test_torch_fused_burgers.py``; the Gaussian step
within 2 eps of float64 and 32 eps of the JAX generic path.
"""

import dataclasses

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
from multigpu_advectiondiffusion_tpu.ops import weno as jweno
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_burgers as jfb
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as cli
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PConfig,
    BurgersSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.ensemble import (
    EnsembleSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops import weno as pweno
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as pfb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers2d as pfb2,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS


def _assert_fused_close(got, want):
    """Within 32 eps of max|want|; prints the gap in eps (``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    assert gap <= TOL


def _spacing(shape):
    return tuple(2.0 / (n - 1) for n in shape)


# --------------------------------------------------------------------- #
# The e-form side
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("side", ["minus", "plus"])
def test_weno7_side_nd_e_matches_jax(side, dtype):
    """Seeded windows of split-flux values in [-0.1, 1.0], both sides:
    numerator and denominator within 2 ulp of the JAX package's."""
    rng = np.random.default_rng(7 if side == "minus" else 8)
    q = rng.uniform(-0.1, 1.0, (7, 4096)).astype(dtype)
    e = np.diff(q, axis=0)
    got = pweno._weno7_side_nd_e(*(torch.from_numpy(x) for x in e), side)
    want = jweno._weno7_side_nd_e(*(jnp.asarray(x) for x in e), side)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == dtype
        assert np.all(np.isfinite(w))
        ulp = np.spacing(np.abs(w).astype(dtype))
        assert np.max(np.abs(g - w) / ulp) <= 2.0


# --------------------------------------------------------------------- #
# K5 at order 7, one stage: the twin against the JAX kernel
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(24, 16, 16), (24, 19, 16)],
                         ids=["24x16x16", "24x19x16"])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k5_order7_stage_twin_matches_jax(kind, shape):
    """WENO7-JS, Burgers flux, nu = 1e-5, r = 4 (the embedding and bound
    of ``tests/test_torch_fused_burgers.py``); the final stage also
    emits max|f'(u_next)|."""
    spacing, nu, dt = _spacing(shape), 1e-5, 2e-3
    a, b = pfb.STAGES[kind]
    rng = np.random.default_rng(10 + kind)
    v = rng.uniform(-0.1, 1.0, shape).astype(np.float32)
    u = rng.uniform(-0.1, 1.0, shape).astype(np.float32)

    out = torch.from_numpy(u.copy() if kind == 2 else np.zeros_like(v))
    mx = torch.zeros(1) if kind == 2 else None
    pfb.fused_burgers_stage(
        torch.from_numpy(v), None if kind == 0 else out if kind == 2
        else torch.from_numpy(u), out, dt, mx,
        params=pfb.stage_params(pflux.burgers(), "js", spacing, nu, order=7),
        a=a, b=b)

    st = jfb.FusedBurgersStepper(shape, jnp.float32, spacing, jflux.burgers(),
                                 "js", nu, dt=dt, order=7)
    src = ("none", "operand", "target")[kind]
    stage = jfb._make_stage(
        st.padded_shape, shape, jnp.float32, bz=st.block[0], by=st.block[1],
        inv_dx=[1.0 / h for h in spacing],
        nu_scales=[nu / (12.0 * h * h) for h in spacing],
        flux=jflux.burgers(), variant="js", a=a, b=b, u_source=src,
        emit_max=kind == 2, order=7, r=4)
    dt_arr = jnp.asarray([dt], jnp.float32)
    V, U = st.embed(jnp.asarray(v)), st.embed(jnp.asarray(u))
    if src == "none":
        want = stage(dt_arr, V, V)
    elif src == "operand":
        want = stage(dt_arr, V, U, V)
    else:
        want, jmx = stage(dt_arr, V, U)
    _assert_fused_close(out.numpy(), np.asarray(st.extract(want)))
    if kind == 2:
        assert float(mx[0]) == float(out.abs().max())
        assert abs(float(mx[0]) - float(jmx[0])) <= TOL * float(jmx[0])


# --------------------------------------------------------------------- #
# Whole runs, 5 steps: the port's rungs against the JAX kernels
# --------------------------------------------------------------------- #
def _pair(n, port_impl, jax_impl, seed=None, **kw):
    """Both solvers on one config and both initial states; ``seed``: a
    bounded random state (``uniform(-0.1, 1.0)``) in place of the IC."""
    jcfg = JConfig(grid=JGrid.make(*n, lengths=2.0), dtype="float32",
                   impl=jax_impl, weno_order=7, **kw)
    js = JSolver(jcfg)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["impl"] = port_impl
    ps = PSolver(convert.burgers_config_from_fields(fields), device="cpu")
    s0 = js.initial_state()
    if seed is not None:
        u = np.random.default_rng(seed).uniform(
            -0.1, 1.0, np.asarray(s0.u).shape).astype(np.float32)
        s0 = s0._replace(u=jnp.asarray(u))
    p0 = convert.state_from_numpy(np.asarray(s0.u), np.asarray(s0.t),
                                  int(s0.it), device="cpu")
    return js, ps, s0, p0


RUNS = {
    # the port's pallas (K5) against JAX K5, adaptive, viscous
    "3d-k5-adaptive-viscous": ((16, 16, 24), "pallas", "pallas_stage",
                               "fused-stage", {"nu": 1e-5}),
    # K6 in both packages
    "3d-k6-fixed": ((16, 16, 24), "pallas_slab", "pallas_slab",
                    "fused-whole-run-slab", {"adaptive_dt": False}),
    # K7 and K7a in both packages (grid x, y: a (46, 40) array)
    "2d-k7-fixed": ((40, 46), "pallas", "pallas", "fused-whole-run",
                    {"adaptive_dt": False}),
    "2d-k7a-adaptive": ((40, 46), "pallas", "pallas", "fused-whole-run",
                        {"nu": 1e-5}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_order7_run_matches_jax(name):
    """5 steps from a bounded random state (the module's note); fixed dt
    advances both times alike, adaptive dt within a float32 rounding
    (each takes the maximum of its own state)."""
    n, port_impl, jax_impl, label, kw = RUNS[name]
    js, ps, s0, p0 = _pair(n, port_impl, jax_impl, seed=5, **kw)
    assert js.engaged_path()["stepper"] == label
    assert ps.engaged_path()["stepper"] == label
    want = js.run(s0, 5)
    got = ps.run(p0, 5)
    assert got.it == int(want.it) == 5
    if kw.get("adaptive_dt", True):
        assert abs(float(got.t) - float(want.t)) <= 1e-6 * float(want.t)
    else:
        assert got.t == np.float32(want.t)
    _assert_fused_close(got.u.numpy(), want.u)


def test_order7_gaussian_matches_float64_and_jax_generic():
    """One K7 step on the solver's Gaussian (the module's note on
    subnormals): within 2 eps of the same twin in float64 and within 32
    eps of the JAX package's generic WENO7 path."""
    js, ps, s0, p0 = _pair((40, 46), "pallas", "xla", adaptive_dt=False)
    assert ps.engaged_path()["stepper"] == "fused-whole-run"
    got = ps.run(p0, 1)
    params = ps._fused_stepper().params
    S = p0.u.double().clone()
    T1, T2 = torch.empty_like(S), torch.empty_like(S)
    (a1, b1), (a2, b2), (a3, b3) = pfb.STAGES
    dt = float(np.float32(ps.dt))
    for v, u, out, a, b in ((S, None, T1, a1, b1), (T1, S, T2, a2, b2),
                            (T2, S, S, a3, b3)):
        pfb.stage_reference(v, u, out, dt, params=params, a=a, b=b)
    scale = float(S.abs().max())
    gap64 = float((got.u.double() - S).abs().max()) / scale / EPS
    print(f"max|port - float64| = {gap64:.2f} eps of max|u|")
    assert gap64 <= 2.0
    _assert_fused_close(got.u.numpy(), js.run(s0, 1).u)


# --------------------------------------------------------------------- #
# Engaged paths over the sweep's grids
# --------------------------------------------------------------------- #
SWEEP = [(32, 32), (400, 400), (1001, 1001), (1478, 1478), (24, 16, 16),
         (64, 64, 64), (400, 400, 406), (512, 512, 512)]


def _gate_difference(n, impl, adaptive):
    """The port's stepper where its gates differ from the JAX package's,
    else None: 3-D fixed-dt ``pallas`` runs K5 where the JAX slab model
    picks K6 (``SlabRunBurgersStepper.profitable``), a pinned
    ``pallas_slab`` runs K6 on grids the JAX VMEM model gives K5, and a
    2-D grid of 1001^2 or more runs K7 under the port's L2 gate, where
    the JAX VMEM gate runs the generic path."""
    if len(n) == 2:
        return "fused-whole-run" if n[0] >= 1001 else None
    if adaptive:
        return None
    small = n[0] * n[1] * n[2] <= 64 ** 3
    if impl == "pallas" and small:
        return "fused-stage"
    if impl == "pallas_slab" and not small:
        return "fused-whole-run-slab"
    return None


@pytest.mark.parametrize("n", SWEEP, ids=["x".join(map(str, n))
                                          for n in SWEEP])
def test_order7_engaged_path_matches_jax(n):
    for impl in ("pallas", "pallas_stage", "pallas_step", "pallas_slab"):
        for adaptive in (False, True):
            kw = dict(weno_order=7, impl=impl, adaptive_dt=adaptive,
                      dtype="float32")
            want = JSolver(JConfig(grid=JGrid.make(*n), **kw)).engaged_path()
            got = PSolver(PConfig(grid=PGrid.make(*n), **kw),
                          device="cpu").engaged_path()
            other = _gate_difference(n, impl, adaptive)
            assert got["stepper"] == (other or want["stepper"]), (
                impl, adaptive)
            assert want["stepper"] != "generic-xla" or other, (impl,
                                                               adaptive)


def test_weno7_z_declines_with_jax_reason():
    """WENO7-Z has no fused kernel in either package: both run the
    generic path with the same reason."""
    kw = dict(weno_order=7, weno_variant="z", impl="pallas",
              dtype="float32")
    for n in ((24, 16, 16), (32, 32)):
        want = JSolver(JConfig(grid=JGrid.make(*n), **kw)).engaged_path()
        got = PSolver(PConfig(grid=PGrid.make(*n), **kw),
                      device="cpu").engaged_path()
        assert got["stepper"] == want["stepper"] == "generic-xla"
        assert (got["fallback"].split(";")[0]
                == want["fallback"].split(";")[0])


# --------------------------------------------------------------------- #
# Order 7 on meshes and under the ensemble engine: each config runs its
# kernel's twin and names it (tests/test_torch_weno7_mesh.py holds the
# runs to the unsharded ones and to JAX)
# --------------------------------------------------------------------- #
def test_order7_on_a_z_slab_mesh_raises_item_2():
    """The order-7 configs of a z-slab mesh construct, engage their
    kernel (K5 sharded, K3, K4) and run 2 steps equal to the unsharded
    run; the wrappers and steppers take order 7 on a shard."""
    mesh = pmesh.make_mesh({"dz": 2}, devices=[torch.device("cpu")] * 2,
                           timeout=60.0)
    grid = PGrid.make(16, 12, 24, lengths=2.0)
    for impl, kw, label in (
            ("pallas", {}, ("fused-stage", "serialized-refresh")),
            ("pallas_slab", {"adaptive_dt": False},
             ("fused-whole-run-slab", "serialized-refresh")),
            ("pallas_slab", {"adaptive_dt": False, "exchange": "dma"},
             ("fused-whole-run-slab", "in-kernel"))):
        cfg = PConfig(grid=grid, weno_order=7, impl=impl, **kw)
        sharded = PSolver(cfg, mesh=mesh)
        path = sharded.engaged_path()
        assert (path["stepper"], path["overlap"]) == label
        one = PSolver(dataclasses.replace(cfg, exchange="collective"),
                      device="cpu")
        got = sharded.run(sharded.initial_state(), 2)
        want = one.run(one.initial_state(), 2)
        assert torch.equal(got.u.assemble(), want.u) and got.t == want.t
    # the generic rung runs WENO7 on the mesh
    PSolver(PConfig(grid=grid, weno_order=7), mesh=mesh)
    # the kernels' own wrappers and steppers, at reach 4 and G = 12
    params = pfb.stage_params(pflux.burgers(), "js", (0.1,) * 3, 0.0,
                              order=7)
    slab = psr.SlabRunBurgersStepper((12, 8, 8), (0.1,) * 3, pflux.burgers(),
                                     "js", 0.0, 0.01, "cpu", order=7,
                                     global_shape=(24, 8, 8))
    assert (slab.halo, slab.exchange_depth, slab.padded_shape) == (
        12, 12, (36, 8, 8))
    stage = pfb.FusedBurgersStepper((0.1,) * 3, pflux.burgers(), "js", 0.0,
                                    0.4, "cpu", interior_shape=(12, 8, 8),
                                    global_shape=(24, 8, 8), order=7)
    assert (stage.zpad, stage.exchange_depth) == (4, 4)
    assert stage.embed(torch.zeros((12, 8, 8))).shape == (20, 8, 8)
    S = torch.rand((8, 8, 8))
    want = psr.burgers_step_reference(S, torch.empty_like(S), 0.01,
                                      params=params)
    got = psr.slab_step_burgers(S, torch.zeros_like(S), 0.01, params=params,
                                global_nz=8, oz=0, depth=0, window=(0, 8))
    assert torch.equal(got, want)
    out = pfb.fused_burgers_stage(S, None, torch.zeros_like(S), 0.01,
                                  params=params, a=0.0, b=1.0,
                                  window=(0, 4))
    first = pfb.stage_reference(S, None, torch.empty_like(S), 0.01,
                                params=params, a=0.0, b=1.0)
    assert torch.equal(out[:4], first[:4]) and not out[4:].any()


def test_order7_under_the_ensemble_engine_raises_item_2():
    """3-D fused WENO7 ensembles run: the slab pin folds B into K2b, the
    per-stage flavors run K5 a member; the generic rung and the 2-D
    fused flavors (which decline batching at every order) as before."""
    grid = PGrid.make(12, 10, 8, lengths=2.0)
    for impl, label in (("pallas", "ensemble-vmap[fused-stage]"),
                        ("pallas_stage", "ensemble-vmap[fused-stage]"),
                        ("pallas_slab",
                         "ensemble-fold[fused-whole-run-slab]")):
        cfg = PConfig(grid=grid, weno_order=7, impl=impl, adaptive_dt=False)
        ens = EnsembleSolver(PSolver, cfg, 2, device="cpu")
        ens.run(ens.initial_state(), 1)
        assert ens.engaged_path()["stepper"] == label
    st = psr.SlabRunBurgersStepper((8, 8, 8), (0.1,) * 3, pflux.burgers(),
                                   "js", 0.0, 0.01, "cpu", order=7)
    us = torch.rand((2, 8, 8, 8))
    got, ts = st.run_batched(us, np.zeros(2, np.float32), 1)
    for i in range(2):
        assert torch.equal(got[i], st.run(us[i], np.float32(0.0), 1)[0])
    assert ts.tolist() == [np.float32(0.01)] * 2
    # the generic rung runs WENO7 ensembles, and 2-D fused ensembles
    # decline batching to it at every order
    EnsembleSolver(PSolver, PConfig(grid=grid, weno_order=7), 2,
                   device="cpu")
    ens = EnsembleSolver(PSolver, PConfig(grid=PGrid.make(16, 12),
                                          weno_order=7, impl="pallas"),
                         2, device="cpu")
    ens.run(ens.initial_state(), 1)
    assert ens.engaged_path()["stepper"] == "ensemble-vmap[generic-xla]"


@pytest.mark.parametrize("verb,n,impl,label", [
    ("burgers3d", ("16", "12", "10"), "pallas", "fused-stage"),
    ("burgers3d", ("16", "12", "10"), "pallas_slab", "fused-whole-run-slab"),
    ("burgers2d", ("40", "30"), "pallas", "fused-whole-run"),
])
def test_cli_weno7_prints_its_kernel_path(verb, n, impl, label, capsys):
    assert cli([verb, "--n", *n, "--iters", "2", "--weno-order", "7",
                "--fixed-dt", "--impl", impl, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"kernel path        : {label} (impl={impl})" in out


# --------------------------------------------------------------------- #
# The order-7 geometry and operation counts, by hand
# --------------------------------------------------------------------- #
def test_k5_order7_tile_and_ops_hand_counted():
    """K5 at reach 4: the 14x32 tile's plane is 22 x 40 = 880 cells, 432
    of them halo; two buffers of v, f+ and f-, the faces and a word a
    warp are 24,944 B. One block of one plane, stage 1, inviscid: each
    thread splits 9 + 1 values (6 each), computes 2 z faces alone (227
    each) and 1 cell (6 + 3 + 3); the block splits its halo and computes
    314 runs of three faces (661 each)."""
    assert pfb.tile_geometry(7) == {"threads": 448, "plane": 880,
                                    "halo": 432, "runs": 314,
                                    "smem_bytes": 24944}
    assert pfb.ops_issued((1, 14, 32), 32, has_u=False, viscous=False,
                          variant="js", order=7) == (
        448 * (10 * 6 + 2 * 227 + 12) + 432 * 6 + 314 * 661)
    # K7 at reach 4, one 25x37 tile: its window reaches 4 past the grid
    # (33x45), stages on every cell, 25 x 13 + 37 x 9 = 658 runs a stage;
    # the resident halo's 560 splits and the cells' 14 + 17 + 17
    h100 = dict(sms=132, blocks_per_sm=1, smem_block=232_448,
                smem_sm=233_472, smem_reserved=1024)
    plan = pfb2.burgers2d_schedule(25, 37, **h100, tiles=(1, 1), order=7)
    assert (plan["window"], plan["smem_bytes"]) == ((33, 45),
                                                    7 * 35 * 47 * 4)
    assert pfb2.ops_issued(25, 37, plan, viscous=False, variant="js",
                           adaptive=False, order=7) == (
        560 * 6 + 3 * 658 * 661 + 925 * (14 + 17 + 17))
    with pytest.raises(ValueError, match="12 cells"):
        pfb2.burgers2d_schedule(25, 37, **h100, tiles=(3, 1), order=7)
    # K6 at order 7 plans 24x24 tiles
    assert psr.burgers_schedule(8, 49, 23, 132, order=7)["tiles"] == 3 * 1
