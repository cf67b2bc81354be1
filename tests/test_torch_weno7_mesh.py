"""WENO7-JS on the port's fused rungs of device meshes and of the 3-D
ensemble engine (CPU shards and members), against the port's unsharded
runs and the JAX package's unsharded kernels at order 7 (Pallas
interpret mode):

* the z-slab mesh ``{"dz": 2}`` (and ``{"dz": 4}``): the sharded K5
  twin (4 ghost planes, split windows and operands), fixed and adaptive,
  serialized and split; the K3 twin at ``G = 12``, k = 1 and 4; the K4
  twin (``exchange="dma"``);
* the 2-D meshes ``{"dy": 2}``, ``{"dy": 4}`` (split) and ``{"dy": 2,
  "dx": 2}``: the K8/K8b twins at halo 4, each also held directly
  against JAX's ``_burgers_stage`` and band calls at order 7;
* the ensemble engine at B = 2-3: the K2b twin against JAX's
  ``run_batched`` at order 7, and every member equal to its single run;
* ``engaged_path()`` against the JAX package's on the same mesh configs
  (the 8 host devices of ``tests/conftest.py``), the ensemble labels
  against JAX's, and the CLI.

Data: bounded random states, ``uniform(-0.1, 1.0)`` from numpy seeds;
``tests/test_torch_weno7_fused.py``'s note says why (XLA's CPU backend
flushes the e-form's subnormal products on the Gaussian's tails).

Tolerances: a sharded or batched run against the port's unsharded or
single run, 0 difference and ``t`` equal (the same twin arithmetic; only
where the ghosts come from differs); the port against the JAX package's
unsharded kernels, ``32 eps_f32 * max|u|`` (the bound of the unsharded
order-7 runs, ``tests/test_torch_weno7_fused.py``), ``t`` equal at fixed
dt and within ``1e-6`` relative adaptive. The JAX sharded runs are not
the oracle (several fail on the CPU backend, ROADMAP §3).
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.burgers import (
    BurgersConfig as JConfig,
    BurgersSolver as JSolver,
)
from multigpu_advectiondiffusion_tpu.models.ensemble import (
    EnsembleSolver as JEnsemble,
)
from multigpu_advectiondiffusion_tpu.ops import flux as jflux
from multigpu_advectiondiffusion_tpu.ops.pallas import (
    fused2d_sharded as jfs,
)
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_slab_run as jsr
from multigpu_advectiondiffusion_tpu.ops.pallas.laplacian import (
    LANE,
    SUBLANE,
    round_up,
)
from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as pmain
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PConfig,
    BurgersSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.ensemble import (
    EnsembleSolver as PEnsemble,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import ShardedArray
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused2d_sharded as pfs,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as pfb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS
STEPS = 5  # k = 4 ends with a partial block
N3 = (16, 16, 96)  # physical (nx, ny, nz): lz = 48 on dz = 2 holds 4 G
N2 = (40, 48)  # physical (nx, ny): ly = 12 = 3h on dy = 4 (split)


def _gap(got, want) -> float:
    """max|got - want| in eps of max|want| (printed with ``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    return gap


def _mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return pmesh.make_mesh(sizes, devices=[CPU] * n, timeout=60.0)


def _u0(n_xyz, seed: int = 17):
    shape = tuple(reversed(n_xyz))
    return np.random.default_rng(seed).uniform(-0.1, 1.0, shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_run(n_xyz, impl: str, adaptive: bool):
    """The JAX package's unsharded order-7 run of the bounded random
    state: ``(u, t)`` after ``STEPS`` steps (interpret mode)."""
    js = JSolver(JConfig(grid=JGrid.make(*n_xyz, lengths=2.0),
                         dtype="float32", impl=impl, weno_order=7,
                         adaptive_dt=adaptive))
    s0 = js.initial_state()._replace(u=jnp.asarray(_u0(n_xyz)))
    out = js.run(s0, STEPS)
    return np.asarray(out.u), float(out.t)


def _sharded_vs_one(n_xyz, layout, cfg, plain):
    """Run ``cfg`` on ``layout`` and ``plain`` on one device from the same
    bounded random state; assert 0 difference and equal ``t``; return the
    sharded solver and the unsharded result."""
    sizes, mapping = layout
    mesh = _mesh(sizes)
    decomp = pmesh.Decomposition.of(mapping)
    sharded = PSolver(cfg, mesh=mesh, decomp=decomp)
    one = PSolver(plain, device="cpu")
    u0 = _u0(n_xyz)
    got = sharded.run(convert.state_from_numpy(u0, 0.0, mesh=mesh,
                                               decomp=decomp), STEPS)
    want = one.run(convert.state_from_numpy(u0, 0.0, device="cpu"), STEPS)
    assert isinstance(got.u, ShardedArray)
    assert torch.equal(got.u.assemble(), want.u)
    assert (got.t, got.it) == (want.t, want.it)
    assert float((want.u - torch.from_numpy(u0)).abs().max()) > 0
    return sharded, want


def _against_jax(want, jax_run, adaptive: bool):
    ju, jt = jax_run
    assert _gap(want.u.numpy(), ju) <= TOL
    if adaptive:
        assert abs(float(want.t) - jt) <= 1e-6 * jt
    else:
        assert want.t == np.float32(jt)


# --------------------------------------------------------------------- #
# The z-slab mesh: sharded K5, K3 and K4 at order 7
# --------------------------------------------------------------------- #
Z2, Z4 = ({"dz": 2}, {0: "dz"}), ({"dz": 4}, {0: "dz"})
# name: (layout, config knobs, engaged (stepper, overlap, k, exchange))
ZSLAB = {
    "k5-fixed": (Z2, dict(impl="pallas", adaptive_dt=False),
                 ("fused-stage", "serialized-refresh", 1, "collective")),
    "k5-fixed-split": (Z2, dict(impl="pallas", adaptive_dt=False,
                                overlap="split"),
                       ("fused-stage", "split", 1, "collective")),
    "k5-adaptive": (Z2, dict(impl="pallas"),
                    ("fused-stage", "serialized-refresh", 1, "collective")),
    "k5-adaptive-split": (Z2, dict(impl="pallas", overlap="split"),
                          ("fused-stage", "split", 1, "collective")),
    "k3-k1": (Z2, dict(impl="pallas_slab", adaptive_dt=False),
              ("fused-whole-run-slab", "serialized-refresh", 1,
               "collective")),
    "k3-k1-split": (Z2, dict(impl="pallas_slab", adaptive_dt=False,
                             overlap="split"),
                    ("fused-whole-run-slab", "split", 1, "collective")),
    "k3-k4": (Z2, dict(impl="pallas_slab", adaptive_dt=False,
                       steps_per_exchange=4),
              ("fused-whole-run-slab", "serialized-refresh", 4,
               "collective")),
    "k3-k4-split": (Z2, dict(impl="pallas_slab", adaptive_dt=False,
                             steps_per_exchange=4, overlap="split"),
                    ("fused-whole-run-slab", "split", 4, "collective")),
    "k4-k1": (Z2, dict(impl="pallas_slab", adaptive_dt=False,
                       exchange="dma"),
              ("fused-whole-run-slab", "in-kernel", 1, "dma")),
    "k4-k4": (Z2, dict(impl="pallas_slab", adaptive_dt=False,
                       exchange="dma", steps_per_exchange=4),
              ("fused-whole-run-slab", "in-kernel", 4, "dma")),
    "k4-dz4-k2": (Z4, dict(impl="pallas_slab", adaptive_dt=False,
                           exchange="dma", steps_per_exchange=2),
                  ("fused-whole-run-slab", "in-kernel", 2, "dma")),
}


@pytest.mark.parametrize("name", list(ZSLAB))
def test_zslab_mesh_matches_unsharded_and_jax(name):
    """Each order-7 z-slab rung, 5 steps: 0 difference and equal ``t``
    against the port's unsharded run of the same rung (K5 or K6), and
    within 32 eps of the JAX package's unsharded K5 run."""
    layout, kw, label = ZSLAB[name]
    grid = PGrid.make(*N3, lengths=2.0)
    cfg = PConfig(grid=grid, weno_order=7, **kw)
    plain = dataclasses.replace(cfg, overlap="padded", steps_per_exchange=1,
                                exchange="collective")
    sharded, want = _sharded_vs_one(N3, layout, cfg, plain)
    path = sharded.engaged_path()
    assert tuple(path[f] for f in ("stepper", "overlap",
                                   "steps_per_exchange",
                                   "exchange")) == label
    assert path["fallback"] is None
    adaptive = cfg.adaptive_dt
    _against_jax(want, _jax_run(N3, "pallas_stage", adaptive), adaptive)


def test_sharded_k5_twin_windows_and_operands_at_reach_4():
    """One order-7 stage on the two shards of ``{"dz": 2}``, each block
    with 4 ghost planes of garbage: the split schedule's interior window,
    then the edge windows reading the exchanged operands (the true
    neighbour planes or the global edge's), equals the unsharded stage to
    the bit, and the emitted maximum folds the three calls."""
    params = pfb.stage_params(pflux.burgers(), "js", (0.05, 0.06, 0.07),
                              1e-5, order=7)
    r, nz, lz, bz = 4, 48, 24, pfb.SPLIT_BZ
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.uniform(-0.1, 1.0, (nz, 10, 12)).astype(
        np.float32))
    u = torch.from_numpy(rng.uniform(-0.1, 1.0, (nz, 10, 12)).astype(
        np.float32))
    want, wmax = pfb.stage_reference(v, u, torch.empty_like(v), 2e-3,
                                     params=params, a=0.75, b=0.25,
                                     emit=True)
    for i in range(2):
        oz = i * lz
        blk = torch.full((lz + 2 * r, 10, 12), 9.0)  # stale ghosts
        blk[r:r + lz] = v[oz:oz + lz]
        ublk = torch.zeros_like(blk)
        ublk[r:r + lz] = u[oz:oz + lz]
        lo = v[max(oz - r, 0):oz] if i else v[:1].expand(r, -1, -1)
        hi = v[oz + lz:oz + lz + r] if i == 0 else v[-1:].expand(r, -1, -1)
        out = torch.zeros_like(blk)
        mx = torch.zeros(1)
        kw = dict(params=params, a=0.75, b=0.25, zpad=r, global_nz=nz,
                  oz=oz)
        pfb.fused_burgers_stage(blk, ublk, out, 2e-3, mx,
                                window=(bz, lz - bz), **kw)
        pfb.fused_burgers_stage(blk, ublk, out, 2e-3, mx, window=(0, bz),
                                lo=lo.contiguous(), mx_init=False, **kw)
        pfb.fused_burgers_stage(blk, ublk, out, 2e-3, mx,
                                window=(lz - bz, lz), hi=hi.contiguous(),
                                mx_init=False, **kw)
        assert torch.equal(out[r:r + lz], want[oz:oz + lz])
        assert float(mx) == float(want[oz:oz + lz].abs().max())
    assert float(wmax) == float(want.abs().max())
    with pytest.raises(ValueError, match="zpad must be 0 or 4"):
        pfb.fused_burgers_stage(blk[1:-1].contiguous(), None,
                                torch.zeros_like(blk[1:-1]), 2e-3,
                                params=params, a=0.0, b=1.0, zpad=3,
                                global_nz=nz, oz=0)


def test_k3_twin_box_is_twelve_planes_a_side():
    """K3 at order 7 reads its window and ``G = 12`` planes a side: a
    window whose box leaves its buffer is refused, and the per-step
    window of a shard with 12 ghost planes is K6's step to the bit."""
    params = pfb.stage_params(pflux.burgers(), "js", (0.1,) * 3, 0.0,
                              order=7)
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.uniform(-0.1, 1.0, (40, 6, 7)).astype(
        np.float32))
    want = psr.burgers_step_reference(g, torch.empty_like(g), 0.01,
                                      params=params)
    # the middle shard [12, 28) of 40 planes with 12 ghost planes a side
    lz, depth, oz = 16, 12, 12
    buf = g.clone()
    out = torch.zeros_like(buf)
    psr.slab_step_burgers(buf, out, 0.01, params=params, global_nz=40,
                          oz=oz, depth=depth, window=(0, lz))
    assert torch.equal(out[depth:depth + lz], want[oz:oz + lz])
    assert not out[:depth].any() and not out[depth + lz:].any()
    with pytest.raises(ValueError, match="box 12 planes a side"):
        psr.slab_step_burgers(buf[1:-1].contiguous(),
                              torch.zeros_like(buf[1:-1]), 0.01,
                              params=params, global_nz=40, oz=oz, depth=11,
                              window=(0, lz))


# --------------------------------------------------------------------- #
# The 2-D meshes: K8 and K8b at halo 4
# --------------------------------------------------------------------- #
DY2, DY4 = ({"dy": 2}, {0: "dy"}), ({"dy": 4}, {0: "dy"})
DYX = ({"dy": 2, "dx": 2}, {0: "dy", 1: "dx"})
MESH2D = {  # name: (layout, adaptive, overlap, engaged overlap)
    "dy2-fixed": (DY2, False, "padded", "serialized-refresh"),
    "dy2-fixed-split": (DY2, False, "split", "split"),
    "dy2-adaptive": (DY2, True, "padded", "serialized-refresh"),
    "dy2-adaptive-split": (DY2, True, "split", "split"),
    "dy4-fixed-split": (DY4, False, "split", "split"),
    "dy4-adaptive-split": (DY4, True, "split", "split"),
    "pencil-fixed": (DYX, False, "padded", "serialized-refresh"),
    "pencil-adaptive": (DYX, True, "padded", "serialized-refresh"),
}


@pytest.mark.parametrize("name", list(MESH2D))
def test_2d_mesh_matches_k7_and_jax(name):
    """K8 (K8b under split) at order 7, 5 steps: 0 difference and equal
    ``t`` against the port's unsharded K7/K7a run, and within 32 eps of
    the JAX package's unsharded ``FusedBurgers2DStepper(order=7)``."""
    layout, adaptive, overlap, engaged = MESH2D[name]
    cfg = PConfig(grid=PGrid.make(*N2, lengths=2.0), weno_order=7,
                  impl="pallas", adaptive_dt=adaptive, overlap=overlap)
    plain = dataclasses.replace(cfg, overlap="padded")
    sharded, want = _sharded_vs_one(N2, layout, cfg, plain)
    path = sharded.engaged_path()
    assert (path["stepper"], path["overlap"]) == ("fused-stage", engaged)
    fused = sharded._fused_stepper()
    assert (fused.halo, fused.order, fused.padded_shape[1]) == (
        4, 7, fused.interior_shape[1] + 8)
    assert PSolver(plain, device="cpu").engaged_path()["stepper"] == (
        "fused-whole-run")
    _against_jax(want, _jax_run(N2, "pallas", adaptive), adaptive)


GLOBAL2 = (48, 40)  # (ny, nx) of N2
SPACING2 = (2.0 / 47, 2.0 / 39)
STAGES = pfb.STAGES
DT2 = 0.004


def _k8_params():
    return pfb.stage_params(pflux.get("burgers"), "js", SPACING2, 1e-3,
                            order=7)


def _k8_stage_fn(local_shape):
    return functools.partial(
        jfs._burgers_stage, local_shape=local_shape, global_shape=GLOBAL2,
        inv_dx=tuple(1.0 / dx for dx in SPACING2),
        nu_scales=tuple(1e-3 / (12.0 * dx * dx) for dx in SPACING2),
        flux=jflux.get("burgers"), variant="js", order=7, halo=4)


def _shard2d(seed, oy, ly, h=4):
    """Rows [oy - h, oy + ly + h) of a global field padded by edge
    replicas, all 48 rows of x plus h a side."""
    u = np.random.default_rng(seed).uniform(-0.1, 1.0, GLOBAL2).astype(
        np.float32)
    U = np.pad(u, h, mode="edge")
    return U[oy:oy + ly + 2 * h].copy()


def _jax_layout(P, h=4):
    py, px = round_up(P.shape[0], SUBLANE), round_up(P.shape[1], LANE)
    return np.pad(P, ((0, py - P.shape[0]), (0, px - P.shape[1])),
                  mode="edge")


@pytest.mark.parametrize("stage,oy", [(0, 0), (1, 12), (2, 36)],
                         ids=["s1-first", "s2-middle", "s3-last"])
def test_k8_twin_matches_jax_order7(stage, oy):
    """K8's twin at halo 4 on shards of ``{"dy": 4}`` (12 rows) against
    JAX's ``_burgers_stage(order=7, halo=4)`` in interpret mode, viscous;
    the last stage also emits ``max|f'(u_next)|``."""
    h, ly, lx = 4, 12, 40
    V, U = _shard2d(1, oy, ly), _shard2d(2, oy, ly)
    a, b = STAGES[stage]
    u = None if stage == 0 else torch.from_numpy(U.copy())
    out = u if stage == 2 else torch.zeros(V.shape, dtype=torch.float32)
    mx = torch.zeros(()) if stage == 2 else None
    pfs.fused2d_stage(torch.from_numpy(V.copy()), u, out, DT2, (oy, 0),
                      params=_k8_params(), a=a, b=b, global_shape=GLOBAL2,
                      mx=mx)
    src = ("none", "operand", "alias_u")[stage]
    fn = jax.jit(jfs._make_stage(_jax_layout(V).shape, jnp.float32,
                                 _k8_stage_fn((ly, lx)), a=a, b=b,
                                 u_source=src))
    jv, ju = _jax_layout(V), _jax_layout(U)
    args = [jnp.asarray([DT2], jnp.float32), jnp.asarray((oy, 0), jnp.int32),
            jnp.asarray(jv)]
    if stage > 0:
        args.append(jnp.asarray(ju))
    if stage < 2:
        args.append(jnp.zeros_like(jnp.asarray(jv)))
    want = np.asarray(fn(*args))[h:h + ly, h:h + lx]
    assert _gap(out.numpy()[h:h + ly, h:h + lx], want) <= TOL
    if stage == 2:
        assert float(mx) == float(out[h:h + ly, h:h + lx].abs().max())


@pytest.mark.parametrize("band", ["bottom", "interior", "top"])
def test_k8b_twin_matches_jax_order7(band):
    """K8b's bands at halo 4 (3h = 12 rows on ``{"dy": 4}``) against
    JAX's band calls at order 7: the ghost rows hold garbage, so the edge
    bands read the exchanged operands and the interior band no ghost
    row."""
    h, ly, lx, oy = 4, 12, 40, 24
    stage = {"bottom": 0, "interior": 1, "top": 2}[band]
    V, U = _shard2d(3, oy, ly), _shard2d(4, oy, ly)
    lo, hi = V[:h].copy(), V[ly + h:].copy()
    stale = V.copy()
    stale[:h] = stale[ly + h:] = 7.5
    a, b = STAGES[stage]
    rows = {"bottom": (0, h), "interior": (h, ly - h), "top": (ly - h, ly)}
    assert tuple(r for r, _ in pfs.split_bands(ly, h)) == (
        rows["interior"], rows["bottom"], rows["top"])
    u = None if stage == 0 else torch.from_numpy(U.copy())
    out = torch.zeros(V.shape, dtype=torch.float32)
    pfs.fused2d_band_stage(
        torch.from_numpy(stale), u, out, DT2, (oy, 0), params=_k8_params(),
        a=a, b=b, global_shape=GLOBAL2, rows=rows[band],
        lo=torch.from_numpy(lo) if band == "bottom" else None,
        hi=torch.from_numpy(hi) if band == "top" else None)
    r0, r1 = rows[band]
    assert not out[:h + r0].any() and not out[h + r1:].any()
    px = round_up(lx + 2 * h, LANE)
    mid = ly - 2 * h
    in_rows, out_rows, fn_shape = ((ly, mid, (mid, lx)) if band == "interior"
                                   else (3 * h, h, (h, lx)))
    fn = jax.jit(jfs._make_band_stage(in_rows, out_rows, h, (px,),
                                      jnp.float32, _k8_stage_fn(fn_shape),
                                      a=a, b=b, use_u=stage > 0))
    jv, ju = _jax_layout(V), _jax_layout(U)
    (i0, i1), shift = {"bottom": ((0, 3 * h), 0),
                       "interior": ((h, h + ly), h),
                       "top": ((ly - h, ly + 2 * h), ly - h)}[band]
    args = [jnp.asarray([DT2], jnp.float32),
            jnp.asarray((oy + shift, 0), jnp.int32), jnp.asarray(jv[i0:i1])]
    if stage > 0:
        args.append(jnp.asarray(ju[i0:i1]))
    want = np.asarray(fn(*args))
    assert _gap(out.numpy()[h + r0:h + r1, h:h + lx],
                want[:, h:h + lx]) <= TOL


# --------------------------------------------------------------------- #
# The ensemble engine: K2b and K5 a member at order 7
# --------------------------------------------------------------------- #
def test_k2b_twin_matches_jax_run_batched_order7():
    """K2b's twin at order 7, B = 3, 2 steps, viscous, on the JAX suite's
    24x8x8 grid, against JAX's ``run_batched(order=7)``; member i equals
    the single K6 twin run of member i to the bit."""
    grid = JGrid.make(24, 8, 8, lengths=2.0)
    dt = 0.4 * min(grid.spacing)
    us = np.random.default_rng(23).uniform(
        -0.1, 1.0, (3, *grid.shape)).astype(np.float32)
    ts = np.zeros(3, np.float32)
    st = jsr.SlabRunBurgersStepper(grid.shape, jnp.float32, grid.spacing,
                                   jflux.get("burgers"), "js", 1e-5, dt=dt,
                                   order=7)
    want_u, want_t = jax.jit(lambda u, t: st.run_batched(u, t, 2))(
        jnp.asarray(us), jnp.asarray(ts))
    pst = psr.SlabRunBurgersStepper(grid.shape, grid.spacing,
                                    pflux.get("burgers"), "js", 1e-5, dt,
                                    "cpu", order=7)
    got_u, got_t = pst.run_batched(torch.from_numpy(us), ts, 2)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    for i in range(3):
        assert _gap(got_u[i].numpy(), np.asarray(want_u[i])) <= TOL
        one = psr.slab_run_burgers(torch.from_numpy(us[i].copy()),
                                   torch.empty_like(got_u[i]), 2, dt,
                                   params=pst.params)
        assert torch.equal(got_u[i], one)


# impl, adaptive -> the port's label; JAX's where the two gates agree
ENSEMBLE = [("pallas_slab", False), ("pallas_stage", False),
            ("pallas_stage", True), ("pallas", False), ("pallas", True),
            ("pallas_step", False)]


@pytest.mark.parametrize("impl,adaptive", ENSEMBLE,
                         ids=[f"{i}-{'adaptive' if a else 'fixed'}"
                              for i, a in ENSEMBLE])
def test_weno7_ensemble_members_equal_single_runs(impl, adaptive):
    """A 3-D WENO7 ensemble of B = 3 Gaussians of other widths, 3 steps:
    every member equals its single run to the bit, ``t`` too; the label
    is JAX's, but for fixed-dt ``pallas``, where the port's measured
    slab gate runs K5 a member and JAX's VMEM model folds B into K6 (the
    3-D slab gates' recorded difference, ROADMAP §3)."""
    grid_p, grid_j = PGrid.make(12, 10, 8, lengths=2.0), JGrid.make(
        12, 10, 8, lengths=2.0)
    kw = dict(weno_order=7, impl=impl, adaptive_dt=adaptive)
    members = [{"ic_params": {"width": w}} for w in (0.1, 0.13, 0.16)]
    ens = PEnsemble(PSolver, PConfig(grid=grid_p, **kw), members,
                    device="cpu")
    out = ens.run(ens.initial_state(), 3)
    for i in range(3):
        ms = ens.member_solver(i)
        ref = ms.run(ms.initial_state(), 3)
        assert torch.equal(out.u[i], ref.u) and out.t[i] == ref.t
    jens = JEnsemble(JSolver, JConfig(grid=grid_j, dtype="float32", **kw), 3)
    jens.run(jens.initial_state(), 0)
    want = jens.engaged_path()["stepper"]
    got = ens.engaged_path()["stepper"]
    if impl == "pallas" and not adaptive:
        assert (got, want) == ("ensemble-vmap[fused-stage]",
                               "ensemble-fold[fused-whole-run-slab]")
    else:
        assert got == want
    assert got in ("ensemble-vmap[fused-stage]",
                   "ensemble-fold[fused-whole-run-slab]")


# --------------------------------------------------------------------- #
# engaged_path() against the JAX package's sharded solvers
# --------------------------------------------------------------------- #
LAYOUTS = {"dz2": Z2, "dz4": Z4, "dy2": DY2, "dy4": DY4,
           "dx2": ({"dx": 2}, {1: "dx"}), "dydx": DYX,
           "dz2dy2": ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"})}
# (layout, physical grid): shards that hold 4 G, 2 G or one G of z, 3 h
# rows or fewer, and shards thinner than the WENO7 halo (3 < 4 cells)
DISPATCH = [("dz2", (16, 16, 96)), ("dz2", (16, 16, 48)),
            ("dz2", (16, 16, 24)), ("dz2", (16, 16, 14)),
            ("dz4", (16, 16, 96)), ("dz4", (16, 16, 12)),
            ("dz2dy2", (16, 16, 48)), ("dy2", (40, 48)), ("dy2", (40, 14)),
            ("dy4", (40, 48)), ("dy4", (40, 12)), ("dx2", (40, 48)),
            ("dydx", (40, 48)), ("dydx", (6, 40))]
_FIELDS = ("stepper", "overlap", "steps_per_exchange", "exchange")


def _outcome(make):
    try:
        path = make().engaged_path()
    except (ValueError, NotImplementedError) as exc:
        return (type(exc).__name__, str(exc))
    fallback = None if path["stepper"].startswith("fused") else path[
        "fallback"]
    return tuple(path[f] for f in _FIELDS) + (fallback,)


@pytest.mark.parametrize("layout,n", DISPATCH,
                         ids=[f"{lay}-{'x'.join(map(str, n))}"
                              for lay, n in DISPATCH])
def test_weno7_mesh_dispatch_matches_jax(layout, n):
    """Construction and ``engaged_path()`` only, every fused flavor,
    overlap, steps per exchange, exchange and dt mode at order 7: where
    the JAX package raises, the port raises the same error; elsewhere the
    engaged stepper, overlap, steps per exchange, exchange and — off the
    fused rungs — the fallback (the thin shard's "a sharded axis is
    thinner than the WENO7 halo (4)") are JAX's, on the y-sharded 3-D
    pencil too (K5's YX instance where JAX runs its y-sharded K5)."""
    sizes, mapping = LAYOUTS[layout]
    nd = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(sizes, devices=jax.devices()[:nd])
    jd = jmesh.Decomposition.of(mapping)
    pm, pd = _mesh(sizes), pmesh.Decomposition.of(mapping)
    knobs = itertools.product(
        ("pallas", "pallas_stage", "pallas_step", "pallas_slab"),
        ("padded", "split"), (1, 4) if len(n) == 3 else (1,),
        (False, True), ("collective", "dma") if len(n) == 3
        else ("collective",))
    fused = 0
    for impl, overlap, k, adaptive, exchange in knobs:
        kw = dict(weno_order=7, impl=impl, overlap=overlap,
                  steps_per_exchange=k, adaptive_dt=adaptive,
                  exchange=exchange)
        want = _outcome(lambda: JSolver(JConfig(
            grid=JGrid.make(*n, lengths=2.0), dtype="float32", **kw),
            mesh=jm, decomp=jd))
        got = _outcome(lambda: PSolver(PConfig(
            grid=PGrid.make(*n, lengths=2.0), **kw), mesh=pm, decomp=pd))
        fused += str(want[0]).startswith("fused")
        assert got == want, kw
    # the thin shards decline every fused flavor to the generic rung
    assert bool(fused) != (n in ((16, 16, 12), (40, 12), (6, 40)))


def test_cli_weno7_mesh_prints_its_kernel_path(capsys, tmp_path):
    """``burgers{3,2}d --weno-order 7 --mesh ...`` on CPU shards: the
    summary names the rung and its schedule, and the result equals the
    unsharded run's."""
    runs = [
        (["burgers3d", "--n", "16", "16", "96", "--impl", "pallas_slab",
          "--fixed-dt", "--exchange", "dma", "--steps-per-exchange", "4"],
         "dz=2", "fused-whole-run-slab (impl=pallas_slab)",
         "overlap=in-kernel, steps/exchange=4, exchange=dma"),
        (["burgers2d", "--n", "40", "48", "--impl", "pallas",
          "--overlap", "split"], "dy=4", "fused-stage (impl=pallas)",
         "overlap=split"),
    ]
    for i, (args, mesh, label, sched) in enumerate(runs):
        base = args + ["--weno-order", "7", "--iters", "2", "--device",
                       "cpu", "--save"]
        assert pmain(base + [str(tmp_path / f"m{i}"), "--mesh", mesh]) == 0
        out = capsys.readouterr().out
        assert label in out and sched in out
        assert "kernel launches    : none" in out  # the CPU runs twins
        one = [a for a in base if a not in ("--overlap", "split")]
        if "--exchange" in one:
            j = one.index("--exchange")
            del one[j:j + 4]
        assert pmain(one + [str(tmp_path / f"o{i}")]) == 0
        capsys.readouterr()
        got, want = (np.fromfile(tmp_path / f"{d}{i}" / "result.bin",
                                 dtype=np.float32) for d in ("m", "o"))
        assert np.array_equal(got, want)
