"""Fused 3-D Burgers on y- and x-cut meshes (K5's YX instance: ``r``
stored ghosts on each cut axis, neighbours clamped at the global edges
only) on CPU shards, where every wrapper runs K5's twin
(``ops/kernels/fused_burgers.stage_reference``):

* the sharded run against the port's own unsharded run on ``{"dy": 2}``,
  ``{"dx": 2}``, ``{"dy": 2, "dx": 2}``, ``{"dz": 2, "dy": 2}`` (padded
  and split) and ``{"dz": 2, "dy": 2, "dx": 2}``, WENO5-JS, WENO5-Z and
  WENO7, fixed and adaptive dt: 0 difference and ``t`` equal (a cell's
  arithmetic is the unsharded kernel's; only where its neighbours are
  stored differs);
* the sharded run against the JAX package's unsharded fused run (K5 in
  Pallas interpret mode) of the same config: 32 eps_f32 of max|u|, the
  bound of ``tests/test_torch_fused_burgers.py``, from a bounded random
  state (seeded ``uniform(-0.1, 1.0)``): on the Gaussian's tails XLA's
  CPU backend flushes WENO7's subnormal e-form products, which K5 and
  its twin keep (``tests/test_torch_weno7_fused.py``'s note). The JAX
  sharded runs are not the oracle: several of them fail on the CPU
  backend;
* ``engaged_path()`` against the JAX package's sharded solvers on the
  y/x layouts, with the recorded differences and their reasons;
* the CLI with ``--mesh dy=2`` and ``--mesh dz=2,dy=2``.
"""

import dataclasses
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
from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as pmain
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PConfig,
    BurgersSolver as PSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import ShardedArray
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS = float(np.finfo(np.float32).eps)
LAYOUTS = {
    "dy2": ({"dy": 2}, {1: "dy"}),
    "dx2": ({"dx": 2}, {2: "dx"}),
    "dydx": ({"dy": 2, "dx": 2}, {1: "dy", 2: "dx"}),
    "dzdy": ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"}),
    "block": ({"dz": 2, "dy": 2, "dx": 2}, {0: "dz", 1: "dy", 2: "dx"}),
}
N16 = (16, 16, 16)
N48 = (16, 16, 48)  # physical (nx, ny, nz): 24-plane z shards split


def _port(cfg, layout=None):
    if layout is None:
        return PSolver(cfg, device="cpu")
    sizes, mapping = LAYOUTS[layout]
    n = int(np.prod(list(sizes.values())))
    return PSolver(cfg, mesh=pmesh.make_mesh(sizes, devices=[CPU] * n,
                                             timeout=60.0),
                   decomp=pmesh.Decomposition.of(mapping))


def _cfg(n, **kw):
    return PConfig(grid=PGrid.make(*n, lengths=2.0), impl="pallas", **kw)


# (layout, physical grid, config knobs, the engaged overlap)
RUNS = [
    ("dy2", N16, {"adaptive_dt": False}, "serialized-refresh"),
    ("dy2", N16, {"weno_variant": "z"}, "serialized-refresh"),
    ("dy2", N16, {"weno_order": 7}, "serialized-refresh"),
    ("dx2", N16, {"nu": 1e-3}, "serialized-refresh"),
    ("dx2", N16, {"weno_order": 7, "adaptive_dt": False},
     "serialized-refresh"),
    ("dydx", N16, {"weno_variant": "z", "adaptive_dt": False},
     "serialized-refresh"),
    ("dydx", N16, {}, "serialized-refresh"),
    ("dzdy", N16, {"weno_order": 7}, "serialized-refresh"),
    ("dzdy", N48, {"overlap": "split"}, "split"),
    ("dzdy", N48, {"overlap": "split", "weno_order": 7,
                   "adaptive_dt": False}, "split"),
    ("dzdy", N48, {"overlap": "split", "weno_variant": "z"}, "split"),
    ("block", N16, {}, "serialized-refresh"),
    ("block", N16, {"weno_order": 7}, "serialized-refresh"),
    ("block", N16, {"weno_variant": "z", "adaptive_dt": False},
     "serialized-refresh"),
]


def _run_id(case):
    layout, n, kw, _ = case
    knobs = "-".join(f"{k}={v}" for k, v in kw.items()) or "js-adaptive"
    return f"{layout}-{'x'.join(map(str, n))}-{knobs}"


@pytest.mark.parametrize("case", RUNS, ids=[_run_id(c) for c in RUNS])
def test_sharded_run_bit_exact(case):
    """The sharded K5 run equals the unsharded one to the bit, ``t`` and
    ``it`` equal, over 3 steps (a split schedule against the padded
    unsharded run)."""
    layout, n, kw, overlap = case
    cfg = _cfg(n, **kw)
    one = _port(dataclasses.replace(cfg, overlap="padded"))
    sharded = _port(cfg, layout)
    path = sharded.engaged_path()
    assert (path["stepper"], path["overlap"]) == ("fused-stage", overlap)
    assert sharded._fused_stepper().overlap_split == (overlap == "split")
    want = one.run(one.initial_state(), 3)
    got = sharded.run(sharded.initial_state(), 3)
    assert isinstance(got.u, ShardedArray)
    assert torch.equal(got.u.assemble(), want.u)
    assert (got.t, got.it) == (want.t, want.it)
    assert float((want.u - one.initial_state().u).abs().max()) > 0


# (layout, physical grid, config knobs): a y slab, a split pencil and a
# block, the three WENO variants
JAX_RUNS = [("dy2", N16, {"nu": 1e-3}),
            ("dzdy", N48, {"overlap": "split", "weno_variant": "z",
                           "adaptive_dt": False}),
            ("block", N16, {"weno_order": 7})]


@pytest.mark.parametrize("layout,n,kw", JAX_RUNS,
                         ids=[_run_id(c + ("",))
                              for c in JAX_RUNS])
def test_sharded_run_matches_jax_unsharded(layout, n, kw):
    """The sharded K5 run within 32 eps_f32 of max|u| of the JAX
    package's unsharded fused run (``impl="pallas_stage"``: K5 in
    interpret mode), from the same bounded random state; ``t`` within a
    float32 rounding (adaptive dt: the two packages' CFL steps may
    differ in their last bit), ``it`` equal."""
    jkw = {k: v for k, v in kw.items() if k != "overlap"}
    jsolver = JSolver(JConfig(grid=JGrid.make(*n, lengths=2.0),
                              dtype="float32", impl="pallas_stage", **jkw))
    assert jsolver.engaged_path()["stepper"] == "fused-stage"
    js = jsolver.initial_state()
    u0 = np.random.default_rng(7).uniform(
        -0.1, 1.0, np.asarray(js.u).shape).astype(np.float32)
    js = js._replace(u=jnp.asarray(u0))
    want = jsolver.run(js, 3)
    psolver = _port(_cfg(n, **kw), layout)
    ps = convert.state_from_numpy(np.asarray(js.u), np.asarray(js.t),
                                  mesh=psolver.mesh, decomp=psolver.decomp)
    u, t, it = convert.state_to_numpy(psolver.run(ps, 3))
    ref = np.asarray(want.u)
    assert np.max(np.abs(u - ref)) <= 32 * EPS * np.max(np.abs(ref))
    assert abs(float(t) - float(want.t)) <= 1e-6 * float(want.t)
    assert it == int(want.it) == 3


# --------------------------------------------------------------------- #
# engaged_path() against the JAX package's sharded solvers
# --------------------------------------------------------------------- #
_FIELDS = ("stepper", "overlap", "steps_per_exchange", "exchange")
_Y_GATE = (
    "JAX's per-stage Burgers kernel refuses a y-sharded shard whose ly is "
    "not a multiple of 8 (its TPU sublane tiling, fused_burgers.py:871-877 "
    "and :1011) and declines with 'no viable VMEM block tiling for this "
    "local shape'; K5 keeps no such tiling and runs the shard")
_SPLIT_RULE = (
    "the port splits where lz // 8 >= 3 (K5's edge calls take 8 planes); "
    "JAX where lz // bz >= 3 with bz >= r, bz the z block its VMEM "
    "planner picks (_pick_blocks): a 20-plane shard is 4 blocks of 5 "
    "there and runs serialized-refresh here")
# (layout, physical grid) -> why the port's outcome differs where it does:
# every fused outcome of JAX's is the port's, and the listed tables
# differ exactly where the reason says
DISPATCH = {
    ("dy2", N16): None, ("dx2", N16): None, ("dydx", N16): None,
    ("dzdy", N48): None, ("block", N48): None,
    ("dy2", (400, 200, 206)): _Y_GATE, ("dydx", (40, 24, 20)): _Y_GATE,
    ("dzdy", (16, 16, 40)): _SPLIT_RULE,
}


def _outcome(make):
    try:
        path = make().engaged_path()
    except (ValueError, NotImplementedError) as exc:
        return (type(exc).__name__, str(exc))
    fallback = None if path["stepper"].startswith("fused") else path[
        "fallback"]
    return tuple(path[f] for f in _FIELDS) + (fallback,)


@pytest.mark.parametrize("layout,n", list(DISPATCH),
                         ids=[f"{lay}-{'x'.join(map(str, n))}"
                              for lay, n in DISPATCH])
def test_yx_dispatch_matches_jax(layout, n):
    """Construction and ``engaged_path()`` only, every fused flavor,
    overlap, steps per exchange, exchange, dt mode and WENO order:
    where the JAX package raises, the port raises the same error;
    elsewhere the engaged stepper, overlap, steps per exchange, exchange
    and — off the fused rungs — the fallback are JAX's, apart from the
    table's recorded difference: the y gate (the port runs ``fused-stage``
    where JAX declines with its VMEM text) or the split rule (the port's
    ``overlap`` is ``serialized-refresh`` where JAX's is ``split``)."""
    reason = DISPATCH[(layout, n)]
    sizes, mapping = LAYOUTS[layout]
    nd = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(sizes, devices=jax.devices()[:nd])
    jd = jmesh.Decomposition.of(mapping)
    pm = pmesh.make_mesh(sizes, devices=[CPU] * nd, timeout=20.0)
    pd = pmesh.Decomposition.of(mapping)
    knobs = itertools.product(("pallas", "pallas_stage", "pallas_slab"),
                              ("padded", "split"), (1, 2), (False, True),
                              (5, 7), ("collective", "dma"))
    differ = fused = 0
    for impl, overlap, k, adaptive, order, exchange in knobs:
        kw = dict(impl=impl, overlap=overlap, steps_per_exchange=k,
                  adaptive_dt=adaptive, weno_order=order, exchange=exchange)
        want = _outcome(lambda: JSolver(JConfig(
            grid=JGrid.make(*n, lengths=2.0), dtype="float32", **kw),
            mesh=jm, decomp=jd))
        got = _outcome(lambda: PSolver(PConfig(
            grid=PGrid.make(*n, lengths=2.0), **kw), mesh=pm, decomp=pd))
        fused += got[0] == "fused-stage"
        if got == want:
            continue
        differ += 1
        if reason is _Y_GATE:
            assert "no viable VMEM block tiling" in want[4], kw
            assert got[0] == "fused-stage" and got[1:4] == (
                "serialized-refresh", 1, "collective"), kw
        else:
            assert reason is _SPLIT_RULE, (kw, want, got)
            assert (want[1], got[1]) == ("split", "serialized-refresh"), kw
            assert want[0] == got[0] and want[2:] == got[2:], kw
    assert fused and bool(differ) == (reason is not None)


def test_cli_yx_meshes_print_their_kernel_path(capsys, tmp_path):
    """``burgers3d --mesh dy=2`` and ``--mesh dz=2,dy=2`` on CPU shards:
    the summary names K5's rung and the mesh, and the result equals the
    unsharded run's."""
    base = ["burgers3d", "--n", "16", "16", "16", "--iters", "2",
            "--impl", "pallas", "--device", "cpu", "--save"]
    assert pmain(base + [str(tmp_path / "one")]) == 0
    capsys.readouterr()
    want = np.fromfile(tmp_path / "one" / "result.bin", dtype=np.float32)
    for i, mesh in enumerate(("dy=2", "dz=2,dy=2")):
        assert pmain(base + [str(tmp_path / f"m{i}"), "--mesh", mesh]) == 0
        out = capsys.readouterr().out
        assert "kernel path        : fused-stage (impl=pallas)" in out
        assert "overlap=serialized-refresh" in out
        assert "kernel launches    : none" in out  # the CPU runs twins
        got = np.fromfile(tmp_path / f"m{i}" / "result.bin",
                          dtype=np.float32)
        assert np.array_equal(got, want)
