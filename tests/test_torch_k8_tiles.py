"""K8/K8b's launch plans on the CPU: the tile planner
(``fused2d_sharded.plan_tiles``), the paired edge-band role of K8b, the
stepper's launch plans, and a CUDA device without a card.

* The planner's tiles cover every row and column that a launch writes
  exactly once, on the main shard (200x400 of 400^2 on ``{"dy": 2}``),
  an odd one (23x37), the split schedule's edge bands of h = 2, 3 and 4
  rows and a 2048x4096 shard, for each body; each tile's window stays in
  the padded buffer or the exchanged operands, a block has no more
  threads than a full tile has cells (an edge band's CELL block a row of
  threads a row), and a window load of several floats stays aligned.
* The paired edge-band twin (both edge bands in one call) equals the two
  single-band twin calls bit for bit, the emitted maximum too, for
  diffusion, WENO5-JS, WENO5-Z viscous and WENO7-JS, every stage kind.
* A two-shard ``{"dy": 2}`` run, serialized and split, at both WENO
  orders (and diffusion), equals bit for bit the same run stepped by the
  previous schedule: one fused2d_stage a stage, or the split schedule's
  three fused2d_band_stage calls.
* A CUDA device without a card raises, and a plan for the CPU given a
  tensor on a CUDA device raises; the twin never stands in.
"""

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig,
    BurgersSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig,
    DiffusionSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused2d_sharded as pfs,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as fb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

SPACING = (0.05, 0.04)
FAMILIES = {
    "diffusion": pfs.DiffusionParams(fd.stage_taps(SPACING, (1.0, 0.5)), 2,
                                     0.25),
    "weno5-js": fb.stage_params(pflux.get("burgers"), "js", SPACING, 0.0),
    "weno5-z-viscous": fb.stage_params(pflux.get("burgers"), "z", SPACING,
                                       1e-3),
    "weno7-js": fb.stage_params(pflux.get("burgers"), "js", SPACING, 0.0,
                                order=7),
}
# (name, bands (r0, r1), lx, reach, Burgers?, order)
LAUNCHES = [
    ("main", ((0, 200),), 400, 3, True, 5),
    ("main-interior", ((3, 197),), 400, 3, True, 5),
    ("main-weno7", ((0, 204),), 400, 4, True, 7),
    ("main-diffusion", ((0, 200),), 400, 2, False, 5),
    ("odd", ((0, 23),), 37, 3, True, 5),
    ("odd-weno7", ((0, 23),), 37, 4, True, 7),
    ("edges-h2", ((0, 2), (198, 200)), 400, 2, False, 5),
    ("edges-h3", ((0, 3), (197, 200)), 400, 3, True, 5),
    ("edges-h4", ((0, 4), (200, 204)), 400, 4, True, 7),
    ("edges-h3-odd", ((0, 3), (20, 23)), 37, 3, True, 5),
    ("large", ((0, 2048),), 4096, 3, True, 5),
    ("large-weno7", ((0, 2048),), 4096, 4, True, 7),
    ("large-diffusion", ((0, 2048),), 4096, 2, False, 5),
]
BODIES = {"planned": {}, "cell": {"body": pfs.CELL},
          "tiled": {"body": pfs.TILED}}


def _plan(bands, lx, r, burgers, order, **kw):
    return pfs.plan_tiles([b - a for a, b in bands], lx, r, burgers=burgers,
                          order=order, **kw)


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("launch", LAUNCHES, ids=[c[0] for c in LAUNCHES])
def test_tiles_cover_each_written_cell_once(launch, body):
    """Every row and column a launch writes lies in exactly one tile;
    every tile's window (the tile and ``r`` cells a side, clamped to the
    global domain, which only shrinks it) lies in the padded buffer or,
    past the shard's rows, in the ``(r, lx + 2r)`` operands; each tile is
    within the planned sides, its planes within the shared memory, a
    block's threads no more than a full tile's cells (or 32), and a window
    load of ``vec`` floats starts on a multiple of ``vec`` in rows whose
    pitch is one."""
    name, bands, lx, r, burgers, order = launch
    if body == "tiled" and not burgers:
        with pytest.raises(ValueError, match="no TILED body"):
            _plan(bands, lx, r, burgers, order, **BODIES[body])
        body = "cell"
    plan = _plan(bands, lx, r, burgers, order, **BODIES[body])
    ly = max(b for _, b in bands) + (0 if "interior" not in name else 3)
    tiles = pfs.tiles_of(plan, bands, lx)
    assert len(tiles) == plan["tiles"]
    count = np.zeros((ly, lx), dtype=np.int64)
    ty, tx = plan["tile"]
    full = min(y1 - y0 for y0, y1, _, _ in tiles) * min(tx, lx)
    for y0, y1, x0, x1 in tiles:
        count[y0:y1, x0:x1] += 1
        assert 0 < y1 - y0 <= ty and 0 < x1 - x0 <= tx
        assert -r <= y0 - r and y1 + r <= ly + r  # buffer rows or lo/hi
        assert -r <= x0 - r and x1 + r <= lx + r
        if plan["body"] == pfs.TILED:
            assert plan["pitch"] >= (x1 - x0) + 2 * r + pfs.SPARE
            assert plan["plane"] >= ((y1 - y0) + 2 * r + pfs.SPARE) * plan[
                "pitch"]
    written = np.zeros((ly, lx), dtype=np.int64)
    for a, b in bands:
        written[a:b] = 1
    assert np.array_equal(count, written)
    if plan["body"] == pfs.TILED:
        assert plan["threads"] <= max(full, 32)
        assert plan["smem"] == plan["plane"] * 4 * pfs.PLANES
        assert plan["vec"] in (1, pfs.VEC[r])
        if plan["vec"] > 1:  # the window's padded columns start at x0
            assert (lx + 2 * r) % plan["vec"] == 0
            assert all(x0 % plan["vec"] == 0 for _, _, x0, _ in tiles)
        assert plan["vec"] == (pfs.VEC[r] if (lx + 2 * r) % pfs.VEC[r] == 0
                               and tx % pfs.VEC[r] == 0 else 1)
    else:  # a row of 32 threads a tile row, no more rows than the tiles'
        assert plan["threads"] == 32 * ty
        assert max(y1 - y0 for y0, y1, _, _ in tiles) == ty
        assert ty <= pfs.CELL_BLOCK[0] and tx == pfs.CELL_BLOCK[1]


def test_planner_rule():
    """The bodies and thread counts the planner picks: Burgers TILED on
    2048x4096 (a throughput-bound launch: 32x32 tiles of 128 threads and
    window loads of 8 bytes at WENO5, 32x64 of 256 threads and 16 bytes at
    WENO7) at both orders and on the 204x400 shard at order 7 (512
    threads, 32 columns, a tile an SM), CELL at WENO5 on the 200x400 shard
    (bound by its latency) and on the edge bands with a row of threads a
    band row; diffusion CELL everywhere."""
    for order, r in ((5, 3), (7, 4)):
        large = _plan(((0, 2048),), 4096, r, True, order)
        assert large["body"] == pfs.TILED
        assert (large["tile"], large["threads"]) == {
            5: ((32, 32), 128), 7: ((32, 64), 256)}[order]
        assert large["vec"] == {3: 2, 4: 4}[r]
        assert large["tiles"] > pfs.H100["sms"]
        edges = _plan(((0, r), (200 - r, 200)), 400, r, True, order)
        assert (edges["body"], edges["threads"]) == (pfs.CELL, 32 * r)
    main7 = _plan(((0, 204),), 400, 4, True, 7)
    assert (main7["body"], main7["threads"]) == (pfs.TILED, 512)
    assert main7["tile"][1] == pfs.TILE_X
    assert main7["tiles"] <= pfs.H100["sms"]
    assert _plan(((0, 200),), 400, 3, True, 5)["body"] == pfs.CELL
    for bands, lx in ((((0, 200),), 400), (((0, 2048),), 4096)):
        assert _plan(bands, lx, 2, False, 5)["body"] == pfs.CELL
    # the plan of a shape, card and instance is worked out once
    assert _plan(((0, 204),), 400, 4, True, 7) is main7


def test_ops_issued_each_face_once():
    """The TILED Burgers body issues each split and face once a tile:
    on the main shard's plan 219-239 operations a cell (the face-once
    count, WENO5-JS inviscid and viscous) plus the windows' and the runs'
    overhead, under 1.5x (the TILED plan of the main shard's launch)."""
    for name, nu, low in (("inviscid", 0.0, 219), ("viscous", 1e-3, 239)):
        params = fb.stage_params(pflux.get("burgers"), "js", SPACING, nu)
        plan = _plan(((0, 200),), 400, 3, True, 5, body=pfs.TILED)
        per_cell = pfs.ops_issued(plan, ((0, 200),), 400, params) / 80000
        assert low < per_cell < 1.5 * low, (name, per_cell)


def _shard(params, seed, ly=14, lx=19):
    h = pfs.halo_of(params)
    rng = np.random.default_rng(seed)

    def rand(shape):
        return torch.from_numpy(rng.uniform(-0.2, 1.0, shape).astype(
            np.float32))

    padded = (ly + 2 * h, lx + 2 * h)
    return h, ly, rand(padded), rand(padded), rand(padded), rand(
        (h, padded[1])), rand((h, padded[1]))


@pytest.mark.parametrize("shard", [((14, 0), (42, 19)), ((0, 0), (28, 19)),
                                   ((14, 19), (28, 38))],
                         ids=["middle", "first", "pencil-corner"])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_paired_edges_equal_two_band_calls(family, kind, shard):
    """K8b's paired edge role on the CPU equals the bottom and top band
    calls in the split schedule's order, bit for bit; the emitted
    maximum is folded alike and equal."""
    params = FAMILIES[family]
    h, ly, v, u, out0, lo, hi = _shard(params, 10 * kind + 1)
    offsets, gshape = shard
    a, b = fd.STAGES[kind]
    burgers = family != "diffusion"
    dt = torch.tensor(0.002) if burgers else 0.002
    kw = dict(params=params, a=a, b=b, global_shape=gshape)
    u_arg = None if kind == 0 else u
    _, bottom, top = pfs.split_bands(ly, h)
    want, got = out0.clone(), out0.clone()
    mx_w = torch.full((), 0.5) if burgers else None
    mx_g = torch.full((), 0.5) if burgers else None
    pfs.fused2d_band_stage(v, u_arg, want, dt, offsets, rows=bottom[0],
                           lo=lo, mx=mx_w, mx_init=False, **kw)
    pfs.fused2d_band_stage(v, u_arg, want, dt, offsets, rows=top[0], hi=hi,
                           mx=mx_w, mx_init=False, **kw)
    pfs.fused2d_band_stage(v, u_arg, got, dt, offsets,
                           rows=pfs.edge_bands(ly, h), lo=lo, hi=hi,
                           mx=mx_g, mx_init=False, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, out0)
    if burgers:
        assert mx_g.item() == mx_w.item()
    with pytest.raises(ValueError, match="not a band"):
        pfs.fused2d_band_stage(v, u_arg, got, dt, offsets,
                               rows=pfs.edge_bands(ly, h), lo=lo, **kw)


def _previous_step(self, S, T1, T2, dt, m=None, refresh=None, offsets=None,
                   exch=None):
    """The stepper's stage loop before the launch plans: one
    fused2d_stage a stage, or the split schedule's three
    fused2d_band_stage calls (interior, then bottom and top)."""
    offs = tuple(offsets) if offsets is not None else (0, 0)
    kw = dict(params=self.params, global_shape=self.global_shape)
    (a1, b1), (a2, b2), (a3, b3) = fd.STAGES
    for v, u, out, a, b, mx in ((S, None, T1, a1, b1, None),
                                (T1, S, T2, a2, b2, None),
                                (T2, S, S, a3, b3, m)):
        if self.overlap_split:
            lo, hi = exch(v)
            (mid, _), (bottom, _), (top, _) = pfs.split_bands(
                self.interior_shape[0], self.halo)
            pfs.fused2d_band_stage(v, u, out, dt, offs, rows=mid, mx=mx,
                                   a=a, b=b, **kw)
            pmesh.wait_exchange(lo, hi)
            pfs.fused2d_band_stage(v, u, out, dt, offs, rows=bottom, lo=lo,
                                   mx=mx, mx_init=False, a=a, b=b, **kw)
            pfs.fused2d_band_stage(v, u, out, dt, offs, rows=top, hi=hi,
                                   mx=mx, mx_init=False, a=a, b=b, **kw)
        else:
            pfs.fused2d_stage(v, u, out, dt, offs, a=a, b=b, mx=mx, **kw)
        if refresh is not None:
            refresh(out)
    return S, T1, T2


RUNS = {  # (solver, config): 32 x 40 (arrays 40 x 32) on {"dy": 2}
    "weno5-adaptive": (BurgersSolver, dict(weno_variant="z", nu=1e-3)),
    "weno5-fixed": (BurgersSolver, dict(adaptive_dt=False)),
    "weno7-adaptive": (BurgersSolver, dict(weno_order=7)),
    "weno7-fixed": (BurgersSolver, dict(weno_order=7, adaptive_dt=False)),
    "diffusion": (DiffusionSolver, {}),
}


@pytest.mark.parametrize("overlap", ["padded", "split"])
@pytest.mark.parametrize("run", list(RUNS))
def test_runs_equal_the_previous_schedule(monkeypatch, run, overlap):
    """A two-shard ``{"dy": 2}`` run on the launch plans (the split
    schedule's two launches a stage) equals the run stepped by the
    previous schedule bit for bit, ``t`` and the steps equal."""
    cls, extra = RUNS[run]
    cfg_cls = BurgersConfig if cls is BurgersSolver else DiffusionConfig
    cfg = cfg_cls(grid=Grid.make(32, 40, lengths=2.0), impl="pallas",
                  overlap=overlap, **extra)

    def solve():
        mesh = pmesh.make_mesh({"dy": 2},
                               devices=[torch.device("cpu")] * 2,
                               timeout=60.0)
        solver = cls(cfg, mesh=mesh)
        assert solver.engaged_path()["stepper"] == "fused-stage"
        assert solver._fused_stepper().overlap_split == (overlap == "split")
        return solver.run(solver.initial_state(), 3)

    got = solve()
    monkeypatch.setattr(pfs._Sharded2DStepper, "_step", _previous_step)
    want = solve()
    assert torch.equal(got.u.assemble(), want.u.assemble())
    assert (got.t, got.it) == (want.t, want.it)


def test_cuda_device_without_a_card_raises(monkeypatch):
    """A plan or a launch for a CUDA device builds the kernel or raises:
    on a machine without a card (and without nvcc) it raises, and the
    twin never runs in its place."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def twin(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(pfs, "_twin", twin)
    params = FAMILIES["weno5-js"]
    with pytest.raises(RuntimeError):
        pfs.StagePlan(pfs.fused2d_stage, params, 0.0, 1.0, (16, 46), (0, 0),
                      (10, 40), (((0, 10), None),), "cuda:0")
    st = pfs.ShardedFusedBurgers2DStepper(
        (10, 40), SPACING, pflux.get("burgers"), "js", 0.0, 0.4, "cpu",
        global_shape=(20, 40))
    with FakeTensorMode(allow_non_fake_inputs=True):
        S = torch.empty((16, 46), device="cuda")
    assert S.device.type == "cuda"
    launches = pfs.fused2d_stage.launches
    # torch without CUDA raises AssertionError for the stream, nvcc's
    # absence RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        st.stage_plans(S, S, S, (0, 0))
    assert pfs.fused2d_stage.launches == launches


@pytest.mark.parametrize("slot", ["v", "u", "out", "lo", "hi", "dt", "mx"])
def test_cpu_plan_refuses_a_cuda_tensor(monkeypatch, slot):
    """A plan for the CPU runs the twin on CPU tensors only: given a
    tensor on a CUDA device in any slot of a launch (the buffers, the
    edge bands' operands, dt, the maximum), the lean entry raises and the
    twin never runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def twin(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(pfs, "_twin", twin)
    params = FAMILIES["weno5-js"]
    h, ly, v, u, out, lo, hi = _shard(params, 7)
    _, bottom, top = pfs.split_bands(ly, h)
    plan = pfs.StagePlan(pfs.fused2d_band_stage, params, 0.75, 0.25,
                         v.shape, (14, 0), (42, 19), (bottom, top), "cpu")
    args = dict(v=v, u=u, out=out, lo=lo, hi=hi, dt=torch.tensor(0.002),
                mx=torch.zeros(()))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args[slot] = torch.empty(args[slot].shape, device="cuda")
    assert args[slot].device.type == "cuda"
    launches = pfs.fused2d_band_stage.launches
    with pytest.raises(ValueError, match="a plan for the CPU"):
        pfs.launch(plan, args["v"], args["u"], args["out"], args["dt"],
                   lo=args["lo"], hi=args["hi"], mx=args["mx"])
    assert pfs.fused2d_band_stage.launches == launches
