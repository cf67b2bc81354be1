"""The storage-precision rungs on device meshes (CPU shards), against the
port's unsharded runs and the JAX package, on the CPU.

* The bf16 halo wires (``parallel/halo.py``, ``wire_dtype``): only the
  exchanged ghost slabs, and the edge shards' boundary ghosts, are
  rounded to bf16; the byte count of a bf16 run is exactly half the
  native run's (the JAX suite's ``test_sharded_halo_bytes_halved``).
* ``engaged_path()`` of both packages on ``{"dz": 2}``, ``{"dy": 2}``
  and ``{"dz": 2, "dy": 2}`` (and 2-D ``{"dy": 2}``) under
  ``precision="bf16"`` and ``dtype="bfloat16"``, every fused flavor,
  overlap, steps per exchange and exchange: where the JAX package
  raises, the port raises the same error; elsewhere the same rung,
  schedule, storage dtype and, off the fused rungs, the same reason.
  :data:`DIFFERENCES` lists where the port differs, with the reason.
* Every sharded bf16 twin run (the sharded K1, serialized and split; K3
  at k = 1 and 2; K4; K3/K4 Burgers at WENO orders 5 and 7; the sharded
  K9; ``dtype="bfloat16"`` on the sharded K1) against the unsharded bf16
  twin run of its rung: 0 difference, ``t`` equal. Each shard's ghost
  planes come from a neighbour's bf16 buffer, so nothing is rounded
  that the unsharded run does not round. Each is also held against the
  JAX package's solver of the same config on the same mesh layout and
  state (its sharded bf16 kernels in interpret mode): the same rung, at
  most 1 bf16 ulp a cell, ``t`` equal.
* The carried generic loop on ``{"dz": 2}`` against the JAX package's
  sharded generic bf16 run (``shard_map`` on the 8 host devices of
  ``tests/conftest.py``): within ``2^-15`` of max|u|, the tolerance of
  the unsharded carried loop (``tests/test_torch_precision.py``). It is
  not the unsharded run: the wire drops ``lo``.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models import adr as jadr
from multigpu_advectiondiffusion_tpu.models import burgers as jbur
from multigpu_advectiondiffusion_tpu.models import diffusion as jdif
from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as pmain
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models import adr as padr
from multigpu_advectiondiffusion_tpu_torch.models import burgers as pbur
from multigpu_advectiondiffusion_tpu_torch.models import diffusion as pdif
from multigpu_advectiondiffusion_tpu_torch.models.state import ShardedArray
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import halo as phalo
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
BF16 = torch.bfloat16
FAMILIES = {
    "diffusion": (jdif.DiffusionConfig, jdif.DiffusionSolver,
                  pdif.DiffusionConfig, pdif.DiffusionSolver),
    "burgers": (jbur.BurgersConfig, jbur.BurgersSolver,
                pbur.BurgersConfig, pbur.BurgersSolver),
    "adr": (jadr.ADRConfig, jadr.ADRSolver, padr.ADRConfig, padr.ADRSolver),
}
LAYOUTS = {"dz2": ({"dz": 2}, {0: "dz"}), "dy2": ({"dy": 2}, {1: "dy"}),
           "dz2dy2": ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"}),
           "2d-dy2": ({"dy": 2}, {0: "dy"})}
# physical (nx, ny, nz): a 16-plane shard holds the 12-deep k = 2
# diffusion exchange; Burgers' 24-plane shards hold 2 G at either order
D3, B3, A3, D2 = (24, 16, 32), (16, 16, 48), (16, 12, 20), (40, 32)


def _mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return pmesh.make_mesh(sizes, devices=[CPU] * n, timeout=60.0)


def _port(family, grid, kw, layout=None):
    _, _, pcfg, psol = FAMILIES[family]
    cfg = pcfg(grid=PGrid.make(*grid, lengths=2.0), **kw)
    if layout is None:
        return psol(cfg, device="cpu")
    sizes, mapping = LAYOUTS[layout]
    return psol(cfg, mesh=_mesh(sizes),
                decomp=pmesh.Decomposition.of(mapping))


# --------------------------------------------------------------------- #
# The wires
# --------------------------------------------------------------------- #
def test_bf16_wire_rounds_the_slabs_and_the_edge_ghosts():
    """``exchange_ghosts`` with a bf16 wire on a 3-shard z mesh: every
    received slab is the neighbour's edge rounded to bf16 and back, the
    global edges' Dirichlet ghosts are ``bf16(0.3)``, the interior is
    untouched, and the count is the bf16 slabs' bytes."""
    mesh = _mesh({"dz": 3})
    decomp = pmesh.Decomposition.of({0: "dz"})
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.random((9, 4, 5), dtype=np.float32) + 0.1)
    wall = Boundary("dirichlet", 0.3)

    def body(x):
        lo, hi = phalo.exchange_ghosts(x, 0, 2, "dz", 3, wall,
                                       wire_dtype=BF16)
        return (torch.cat([lo, x, hi], 0),)

    phalo.exchange_ghosts.bytes_per_execution.value = 0
    out = pmesh.shard_map(body, mesh, (decomp,), (decomp,))(
        ShardedArray.scatter(u, mesh, decomp))[0].assemble()
    assert phalo.exchange_ghosts.bytes_per_execution.value == 3 * 2 * (
        2 * 4 * 5 * 2)
    r = u.to(BF16).float()
    w = float(torch.tensor(0.3).to(BF16).float())
    assert float(torch.tensor(0.3)) != w
    for i in range(3):
        blk = out[7 * i:7 * i + 7]
        assert torch.equal(blk[2:5], u[3 * i:3 * i + 3])
        want_lo = r[3 * i - 2:3 * i] if i > 0 else torch.full(
            (2, 4, 5), w)
        want_hi = r[3 * i + 3:3 * i + 5] if i < 2 else torch.full(
            (2, 4, 5), w)
        assert torch.equal(blk[:2], want_lo)
        assert torch.equal(blk[5:], want_hi)


@pytest.mark.parametrize("family,impl", [("diffusion", "xla"),
                                         ("diffusion", "pallas_axis"),
                                         ("burgers", "xla")])
def test_bf16_halo_bytes_halved(family, impl):
    """A generic or per-axis run under ``precision="bf16"`` moves exactly
    half the halo bytes of the same run at native precision."""
    grid = D3 if family == "diffusion" else B3
    moved = {}
    for precision in ("native", "bf16"):
        s = _port(family, grid, dict(impl=impl, precision=precision),
                  "dz2dy2")
        phalo.exchange_ghosts.bytes_per_execution.value = 0
        s.run(s.initial_state(), 2)
        moved[precision] = phalo.exchange_ghosts.bytes_per_execution.value
    assert moved["native"] > 0 and moved["bf16"] * 2 == moved["native"]


def test_fused_refresh_moves_bf16_rows():
    """The fused bf16 rungs' buffers are bf16 themselves: the sharded
    K1's refresh moves half the bytes of the float32 one's."""
    moved = {}
    for precision in ("native", "bf16"):
        s = _port("diffusion", D3, dict(impl="pallas_stage",
                                        precision=precision), "dz2")
        phalo.exchange_ghosts.bytes_per_execution.value = 0
        s.run(s.initial_state(), 1)
        moved[precision] = phalo.exchange_ghosts.bytes_per_execution.value
    assert moved["bf16"] * 2 == moved["native"] > 0


# --------------------------------------------------------------------- #
# engaged_path() against the JAX package's sharded solvers
# --------------------------------------------------------------------- #
_FIELDS = ("stepper", "overlap", "steps_per_exchange", "exchange",
           "storage_dtype", "precision")
_NO_VMEM_GATE = (
    "JAX's per-stage Burgers kernel has a TPU VMEM tiling gate for y- and "
    "x-sharded shards, which declines first with its own text; the port "
    "has no such gate (K5 needs no block to fit a fast memory), so the "
    "bf16 decline of the slab rung names the reason: the same rung")
_SPLIT_CHUNKS = (
    "the sharded K1 takes the split schedule at 3 chunks of Z_CHUNK planes "
    "(a 32-plane shard here), where JAX's VMEM-sized z block leaves fewer "
    "than 3 and it runs serialized-refresh: the float32 rung's recorded "
    "difference (tests/test_torch_sharded.py)")
# (family, layout, physical grid) -> (the field of the outcome that may
# differ, why the port's outcome differs from the JAX package's); each
# listed case must differ, in that field alone, and the rest must not
_SLAB_SPLIT = (
    "the slab rung takes the split schedule wherever a shard holds 3 G "
    "planes (K3's windows need no z block), where JAX's needs 3 VMEM-sized "
    "z blocks of at least G planes; its bf16 block on a 200x400 plane is "
    "thinner than G = 9, so it runs serialized-refresh")
DIFFERENCES = {
    ("burgers", "dy2", (400, 200, 206)): ("fallback", _NO_VMEM_GATE),
    ("diffusion", "dz2", (64, 64, 64)): ("overlap", _SPLIT_CHUNKS),
    ("burgers", "dz2", (400, 200, 206)): ("overlap", _SLAB_SPLIT),
}
DISPATCH = [
    ("diffusion", "dz2", D3), ("diffusion", "dy2", D3),
    ("diffusion", "dz2dy2", D3), ("diffusion", "dz2", (64, 64, 64)),
    ("diffusion", "2d-dy2", D2),
    ("burgers", "dz2", B3), ("burgers", "dy2", B3),
    ("burgers", "dz2dy2", B3), ("burgers", "dz2", (400, 400, 406)),
    ("burgers", "dz2", (400, 200, 206)), ("burgers", "dz2", (200, 100, 104)),
    ("burgers", "dy2", (400, 200, 206)), ("burgers", "2d-dy2", D2),
    ("adr", "dz2", A3), ("adr", "dy2", A3), ("adr", "dz2dy2", A3),
    ("adr", "2d-dy2", D2),
]


def _outcome(make):
    try:
        path = make().engaged_path()
    except (ValueError, NotImplementedError) as exc:
        return (type(exc).__name__, str(exc))
    fallback = None if path["stepper"].startswith("fused") else path[
        "fallback"]
    return tuple(path[f] for f in _FIELDS) + (fallback,)


def _knobs(family, ndim):
    three = ndim == 3
    knobs = itertools.product(
        ("pallas", "pallas_stage", "pallas_step", "pallas_slab"),
        ("padded", "split"), (1, 2) if three else (1,),
        ("collective", "dma") if three else ("collective",),
        ({"precision": "bf16"}, {"dtype": "bfloat16"}))
    for impl, overlap, k, exchange, storage in knobs:
        kw = dict(impl=impl, overlap=overlap, steps_per_exchange=k,
                  exchange=exchange, **storage)
        if family != "burgers":
            yield kw
            continue
        for adaptive, order in itertools.product((False, True), (5, 7)):
            if "dtype" in storage and (adaptive or order == 7):
                continue  # the float32-only decline, once is enough
            yield dict(kw, adaptive_dt=adaptive, weno_order=order)


@pytest.mark.parametrize("family,layout,n", DISPATCH,
                         ids=[f"{f}-{lay}-{'x'.join(map(str, n))}"
                              for f, lay, n in DISPATCH])
def test_bf16_mesh_dispatch_matches_jax(family, layout, n):
    """Construction and ``engaged_path()`` only (no run): the JAX
    package's outcome, or the listed difference."""
    jcfg, jsol, pcfg, psol = FAMILIES[family]
    sizes, mapping = LAYOUTS[layout]
    nd = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(sizes, devices=jax.devices()[:nd])
    jd = jmesh.Decomposition.of(mapping)
    pm, pd = _mesh(sizes), pmesh.Decomposition.of(mapping)
    lengths = 2.0 if family == "burgers" else 10.0
    differ = fused = 0
    for kw in _knobs(family, len(n)):
        with jax.enable_x64(True):
            want = _outcome(lambda: jsol(jcfg(
                grid=JGrid.make(*n, lengths=lengths), **kw), mesh=jm,
                decomp=jd))
        got = _outcome(lambda: psol(pcfg(
            grid=PGrid.make(*n, lengths=lengths), **kw), mesh=pm,
            decomp=pd))
        fused += str(got[0]).startswith("fused")
        if got == want:
            continue
        assert (family, layout, n) in DIFFERENCES, (kw, want, got)
        field = (_FIELDS + ("fallback",)).index(
            DIFFERENCES[family, layout, n][0])
        assert [i for i in range(len(got)) if got[i] != want[i]] == [
            field], (kw, want, got)
        differ += 1
    assert bool(differ) == ((family, layout, n) in DIFFERENCES)
    # the table's fused rungs: K1/K9 on every 3-D layout, K3/K4 on z slabs
    # where the local plane passes the JAX bf16 slab gate
    assert bool(fused) == (len(n) == 3 and not (
        family == "burgers" and (layout != "dz2" or n[:2] == (400, 400))))


def test_bf16_main_grids_engage_the_table_rungs():
    """The table's rows at the main grids on ``{"dz": 2}``, by name."""
    def path(family, n, **kw):
        return _port(family, n, kw, "dz2").engaged_path()

    d = (400, 200, 206)
    for kw, stepper, overlap in (
            (dict(impl="pallas"), "fused-stage", "serialized-refresh"),
            (dict(impl="pallas_stage", overlap="split"), "fused-stage",
             "split"),
            (dict(impl="pallas_slab"), "fused-whole-run-slab",
             "serialized-refresh"),
            (dict(impl="pallas", steps_per_exchange=2),
             "fused-whole-run-slab", "serialized-refresh"),
            (dict(impl="pallas", exchange="dma"), "fused-whole-run-slab",
             "in-kernel")):
        got = path("diffusion", d, precision="bf16", **kw)
        assert (got["stepper"], got["overlap"], got["storage_dtype"]) == (
            stepper, overlap, "bfloat16"), kw
    for n, order in (((400, 200, 206), 5), ((200, 100, 104), 7)):
        for kw, overlap in ((dict(impl="pallas"), "serialized-refresh"),
                            (dict(impl="pallas", exchange="dma"),
                             "in-kernel")):
            got = path("burgers", n, precision="bf16", adaptive_dt=False,
                       weno_order=order, **kw)
            assert (got["stepper"], got["overlap"]) == (
                "fused-whole-run-slab", overlap), (n, kw)
    got = path("burgers", (400, 200, 206), precision="bf16",
               adaptive_dt=False, weno_order=7, impl="pallas")
    assert got["stepper"] == "generic-xla"
    assert "the slab declined" in got["fallback"]
    with pytest.raises(ValueError, match="slab VMEM budget"):
        path("burgers", (400, 400, 406), precision="bf16",
             adaptive_dt=False, impl="pallas", exchange="dma")
    got = path("adr", (508, 204, 160), precision="bf16", impl="pallas")
    assert (got["stepper"], got["storage_dtype"]) == ("fused-stage",
                                                      "bfloat16")


# --------------------------------------------------------------------- #
# Every sharded bf16 twin run against the unsharded bf16 twin run
# --------------------------------------------------------------------- #
_BU = dict(precision="bf16", adaptive_dt=False)
RUNS = {
    # name: (family, grid, layout, sharded kw, unsharded kw, steps)
    "k1": ("diffusion", D3, "dz2", dict(precision="bf16", impl="pallas"),
           dict(precision="bf16", impl="pallas_stage"), 3),
    "k1-split": ("diffusion", D3, "dz2",
                 dict(precision="bf16", impl="pallas_stage",
                      overlap="split"),
                 dict(precision="bf16", impl="pallas_stage"), 3),
    "k1-dy2": ("diffusion", D3, "dy2", dict(precision="bf16",
                                            impl="pallas_stage"),
               dict(precision="bf16", impl="pallas_stage"), 3),
    "k1-dz2dy2": ("diffusion", D3, "dz2dy2",
                  dict(precision="bf16", impl="pallas_stage",
                       overlap="split"),
                  dict(precision="bf16", impl="pallas_stage"), 3),
    "k1-dtype": ("diffusion", D3, "dz2",
                 dict(dtype="bfloat16", impl="pallas_slab"),
                 dict(dtype="bfloat16", impl="pallas_stage"), 3),
    "k3": ("diffusion", D3, "dz2", dict(precision="bf16",
                                        impl="pallas_slab"),
           dict(precision="bf16", impl="pallas_slab"), 3),
    "k3-split-k2": ("diffusion", D3, "dz2",
                    dict(precision="bf16", impl="pallas_slab",
                         overlap="split", steps_per_exchange=2),
                    dict(precision="bf16", impl="pallas_slab"), 5),
    "k4-k2": ("diffusion", D3, "dz2",
              dict(precision="bf16", impl="pallas", exchange="dma",
                   steps_per_exchange=2),
              dict(precision="bf16", impl="pallas_slab"), 5),
    "k3-burgers5": ("burgers", B3, "dz2", dict(_BU, impl="pallas"),
                    dict(_BU, impl="pallas"), 3),
    "k3-burgers7-split": ("burgers", B3, "dz2",
                          dict(_BU, impl="pallas", weno_order=7,
                               overlap="split"),
                          dict(_BU, impl="pallas", weno_order=7), 3),
    "k4-burgers5": ("burgers", B3, "dz2",
                    dict(_BU, impl="pallas_slab", exchange="dma"),
                    dict(_BU, impl="pallas_slab"), 3),
    "k4-burgers7": ("burgers", B3, "dz2",
                    dict(_BU, impl="pallas", weno_order=7, exchange="dma",
                         nu=1e-3),
                    dict(_BU, impl="pallas", weno_order=7, nu=1e-3), 3),
    "k9": ("adr", A3, "dz2", dict(precision="bf16", impl="pallas"),
           dict(precision="bf16", impl="pallas"), 3),
    "k9-dz2dy2": ("adr", A3, "dz2dy2", dict(precision="bf16",
                                            impl="pallas_stage"),
                  dict(precision="bf16", impl="pallas"), 3),
}
_WRAPPERS = {"k3": psr.slab_step_diffusion_bf16,
             "k3-split-k2": psr.slab_step_diffusion_bf16,
             "k4-k2": psr.slab_run_dma_diffusion_bf16,
             "k3-burgers5": psr.slab_step_burgers_bf16,
             "k3-burgers7-split": psr.slab_step_burgers_bf16,
             "k4-burgers5": psr.slab_run_dma_burgers_bf16,
             "k4-burgers7": psr.slab_run_dma_burgers_bf16}


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
    for a in (got, want):
        assert np.array_equal(a, np.asarray(
            torch.from_numpy(a).to(BF16).float()))
    return int(np.max(np.abs(_ordered(got) - _ordered(want))))


@functools.lru_cache(maxsize=None)
def _twin_runs(name):
    """The sharded run of ``RUNS[name]`` and the unsharded run of its
    rung from one state: ``(sharded solver, sharded result, unsharded
    result, u0 as float32, t0)``."""
    family, grid, layout, kw, plain, steps = RUNS[name]
    sharded = _port(family, grid, kw, layout)
    one = _port(family, grid, plain)
    state = one.initial_state()
    dtype = kw.get("dtype", "float32")
    u0 = state.u.float().numpy()
    if family == "burgers":
        u0 = np.random.default_rng(7).uniform(-0.1, 1.0, u0.shape).astype(
            np.float32)
    got = sharded.run(convert.state_from_numpy(
        u0, float(state.t), mesh=sharded.mesh,
        decomp=pmesh.Decomposition.of(LAYOUTS[layout][1]), dtype=dtype),
        steps)
    want = one.run(convert.state_from_numpy(u0, float(state.t),
                                            device="cpu", dtype=dtype),
                   steps)
    return sharded, got, want, u0, float(state.t)


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_bf16_twin_run_equals_unsharded(name):
    family, grid, layout, kw, plain, steps = RUNS[name]
    sharded, got, want, u0, _ = _twin_runs(name)
    path = sharded.engaged_path()
    ref = _port(family, grid, plain).engaged_path()
    assert path["storage_dtype"] == ref["storage_dtype"] == "bfloat16"
    assert path["stepper"].startswith("fused") and ref["stepper"].startswith(
        "fused"), (path, ref)
    st = sharded._fused_stepper()
    if name in _WRAPPERS:
        assert st.dtype == BF16 and st.sharded
    assert isinstance(got.u, ShardedArray)
    g = got.u.assemble()
    assert g.dtype == want.u.dtype
    assert torch.equal(g, want.u)
    assert (got.t, got.it) == (want.t, want.it)
    assert float((want.u.float() - torch.from_numpy(u0)).abs().max()) > 0


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_bf16_twin_run_matches_jax(name):
    """The port's sharded bf16 run against the JAX package's solver of the
    same config on the same mesh layout and state (its sharded bf16
    kernels in interpret mode under ``shard_map``): the same rung, at
    most 1 bf16 ulp a cell (the tolerance of the unsharded bf16 runs,
    ``tests/test_torch_precision.py``), ``t`` and the step count equal.
    Among what this holds is the value of the planes outside the domain
    that each edge shard's bf16 buffer carries."""
    family, grid, layout, kw, _, steps = RUNS[name]
    sharded, got, _, u0, t0 = _twin_runs(name)
    jcfg, jsol, _, _ = FAMILIES[family]
    sizes, mapping = LAYOUTS[layout]
    nd = int(np.prod(list(sizes.values())))
    js = jsol(jcfg(grid=JGrid.make(*grid, lengths=2.0),
                   **{"dtype": "float32", **kw}),
              mesh=jmesh.make_mesh(sizes, devices=jax.devices()[:nd]),
              decomp=jmesh.Decomposition.of(mapping))
    jp, pp = js.engaged_path(), sharded.engaged_path()
    assert [jp[f] for f in _FIELDS] == [pp[f] for f in _FIELDS]
    s0 = js.initial_state()
    assert float(s0.t) == t0
    s0 = s0._replace(u=jax.device_put(jnp.asarray(u0).astype(s0.u.dtype),
                                      s0.u.sharding))
    want = js.run(s0, steps)
    assert got.it == int(want.it) and got.t == np.float32(want.t)
    g = got.u.assemble().float().numpy()
    w = np.array(want.u.astype(jnp.float32))
    ulps = bf16_ulps(g, w)
    print(f"{name}: {ulps} bf16 ulps from the JAX package's run")
    assert ulps <= 1


def test_sharded_bf16_wrappers_check_their_buffers():
    """The bf16 K3/K4 wrappers take bf16 buffers only, and the float32
    ones float32 only."""
    S = torch.zeros((12 + 12, 20, 28), dtype=BF16)
    kw = dict(taps=(0.0,) * 15, band=2, bc_value=0.0, global_nz=24, oz=0,
              depth=6, window=(0, 12))
    with pytest.raises(TypeError, match="bfloat16 only"):
        psr.slab_step_diffusion_bf16(S.float(), S.float().clone(), 0.1,
                                     **kw)
    with pytest.raises(TypeError, match="float32 only"):
        psr.slab_step_diffusion(S, S.clone(), 0.1, **kw)
    lands = [torch.zeros((2, 2, 6, 20, 28), dtype=torch.float32)] * 2
    with pytest.raises(TypeError, match="bfloat16 only"):
        psr.slab_run_dma_diffusion_bf16(
            [S, S.clone()], [S.clone(), S.clone()],
            [x.clone() for x in lands], 1, 0.1, taps=(0.0,) * 15, band=2,
            bc_value=0.0)


def test_k4_bf16_landing_buffer_is_bf16():
    """K4's bf16 run posts bf16 landing buffers, and its remote bytes are
    half the float32 run's."""
    moved = {}
    for precision in ("native", "bf16"):
        s = _port("diffusion", D3, dict(impl="pallas_slab", exchange="dma",
                                        precision=precision), "dz2")
        assert s._fused_stepper().remote_dma is not None
        phalo.record_remote_dma.bytes_per_execution.value = 0
        s.run(s.initial_state(), 3)
        moved[precision] = phalo.record_remote_dma.bytes_per_execution.value
        assert s._fused_stepper().stencil_spec()["bytes_per_cell"] == (
            2 if precision == "bf16" else 4)
    assert moved["bf16"] * 2 == moved["native"] > 0


# --------------------------------------------------------------------- #
# The carried generic loop against the JAX package's sharded run
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("family,impl", [("diffusion", "xla"),
                                         ("diffusion", "pallas_step"),
                                         ("burgers", "xla")])
def test_carried_generic_loop_on_mesh_matches_jax(family, impl,
                                                  monkeypatch):
    """``run(3)`` of the packed generic loop on ``{"dz": 2}`` within
    ``2^-15`` of max|u| of the JAX package's sharded run, ``t`` and the
    step count equal, and not equal to the port's unsharded run (the
    wire drops ``lo``)."""
    monkeypatch.delenv("TPUCFD_BF16_NO_CARRY", raising=False)
    jcfg, jsol, _, _ = FAMILIES[family]
    n = D3 if family == "diffusion" else (16, 12, 24)
    kw = dict(impl=impl, precision="bf16")
    if family == "burgers":
        kw.update(adaptive_dt=False, nu=1e-3)
    sizes, mapping = LAYOUTS["dz2"]
    jm = jmesh.make_mesh(sizes, devices=jax.devices()[:2])
    js = jsol(jcfg(grid=JGrid.make(*n, lengths=2.0), dtype="float32", **kw),
              mesh=jm, decomp=jmesh.Decomposition.of(mapping))
    ps = _port(family, n, kw, "dz2")
    assert ps.engaged_path()["stepper"] == js.engaged_path()["stepper"]
    s0 = js.initial_state()
    u0 = np.asarray(s0.u)
    if family == "burgers":
        u0 = np.random.default_rng(9).uniform(0.0, 1.0, u0.shape).astype(
            np.float32)
        s0 = s0._replace(u=jax.device_put(jnp.asarray(u0),
                                          s0.u.sharding))
    want = js.run(s0, 3)
    got = ps.run(convert.state_from_numpy(
        u0, np.float32(s0.t), mesh=ps.mesh,
        decomp=pmesh.Decomposition.of(mapping)), 3)
    assert got.it == int(want.it) and got.t == np.float32(want.t)
    g, w = got.u.assemble().numpy(), np.asarray(want.u)
    gap = float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
    print(f"{family} {impl}: {gap * 2 ** 15:.3f} x 2^-15 of max|u|")
    assert gap <= 2.0 ** -15
    one = _port(family, n, kw)
    alone = one.run(convert.state_from_numpy(u0, np.float32(s0.t),
                                             device="cpu"), 3)
    assert not torch.equal(alone.u, got.u.assemble())


# --------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------- #
def test_cli_bf16_mesh_prints_its_storage(capsys, tmp_path):
    """``diffusion3d --precision bf16 --mesh dz=2`` on CPU shards runs the
    sharded K1's twin, names the storage type, and equals the unsharded
    bf16 run."""
    base = ["diffusion3d", "--n", "24", "16", "32", "--iters", "2",
            "--device", "cpu", "--precision", "bf16", "--impl",
            "pallas_stage"]
    assert pmain(base + ["--mesh", "dz=2", "--save",
                         str(tmp_path / "m")]) == 0
    out = capsys.readouterr().out
    assert "float32 (storage bfloat16, precision=bf16)" in out
    assert "fused-stage (impl=pallas_stage)" in out and "dz" in out
    assert pmain(base + ["--save", str(tmp_path / "o")]) == 0
    capsys.readouterr()
    got, want = (np.fromfile(tmp_path / d / "result.bin", dtype=np.float32)
                 for d in ("m", "o"))
    assert np.array_equal(got, want)
