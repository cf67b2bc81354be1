"""The sharded solvers of the port on CPU device meshes (shards on
``torch.device("cpu")``): the generic, per-axis and per-stage rungs
against the port's unsharded runs and the JAX package's unsharded runs,
the dispatch sweep against the JAX package's sharded solvers, the
configurations that still raise, ``advance_to`` and the CLI.

Tolerances:
* sharded against the port's unsharded run of the same rung: 0
  difference and ``t`` equal (the per-cell arithmetic is the same; only
  where ghosts come from differs);
* the generic rung in float64 against the JAX package's unsharded run:
  1e-12 of max|u| (XLA may contract multiply-adds the port rounds);
* the per-stage rung (K1's twin) against the JAX package's unsharded
  fused run in Pallas interpret mode: 32 eps_f32 of max|u|, the bound
  the unsharded twins are held to (``tests/test_torch_fused_diffusion``).
The JAX sharded runs are not the oracle: several of them fail on the
CPU backend (``tests/test_sharded.py``), so the oracle is the JAX
unsharded run, as those tests build it. Every mesh has a timeout of 60 s a collective.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.adr import (
    ADRConfig as JAConfig,
    ADRSolver as JASolver,
)
from multigpu_advectiondiffusion_tpu.models.burgers import (
    BurgersConfig as JBConfig,
    BurgersSolver as JBSolver,
)
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JDConfig,
    DiffusionSolver as JDSolver,
)
from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as pmain
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.adr import (
    ADRConfig as PAConfig,
    ADRSolver as PASolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PBConfig,
    BurgersSolver as PBSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PDConfig,
    DiffusionSolver as PDSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import ShardedArray
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS = float(np.finfo(np.float32).eps)
SLAB, PENCIL, BLOCK = ({"dz": 4}, {0: "dz"}), (
    {"dz": 2, "dy": 2}, {0: "dz", 1: "dy"}), (
    {"dz": 2, "dy": 2, "dx": 2}, {0: "dz", 1: "dy", 2: "dx"})


def _mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return pmesh.make_mesh(sizes, devices=[CPU] * n, timeout=60.0)


def _port(cls, cfg, layout=None):
    if layout is None:
        return cls(cfg, device="cpu")
    sizes, mapping = layout
    return cls(cfg, mesh=_mesh(sizes),
               decomp=pmesh.Decomposition.of(mapping))


def _bit_exact(cls, cfg, layout, iters, plain=None):
    """The sharded run of ``cfg`` equals the unsharded run of ``plain``
    (default ``cfg``) to the bit, ``t`` and ``it`` equal."""
    one = _port(cls, plain or cfg)
    sharded = _port(cls, cfg, layout)
    want = one.run(one.initial_state(), iters)
    got = sharded.run(sharded.initial_state(), iters)
    assert isinstance(got.u, ShardedArray)
    assert torch.equal(got.u.assemble(), want.u)
    assert (got.t, got.it) == (want.t, want.it)
    assert float((want.u - one.initial_state().u).abs().max()) > 0
    return sharded, got


# --------------------------------------------------------------------- #
# The generic and per-axis rungs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("overlap", ["padded", "split"])
@pytest.mark.parametrize("layout", [SLAB, PENCIL, BLOCK],
                         ids=["slab", "pencil", "block"])
@pytest.mark.parametrize("impl", ["xla", "pallas_axis"])
def test_generic_diffusion_bit_exact(impl, layout, overlap):
    cfg = PDConfig(grid=PGrid.make(24, 16, 16, lengths=10.0), impl=impl,
                   overlap=overlap)
    s, _ = _bit_exact(PDSolver, cfg, layout, 4)
    assert s.engaged_path()["overlap"] == overlap


@pytest.mark.parametrize("overlap", ["padded", "split"])
@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
def test_generic_burgers_bit_exact(adaptive, overlap):
    cfg = PBConfig(grid=PGrid.make(12, 10, 16, lengths=2.0),
                   adaptive_dt=adaptive, nu=1e-5, overlap=overlap)
    _bit_exact(PBSolver, cfg, SLAB, 3)


def test_edge_wall_diffusion_bit_exact():
    """Zero-gradient walls copy the first evolving row into the band:
    the source row's local index, clipped into the shard."""
    cfg = PDConfig(grid=PGrid.make(24, 16, 16, lengths=10.0), bc="edge")
    _bit_exact(PDSolver, cfg, SLAB, 3)


@pytest.mark.parametrize("family", ["diffusion", "burgers"])
def test_generic_float64_matches_jax_unsharded(family):
    """Float64 on the generic rung of a z-slab mesh within 1e-12 of
    max|u| of the JAX package's unsharded run."""
    if family == "diffusion":
        kw = dict(dtype="float64", impl="xla")
        jg, pg = JGrid.make(24, 16, 16, lengths=10.0), PGrid.make(
            24, 16, 16, lengths=10.0)
        jsolver = JDSolver(JDConfig(grid=jg, **kw))
        psolver = _port(PDSolver, PDConfig(grid=pg, **kw), SLAB)
    else:
        kw = dict(dtype="float64", nu=1e-5)
        jg, pg = JGrid.make(12, 10, 16, lengths=2.0), PGrid.make(
            12, 10, 16, lengths=2.0)
        jsolver = JBSolver(JBConfig(grid=jg, **kw))
        psolver = _port(PBSolver, PBConfig(grid=pg, **kw), SLAB)
    js = jsolver.initial_state()
    want = jsolver.run(js, 3)
    ps = convert.state_from_numpy(np.asarray(js.u), np.asarray(js.t),
                                  mesh=psolver.mesh, decomp=psolver.decomp)
    got = psolver.run(ps, 3)
    u, t, it = convert.state_to_numpy(got)
    ref = np.asarray(want.u)
    assert np.max(np.abs(u - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert abs(float(t) - float(want.t)) <= 1e-12 and it == int(want.it)


# --------------------------------------------------------------------- #
# The per-stage rung: K1's and K5's sharded twins
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", [SLAB, PENCIL, BLOCK],
                         ids=["slab", "pencil", "block"])
def test_k1_sharded_bit_exact(layout):
    cfg = PDConfig(grid=PGrid.make(24, 16, 16, lengths=10.0),
                   impl="pallas_stage")
    s, _ = _bit_exact(PDSolver, cfg, layout, 4)
    path = s.engaged_path()
    assert (path["stepper"], path["overlap"]) == (
        "fused-stage", "serialized-refresh")


@pytest.mark.parametrize("layout", [({"dz": 2}, {0: "dz"}), PENCIL],
                         ids=["slab", "pencil"])
def test_k1_split_bit_exact(layout):
    """The split schedule: three launches a stage, the edge calls on the
    exchanged slabs (a pencil's y ghosts refreshed in between)."""
    cfg = PDConfig(grid=PGrid.make(16, 16, 48, lengths=4.0),
                   impl="pallas_stage", overlap="split")
    s, _ = _bit_exact(PDSolver, cfg, layout, 3,
                      plain=dataclasses.replace(cfg, overlap="padded"))
    assert s._fused_stepper().overlap_split
    assert s.engaged_path()["overlap"] == "split"


def test_k1_minimal_shards_bit_exact():
    """16³ on 8 z shards: every shard is 2 planes thick, and the edge
    shards lie wholly inside the frozen boundary band."""
    cfg = PDConfig(grid=PGrid.make(16, 16, 16, lengths=4.0), impl="pallas")
    s, _ = _bit_exact(PDSolver, cfg, ({"dz": 8}, {0: "dz"}), 4,
                      plain=dataclasses.replace(cfg, impl="pallas_stage"))
    assert s.engaged_path()["stepper"] == "fused-stage"


def test_k1_sharded_matches_jax_unsharded_fused():
    """K1's sharded twin within 32 eps of max|u| of the JAX package's
    unsharded fused run (K1 in Pallas interpret mode)."""
    jg = JGrid.make(24, 16, 16, lengths=10.0)
    jsolver = JDSolver(JDConfig(grid=jg, dtype="float32",
                                impl="pallas_stage"))
    js = jsolver.initial_state()
    want = np.asarray(jsolver.run(js, 3).u)
    psolver = _port(PDSolver, PDConfig(grid=PGrid.make(24, 16, 16,
                                                       lengths=10.0),
                                       impl="pallas_stage"), SLAB)
    ps = convert.state_from_numpy(np.asarray(js.u), np.asarray(js.t),
                                  mesh=psolver.mesh, decomp=psolver.decomp)
    got = convert.state_to_numpy(psolver.run(ps, 3))[0]
    assert np.max(np.abs(got - want)) <= 32 * EPS * np.max(np.abs(want))


@pytest.mark.parametrize("kw", [
    {"adaptive_dt": False}, {"adaptive_dt": True, "nu": 1e-5},
    {"adaptive_dt": True, "weno_variant": "z", "flux": "buckley"},
], ids=["fixed", "adaptive-viscous", "adaptive-z-buckley"])
def test_k5_sharded_bit_exact(kw):
    cfg = PBConfig(grid=PGrid.make(12, 10, 16, lengths=2.0), impl="pallas",
                   **kw)
    s, _ = _bit_exact(PBSolver, cfg, SLAB, 3)
    assert s.engaged_path()["stepper"] == "fused-stage"


def test_k5_split_bit_exact():
    cfg = PBConfig(grid=PGrid.make(12, 10, 48, lengths=2.0), impl="pallas",
                   nu=1e-5, overlap="split")
    s, _ = _bit_exact(PBSolver, cfg, ({"dz": 2}, {0: "dz"}), 3,
                      plain=dataclasses.replace(cfg, overlap="padded"))
    assert s.engaged_path()["overlap"] == "split"


def test_advance_to_bit_exact():
    """``advance_to`` on a mesh: K5's ``run_to`` (adaptive dt, the last
    step trimmed) and the generic loop, both to the bit."""
    cfg = PBConfig(grid=PGrid.make(12, 10, 16, lengths=2.0), impl="pallas")
    for c in (cfg, dataclasses.replace(cfg, impl="xla")):
        one, sharded = _port(PBSolver, c), _port(PBSolver, c, SLAB)
        want = one.advance_to(one.initial_state(), 0.2)
        got = sharded.advance_to(sharded.initial_state(), 0.2)
        assert torch.equal(got.u.assemble(), want.u)
        assert (got.t, got.it) == (want.t, want.it) and got.it > 1


def test_failed_shard_raises_in_caller(monkeypatch):
    """A kernel that fails on one shard fails the run in the caller; the
    other shards leave their collectives instead of waiting."""
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        fused_diffusion as pfd,
    )

    real = pfd.stage_reference

    def flaky(v, u, out, dt, **kw):
        if kw["offsets"][0] == 8:
            raise FloatingPointError("stage failed on the shard at z = 8")
        return real(v, u, out, dt, **kw)

    monkeypatch.setattr(pfd, "stage_reference", flaky)
    s = _port(PDSolver, PDConfig(grid=PGrid.make(24, 16, 16, lengths=10.0),
                                 impl="pallas_stage"), SLAB)
    with pytest.raises(FloatingPointError, match="z = 8"):
        s.run(s.initial_state(), 2)


# --------------------------------------------------------------------- #
# Dispatch: engaged_path against the JAX package's sharded solvers
# --------------------------------------------------------------------- #
_FAMILIES = {"diffusion": (JDConfig, JDSolver, PDConfig, PDSolver),
             "burgers": (JBConfig, JBSolver, PBConfig, PBSolver),
             "adr": (JAConfig, JASolver, PAConfig, PASolver)}


def _both(family, layout, **kw):
    """Makers of the JAX and the port solver of one config on one mesh
    layout: a 3-D grid 16x16x96 on a layout with a z axis, else the 2-D
    grid 24x96."""
    sizes, mapping = layout
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(sizes, devices=jax.devices()[:n])
    jd = jmesh.Decomposition.of(mapping)
    n_xyz = (16, 16, 96) if "dz" in sizes else (24, 96)
    lengths = 2.0 if family == "burgers" else 4.0
    jcls, jsolver, pcls, psolver = _FAMILIES[family]
    # configs too are built in the makers: a config may refuse the knobs
    jkw = {"dtype": "float32", **kw}
    return (lambda: jsolver(jcls(grid=JGrid.make(*n_xyz, lengths=lengths),
                                 **jkw),
                            mesh=jm, decomp=jd),
            lambda: _port(psolver, pcls(grid=PGrid.make(*n_xyz,
                                                        lengths=lengths),
                                        **kw), layout))


_FIELDS = ("stepper", "overlap", "steps_per_exchange", "exchange")
_Z2 = ({"dz": 2}, {0: "dz"})
_Y = ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"})
# the 2-D layouts: y slabs, x slabs, a y-x block
_DY = ({"dy": 2}, {0: "dy"})
_DX = ({"dx": 2}, {1: "dx"})
_DYX = ({"dy": 2, "dx": 2}, {0: "dy", 1: "dx"})
SWEEP = [
    (fam, layout, dict(impl=impl, overlap=ov, steps_per_exchange=k, **extra))
    for fam, extras, layouts in (
        ("diffusion", [{}], (_Z2, _Y, _DY, _DX, _DYX)),
        ("burgers", [{"adaptive_dt": False}, {"adaptive_dt": True}],
         (_Z2, _Y, _DY, _DX, _DYX)),
        ("adr", [{}], (_Z2, _Y, _DY)))
    for extra in extras
    for layout in layouts
    for impl in ("xla", "pallas_axis", "pallas", "pallas_stage",
                 "pallas_step", "pallas_slab")
    for ov in ("padded", "split")
    for k in (1, 2)
]


def _sweep_id(case):
    fam, layout, kw = case
    parts = [fam, "x".join(f"{a}{n}" for a, n in layout[0].items()),
             kw["impl"], kw["overlap"], f"k{kw['steps_per_exchange']}"]
    if "adaptive_dt" in kw:
        parts.append("adaptive" if kw["adaptive_dt"] else "fixed")
    return "-".join(parts)


@pytest.mark.parametrize("case", SWEEP, ids=[_sweep_id(c) for c in SWEEP])
def test_dispatch_matches_jax(case):
    """Construction and ``engaged_path()`` only. Where the JAX package
    raises, the port raises the same error; where it runs a rung whose
    kernel is not ported (K5 on a y-sharded 3-D mesh), the port raises
    and names its ROADMAP item; elsewhere the engaged stepper, overlap,
    steps per exchange, exchange and — off the fused rungs — fallback
    are JAX's: the 2-D layouts engage K8 (K8b under split), ADR's 3-D
    meshes K9's sharded instance."""
    family, layout, kw = case
    make_jax, make_port = _both(family, layout, **kw)
    try:
        jsolver = make_jax()
        want = jsolver.engaged_path()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            make_port().engaged_path()
        assert str(got.value) == str(exc)
        return
    if family == "burgers" and "dz" in layout[0] and 1 in layout[1] and (
            want["stepper"].startswith("fused")):
        with pytest.raises(NotImplementedError, match="item 8d"):
            make_port()
        return
    got = make_port().engaged_path()
    assert {f: got[f] for f in _FIELDS} == {f: want[f] for f in _FIELDS}
    if not want["stepper"].startswith("fused"):
        assert got["fallback"] == want["fallback"]


# configs whose fused rung declines on a z-slab mesh, by family
DECLINING = [("diffusion", {"order": 2}), ("diffusion", {"bc": "periodic"}),
             ("diffusion", {"dtype": "float64"}),
             ("burgers", {"adaptive_dt": False, "dtype": "float64"}),
             ("burgers", {"adaptive_dt": False, "weno_order": 7,
                          "weno_variant": "z"})]
DECLINE_SWEEP = [
    (fam, dict(impl=impl, steps_per_exchange=k, exchange=ex, **extra))
    for fam, extra in DECLINING
    for impl in ("pallas", "pallas_slab")
    for k in (1, 2)
    for ex in ("collective", "dma")
]


def _decline_id(case):
    fam, kw = case
    extra = "-".join(f"{a}={v}" for a, v in kw.items()
                     if a not in ("impl", "steps_per_exchange", "exchange"))
    return (f"{fam}-{extra}-{kw['impl']}-k{kw['steps_per_exchange']}-"
            f"{kw['exchange']}")


@pytest.mark.parametrize("case", DECLINE_SWEEP,
                         ids=[_decline_id(c) for c in DECLINE_SWEEP])
def test_declined_fusion_matches_jax_on_zslab(case):
    """A config whose fused rung declines, on ``{"dz": 2}``: with
    ``steps_per_exchange > 1`` or ``exchange="dma"`` the port raises the
    JAX package's error, the cadence named first when both are set;
    otherwise its ``engaged_path()`` fields are JAX's and its fallback
    starts with JAX's reason (the port may add that an order-2 Laplacian
    runs in plain PyTorch, a recorded difference)."""
    family, kw = case
    make_jax, make_port = _both(family, _Z2, **kw)
    try:
        want = make_jax().engaged_path()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            make_port().engaged_path()
        assert str(got.value) == str(exc)
        return
    got = make_port().engaged_path()
    assert {f: got[f] for f in _FIELDS} == {f: want[f] for f in _FIELDS}
    assert got["fallback"].startswith(want["fallback"])


@pytest.mark.parametrize("impl", ["pallas", "pallas_stage"])
def test_split_schedule_difference_against_jax(impl):
    """A recorded difference, beside the slab gates: the sharded
    per-stage diffusion rung takes the split schedule at 3 chunks of
    ``Z_CHUNK`` planes (``ops/kernels/fused_diffusion.py``), where JAX's
    VMEM-sized z block leaves fewer than 3 and it runs
    ``serialized-refresh``. 16x16x96 on ``{"dz": 4}`` (local z 24)
    reaches it; every other field is JAX's."""
    make_jax, make_port = _both("diffusion", ({"dz": 4}, {0: "dz"}),
                                impl=impl, overlap="split")
    want, got = make_jax().engaged_path(), make_port().engaged_path()
    assert (want["overlap"], got["overlap"]) == ("serialized-refresh",
                                                 "split")
    rest = [f for f in _FIELDS if f != "overlap"] + ["fallback"]
    assert {f: got[f] for f in rest} == {f: want[f] for f in rest}


@pytest.mark.parametrize("make,match", [
    # the 2-D fused rungs and ADR run on a mesh now (K8, sharded K9)
    (lambda m: PDSolver(PDConfig(grid=PGrid.make(16, 12), impl="pallas"),
                        mesh=m), None),
    (lambda m: PBSolver(PBConfig(grid=PGrid.make(16, 12), impl="pallas"),
                        mesh=m), None),
    (lambda m: PASolver(PAConfig(grid=PGrid.make(8, 8, 8),
                                 impl="pallas"), mesh=m), None),
    (lambda m: PDSolver(PDConfig(grid=PGrid.make(8, 8, 8), impl="pallas",
                                 precision="bf16"), mesh=m), "bf16"),
    # exchange="dma" runs now (K4), on a grid whose shards serve it
    (lambda m: PDSolver(PDConfig(grid=PGrid.make(8, 8, 24),
                                 impl="pallas_slab", exchange="dma"),
                        mesh=m), None),
])
def test_unported_mesh_configs_raise(make, match):
    """What a mesh still refuses raises and names its ROADMAP item; the
    configs that raised before K8/K8b, the sharded K9 (items 8b, 8c) and
    K4 (item 8e) engage their fused rung and run a step."""
    if match is None:
        solver = make(_mesh({"dz": 2}))
        assert solver.engaged_path()["stepper"] == (
            "fused-whole-run-slab" if solver.cfg.exchange == "dma"
            else "fused-stage")
        state = solver.initial_state()
        out = solver.run(state, 1)
        assert out.it == 1 and torch.isfinite(out.u.assemble()).all()
    else:
        with pytest.raises(NotImplementedError, match=match):
            make(_mesh({"dz": 2}))
    with pytest.raises(NotImplementedError, match="item 8f"):
        PDSolver(PDConfig(grid=PGrid.make(8, 8, 8)),
                 mesh=_mesh({"members": 2}))


def test_2d_meshes_run_the_generic_and_per_axis_rungs():
    for impl in ("xla", "pallas_axis"):
        cfg = PDConfig(grid=PGrid.make(24, 16, lengths=10.0), impl=impl)
        _bit_exact(PDSolver, cfg, ({"dy": 2}, {0: "dy"}), 3)


# --------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------- #
def test_cli_mesh_on_cpu_shards(capsys, tmp_path):
    """``--mesh dz=2 --device cpu``: two CPU shards; the summary names
    the mesh, the halo schedule and the launches summed over shards."""
    run = ["diffusion3d", "--n", "12", "10", "48", "--iters", "3",
           "--impl", "pallas_slab", "--device", "cpu", "--save"]
    assert pmain(run + [str(tmp_path / "mesh"), "--steps-per-exchange",
                        "2", "--overlap", "split", "--mesh", "dz=2"]) == 0
    out = capsys.readouterr().out
    assert "mesh               : {'dz': 2} on cpu, cpu" in out
    assert "overlap=split, steps/exchange=2" in out
    assert "fused-whole-run-slab" in out
    assert pmain(run + [str(tmp_path / "one")]) == 0
    got, want = (np.fromfile(tmp_path / d / "result.bin", dtype=np.float32)
                 for d in ("mesh", "one"))
    assert np.array_equal(got, want)
