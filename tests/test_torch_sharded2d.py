"""The 2-D mesh paths (K8, K8b) and ADR on meshes (K9's sharded instance)
on CPU device meshes: the port's sharded runs against its own unsharded
runs, against the JAX package's unsharded fused runs, ``advance_to``
against the generic rung, the declines, and the CLI.

Tolerances:
* sharded against the port's unsharded run of the same config (K8
  against K7's twin, sharded K9 against K9's, the generic and per-axis
  rungs against themselves): 0 difference and ``t`` equal — the per-cell
  arithmetic is the same, only where neighbours come from differs;
* against the JAX package's unsharded fused run in Pallas interpret
  mode: 32 eps_f32 of max|u|, the bound the twins are held to;
* the fused rung's ``advance_to`` against the generic rung on the same
  mesh: the same steps and landing ``t``, ``u`` within the JAX suite's
  fused-against-generic bound (``rtol 2e-5, atol 2e-6 max|u|``,
  ``tests/test_pallas.py:1565-1572``).
Oracle grids are the JAX suite's 40x32 (``tests/test_pallas.py:1391``);
every mesh has a timeout of 60 s a collective.
"""

import dataclasses

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
N_XY = (32, 40)  # physical (nx, ny): arrays (40, 32)
DY4 = ({"dy": 4}, {0: "dy"})
DX4 = ({"dx": 4}, {1: "dx"})
DYX = ({"dy": 2, "dx": 2}, {0: "dy", 1: "dx"})
DY2 = ({"dy": 2}, {0: "dy"})
CONFIGS = {
    "diffusion": (PDSolver, PDConfig(grid=PGrid.make(*N_XY, lengths=2.0),
                                     impl="pallas")),
    "burgers-fixed": (PBSolver, PBConfig(grid=PGrid.make(*N_XY,
                                                         lengths=2.0),
                                         impl="pallas", adaptive_dt=False)),
    "burgers-adaptive-viscous": (PBSolver, PBConfig(
        grid=PGrid.make(*N_XY, lengths=2.0), impl="pallas", nu=1e-3,
        weno_variant="z")),
}


def _mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return pmesh.make_mesh(sizes, devices=[CPU] * n, timeout=60.0)


def _port(cls, cfg, layout=None):
    if layout is None:
        return cls(cfg, device="cpu")
    sizes, mapping = layout
    return cls(cfg, mesh=_mesh(sizes), decomp=pmesh.Decomposition.of(mapping))


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
    return sharded


# --------------------------------------------------------------------- #
# K8 and K8b against K7
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("overlap", ["padded", "split"])
@pytest.mark.parametrize("layout", [DY4, DX4, DYX], ids=["dy4", "dx4", "dyx"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_k8_bit_exact_with_k7(config, layout, overlap):
    """Every 2-D layout, both schedules, both dt modes: the sharded run
    equals K7's unsharded run (the whole-run twin); the split schedule
    engages on y slabs only, elsewhere the serialized refresh runs."""
    cls, cfg = CONFIGS[config]
    s = _bit_exact(cls, dataclasses.replace(cfg, overlap=overlap), layout, 4,
                   plain=cfg)
    path = s.engaged_path()
    split = overlap == "split" and layout is DY4
    assert (path["stepper"], path["overlap"]) == (
        "fused-stage", "split" if split else "serialized-refresh")


def test_k8_launch_counts_on_cpu_are_zero():
    """On CPU shards the wrappers run their twins: no launch counted."""
    from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
        fused2d_sharded as pfs,
    )

    pfs.fused2d_stage.launches = pfs.fused2d_band_stage.launches = 0
    cls, cfg = CONFIGS["diffusion"]
    s = _port(cls, cfg, DY2)
    s.run(s.initial_state(), 2)
    assert pfs.fused2d_stage.launches == pfs.fused2d_band_stage.launches == 0


@pytest.mark.parametrize("family,layout", [("diffusion", DY2),
                                           ("burgers", DYX)],
                         ids=["diffusion-dy2", "burgers-dyx"])
def test_k8_matches_jax_unsharded_fused(family, layout):
    """K8's twin on a mesh within 32 eps of max|u| of the JAX package's
    unsharded fused run (K7 in Pallas interpret mode), the JAX state
    handed over with ``convert.state_from_numpy(..., mesh=)``."""
    if family == "diffusion":
        jsolver = JDSolver(JDConfig(grid=JGrid.make(*N_XY, lengths=2.0),
                                    dtype="float32", impl="pallas"))
        psolver = _port(PDSolver, CONFIGS["diffusion"][1], layout)
    else:
        jsolver = JBSolver(JBConfig(grid=JGrid.make(*N_XY, lengths=2.0),
                                    dtype="float32", impl="pallas"))
        psolver = _port(PBSolver, dataclasses.replace(
            CONFIGS["burgers-fixed"][1], adaptive_dt=True), layout)
    js = jsolver.initial_state()
    want = jsolver.run(js, 4)
    ps = convert.state_from_numpy(np.asarray(js.u), np.asarray(js.t),
                                  mesh=psolver.mesh, decomp=psolver.decomp)
    got = psolver.run(ps, 4)
    u, t, it = convert.state_to_numpy(got)
    ref = np.asarray(want.u)
    gap = np.max(np.abs(u - ref)) / np.max(np.abs(ref))
    print(f"{family}: {gap / EPS:.2f} eps of max|u|")
    assert gap <= 32 * EPS
    assert it == int(want.it)
    assert abs(float(t) - float(want.t)) <= 4 * EPS * float(want.t)


@pytest.mark.parametrize("config", ["diffusion", "burgers-fixed",
                                    "burgers-adaptive-viscous"])
def test_advance_to_matches_generic_rung(config):
    """``advance_to`` on a y-slab mesh under the split schedule: the fused
    steppers' ``run_to`` (the last step trimmed) against the generic rung
    on the same mesh."""
    cls, cfg = CONFIGS[config]
    cfg = dataclasses.replace(cfg, overlap="split")
    fused = _port(cls, cfg, DY4)
    generic = _port(cls, dataclasses.replace(cfg, impl="xla"), DY4)
    assert fused.engaged_path("t_end")["stepper"] == "fused-stage"
    t_end = 0.1 + 3.5 * (fused.dt or 0.004)
    got = fused.advance_to(fused.initial_state(), t_end)
    want = generic.advance_to(generic.initial_state(), t_end)
    assert got.it == want.it and got.it > 2 and got.t == want.t
    g, w = got.u.assemble(), want.u.assemble()
    atol = 2e-6 * float(w.abs().max())
    assert torch.allclose(g, w, rtol=2e-5, atol=atol)


@pytest.mark.parametrize("cls,cfg", [
    (PDSolver, PDConfig(grid=PGrid.make(32, 8, lengths=2.0), impl="pallas")),
    (PBSolver, PBConfig(grid=PGrid.make(32, 16, lengths=2.0),
                        impl="pallas")),
], ids=["diffusion", "burgers"])
def test_thin_shard_declines_naming_the_halo(cls, cfg):
    """A shard thinner than the stencil's halo declines the fused rung
    with the JAX package's reason (construction and ``engaged_path``
    only: no rung's exchange can serve such a shard)."""
    s = _port(cls, cfg, ({"dy": 8}, {0: "dy"}))
    path = s.engaged_path()
    assert path["stepper"] == "per-axis-pallas"
    assert "thinner than the" in path["fallback"]
    assert "halo" in path["fallback"]


@pytest.mark.parametrize("cls,cfg", [
    (PDSolver, PDConfig(grid=PGrid.make(32, 20, lengths=2.0), impl="pallas",
                        overlap="split")),
    (PBSolver, PBConfig(grid=PGrid.make(32, 32, lengths=2.0), impl="pallas",
                        overlap="split")),
], ids=["diffusion", "burgers"])
def test_split_falls_back_below_three_halos(cls, cfg):
    """Shards of fewer than 3h rows (5 < 6, 8 < 9) keep the serialized
    refresh under ``overlap="split"``, as the JAX steppers decline it
    (``fused2d_sharded.py:400-402, 478-480``)."""
    s = _bit_exact(cls, cfg, DY4, 3)
    assert s.engaged_path()["overlap"] == "serialized-refresh"
    assert not s._fused_stepper().overlap_split


# --------------------------------------------------------------------- #
# ADR on meshes: K9's sharded instance and the generic rungs
# --------------------------------------------------------------------- #
ADR3 = PAConfig(grid=PGrid.make(12, 10, 16, lengths=(1.2, 1.0, 1.6)),
                velocity=(0.5, -0.3, 0.2), kappa_variation=0.2,
                reaction_rate=0.25, impl="pallas")


@pytest.mark.parametrize("layout", [
    ({"dz": 2}, {0: "dz"}), ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"})],
    ids=["dz2", "dz2-dy2"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_adr3d_mesh_bit_exact(impl, layout):
    """K9's sharded instance (walls and K(x) in global indices) and the
    generic rung on z slabs and z-y pencils, against the unsharded run of
    the same rung."""
    cfg = dataclasses.replace(ADR3, impl=impl)
    s = _bit_exact(PASolver, cfg, layout, 4)
    path = s.engaged_path()
    want = ("fused-stage", "serialized-refresh") if impl == "pallas" else (
        "generic-xla", "padded")
    assert (path["stepper"], path["overlap"]) == want
    assert s.engaged_path("t_end")["stepper"] == want[0]


def test_adr3d_mesh_matches_jax_unsharded_fused():
    """K9's sharded twin on a z-y pencil within 32 eps of max|u| of the
    JAX package's unsharded K9 run (interpret mode), ``run`` and
    ``advance_to``."""
    jsolver = JASolver(JAConfig(
        grid=JGrid.make(12, 10, 16, lengths=(1.2, 1.0, 1.6)),
        dtype="float32", velocity=(0.5, -0.3, 0.2), kappa_variation=0.2,
        reaction_rate=0.25, impl="pallas"))
    psolver = _port(PASolver, ADR3, ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"}))
    js = jsolver.initial_state()
    ps = convert.state_from_numpy(np.asarray(js.u), np.asarray(js.t),
                                  mesh=psolver.mesh, decomp=psolver.decomp)
    t_end = float(js.t) + 3.5 * psolver.dt
    for got, want in ((psolver.run(ps, 3), jsolver.run(js, 3)),
                      (psolver.advance_to(ps, t_end),
                       jsolver.advance_to(js, t_end))):
        u, t, it = convert.state_to_numpy(got)
        ref = np.asarray(want.u)
        assert np.max(np.abs(u - ref)) <= 32 * EPS * np.max(np.abs(ref))
        assert it == int(want.it)
        assert abs(float(t) - float(want.t)) <= 4 * EPS * float(want.t)


def test_adr_split_and_thin_decline_to_the_generic_rung():
    """The JAX package's two mesh declines of the fused ADR rung, with
    its reasons; the per-axis rung then runs."""
    split = _port(PASolver, dataclasses.replace(ADR3, overlap="split"),
                  ({"dz": 2}, {0: "dz"}))
    path = split.engaged_path()
    assert path["stepper"] == "per-axis-pallas"
    assert "overlap='split' rides the generic rung" in path["fallback"]
    thin = _port(PASolver, dataclasses.replace(
        ADR3, grid=PGrid.make(12, 10, 8, lengths=1.0)), ({"dz": 8}, {0: "dz"}))
    assert "thinner than the O4 halo (2)" in thin.engaged_path()["fallback"]


@pytest.mark.parametrize("overlap", ["padded", "split"])
@pytest.mark.parametrize("impl", ["xla", "pallas_axis"])
def test_adr2d_mesh_bit_exact(impl, overlap):
    """ADR 2-D on y slabs: the generic and per-axis rungs (the fused ADR
    kernel is 3-D only) against their unsharded runs."""
    cfg = PAConfig(grid=PGrid.make(*N_XY, lengths=(3.2, 4.0)),
                   velocity=(0.4, -0.2), kappa_variation=0.2,
                   reaction_rate=0.25, impl=impl, overlap=overlap)
    s = _bit_exact(PASolver, cfg, DY2, 3,
                   plain=dataclasses.replace(cfg, overlap="padded"))
    assert s.engaged_path()["overlap"] == overlap


# --------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("verb,extra", [
    ("diffusion2d", []),
    ("burgers2d", ["--fixed-dt", "--overlap", "split"]),
], ids=["diffusion2d", "burgers2d-split"])
def test_cli_2d_mesh_on_cpu_shards(capsys, tmp_path, verb, extra):
    """``--mesh dy=2 --device cpu`` writes the unsharded run's
    ``result.bin``; the summary names the mesh and its schedule (the
    kernels' launches, summed over the shards, are 0 on CPU shards,
    where the twins run)."""
    run = [verb, "--n", "32", "40", "--lengths", "2", "2", "--iters", "2",
           "--impl", "pallas", "--device", "cpu", *extra, "--save"]
    assert pmain(run + [str(tmp_path / "mesh"), "--mesh", "dy=2"]) == 0
    out = capsys.readouterr().out
    assert "mesh               : {'dy': 2} on cpu, cpu" in out
    assert ("overlap=split" if extra else "overlap=serialized-refresh") in out
    assert "fused-stage (impl=pallas)" in out
    assert "kernel launches    : none" in out
    assert pmain(run + [str(tmp_path / "one")]) == 0
    got, want = (np.fromfile(tmp_path / d / "result.bin", dtype=np.float32)
                 for d in ("mesh", "one"))
    assert np.array_equal(got, want)
