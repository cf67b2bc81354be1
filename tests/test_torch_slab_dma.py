"""The sharded slab rung with the in-kernel exchange (``exchange="dma"``,
K4) on CPU device meshes, where K4's plain twin
(``fused_slab_run.slab_run_dma_reference`` over K3's twins) runs once for
every shard through the mesh's launch group:

* against the port's collective K3-twin run and its unsharded K2/K6-twin
  run, to the bit with ``t`` equal, on meshes of 2 and 4 shards of the
  JAX suite's grid (16x16x72, ``tests/test_slab_run.py:278``), with a
  partial tail block;
* against the JAX package's dma run and its unsharded slab run, both in
  Pallas interpret mode on JAX's ``{"dz": 2}`` mesh, from the same numpy
  inputs: within 32 eps_f32 of max|u| (``tests/test_torch_slab_run.py``'s
  bound: XLA may contract multiply-adds the twins round separately), the
  gap printed, ``t`` equal;
* ``engaged_path()`` and ``stencil_spec()["remote_dma"]`` against JAX's
  over a sweep, the JAX refusals with the same texts, the byte counter
  against the JAX package's formula, and the CLI.

Every mesh has a timeout of 60 s a collective.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu import telemetry as jtelemetry
from multigpu_advectiondiffusion_tpu.models.adr import ADRConfig as JAConfig
from multigpu_advectiondiffusion_tpu.models.burgers import (
    BurgersConfig as JBConfig,
    BurgersSolver as JBSolver,
)
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JDConfig,
    DiffusionSolver as JDSolver,
)
from multigpu_advectiondiffusion_tpu.models.ensemble import (
    EnsembleSolver as JEnsembleSolver,
)
from multigpu_advectiondiffusion_tpu.parallel import halo as jhalo
from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as pmain
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.adr import (
    ADRConfig as PAConfig,
)
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PBConfig,
    BurgersSolver as PBSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PDConfig,
    DiffusionSolver as PDSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.ensemble import (
    EnsembleSolver as PEnsembleSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import halo as phalo
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS
N_XYZ = (16, 16, 72)  # the JAX suite's dma grid, physical (nx, ny, nz)
STEPS = 5  # k = 2 and 4 end with a partial block
FAMILIES = {  # name: (port solver, port config, JAX solver, JAX config, kw)
    "diffusion": (PDSolver, PDConfig, JDSolver, JDConfig, {}),
    "burgers-js": (PBSolver, PBConfig, JBSolver, JBConfig,
                   {"adaptive_dt": False, "nu": 1e-5}),
    "burgers-z": (PBSolver, PBConfig, JBSolver, JBConfig,
                  {"adaptive_dt": False, "nu": 1e-5, "weno_variant": "z"}),
}


def _mesh(shards):
    return pmesh.make_mesh({"dz": shards}, devices=[CPU] * shards,
                           timeout=60.0)


def _port(family, shards, **kw):
    cls, cfg_cls, _, _, extra = FAMILIES[family]
    cfg = cfg_cls(grid=PGrid.make(*N_XYZ, lengths=2.0),
                  **{"impl": "pallas_slab", **extra, **kw})
    if shards is None:
        return cls(cfg, device="cpu")
    return cls(cfg, mesh=_mesh(shards),
               decomp=pmesh.Decomposition.slab("dz"))


def _jax(family, shards, **kw):
    _, _, cls, cfg_cls, extra = FAMILIES[family]
    cfg = cfg_cls(grid=JGrid.make(*N_XYZ, lengths=2.0), dtype="float32",
                  **{"impl": "pallas_slab", **extra, **kw})
    if shards is None:
        return cls(cfg)
    return cls(cfg, mesh=jmesh.make_mesh({"dz": shards},
                                         devices=jax.devices()[:shards]),
               decomp=jmesh.Decomposition.slab("dz"))


# --------------------------------------------------------------------- #
# (a) the port's dma run against its collective and unsharded runs
# --------------------------------------------------------------------- #
CASES = [("diffusion", 2, 1), ("diffusion", 2, 2), ("diffusion", 2, 4),
         ("diffusion", 4, 1), ("diffusion", 4, 2),
         ("burgers-js", 2, 1), ("burgers-js", 2, 2), ("burgers-js", 4, 1),
         ("burgers-z", 2, 1), ("burgers-z", 2, 2)]


@pytest.mark.parametrize("family,shards,k", CASES)
def test_dma_equals_collective_and_unsharded(family, shards, k):
    """The dma run equals the collective K3 run on the same mesh and the
    unsharded K2/K6 run to the bit, ``t`` equal; on the CPU the twin
    runs, so no kernel launch is counted."""
    dma = _port(family, shards, steps_per_exchange=k, exchange="dma")
    coll = _port(family, shards, steps_per_exchange=k)
    one = _port(family, None)
    path = dma.engaged_path()
    assert (path["stepper"], path["overlap"], path["exchange"],
            path["steps_per_exchange"]) == (
        "fused-whole-run-slab", "in-kernel", "dma", k)
    before = (psr.slab_run_dma_diffusion.launches,
              psr.slab_run_dma_burgers.launches)
    got = dma.run(dma.initial_state(), STEPS)
    assert (psr.slab_run_dma_diffusion.launches,
            psr.slab_run_dma_burgers.launches) == before
    want = coll.run(coll.initial_state(), STEPS)
    ref = one.run(one.initial_state(), STEPS)
    assert torch.equal(got.u.assemble(), want.u.assemble())
    assert torch.equal(got.u.assemble(), ref.u)
    assert got.t == want.t == ref.t and got.it == ref.it == STEPS


def test_twin_schedule_moves_rows_as_the_tpu_kernel():
    """K4's twin alone: after one block the landing slots hold the
    neighbours' core edge windows (a ring: the wall shards' wrapped
    windows land too) and the interior ghost rows hold them; the wall
    ghost rows keep their values."""
    G, k, lz, P = 6, 1, 8, 3
    pz = lz + 2 * G
    S0 = [torch.full((pz, 2, 2), float(i)) for i in range(P)]
    for i in range(P):
        S0[i][G:G + lz] = torch.arange(lz, dtype=torch.float32)[
            :, None, None] + 100 * i
    S1 = [s.clone() for s in S0]
    lands = [torch.full((2, 2, G, 2, 2), -1.0) for _ in range(P)]
    seen = []
    psr.slab_run_dma_reference(
        lambda S, out, window, oz: seen.append((window, oz)), S0, S1,
        lands, 1, k=k, G=G)
    assert seen == [((0, lz), 0), ((0, lz), lz), ((0, lz), 2 * lz)]
    for i in range(P):
        below, above = (i - 1) % P, (i + 1) % P
        assert torch.equal(lands[i][0, 0], S0[below][pz - 2 * G:pz - G])
        assert torch.equal(lands[i][0, 1], S0[above][G:2 * G])
        assert torch.equal(lands[i][1], torch.full((2, G, 2, 2), -1.0))
    assert torch.equal(S0[0][:G], torch.zeros(G, 2, 2))
    assert torch.equal(S0[1][:G], S0[0][lz:lz + G])
    assert torch.equal(S0[1][pz - G:], S0[2][G:2 * G])
    assert torch.equal(S0[2][pz - G:], torch.full((G, 2, 2), 2.0))


# --------------------------------------------------------------------- #
# (b) against the JAX package's dma run and unsharded slab run
# --------------------------------------------------------------------- #
JAX_CASES = {"diffusion": 2, "burgers-js": 1}  # family: k


@pytest.fixture(scope="module")
def jax_runs():
    """Each family's JAX dma run on ``{"dz": 2}`` and unsharded slab
    run, from one numpy-seeded field at the config's ``t0``:
    ``{family: ((u0, t0), dma, unsharded)}``, each run numpy ``(u, t)``,
    built once."""
    out = {}
    for family, k in JAX_CASES.items():
        rng = np.random.default_rng(sum(map(ord, family)))
        u0 = rng.uniform(0.0, 1.0, N_XYZ[::-1]).astype(np.float32)
        runs = []
        for solver in (_jax(family, 2, steps_per_exchange=k, exchange="dma"),
                       _jax(family, None)):
            s0 = solver.initial_state()
            t0 = np.asarray(s0.t)
            s0 = s0._replace(u=jax.device_put(jnp.asarray(u0),
                                              s0.u.sharding))
            s = solver.run(s0, STEPS)
            runs.append((np.asarray(s.u), float(s.t)))
        out[family] = ((u0, t0), *runs)
    return out


def _gap(got, want) -> float:
    """max|got - want| over max|want|, printed in eps (``pytest -s``)."""
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    return gap


@pytest.mark.parametrize("family", list(JAX_CASES))
def test_dma_matches_jax_dma_and_unsharded(family, jax_runs):
    (u0, t0), (jdma, jt), (jone, jt1) = jax_runs[family]
    solver = _port(family, 2, steps_per_exchange=JAX_CASES[family],
                   exchange="dma")
    s0 = convert.state_from_numpy(u0, t0, 0, mesh=solver.mesh,
                                  decomp=solver.decomp)
    out = solver.run(s0, STEPS)
    got = out.u.assemble().numpy()
    assert _gap(got, jdma) <= TOL
    assert _gap(got, jone) <= TOL
    assert float(out.t) == jt == jt1


# --------------------------------------------------------------------- #
# (c) engaged_path() and the declared windows against JAX's
# --------------------------------------------------------------------- #
_FIELDS = ("impl", "stepper", "overlap", "steps_per_exchange", "exchange",
           "storage_dtype", "precision", "fallback")
SWEEP = [(fam, impl, k, shards)
         for fam in ("diffusion", "burgers-js")
         for impl in ("pallas", "pallas_slab")
         for k in (1, 2)
         for shards in (2, 4)]


@pytest.mark.parametrize("family,impl,k,shards", SWEEP)
def test_engaged_path_and_remote_dma_match_jax(family, impl, k, shards):
    kw = dict(impl=impl, steps_per_exchange=k, exchange="dma")
    js, ps = _jax(family, shards, **kw), _port(family, shards, **kw)
    want, got = js.engaged_path(), ps.engaged_path()
    assert {f: got[f] for f in _FIELDS} == {f: want[f] for f in _FIELDS}
    jspec = js._fused_stepper().stencil_spec()
    pspec = ps._fused_stepper().stencil_spec()
    assert pspec["remote_dma"] == jspec["remote_dma"] is not None
    for key in ("kernel", "stage_radius", "fused_stages", "ghost_depth",
                "exchange_depth", "steps_per_exchange", "members",
                "member_halo", "exchange", "storage_dtype",
                "bytes_per_cell"):
        assert pspec[key] == jspec[key], key


def test_collective_slab_stepper_declares_no_remote_dma():
    for fam in ("diffusion", "burgers-js"):
        spec = _port(fam, 2)._fused_stepper().stencil_spec()
        want = _jax(fam, 2)._fused_stepper().stencil_spec()
        assert spec["remote_dma"] is None is want["remote_dma"]
        assert spec["exchange"] == "collective" == want["exchange"]


# --------------------------------------------------------------------- #
# (d) the refusals
# --------------------------------------------------------------------- #
def _pencil(pkg):
    if pkg == "jax":
        return dict(mesh=jmesh.make_mesh({"dz": 2, "dy": 2},
                                         devices=jax.devices()[:4]),
                    decomp=jmesh.Decomposition.of({0: "dz", 1: "dy"}))
    return dict(mesh=pmesh.make_mesh({"dz": 2, "dy": 2}, devices=[CPU] * 4,
                                     timeout=60.0),
                decomp=pmesh.Decomposition.of({0: "dz", 1: "dy"}))


REFUSALS = {  # name: (match, make(pkg) -> the call that raises)
    "unsharded": ("needs a device mesh", lambda pkg: _maker(pkg)(
        "diffusion", None, exchange="dma")),
    "pencil": ("z-slab", lambda pkg: _cls(pkg, "diffusion")(
        _cfg(pkg, "diffusion", exchange="dma"), **_pencil(pkg))),
    "split": ("split-overlap", lambda pkg: _maker(pkg)(
        "diffusion", 2, exchange="dma", overlap="split")),
    "generic": ("sharded slab rung", lambda pkg: _maker(pkg)(
        "diffusion", 2, exchange="dma", impl="xla")),
    "ensemble": ("dma", lambda pkg: (
        JEnsembleSolver if pkg == "jax" else PEnsembleSolver)(
        _cls(pkg, "diffusion"), _cfg(pkg, "diffusion", exchange="dma"), 4)),
    "adaptive": ("adaptive dt", lambda pkg: _maker(pkg)(
        "burgers-js", 2, exchange="dma", adaptive_dt=True).engaged_path()),
    "advance_to": ("no run_to", lambda pkg: _advance(pkg)),
    "thin": ("cannot serve the 24-deep exchange", lambda pkg: _maker(pkg)(
        "diffusion", 4, exchange="dma", steps_per_exchange=4
    ).engaged_path()),
    "periodic": ("declined fusion", lambda pkg: _maker(pkg)(
        "diffusion", 2, exchange="dma", bc="periodic").engaged_path()),
    "adr": ("collective", lambda pkg: (JAConfig if pkg == "jax" else PAConfig)(
        grid=(JGrid if pkg == "jax" else PGrid).make(*N_XYZ),
        exchange="dma")),
}


def _maker(pkg):
    return _jax if pkg == "jax" else _port


def _cls(pkg, family):
    return FAMILIES[family][2 if pkg == "jax" else 0]


def _cfg(pkg, family, **kw):
    _, pcfg, _, jcfg, extra = FAMILIES[family]
    if pkg == "jax":
        return jcfg(grid=JGrid.make(*N_XYZ, lengths=2.0), dtype="float32",
                    **{"impl": "pallas_slab", **extra, **kw})
    return pcfg(grid=PGrid.make(*N_XYZ, lengths=2.0),
                **{"impl": "pallas_slab", **extra, **kw})


def _advance(pkg):
    solver = _maker(pkg)("diffusion", 2, exchange="dma")
    return solver.advance_to(solver.initial_state(), 1e-3)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    """Every config the JAX package refuses under ``exchange="dma"``
    (``tests/test_slab_run.py:336-389`` and beyond) raises in the port
    with the same text; the ensemble with its own: the port checks the
    ensemble gate (``models/base.ensemble_cfg_gate``) before it builds
    the member solver, whose mesh gate JAX's meets first."""
    match, make = REFUSALS[name]
    with pytest.raises(ValueError, match=match) as want:
        make("jax")
    with pytest.raises(ValueError, match=match) as got:
        make("port")
    if name != "ensemble":
        assert str(got.value) == str(want.value)


def test_launch_group_refuses_several_devices():
    """A mesh whose shards sit on two devices raises in the launch group
    and names the ROADMAP item; nothing falls back to the collective
    exchange."""
    mesh = pmesh.Mesh(np.array([CPU, torch.device("meta")], dtype=object),
                      ("dz",), timeout=20.0)
    with pytest.raises(NotImplementedError, match="item 8g"):
        pmesh.run_shards(mesh, lambda rank: pmesh.launch_group(
            [torch.zeros(1)], lambda shards: None))


def test_launch_group_launches_once_for_every_shard():
    """On the CPU the leader runs the launch once, with every shard's
    live tensors in rank order; every shard sees its writes."""
    mesh = _mesh(4)
    calls = []

    def launch(shards):
        calls.append(len(shards))
        for i, (t,) in enumerate(shards):
            t.fill_(i + 1)

    def body(rank):
        t = torch.zeros(3)
        pmesh.launch_group([t], launch)
        return float(t[0])

    assert pmesh.run_shards(mesh, body) == [1.0, 2.0, 3.0, 4.0]
    assert calls == [4]


def test_launch_group_stress_many_shards_and_rounds():
    """Sixteen shard threads (more than the cores), 30 launch groups in a
    row, a short switch interval: every launch runs once with every
    shard's tensors, and every shard sees every round's write before it
    posts the next (a lost or reordered round breaks the count)."""
    import sys

    mesh = _mesh(16)
    rounds, calls = 30, []

    def launch(shards):
        calls.append(len(shards))
        for (t,) in shards:
            t += 1

    def body(rank):
        t = torch.zeros(())
        for r in range(rounds):
            pmesh.launch_group([t], launch)
            assert float(t) == r + 1
        return float(t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert pmesh.run_shards(mesh, body) == [float(rounds)] * 16
    finally:
        sys.setswitchinterval(old)
    assert calls == [16] * rounds


# --------------------------------------------------------------------- #
# (e) the byte counter, (f) the CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("family,k", [("diffusion", 2), ("burgers-js", 1)])
def test_dma_byte_counter_is_jax_formula(family, k, tmp_path):
    """Each shard counts the JAX package's ``2 * window_rows * plane *
    itemsize * blocks`` for its padded plane (``blocks = ceil(steps /
    k)``): the JAX ``record_remote_dma`` counter for the same plane."""
    solver = _port(family, 2, steps_per_exchange=k, exchange="dma")
    fused = solver._fused_stepper()
    blocks = -(-STEPS // k)
    path = str(tmp_path / "ev.jsonl")
    with jtelemetry.capture(path):
        jhalo.record_remote_dma(
            kernel=fused.engaged_label, plane_shape=fused.padded_shape[1:],
            itemsize=4, window_rows=fused.exchange_depth, blocks=blocks,
            mesh_axis="dz")
    with open(path) as f:
        want = [e for e in map(json.loads, f) if e.get("name") ==
                "halo.dma_bytes_per_execution"]
    before = phalo.record_remote_dma.bytes_per_execution.value
    exch_before = phalo.exchange_ghosts.bytes_per_execution.value
    solver.run(solver.initial_state(), STEPS)
    got = phalo.record_remote_dma.bytes_per_execution.value - before
    assert len(want) == 1 and got == 2 * want[0]["inc"]
    assert phalo.exchange_ghosts.bytes_per_execution.value == exch_before
    assert phalo.remote_dma_spec() == jhalo.remote_dma_spec()


def test_cli_dma_on_cpu_shards(capsys, tmp_path):
    """``--mesh dz=2 --exchange dma --device cpu``: the summary names the
    in-kernel exchange, and the result equals the unsharded run's."""
    run = ["diffusion3d", "--n", "12", "10", "48", "--iters", "3",
           "--impl", "pallas_slab", "--device", "cpu", "--save"]
    assert pmain(run + [str(tmp_path / "dma"), "--mesh", "dz=2",
                        "--exchange", "dma", "--steps-per-exchange",
                        "2"]) == 0
    out = capsys.readouterr().out
    assert "mesh               : {'dz': 2} on cpu, cpu" in out
    assert ("overlap=in-kernel, steps/exchange=2, exchange=dma" in out)
    assert "kernel launches    : none" in out  # the CPU runs the twin
    assert pmain(run + [str(tmp_path / "one")]) == 0
    got, want = (np.fromfile(tmp_path / d / "result.bin", dtype=np.float32)
                 for d in ("dma", "one"))
    assert np.array_equal(got, want)
