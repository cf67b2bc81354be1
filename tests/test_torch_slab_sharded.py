"""The sharded slab rung (K3's plain twin, ``fused_slab_run.
slab_step_diffusion_reference`` / ``slab_step_burgers_reference``) on CPU
device meshes, against the port's unsharded whole-run slab rung (K2's
and K6's twins), to the bit with ``t`` equal: the per-step schedule (a
G-deep refresh and one window a step), the split schedule (interior
window, then the bottom and top windows from the exchanged slabs) and
the k-step schedule (one k·G-deep exchange a block, windows widened by
(k-1-j)·G), with a partial tail block. The grids are the JAX suite's
(``tests/test_slab_run.py:183-262``, ``tests/test_comm_avoid.py:
52-145``). The sharded slab rung's refusals match the JAX package's.
Every mesh has a timeout of 60 s a collective.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.burgers import (
    BurgersConfig as JBConfig,
    BurgersSolver as JBSolver,
)
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JDConfig,
    DiffusionSolver as JDSolver,
)
from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PBConfig,
    BurgersSolver as PBSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig as PDConfig,
    DiffusionSolver as PDSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _sharded(cls, cfg, shards):
    mesh = pmesh.make_mesh({"dz": shards}, devices=[CPU] * shards,
                           timeout=60.0)
    return cls(cfg, mesh=mesh, decomp=pmesh.Decomposition.slab("dz"))


def _bit_exact(cls, cfg, shards, iters):
    """The sharded slab run equals the unsharded one (K2's/K6's twin) to
    the bit; returns the sharded solver."""
    one = cls(dataclasses.replace(cfg, steps_per_exchange=1,
                                  overlap="padded"), device="cpu")
    assert one.engaged_path()["stepper"] == "fused-whole-run-slab"
    s = _sharded(cls, cfg, shards)
    want = one.run(one.initial_state(), iters)
    got = s.run(s.initial_state(), iters)
    assert torch.equal(got.u.assemble(), want.u)
    assert (got.t, got.it) == (want.t, want.it)
    return s


SCHEDULES = {  # (overlap, k) -> engaged overlap
    "serialized": ("padded", 1), "split": ("split", 1),
    "deep2": ("padded", 2), "deep3": ("padded", 3),
    "deep2-split": ("split", 2), "deep3-split": ("split", 3),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_k3_diffusion_schedules_bit_exact(schedule):
    """Grid 16x16x72 on two shards (the JAX suite's split grid), 7 steps:
    k = 2 and 3 end with a partial block."""
    overlap, k = SCHEDULES[schedule]
    cfg = PDConfig(grid=PGrid.make(16, 16, 72, lengths=2.0),
                   impl="pallas_slab", overlap=overlap, steps_per_exchange=k)
    before = psr.slab_step_diffusion.launches
    s = _bit_exact(PDSolver, cfg, 2, 7)
    path = s.engaged_path()
    assert (path["stepper"], path["overlap"], path["steps_per_exchange"]) == (
        "fused-whole-run-slab",
        "split" if overlap == "split" else "serialized-refresh", k)
    assert psr.slab_step_diffusion.launches == before  # the CPU runs twins


def test_k3_diffusion_deep_four_shards_bit_exact():
    """The JAX suite's deep-halo grid (8x8x192) on four shards, k = 2."""
    cfg = PDConfig(grid=PGrid.make(8, 8, 192, lengths=2.0),
                   impl="pallas_slab", steps_per_exchange=2)
    _bit_exact(PDSolver, cfg, 4, 5)


@pytest.mark.parametrize("schedule", ["serialized", "split", "deep2",
                                      "deep3-split"])
def test_k3_burgers_schedules_bit_exact(schedule):
    """Grid 16x16x60 on two shards (the JAX suite's Burgers split grid),
    WENO5-JS viscous at fixed dt."""
    overlap, k = SCHEDULES[schedule]
    cfg = PBConfig(grid=PGrid.make(16, 16, 60, lengths=2.0),
                   impl="pallas_slab", adaptive_dt=False, nu=1e-5,
                   overlap=overlap, steps_per_exchange=k)
    s = _bit_exact(PBSolver, cfg, 2, 4)
    assert s.engaged_path()["overlap"] == (
        "split" if overlap == "split" else "serialized-refresh")


def test_k3_burgers_weno_z_deep_bit_exact():
    """WENO5-Z, the Buckley-Leverett flux, k = 2 on the JAX suite's deep
    Burgers grid (8x8x144) over three shards."""
    cfg = PBConfig(grid=PGrid.make(8, 8, 144, lengths=2.0),
                   impl="pallas_slab", adaptive_dt=False, flux="buckley",
                   weno_variant="z", steps_per_exchange=2)
    _bit_exact(PBSolver, cfg, 3, 3)


@pytest.mark.parametrize("family,kw", [
    ("diffusion", dict(impl="pallas_slab", steps_per_exchange=4)),
    ("burgers", dict(impl="pallas_slab", steps_per_exchange=2,
                     adaptive_dt=False)),
    ("burgers", dict(impl="pallas", steps_per_exchange=2)),
    ("diffusion", dict(impl="pallas_stage", steps_per_exchange=2)),
])
def test_k_step_refusals_match_jax(family, kw):
    """Where the k-step schedule cannot run (a shard thinner than k·G,
    adaptive dt, a rung other than the slab's) both packages raise the
    same error."""
    jm = jmesh.make_mesh({"dz": 4}, devices=jax.devices()[:4])
    mesh = pmesh.make_mesh({"dz": 4}, devices=[CPU] * 4, timeout=60.0)
    if family == "diffusion":
        jcls, jcfg = JDSolver, JDConfig(grid=JGrid.make(16, 16, 64),
                                        dtype="float32", **kw)
        pcls, pcfg = PDSolver, PDConfig(grid=PGrid.make(16, 16, 64), **kw)
    else:
        jcls, jcfg = JBSolver, JBConfig(grid=JGrid.make(16, 16, 64),
                                        dtype="float32", **kw)
        pcls, pcfg = PBSolver, PBConfig(grid=PGrid.make(16, 16, 64), **kw)
    with pytest.raises(ValueError) as want:
        jcls(jcfg, mesh=jm).engaged_path()
    with pytest.raises(ValueError) as got:
        pcls(pcfg, mesh=mesh).engaged_path()
    assert str(got.value) == str(want.value)


def test_windows_are_checked():
    """A window whose input box leaves the buffer raises before any
    launch."""
    S = torch.zeros(20, 8, 8)
    with pytest.raises(ValueError, match="does not fit its buffer"):
        psr.slab_step_diffusion(S, S.clone(), 1e-3, taps=(0.0,) * 15,
                                band=2, bc_value=0.0, global_nz=40, oz=10,
                                depth=4, window=(-2, 12))
