"""Which rung each storage-precision config engages, in the port and in
the JAX package, and K6's bf16 instance against the JAX package's, on
the CPU.

The table: ``engaged_path()`` of both packages (stepper, ``storage_dtype``,
``precision``, and for a declined fused rung its ``fallback``) over 2-D
and 3-D diffusion, Burgers (fixed and adaptive dt, WENO orders 5 and 7)
and ADR, every ``impl`` but ``auto``, under ``precision="bf16"``,
``dtype="bfloat16"`` and ``dtype="float64"``, in both modes. A fused
run's ``fallback`` is not compared: the port names why a pinned rung
declined where the JAX package says nothing (``models/base.py``
``engaged_path``). Every difference is listed in :data:`DIFFERENCES`
with its reason; any other fails the test.

K6's bf16 twin (``fused_slab_run.slab_run_burgers_bf16`` on the CPU) is
held against the JAX slab stepper with bf16 buffers (interpret mode) at
the JAX suite's Burgers slab grid, 32x24x16 (``tests/test_precision.py``),
``run(3)`` at WENO orders 5 and 7 on a bounded random state: at most 1
bf16 ulp a cell (``tests/test_torch_precision.py`` gives the reason).
"""

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
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_slab_run as jsr
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models import adr as padr
from multigpu_advectiondiffusion_tpu_torch.models import burgers as pbur
from multigpu_advectiondiffusion_tpu_torch.models import diffusion as pdif
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)

torch.set_num_threads(1)

IMPLS = ("xla", "pallas", "pallas_axis", "pallas_stage", "pallas_step",
         "pallas_slab")
FAMILIES = {
    "diffusion": (jdif.DiffusionConfig, jdif.DiffusionSolver,
                  pdif.DiffusionConfig, pdif.DiffusionSolver),
    "burgers": (jbur.BurgersConfig, jbur.BurgersSolver,
                pbur.BurgersConfig, pbur.BurgersSolver),
    "adr": (jadr.ADRConfig, jadr.ADRSolver, padr.ADRConfig, padr.ADRSolver),
}
GRIDS = {
    "diffusion": [(40, 30), (1001, 1001), (24, 16, 16), (64, 64, 64),
                  (400, 200, 206)],
    "burgers": [(40, 30), (400, 400), (32, 24, 16), (128, 64, 64),
                (400, 400, 406), (512, 512, 512)],
    "adr": [(40, 30), (1001, 1001), (16, 12, 10), (508, 204, 160)],
}
STORAGE = {"bf16": {"precision": "bf16"}, "bfloat16": {"dtype": "bfloat16"},
           "float64": {"dtype": "float64"}}
BURGERS_EXTRAS = [{"adaptive_dt": a, "weno_order": o}
                  for a in (True, False) for o in (5, 7)]

# (family, grid xyz, impl, storage, WENO order at fixed dt (Burgers) or
# None) -> why the port's rung differs from the JAX package's, in "iters"
# mode. Burgers has none: the port takes the JAX slab's bf16 plane gate
# (fused_slab_run.jax_bf16_slab_fits), since K6's bf16 instance left the
# bf16 band on the larger grids on the H100 (PERF.md §6).
_K2_GATE = ("the 3-D slab gate: the port's, measured on the H100, takes K2 "
            "at <= 262,144 cells (SlabRunDiffusionStepper.profitable), "
            "where JAX's TPU model takes K1 at 64^3 (as at float32)")
DIFFERENCES = {
    ("diffusion", (64, 64, 64), "pallas", "bf16", None): _K2_GATE,
    ("diffusion", (64, 64, 64), "pallas", "float64", None): _K2_GATE,
}


def _paths(family, grid, kw, mode):
    jcfg, jsol, pcfg, psol = FAMILIES[family]
    with jax.enable_x64(True):
        want = jsol(jcfg(grid=JGrid.make(*grid), **kw)).engaged_path(mode)
    got = psol(pcfg(grid=PGrid.make(*grid), **kw),
               device="cpu").engaged_path(mode)
    keys = ["stepper", "storage_dtype", "precision"]
    if not want["stepper"].startswith("fused"):
        keys.append("fallback")
    return ({k: want[k] for k in keys}, {k: got[k] for k in keys})


@pytest.mark.parametrize("mode", ["iters", "t_end"])
def test_storage_engaged_path_table_matches_jax(mode):
    seen, count = set(), 0
    for family in FAMILIES:
        extras = BURGERS_EXTRAS if family == "burgers" else [{}]
        for grid, impl, name, extra in itertools.product(
                GRIDS[family], IMPLS, STORAGE, extras):
            kw = dict(impl=impl, **STORAGE[name], **extra)
            want, got = _paths(family, grid, kw, mode)
            count += 1
            key = (family, grid, impl, name,
                   None if family != "burgers" or extra["adaptive_dt"]
                   else extra["weno_order"])
            if want == got:
                continue
            assert mode == "iters" and key in DIFFERENCES, (key, want, got)
            seen.add(key)
            assert (want["stepper"], got["stepper"]) == (
                "fused-stage", "fused-whole-run-slab")
    assert count == (5 + 4) * 6 * 3 + 6 * 6 * 3 * 4
    if mode == "iters":
        assert seen == set(DIFFERENCES)


def _ordered(a) -> np.ndarray:
    bits = (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16
            ).astype(np.int64)
    return np.where(bits >= 0x8000, 0x8000 - bits, bits)


def test_k6_bf16_plane_gate_is_jax_slab_gate():
    """The bf16 instance of K6 takes the planes the JAX slab takes in
    bf16, at both orders (its VMEM model, copied into the port)."""
    for ny, nx, order in itertools.product(
            (8, 64, 150, 152, 160, 400, 512), (30, 122, 123, 400, 1024),
            (5, 7)):
        want = jsr.SlabRunBurgersStepper.supported((16, ny, nx),
                                                   jnp.bfloat16, order=order)
        assert psr.jax_bf16_slab_fits(ny, nx, order) == want, (ny, nx, order)
        assert psr.SlabRunBurgersStepper.supported(
            (16, ny, nx), torch.bfloat16, order=order) == want
        assert psr.SlabRunBurgersStepper.supported((16, ny, nx),
                                                   torch.float32)


@pytest.mark.parametrize("order,nu", [(5, 0.0), (7, 1e-3)])
def test_k6_bf16_runs_match_jax(order, nu):
    kw = dict(dtype="float32", impl="pallas_slab", precision="bf16",
              adaptive_dt=False, weno_order=order, nu=nu)
    js = jbur.BurgersSolver(jbur.BurgersConfig(
        grid=JGrid.make(32, 24, 16, lengths=2.0), **kw))
    ps = pbur.BurgersSolver(pbur.BurgersConfig(
        grid=PGrid.make(32, 24, 16, lengths=2.0), **kw), device="cpu")
    for path in (js.engaged_path(), ps.engaged_path()):
        assert (path["stepper"], path["storage_dtype"]) == (
            "fused-whole-run-slab", "bfloat16")
    st = ps._fused_stepper()
    assert (st.dtype, st.storage_dtype) == (torch.bfloat16, torch.float32)
    u0 = np.random.default_rng(order).random((16, 24, 32), dtype=np.float32)
    s0 = js.initial_state()._replace(u=jnp.asarray(u0))
    p0 = convert.state_from_numpy(u0, np.float32(s0.t), 0, device="cpu")
    before = psr.slab_run_burgers_bf16.launches
    want, got = js.run(s0, 3), ps.run(p0, 3)
    assert psr.slab_run_burgers_bf16.launches == before  # the CPU twin
    assert got.u.dtype == torch.float32 and got.t == np.float32(want.t)
    w = np.asarray(want.u, np.float32)
    g = got.u.numpy()
    assert np.array_equal(g, torch.from_numpy(g).bfloat16().float().numpy())
    assert int(np.max(np.abs(_ordered(g) - _ordered(w)))) <= 1
