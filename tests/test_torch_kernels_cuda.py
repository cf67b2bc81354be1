"""K1 and K5, the port's CUDA stage kernels, against their plain PyTorch
twins on a GPU. Marked ``cuda``: it skips where no CUDA device is
present.

This file imports nothing of JAX, so it also runs on a GPU machine that
has no JAX, with the JAX-side conftest switched off::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu_torch import (
    BurgersConfig,
    BurgersSolver,
    DiffusionConfig,
    DiffusionSolver,
    Grid,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as fb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)

TOL = 32 * np.finfo(np.float32).eps


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("K1 (csrc/fused_diffusion_stage.cu) and K5 "
                    "(csrc/fused_burgers_stage.cu) need a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(23, 29, 37), (5, 6, 70)])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k1_matches_twin(gpu, shape, kind):
    rng = np.random.default_rng(kind)
    padded = tuple(n + 2 * fd.R for n in shape)
    v = torch.from_numpy(rng.random(padded, dtype=np.float32)).to(gpu)
    u = torch.from_numpy(rng.random(padded, dtype=np.float32)).to(gpu)
    a, b = fd.STAGES[kind]
    kw = dict(taps=fd.stage_taps((0.1, 0.2, 0.3), (1.0, 0.5, 2.0)),
              a=a, b=b, band=2, bc_value=0.25)
    u_arg = None if kind == 0 else u
    ref = fd.stage_reference(v, u_arg, torch.zeros_like(v), 1e-4, **kw)
    out = torch.zeros_like(v)
    before = fd.fused_stage.launches
    fd.fused_stage(v, u_arg, out, 1e-4, **kw)
    torch.cuda.synchronize()
    assert fd.fused_stage.launches == before + 1
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err <= TOL
    # the ghost ring stays as it was (zeros here)
    inner = torch.zeros_like(out, dtype=torch.bool)
    inner[2:-2, 2:-2, 2:-2] = True
    assert float(out[~inner].abs().max()) == 0.0


@pytest.mark.cuda
def test_k1_run_matches_generic_path(gpu):
    grid = Grid.make(37, 29, 23, lengths=2.0)
    fused = DiffusionSolver(DiffusionConfig(grid=grid, impl="pallas"))
    generic = DiffusionSolver(DiffusionConfig(grid=grid, impl="xla"))
    s0 = fused.initial_state()
    fd.fused_stage.launches = 0
    got = fused.run(s0, 7)
    assert fd.fused_stage.launches == 21
    want = generic.run(s0, 7)
    scale = float(want.u.abs().max())
    bad = (got.u - want.u).abs() > 1e-5 * want.u.abs() + 1e-6 * scale
    assert not bool(bad.any())
    assert got.t == want.t


K5_CASES = {
    "js-burgers-viscous": ("burgers", {}, "js", 1e-5),
    "z-burgers-inviscid": ("burgers", {}, "z", 0.0),
    "js-linear": ("linear", {"c": -0.7}, "js", 1e-5),
    "z-buckley": ("buckley", {}, "z", 1e-5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["s1", "s2", "s3"])
def test_k5_matches_twin(gpu, case, kind):
    """K5 against its twin on an odd shape: 0 ulp expected (both round
    every operation alike), 32 eps of max|twin| asserted; the emitted
    maximum exactly."""
    name, kw, variant, nu = K5_CASES[case]
    shape = (23, 29, 37)
    rng = np.random.default_rng(kind)
    v = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu)
    u = torch.from_numpy(
        rng.uniform(-0.2, 1.0, shape).astype(np.float32)).to(gpu)
    params = fb.stage_params(pflux.get(name, **kw), variant,
                             (0.05, 0.07, 0.09), nu)
    a, b = fb.STAGES[kind]
    dt = torch.full((), 2e-3, device=gpu)
    u_arg = None if kind == 0 else u
    emit = kind == 2
    ref = fb.stage_reference(v, u_arg, torch.empty_like(v), dt,
                             params=params, a=a, b=b, emit=emit)
    out = u.clone() if kind == 2 else torch.empty_like(v)
    mx = torch.full((1,), -1.0, device=gpu) if emit else None
    before = fb.fused_burgers_stage.launches
    fb.fused_burgers_stage(v, out if kind == 2 else u_arg, out, dt, mx,
                           params=params, a=a, b=b)
    torch.cuda.synchronize()
    assert fb.fused_burgers_stage.launches == before + 1
    want = ref[0] if emit else ref
    err = float((out - want).abs().max()) / float(want.abs().max())
    assert err <= TOL
    if emit:
        assert float(mx[0]) == float(ref[1])


@pytest.mark.cuda
def test_k5_nan_cell_gives_nan_max(gpu):
    shape = (9, 10, 33)
    v = torch.full(shape, 0.5, device=gpu)
    v[4, 3, 20] = float("nan")
    u = torch.full(shape, 0.5, device=gpu)
    params = fb.stage_params(pflux.burgers(), "js", (0.1,) * 3, 1e-5)
    mx = torch.zeros(1, device=gpu)
    a, b = fb.STAGES[2]
    fb.fused_burgers_stage(v, u, u, torch.full((), 1e-3, device=gpu), mx,
                           params=params, a=a, b=b)
    assert bool(torch.isnan(mx[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed"])
def test_k5_run_matches_generic_path(gpu, adaptive):
    grid = Grid.make(37, 29, 23, lengths=2.0)
    kw = dict(grid=grid, nu=1e-5, adaptive_dt=adaptive)
    fused = BurgersSolver(BurgersConfig(impl="pallas", **kw))
    generic = BurgersSolver(BurgersConfig(impl="xla", **kw))
    s0 = fused.initial_state()
    fb.fused_burgers_stage.launches = 0
    got = fused.run(s0, 7)
    assert fb.fused_burgers_stage.launches == 21
    want = generic.run(s0, 7)
    scale = float(want.u.abs().max())
    bad = (got.u - want.u).abs() > 2e-5 * want.u.abs() + 2e-6 * scale
    assert not bool(bad.any())
    assert abs(float(got.t) - float(want.t)) <= 1e-5 * float(want.t)
