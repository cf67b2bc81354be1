"""K1, the port's CUDA stage kernel, against its plain PyTorch twin on a
GPU. Marked ``cuda``: it skips where no CUDA device is present.

This file imports nothing of JAX, so it also runs on a GPU machine that
has no JAX, with the JAX-side conftest switched off::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu_torch import (
    DiffusionConfig,
    DiffusionSolver,
    Grid,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)

TOL = 32 * np.finfo(np.float32).eps


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("K1 (csrc/fused_diffusion_stage.cu) needs a CUDA device")
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
