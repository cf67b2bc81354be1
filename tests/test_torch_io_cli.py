"""Port binary I/O (byte-compatible with the JAX package) and the port's
``diffusion3d`` CLI verb, run on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu.utils import io as jio
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig,
    DiffusionSolver,
)
from multigpu_advectiondiffusion_tpu_torch.utils import io as pio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_save_binary_bytes_match_jax(tmp_path, dtype):
    u = np.random.default_rng(1).standard_normal((3, 4, 5)).astype(dtype)
    jpath, ppath = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    jio.save_binary(u, jpath)
    pio.save_binary(torch.from_numpy(u), ppath)
    with open(jpath, "rb") as fj, open(ppath, "rb") as fp:
        assert fj.read() == fp.read()
    # each package reads the other's file
    np.testing.assert_array_equal(pio.load_binary(jpath, u.shape),
                                  u.astype(np.float32))
    np.testing.assert_array_equal(jio.load_binary(ppath, u.shape),
                                  u.astype(np.float32))


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "multigpu_advectiondiffusion_tpu_torch.cli",
         "diffusion3d", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})},
    )


@pytest.mark.parametrize("impl,stepper", [("xla", "generic-xla"),
                                          ("pallas", "fused-stage")])
def test_cli_diffusion3d_runs_and_names_its_path(tmp_path, impl, stepper):
    # a grid above the slab gate's cell count (64^3), so impl="pallas"
    # runs K1
    proc = _cli("--n", "70", "66", "60", "--iters", "3", "--device", "cpu",
                "--impl", impl, "--save", str(tmp_path), "--check-error")
    assert proc.returncode == 0, proc.stderr
    assert f"kernel path        : {stepper} (impl={impl})" in proc.stdout
    assert "error L1/L2/Linf" in proc.stdout
    # result.bin is the in-process run's state, in the reference layout
    grid = Grid.make(70, 66, 60, lengths=2.0)
    s = DiffusionSolver(DiffusionConfig(grid=grid, impl=impl), device="cpu")
    want = s.run(s.initial_state(), 3).u.numpy()
    got = pio.load_binary(str(tmp_path / "result.bin"), grid.shape)
    np.testing.assert_array_equal(got, want)
    assert os.path.exists(tmp_path / "initial.bin")


@pytest.mark.parametrize("impl,stepper", [
    ("pallas_step", "fused-step"), ("pallas_slab", "fused-whole-run-slab")])
def test_cli_diffusion3d_fused_step_rungs(impl, stepper):
    """The summary names the engaged stepper; the CPU runs the twins and
    launches no kernel."""
    proc = _cli("--n", "16", "12", "10", "--iters", "3", "--device", "cpu",
                "--impl", impl)
    assert proc.returncode == 0, proc.stderr
    assert f"kernel path        : {stepper} (impl={impl})" in proc.stdout
    assert "kernel launches    : none" in proc.stdout


def test_cli_t_end_mode_cpu():
    proc = _cli("--n", "12", "10", "8", "--t-end", "0.101", "--device",
                "cpu", "--impl", "pallas_stage")
    assert proc.returncode == 0, proc.stderr
    assert "fused-stage (impl=pallas_stage)" in proc.stdout


def test_cli_defaults_to_the_gpu():
    """Without --device the run goes to CUDA, and fails where there is none."""
    proc = _cli("--n", "12", "10", "8", "--iters", "1",
                env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
