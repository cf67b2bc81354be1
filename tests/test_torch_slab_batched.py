"""K2b, the B-folded whole-run slab kernel, on the CPU: the plain twins
of ``slab_run_diffusion_batched`` and ``slab_run_burgers_batched``
against the JAX package's ``run_batched`` (``fused_slab_run.py:902-945``,
``_whole_run_kernel(batched=True)`` run in Pallas interpret mode), and,
inside the port, against the single K2/K6 twins member by member.

Tolerances: against the JAX kernel, every member within ``32 eps_f32 *
max|u|``, the bound the K2/K6 twin tests state
(``tests/test_torch_slab_run.py``), and ``t`` equal; inside the port, to
the bit (the batched twin is the single twin run per member).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu import Grid as JGrid
from multigpu_advectiondiffusion_tpu.ops import flux as jflux
from multigpu_advectiondiffusion_tpu.ops.pallas import fused_slab_run as jsr
from multigpu_advectiondiffusion_tpu.timestepping.cfl import (
    diffusive_dt as jdiffusive_dt,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as pfb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as pfd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_slab_run as psr,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as pwr

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS
B = 4


def _members(grid_shape, seed: int, lo=0.0, hi=1.0):
    """B member fields of ``grid_shape`` from one numpy seed."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (B, *grid_shape)).astype(np.float32)


def _assert_members_close(got, want):
    """Every member within 32 eps of its own max|want|; prints the gaps
    in eps (``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    gaps = [float(np.max(np.abs(g - w))) / float(np.max(np.abs(w))) / EPS
            for g, w in zip(got, want)]
    print("max|port - jax| per member:",
          " ".join(f"{g:.2f}" for g in gaps), "eps of max|u|")
    assert max(gaps) <= 32


# --------------------------------------------------------------------- #
# The twins against the JAX package's run_batched (interpret mode)
# --------------------------------------------------------------------- #
def test_k2b_twin_matches_jax_run_batched():
    """Diffusion, B = 4, 2 steps, on the JAX suite's 12x10x8 grid."""
    grid = JGrid.make(12, 10, 8, lengths=(1.2, 1.0, 0.8))
    dt = jdiffusive_dt(1.0, grid.spacing)
    us = _members(grid.shape, 21)
    ts = np.full(B, 0.1, np.float32)
    st = jsr.SlabRunDiffusionStepper(grid.shape, jnp.float32, grid.spacing,
                                     [1.0] * 3, dt, 2, 0.0)
    want_u, want_t = jax.jit(lambda u, t: st.run_batched(u, t, 2))(
        jnp.asarray(us), jnp.asarray(ts))
    pst = psr.SlabRunDiffusionStepper(grid.shape, grid.spacing, [1.0] * 3,
                                      dt, 2, 0.0, "cpu")
    before = psr.slab_run_diffusion_batched.launches
    got_u, got_t = pst.run_batched(torch.from_numpy(us), ts, 2)
    assert psr.slab_run_diffusion_batched.launches == before  # CPU: none
    assert got_u.shape == (B, *grid.shape)
    assert got_t.dtype == np.float32
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    _assert_members_close(got_u.numpy(), want_u)


def test_k2b_burgers_twin_matches_jax_run_batched():
    """Burgers/WENO5-JS, viscous, fixed dt, B = 4, 2 steps, on the JAX
    suite's 24x8x8 grid."""
    grid = JGrid.make(24, 8, 8, lengths=2.0)
    dt = 0.4 * min(grid.spacing)
    us = _members(grid.shape, 22, lo=-0.1, hi=1.0)
    ts = np.zeros(B, np.float32)
    st = jsr.SlabRunBurgersStepper(grid.shape, jnp.float32, grid.spacing,
                                   jflux.get("burgers"), "js", 1e-5, dt=dt,
                                   order=5)
    want_u, want_t = jax.jit(lambda u, t: st.run_batched(u, t, 2))(
        jnp.asarray(us), jnp.asarray(ts))
    pst = psr.SlabRunBurgersStepper(grid.shape, grid.spacing,
                                    pflux.get("burgers"), "js", 1e-5, dt,
                                    "cpu")
    before = psr.slab_run_burgers_batched.launches
    got_u, got_t = pst.run_batched(torch.from_numpy(us), ts, 2)
    assert psr.slab_run_burgers_batched.launches == before
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    _assert_members_close(got_u.numpy(), want_u)


# --------------------------------------------------------------------- #
# Inside the port: member i of the batched twin is the single run of i
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("steps", [0, 1, 2, 3])
def test_k2b_twin_equals_k2_twin_per_member(steps):
    shape = (7, 9, 11)
    kw = dict(taps=pfd.stage_taps((0.3, 0.25, 0.2), (1.0, 0.5, 2.0)),
              band=2, bc_value=0.25)
    S0 = torch.full((B, *(n + 4 for n in shape)), 0.25)
    S0[:, 2:-2, 2:-2, 2:-2] = torch.from_numpy(_members(shape, steps))
    A, C = S0.clone(), S0.clone()
    got = psr.slab_run_diffusion_batched(A, C, steps, 2e-3, **kw)
    assert got is (C if steps % 2 else A)
    for i in range(B):
        want = psr.slab_run_diffusion(S0[i].clone(), S0[i].clone(), steps,
                                      2e-3, **kw)
        assert torch.equal(got[i], want), f"member {i}"


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("variant,nu", [("js", 1e-3), ("z", 0.0)])
def test_k2b_burgers_twin_equals_k6_twin_per_member(variant, nu, steps):
    shape, spacing, dt = (6, 9, 11), (0.1, 0.09, 0.08), 0.02
    params = pfb.stage_params(pflux.burgers(), variant, spacing, nu)
    S0 = torch.from_numpy(_members(shape, 5 + steps, lo=-0.1))
    A, C = S0.clone(), torch.empty_like(S0)
    got = psr.slab_run_burgers_batched(A, C, steps, dt, params=params)
    assert got is (C if steps % 2 else A)
    for i in range(B):
        want = psr.slab_run_burgers(S0[i].clone(), torch.empty_like(S0[i]),
                                    steps, dt, params=params)
        assert torch.equal(got[i], want), f"member {i}"


def test_run_batched_equals_run_per_member():
    """The steppers' ``run_batched``: every member's field and time equal
    its own ``run``, to the bit; no step hands the input back."""
    shape, spacing = (6, 7, 9), (0.2, 0.15, 0.1)
    us = torch.from_numpy(_members(shape, 9))
    ts = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    dst = psr.SlabRunDiffusionStepper(shape, spacing, [1.0] * 3, 1e-3, 2,
                                      0.0, "cpu")
    bst = psr.SlabRunBurgersStepper(shape, spacing, pflux.burgers(), "z",
                                    1e-4, 0.01, "cpu")
    for st in (dst, bst):
        got_u, got_t = st.run_batched(us, ts, 3)
        for i in range(B):
            u_i, t_i = st.run(us[i], ts[i], 3)
            assert torch.equal(got_u[i], u_i) and got_t[i] == t_i
        assert st.run_batched(us, ts, 0) == (us, ts)


def test_member_declarations():
    """The JAX steppers' member-fold declaration: the member axis has no
    stencil reach, on both slab steppers of both packages."""
    for cls in (jsr.SlabRunDiffusionStepper, jsr.SlabRunBurgersStepper,
                psr.SlabRunDiffusionStepper, psr.SlabRunBurgersStepper):
        assert cls.member_halo == 0


def test_accumulate_ts_is_accumulate_t_per_member():
    ts = np.array([0.1, 0.25, 1.5, 3.0], np.float32)
    got = psr.accumulate_ts(ts, 7e-3, 11)
    assert got.dtype == np.float32
    for i in range(B):
        assert got[i] == pwr.accumulate_t(ts[i], np.float32(7e-3), 11)
    got64 = psr.accumulate_ts(ts.astype(np.float64), 7e-3, 3)
    assert got64.dtype == np.float64


def test_batched_wrappers_reject_bad_operands():
    S = torch.zeros((2, 9, 8, 7))
    kw = dict(taps=(0.0,) * 15, band=2, bc_value=0.0)
    params = pfb.stage_params(pflux.burgers(), "js", (0.1,) * 3, 0.0)
    with pytest.raises(ValueError, match="different buffers"):
        psr.slab_run_diffusion_batched(S, S, 1, 1e-3, **kw)
    with pytest.raises(TypeError, match="float32"):
        psr.slab_run_diffusion_batched(S.double(), S.double().clone(), 1,
                                       1e-3, **kw)
    with pytest.raises(ValueError, match=r"\(B, nz, ny, nx\)"):
        psr.slab_run_diffusion_batched(S[0], S[1].clone(), 1, 1e-3, **kw)
    with pytest.raises(ValueError, match="expected"):
        psr.slab_run_burgers_batched(S, torch.zeros((2, 9, 8, 6)), 1, 1e-3,
                                     params=params)
    with pytest.raises(ValueError, match="different buffers"):
        psr.slab_run_burgers_batched(S, S, 1, 1e-3, params=params)
