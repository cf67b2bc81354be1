"""Port core against the JAX package: grid geometry, padding, the
heat-kernel IC, the diffusive dt, wall masks and the convert layer.

Everything geometric is compared in float64 to 1e-15 relative to the
largest value (the two packages evaluate the same formulas; XLA may
fuse a multiply-add or take exp an ulp apart).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu.core import bc as jbc
from multigpu_advectiondiffusion_tpu.core.grid import Grid as JGrid
from multigpu_advectiondiffusion_tpu.models.diffusion import (
    DiffusionConfig as JConfig,
)
from multigpu_advectiondiffusion_tpu.ops import stencils as jst
from multigpu_advectiondiffusion_tpu.timestepping import cfl as jcfl
from multigpu_advectiondiffusion_tpu.utils import ic as jic
from multigpu_advectiondiffusion_tpu_torch import convert
from multigpu_advectiondiffusion_tpu_torch.core import bc as pbc
from multigpu_advectiondiffusion_tpu_torch.core.dtypes import canonicalize
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.ops import stencils as pst
from multigpu_advectiondiffusion_tpu_torch.timestepping import cfl as pcfl
from multigpu_advectiondiffusion_tpu_torch.utils import ic as pic

torch.set_num_threads(1)

TOL = 1e-15


def assert_close(got, want):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert float(np.max(np.abs(np.asarray(got) - want))) <= TOL * scale


GRIDS = [
    dict(n=(24, 16, 16), lengths=(10.0, 5.0, 5.15)),
    dict(n=(400, 200, 206), lengths=(10.0, 5.0, 5.15)),
    dict(n=(9, 7, 5), lengths=2.0),
    dict(n=(13, 6), lengths=(3.0, 1.5)),
]


def _grids(spec):
    return (JGrid.make(*spec["n"], lengths=spec["lengths"]),
            PGrid.make(*spec["n"], lengths=spec["lengths"]))


@pytest.mark.parametrize("spec", GRIDS, ids=lambda s: "x".join(map(str, s["n"])))
def test_grid_geometry_matches_jax(spec):
    jg, pg = _grids(spec)
    assert pg.shape == jg.shape and pg.bounds == jg.bounds
    assert pg.spacing == jg.spacing
    assert pg.num_cells == jg.num_cells and pg.shape_xyz == jg.shape_xyz
    for axis in range(jg.ndim):
        assert_close(pg.coords(axis, torch.float64).numpy(),
                     jg.coords(axis, np.float64))
    assert_close(pg.radius_sq(torch.float64).numpy(),
                 jg.radius_sq(np.float64))


def test_grid_coords_float32_match_jax():
    """float32 nodes are computed in float32 by jnp.linspace's formula.
    XLA's CPU float32 divide and multiply-add round differently from
    PyTorch's correctly rounded ops, so the nodes agree within two
    float32 ulps of the largest coordinate (measured: 1-2 ulp)."""
    jg, pg = _grids(GRIDS[1])
    for axis in range(3):
        want = np.asarray(jg.coords(axis, np.float32))
        got = pg.coords(axis, torch.float32).numpy()
        assert got.dtype == np.float32
        ulp = np.spacing(np.float32(np.max(np.abs(want))))
        assert np.max(np.abs(got - want)) <= 2 * ulp


@pytest.mark.parametrize("t0,K", [(0.1, 1.0), (0.05, 0.27)])
def test_heat_kernel_ic_matches_jax(t0, K):
    jg, pg = _grids(GRIDS[0])
    want = np.asarray(jic.heat_kernel(jg, np.float64, t0=t0, diffusivity=K))
    got = pic.initial_condition("heat_kernel", pg, torch.float64,
                                t0=t0, diffusivity=K).numpy()
    assert_close(got, want)


def test_unported_ic_raises():
    _, pg = _grids(GRIDS[0])
    with pytest.raises(NotImplementedError, match="square_jump"):
        pic.initial_condition("square_jump", pg)


@pytest.mark.parametrize("spec", GRIDS[:3], ids=lambda s: "x".join(map(str, s["n"])))
@pytest.mark.parametrize("K,safety", [(1.0, 0.8), (0.27, 0.9)])
def test_diffusive_dt_matches_jax(spec, K, safety):
    jg, _ = _grids(spec)
    assert (pcfl.diffusive_dt(K, jg.spacing, safety)
            == jcfl.diffusive_dt(K, jg.spacing, safety))


@pytest.mark.parametrize("band", [1, 2])
def test_wall_masks_match_jax(band):
    shape = (7, 9, 11)
    np.testing.assert_array_equal(
        pst.boundary_band_mask(shape, band).numpy(),
        np.asarray(jst.boundary_band_mask(shape, band)))
    np.testing.assert_array_equal(
        pst.boundary_band_mask(shape, band, axes=[0, 2]).numpy(),
        np.asarray(jst.boundary_band_mask(shape, band, axes=[0, 2])))
    for axes in ([0], [1, 2], [0, 1, 2]):
        np.testing.assert_array_equal(
            pst.face_mask(shape, axes).numpy(),
            np.asarray(jst.face_mask(shape, axes)))


@pytest.mark.parametrize("kind,value", [("dirichlet", 0.0),
                                        ("dirichlet", 0.5),
                                        ("edge", 0.0), ("periodic", 0.0)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pad_axis_matches_jax(kind, value, axis):
    u = np.random.default_rng(3).standard_normal((5, 6, 7))
    got = pbc.pad_axis(torch.from_numpy(u), axis, 2,
                       pbc.Boundary(kind, value)).numpy()
    want = np.asarray(jbc.pad_axis(u, axis, 2, jbc.Boundary(kind, value)))
    np.testing.assert_array_equal(got, want)


def test_canonicalize_dtypes():
    assert canonicalize("float32") is torch.float32
    assert canonicalize("f64") is torch.float64
    # bfloat16 is ported (the all-bf16 experiment and the bf16 storage
    # rung); names resolve as in the JAX package
    assert canonicalize("bfloat16") is torch.bfloat16
    assert canonicalize("bf16") is torch.bfloat16
    with pytest.raises(ValueError):
        canonicalize("int8")


def test_convert_state_roundtrip():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        u = rng.standard_normal((4, 5, 6)).astype(dtype)
        st = convert.state_from_numpy(u, 0.125, 7, device="cpu")
        assert st.u.dtype == (torch.float32 if dtype == np.float32
                              else torch.float64)
        assert type(st.t) is dtype and st.it == 7
        u2, t2, it2 = convert.state_to_numpy(st)
        np.testing.assert_array_equal(u2, u)
        assert t2 == dtype(0.125) and it2 == 7
    with pytest.raises(TypeError):
        convert.state_from_numpy(np.zeros((2, 2, 2), np.int32), 0.0,
                                 device="cpu")


def test_convert_config_from_jax_fields():
    jg, _ = _grids(GRIDS[0])
    jcfg = JConfig(grid=jg, diffusivity=0.5, dtype="float32",
                   impl="pallas_stage", bc=jbc.Boundary("dirichlet", 0.25),
                   t0=0.05)
    for fields in (dataclasses.asdict(jcfg),
                   {f.name: getattr(jcfg, f.name)
                    for f in dataclasses.fields(jcfg)}):
        pcfg = convert.config_from_fields(fields)
        assert pcfg.grid.shape == jg.shape and pcfg.grid.bounds == jg.bounds
        assert pcfg.bc == pbc.Boundary("dirichlet", 0.25)
        for f in dataclasses.fields(jcfg):
            if f.name not in ("grid", "bc"):
                assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    with pytest.raises(ValueError, match="lacks"):
        convert.config_from_fields({"grid": jg, "mesh_shape": (2,)})
