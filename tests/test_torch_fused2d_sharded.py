"""The sharded 2-D stage kernels' plain twins (K8, K8b) on the CPU against
the JAX package's kernels, ``fused2d_sharded._make_stage`` and
``_make_band_stage`` in Pallas interpret mode, on shards of the JAX
suite's oracle grid (40x32, ``tests/test_pallas.py:1391``); the wrappers'
contracts; WENO7 on K8 (its twins against JAX at order 7 are in
``tests/test_torch_weno7_mesh.py``).

Each case cuts one shard out of a global field, padded as the stepper
keeps it: its ghost rows and columns hold the neighbours' cells inside
the domain and, outside it, the wall value (diffusion) or edge replicas
(Burgers). The JAX kernel gets the same shard in its tile-rounded
layout. Tolerance: the written cells within ``32 eps_f32 * max|u|``, the
bound the other twins are held to (``tests/test_torch_fused_burgers2d``):
XLA's compilation of the interpret-mode kernel may contract
multiply-adds that the twin rounds separately.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu.ops import flux as jflux
from multigpu_advectiondiffusion_tpu.ops.pallas import (
    fused2d_sharded as jfs,
)
from multigpu_advectiondiffusion_tpu.ops.pallas.laplacian import (
    LANE,
    SUBLANE,
    round_up,
)
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid as PGrid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig as PBConfig,
    BurgersSolver as PBSolver,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused2d_sharded as pfs,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as pfb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as pfd,
)
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 32 * EPS
GLOBAL = (40, 32)  # (ny, nx), the JAX suite's oracle grid
SPACING = (0.05, 0.0625)
STAGES = ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))
# (name, K or flux, flux kwargs, variant, nu); the other fluxes' split is
# K7's and K5's, held against JAX by their own tests
FAMILIES = {
    "diffusion": ("diffusion", 1.3, {}, None, 0.0),
    "burgers-js": ("burgers", "burgers", {}, "js", 0.0),
    "burgers-z-viscous": ("burgers", "burgers", {}, "z", 1e-3),
}
BC_VALUE = 0.25
BAND = 2
# (offsets, local shape): first, middle and last shard of dy = 4, and
# the top-right corner of a dy x dx = 2 x 2 pencil
SHARDS = {
    "dy4-first": ((0, 0), (10, 32)),
    "dy4-middle": ((20, 0), (10, 32)),
    "dy4-last": ((30, 0), (10, 32)),
    "pencil-corner": ((20, 16), (20, 16)),
}


def _family(key):
    kind, what, kw, variant, nu = FAMILIES[key]
    if kind == "diffusion":
        params = pfs.DiffusionParams(pfd.stage_taps(SPACING, (what, what)),
                                     BAND, BC_VALUE)
        stage_fn = functools.partial(
            jfs._diffusion_stage, global_shape=GLOBAL,
            scales=tuple(what / (12.0 * dx * dx) for dx in SPACING),
            band=BAND, bc_value=BC_VALUE)
        return params, (lambda band_shape: stage_fn), 2
    params = pfb.stage_params(pflux.get(what, **kw), variant, SPACING, nu)
    nu_scales = (tuple(nu / (12.0 * dx * dx) for dx in SPACING)
                 if nu else None)

    def stage_fn_for(local_shape):
        return functools.partial(
            jfs._burgers_stage, local_shape=local_shape,
            global_shape=GLOBAL, inv_dx=tuple(1.0 / dx for dx in SPACING),
            nu_scales=nu_scales, flux=jflux.get(what, **kw),
            variant=variant, order=5, halo=3)
    return params, stage_fn_for, 3


def _global_padded(h, diffusion, seed):
    """A global field padded by ``h``: the wall value or edge replicas."""
    u = np.random.default_rng(seed).uniform(-0.2, 1.0, GLOBAL).astype(
        np.float32)
    if diffusion:
        return np.pad(u, h, constant_values=np.float32(BC_VALUE))
    return np.pad(u, h, mode="edge")


def _shard(U, h, offsets, shape):
    (oy, ox), (ly, lx) = offsets, shape
    return U[oy:oy + ly + 2 * h, ox:ox + lx + 2 * h].copy()


def _jax_layout(P, h, shape):
    """The shard in the JAX stepper's tile-rounded layout (slack cells
    replicate their neighbours; no written cell reads them)."""
    ly, lx = shape
    py, px = round_up(ly + 2 * h, SUBLANE), round_up(lx + 2 * h, LANE)
    return np.pad(P, ((0, py - P.shape[0]), (0, px - P.shape[1])),
                  mode="edge")


def _close(got, want):
    gap = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"max|port - jax| = {gap / EPS:.2f} eps of max|u|")
    assert gap <= TOL


@functools.lru_cache(maxsize=None)
def _jax_stage(family, stage, shape):
    _, stage_fn_for, h = _family(family)
    ly, lx = shape
    padded = (round_up(ly + 2 * h, SUBLANE), round_up(lx + 2 * h, LANE))
    a, b = STAGES[stage]
    src = ("none", "operand", "alias_u")[stage]
    return jax.jit(jfs._make_stage(padded, jnp.float32, stage_fn_for(shape),
                                   a=a, b=b, u_source=src))


DT = 0.004


# (stage kind, shard): every stage kind, each on another shard of dy = 4;
# a pencil's corner shard (x ghosts from a neighbour on one side, the
# global edge on the other)
K8_CASES = [(0, "dy4-first"), (1, "dy4-middle"), (2, "dy4-last")]


@pytest.mark.parametrize("family,stage,shard", [
    (family, stage, shard) for family in FAMILIES
    for stage, shard in K8_CASES] + [
    ("burgers-z-viscous", 1, "pencil-corner")])
def test_k8_twin_matches_jax(family, stage, shard):
    params, _, h = _family(family)
    offsets, shape = SHARDS[shard]
    diffusion = family == "diffusion"
    V = _shard(_global_padded(h, diffusion, 1), h, offsets, shape)
    U = _shard(_global_padded(h, diffusion, 2), h, offsets, shape)
    a, b = STAGES[stage]
    u = None if stage == 0 else torch.from_numpy(U.copy())
    out = u if stage == 2 else torch.zeros(V.shape, dtype=torch.float32)
    pfs.fused2d_stage(torch.from_numpy(V.copy()), u, out, DT, offsets,
                      params=params, a=a, b=b, global_shape=GLOBAL)
    fn = _jax_stage(family, stage, shape)
    jv, ju = _jax_layout(V, h, shape), _jax_layout(U, h, shape)
    args = [jnp.asarray([DT], jnp.float32), jnp.asarray(offsets, jnp.int32),
            jnp.asarray(jv)]
    if stage > 0:
        args.append(jnp.asarray(ju))
    if stage < 2:
        args.append(jnp.zeros_like(jnp.asarray(jv)))
    want = np.asarray(fn(*args))
    ly, lx = shape
    _close(out.numpy()[h:h + ly, h:h + lx], want[h:h + ly, h:h + lx])


@functools.lru_cache(maxsize=None)
def _jax_band(family, stage, shape, band):
    _, stage_fn_for, h = _family(family)
    ly, lx = shape
    px = round_up(lx + 2 * h, LANE)
    a, b = STAGES[stage]
    mid = ly - 2 * h
    in_rows, out_rows, fn_shape = ((ly, mid, (mid, lx)) if band == "interior"
                                   else (3 * h, h, (h, lx)))
    return jax.jit(jfs._make_band_stage(in_rows, out_rows, h, (px,),
                                        jnp.float32, stage_fn_for(fn_shape),
                                        a=a, b=b, use_u=stage > 0))


@pytest.mark.parametrize("shard", ["dy4-first", "dy4-middle", "dy4-last"])
@pytest.mark.parametrize("band", ["bottom", "interior", "top"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_k8b_twin_matches_jax(family, band, shard):
    """K8b's band against JAX's band call of the same rows (stage 2, the
    one with both operands; the bottom band stage 1, the top stage 3):
    the buffer's ghost rows hold garbage, so the edge bands read the
    exchanged operands and the interior band no ghost row."""
    params, _, h = _family(family)
    stage = {"bottom": 0, "interior": 1, "top": 2}[band]
    offsets, shape = SHARDS[shard]
    ly, lx = shape
    diffusion = family == "diffusion"
    V = _shard(_global_padded(h, diffusion, 3), h, offsets, shape)
    U = _shard(_global_padded(h, diffusion, 4), h, offsets, shape)
    lo, hi = V[:h].copy(), V[ly + h:].copy()
    stale = V.copy()
    stale[:h] = stale[ly + h:] = 7.5  # the split schedule never reads them
    a, b = STAGES[stage]
    rows = {"bottom": (0, h), "interior": (h, ly - h), "top": (ly - h, ly)}
    u = None if stage == 0 else torch.from_numpy(U.copy())
    out = torch.zeros(V.shape, dtype=torch.float32)
    ops = {"lo": torch.from_numpy(lo) if band == "bottom" else None,
           "hi": torch.from_numpy(hi) if band == "top" else None}
    pfs.fused2d_band_stage(torch.from_numpy(stale), u, out, DT, offsets,
                           params=params, a=a, b=b, global_shape=GLOBAL,
                           rows=rows[band], **ops)
    r0, r1 = rows[band]
    # the rows outside the band are not written
    assert not out[:h + r0].any() and not out[h + r1:].any()
    jv, ju = _jax_layout(V, h, shape), _jax_layout(U, h, shape)
    # the JAX band's input rows, its operands concatenated on, and its
    # offsets shifted so that its first input row has the right global y
    # (fused2d_sharded.py:320-348)
    (r_in0, r_in1), shift = {
        "bottom": ((0, 3 * h), 0), "interior": ((h, h + ly), h),
        "top": ((ly - h, ly + 2 * h), ly - h)}[band]
    offs = jnp.asarray((offsets[0] + shift, offsets[1]), jnp.int32)
    args = [jnp.asarray([DT], jnp.float32), offs,
            jnp.asarray(jv[r_in0:r_in1])]
    if stage > 0:
        args.append(jnp.asarray(ju[r_in0:r_in1]))
    want = np.asarray(_jax_band(family, stage, shape, band)(*args))
    _close(out.numpy()[h + r0:h + r1, h:h + lx], want[:, h:h + lx])


@pytest.mark.parametrize("family", ["diffusion", "burgers-js"])
def test_k8b_band_contract(family):
    """K8b takes only the split schedule's three bands, each with its own
    operand, and a shard of at least 3h rows (the JAX kernel asserts
    its band contract, ``fused2d_sharded.py:221``)."""
    params, _, h = _family(family)
    ly, lx = 10, 32
    v = torch.zeros((ly + 2 * h, lx + 2 * h))
    slab = torch.zeros((h, lx + 2 * h))
    kw = dict(params=params, a=0.0, b=1.0, global_shape=GLOBAL)
    for rows, ops in (((0, h), {}), ((0, h), {"hi": slab}),
                      ((h, ly - h), {"lo": slab}), ((1, ly - h), {}),
                      ((ly - h, ly), {"lo": slab, "hi": slab})):
        with pytest.raises(ValueError, match="not a band"):
            pfs.fused2d_band_stage(v, None, torch.zeros_like(v), DT, (0, 0),
                                   rows=rows, **ops, **kw)
    thin = torch.zeros((3 * h - 1 + 2 * h, lx + 2 * h))
    with pytest.raises(ValueError, match="split schedule's bands"):
        pfs.fused2d_band_stage(thin, None, torch.zeros_like(thin), DT,
                               (0, 0), rows=(h, 2 * h - 1), **kw)
    with pytest.raises(ValueError, match="does not fit"):
        pfs.fused2d_stage(v, None, torch.zeros_like(v), DT, (35, 0), **kw)


def test_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers run their twins and count nothing."""
    params, _, h = _family("burgers-js")
    v = torch.rand((10 + 2 * h, 32 + 2 * h))
    pfs.fused2d_stage.launches = pfs.fused2d_band_stage.launches = 0
    mx = torch.zeros(())
    pfs.fused2d_stage(v, None, torch.zeros_like(v), DT, (0, 0),
                      params=params, a=0.0, b=1.0, global_shape=GLOBAL,
                      mx=mx)
    assert float(mx) > 0
    assert pfs.fused2d_stage.launches == pfs.fused2d_band_stage.launches == 0


def test_weno7_raises_item_2():
    """WENO7 runs on K8's order-7 instance: the stepper pads the shard by
    the reach 4, and the solver on ``{"dy": 2}`` engages it and equals
    the unsharded K7 run to the bit."""
    st = pfs.ShardedFusedBurgers2DStepper(
        (10, 32), SPACING, pflux.get("burgers"), "js", 0.0, 0.4, "cpu",
        global_shape=GLOBAL, order=7)
    assert (st.halo, st.padded_shape, st.params.order) == (4, (18, 40), 7)
    mesh = pmesh.make_mesh({"dy": 2}, devices=[torch.device("cpu")] * 2,
                           timeout=60.0)
    cfg = PBConfig(grid=PGrid.make(32, 40, lengths=2.0), impl="pallas",
                   weno_order=7)
    sharded, one = PBSolver(cfg, mesh=mesh), PBSolver(cfg, device="cpu")
    assert sharded.engaged_path()["stepper"] == "fused-stage"
    got = sharded.run(sharded.initial_state(), 2)
    want = one.run(one.initial_state(), 2)
    assert torch.equal(got.u.assemble(), want.u) and got.t == want.t
    # the generic rung runs WENO7 on the mesh
    PBSolver(PBConfig(grid=cfg.grid, weno_order=7), mesh=mesh)
