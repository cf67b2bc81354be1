"""K7's 2-D Burgers whole-run schedule (``csrc/whole_run_burgers2d.cu``)
emulated on the CPU with plain PyTorch, held to the bit against the plain
twin (``whole_run.plain_run`` / ``plain_run_adaptive`` of
``fused_burgers2d.stage_reference``).

The emulation runs the kernel's schedule, not its arithmetic: the grid
cut into the planner's tiles, a job each; each job's window (the tile and
9 cells a side, clipped to 3 cells past the grid, the cells outside the
grid holding replicas of the edge cell they clamp to); stage 1 on the
tile and 6 cells a side, stage 2 on 3, stage 3 on the tile, each clipped
to the grid, with the cells a stage writes on a grid edge writing their
ghosts; only the state crossing jobs, through two buffers by step parity;
resident jobs (one block each) keeping their window for the run,
publishing the 9 cells of each tile edge and reloading only their halo,
and other jobs reloading their window and writing their tile every step;
an odd run's result copied back; and in adaptive mode the maximum wave
speed taken over each tile and folded across tiles. The WENO7-JS
instance runs the same schedule at reach 4 (a 12-cell window halo,
stages on 8 and 4 cells a side), on tilings whose sides span 12 cells. Each stage's cells
are computed by the twin's own stage arithmetic (``fused_burgers.
_stage_rk``) on the window, so any cell the schedule failed to bring into
a window, a halo too shallow or a ghost holding the wrong stage's value
changes the result. Planes and the second buffer start as NaN, so a read
of a cell nobody wrote poisons the run. Tolerance: 0 ulp and an equal
time advance, as the kernel must be on the card.
"""

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as fb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers2d as fb2,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import whole_run as wr
from multigpu_advectiondiffusion_tpu_torch.timestepping import cfl as pcfl

torch.set_num_threads(1)

R, HALO = fb2.R, fb2.HALO
# An H100 SXM's numbers as K7's C entry reads them (card_limits)
H100 = dict(sms=132, blocks_per_sm=1, smem_block=232_448, smem_sm=233_472,
            smem_reserved=1024)

K7_CASES = {
    "js-burgers-viscous": ("burgers", {}, "js", 1e-5),
    "z-burgers-inviscid": ("burgers", {}, "z", 0.0),
    "js-linear": ("linear", {"c": -0.7}, "js", 1e-5),
    "z-buckley": ("buckley", {}, "z", 1e-5),
}
SHAPE, SPACING, CFL = (23, 37), (0.05, 0.07), 0.4


def _job(j, ny, nx, my, mx, r=R):
    """Job j's tile and window, as the source's job_of at reach r."""
    jy, jx = divmod(j, mx)
    y0, y1 = jy * ny // my, (jy + 1) * ny // my
    x0, x1 = jx * nx // mx, (jx + 1) * nx // mx
    h = 3 * r
    return dict(y0=y0, y1=y1, x0=x0, x1=x1,
                wy0=max(y0 - h, -r), wy1=min(y1 + h, ny + r),
                wx0=max(x0 - h, -r), wx1=min(x1 + h, nx + r))


def _window_of(src, J, ny, nx):
    """``src`` on J's window, every cell at its index clamped into the
    grid (what a load brings in)."""
    rows = torch.arange(J["wy0"], J["wy1"]).clamp(0, ny - 1)
    cols = torch.arange(J["wx0"], J["wx1"]).clamp(0, nx - 1)
    return src.index_select(0, rows).index_select(1, cols)


def _tile_mask(J):
    h, w = J["wy1"] - J["wy0"], J["wx1"] - J["wx0"]
    mask = torch.zeros((h, w), dtype=torch.bool)
    mask[J["y0"] - J["wy0"]:J["y1"] - J["wy0"],
         J["x0"] - J["wx0"]:J["x1"] - J["wx0"]] = True
    return mask


def _write_ghosts(out, J, region, ny, nx):
    """The ghosts of J's window whose clamped cell lies in ``region``
    (rows ya..yb, columns xa..xb) take that cell's value, as the cells a
    stage writes on a grid edge write them."""
    ya, yb, xa, xb = region
    rows = torch.arange(J["wy0"], J["wy1"])
    cols = torch.arange(J["wx0"], J["wx1"])
    rc, cc = rows.clamp(0, ny - 1), cols.clamp(0, nx - 1)
    outside = (rows != rc)[:, None] | (cols != cc)[None, :]
    inside = ((rc >= ya) & (rc < yb))[:, None] & ((cc >= xa) & (cc < xb))[
        None, :]
    src = out.index_select(0, rc - J["wy0"]).index_select(1, cc - J["wx0"])
    return torch.where(outside & inside, src, out)


def _stage(J, st, v, s, dt, params, ny, nx):
    """Stage ``st`` of job J on its evaluated region from the v plane
    ``v`` (u: the S plane ``s``); returns the output plane (stage 3: the
    S plane with the tile replaced) and the region's values."""
    r = params.r
    e = r * (3 - st)
    ya, yb = max(J["y0"] - e, 0), min(J["y1"] + e, ny)
    xa, xb = max(J["x0"] - e, 0), min(J["x1"] + e, nx)
    oy, ox = ya - J["wy0"], xa - J["wx0"]
    h, w = yb - ya, xb - xa
    vp = v[oy - r:oy + h + r, ox - r:ox + w + r]
    a, b = wr.STAGES[st - 1]
    u = None if st == 1 else s[oy:oy + h, ox:ox + w]
    rk = fb._stage_rk(vp, v[oy:oy + h, ox:ox + w], u, dt, params, a, b)
    out = (torch.full_like(v, float("nan")) if st < 3 else s.clone())
    out[oy:oy + h, ox:ox + w] = rk
    if st < 3:
        out = _write_ghosts(out, J, (ya, yb, xa, xb), ny, nx)
    return out, rk


def emulate(S0, params, steps, tiles, blocks, dt=None):
    """K7's schedule on the CPU (see the module's note); ``dt`` None:
    adaptive, returns ``(S, t_sum)``."""
    ny, nx = S0.shape
    my, mx = tiles
    halo = 3 * params.r
    jobs = [_job(j, ny, nx, my, mx, params.r) for j in range(my * mx)]
    resident = len(jobs) <= blocks
    buf = [S0.clone(), torch.full_like(S0, float("nan"))]  # S, T1
    planes = [None] * len(jobs)  # a resident job's S plane
    df = params.flux.df

    def wave_speed(tiles_of):
        return torch.amax(torch.stack(
            [pcfl.max_wave_speed(t, df) for t in tiles_of]))

    adaptive = dt is None
    if adaptive:
        t_sum = torch.zeros((), dtype=torch.float32)
        m = wave_speed([S0[J["y0"]:J["y1"], J["x0"]:J["x1"]] for J in jobs])
    for k in range(steps):
        src, dst = buf[k & 1], buf[1 - (k & 1)]
        if adaptive:
            dt = pcfl.dt_from_wave_speed(m, SPACING, CFL)
            t_sum = t_sum + dt
        maxima = []
        for j, J in enumerate(jobs):
            win = _window_of(src, J, ny, nx)
            if resident and k > 0:  # the tile kept, the halo reloaded
                s = torch.where(_tile_mask(J), planes[j], win)
            else:
                s = win
            t1, _ = _stage(J, 1, s, s, dt, params, ny, nx)
            t2, _ = _stage(J, 2, t1, s, dt, params, ny, nx)
            s, rk = _stage(J, 3, t2, s, dt, params, ny, nx)
            y0, y1, x0, x1 = J["y0"], J["y1"], J["x0"], J["x1"]
            if resident:  # publish the edges neighbours read
                planes[j] = s
                keep = torch.ones_like(rk, dtype=torch.bool)
                keep[halo:-halo, halo:-halo] = False
                dst[y0:y1, x0:x1] = torch.where(keep, rk, dst[y0:y1, x0:x1])
            else:
                dst[y0:y1, x0:x1] = rk
            maxima.append(rk)
        if adaptive:
            m = wave_speed(maxima)
    S = buf[0]
    for j, J in enumerate(jobs):
        y0, y1, x0, x1 = J["y0"], J["y1"], J["x0"], J["x1"]
        if resident:
            S[y0:y1, x0:x1] = planes[j][y0 - J["wy0"]:y1 - J["wy0"],
                                        x0 - J["wx0"]:x1 - J["wx0"]]
        elif steps & 1:
            S[y0:y1, x0:x1] = buf[1][y0:y1, x0:x1]
    return S if not adaptive else (S, t_sum)


def _tilings():
    planned = fb2.burgers2d_schedule(*SHAPE, **H100)
    return {  # name -> (shape, tiles, blocks, steps)
        "planned": (SHAPE, planned["tiles"], planned["blocks"], 3),
        "one-tile": (SHAPE, (1, 1), 1, 2),
        "one-row": (SHAPE, (1, 4), 4, 3),
        "one-column": (SHAPE, (2, 1), 2, 2),
        "more-jobs-than-blocks": (SHAPE, (2, 3), 2, 3),
        # tiles of 20x22: cells more than 9 from every edge stay unpublished
        "wide-tiles": ((40, 45), (2, 2), 4, 2),
    }


TILINGS = list(_tilings())


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("adaptive", [False, True], ids=["K7", "K7a"])
@pytest.mark.parametrize("case", list(K7_CASES))
def test_tiled_schedule_equals_twin(case, adaptive, tiling):
    name, kw, variant, nu = K7_CASES[case]
    shape, tiles, blocks, steps = _tilings()[tiling]
    params = fb.stage_params(pflux.get(name, **kw), variant, SPACING, nu)
    S0 = torch.from_numpy(np.random.default_rng(steps).uniform(
        -0.2, 1.0, shape).astype(np.float32))

    def stage(v, u, out, dt, a, b):
        return fb2.stage_reference(v, u, out, dt, params=params, a=a, b=b)

    T = [torch.empty_like(S0) for _ in range(2)]
    if adaptive:
        got, t_got = emulate(S0, params, steps, tiles, blocks)
        want, t_want = wr.plain_run_adaptive(
            stage, lambda u: pcfl.advective_dt(u, params.flux.df, SPACING,
                                               CFL),
            S0.clone(), *T, steps)
        assert float(t_got) == float(t_want)
    else:
        dt = CFL * min(SPACING)
        got = emulate(S0, params, steps, tiles, blocks, dt=dt)
        want = wr.plain_run(stage, S0.clone(), *T, steps, dt)
    assert torch.equal(got, want)


def test_tilings_cover_the_schedule():
    """The tilings above: the planned one resident on more than one tile,
    one with more jobs than blocks, one with tiles wider than two halos
    (cells no neighbour reads), both step parities."""
    t = _tilings()
    planned = fb2.burgers2d_schedule(*SHAPE, **H100)
    assert planned["resident"] and planned["jobs"] > 1
    assert t["more-jobs-than-blocks"][2] < 6
    assert min(t["wide-tiles"][0]) // 2 > 2 * HALO
    assert {s for *_, s in t.values()} == {2, 3}


# WENO7-JS (reach 4): tilings of sides of 12 cells or more
SHAPE7 = (25, 37)


def _tilings7():
    planned = fb2.burgers2d_schedule(*SHAPE7, **H100, order=7)
    return {  # name -> (shape, tiles, blocks, steps)
        "planned": (SHAPE7, planned["tiles"], planned["blocks"], 3),
        "one-tile": (SHAPE7, (1, 1), 1, 2),
        "one-row": (SHAPE7, (1, 3), 3, 3),
        "one-column": (SHAPE7, (2, 1), 2, 2),
        "more-jobs-than-blocks": (SHAPE7, (2, 3), 2, 3),
        # tiles of 26x27: cells more than 12 from every edge unpublished
        "wide-tiles": ((52, 55), (2, 2), 4, 2),
    }


@pytest.mark.parametrize("tiling", list(_tilings7()))
@pytest.mark.parametrize("adaptive", [False, True], ids=["K7", "K7a"])
@pytest.mark.parametrize("case", ["burgers-viscous", "buckley"])
def test_tiled_schedule_equals_twin_order7(case, adaptive, tiling):
    name, nu = {"burgers-viscous": ("burgers", 1e-5),
                "buckley": ("buckley", 0.0)}[case]
    shape, tiles, blocks, steps = _tilings7()[tiling]
    for m, n in zip(tiles, shape):
        assert fb2._allowed(n, m, order=7)
    params = fb.stage_params(pflux.get(name), "js", SPACING, nu, order=7)
    S0 = torch.from_numpy(np.random.default_rng(steps).uniform(
        -0.2, 1.0, shape).astype(np.float32))

    def stage(v, u, out, dt, a, b):
        return fb2.stage_reference(v, u, out, dt, params=params, a=a, b=b)

    T = [torch.empty_like(S0) for _ in range(2)]
    if adaptive:
        got, t_got = emulate(S0, params, steps, tiles, blocks)
        want, t_want = wr.plain_run_adaptive(
            stage, lambda u: pcfl.advective_dt(u, params.flux.df, SPACING,
                                               CFL),
            S0.clone(), *T, steps)
        assert float(t_got) == float(t_want)
    else:
        got = emulate(S0, params, steps, tiles, blocks,
                      dt=CFL * min(SPACING))
        want = wr.plain_run(stage, S0.clone(), *T, steps,
                            CFL * min(SPACING))
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())


def test_order7_tilings_cover_the_schedule():
    t = _tilings7()
    planned = fb2.burgers2d_schedule(*SHAPE7, **H100, order=7)
    assert planned["resident"] and planned["jobs"] > 1
    assert planned["window"] == tuple(
        min(-(-n // m) + 24, n + 8) for n, m in zip(SHAPE7,
                                                   planned["tiles"]))
    assert min(t["wide-tiles"][0]) // 2 > 2 * fb2.halo_of(7)
    assert {s for *_, s in t.values()} == {2, 3}
