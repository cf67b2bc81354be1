"""Fused SSP-RK3 Burgers/WENO stepping (JAX
``ops/pallas/fused_burgers.py`` counterpart: WENO5-JS/Z and WENO7-JS on
one device and on the shards of every mesh layout).

Each RK stage is ONE kernel launch (K5, ``csrc/fused_burgers_stage.cu``):
the Lax–Friedrichs split, the WENO flux divergence along z, y and x,
the optional viscous O4 Laplacian and the RK combination, with the
final stage of an adaptive run also emitting ``max|f'(u_next)|``. A
block owns a ``TILE`` (y, x) tile and marches z: each plane's tile and
its split go through shared memory, each y and x face is computed once
there, each z face once in a thread's register window
(:func:`ops_issued` counts what a launch issues).

* The state is kept **unpadded**, ``(nz, ny, nx)`` float32. Edge
  boundaries are replicated ghosts, so the kernel clamps every
  neighbour index into the grid instead of keeping ghost cells: there
  is no ghost to maintain, and ``embed``/``extract`` are a copy and a
  view. (The TPU layout's (8, 128) tiles, y margins, x-ghost synthesis
  and edge-block ghost writes have no purpose on a GPU and are gone.)
* Three buffers per step, no allocation: ``T1 = s1(S)``,
  ``T2 = s2(T1, S)``, ``S = s3(T2, S)`` in place.
* ``dt`` is a 0-d float32 tensor on the device that the kernel reads
  through a pointer, and the emitted maximum lands in a 0-d float32
  tensor on the device, so an adaptive run needs no host round trip a
  step (``stepper_base``'s device-scalar mode).
* :func:`fused_burgers_stage` launches K5 for a CUDA tensor and raises
  if it cannot; for a CPU tensor — and only then — it runs
  :func:`stage_reference`, the plain PyTorch twin with the kernel's
  layout, operation order and roundings: the e-form reconstruction
  (``ops/weno._weno5_side_nd_e``, at order 7 ``_weno7_side_nd_e``),
  ``num * reciprocal(den)``, terms z, y, x. K5 is built with
  ``-fmad=false``, so on the card kernel and twin round alike.
* The order (``StageParams.order``) sets the reach ``r = HALO[order]``:
  3 for WENO5, 4 for WENO7-JS; a shard keeps ``r`` ghosts a side on
  each axis its mesh cuts, at either order: z planes on a z slab, y
  rows and/or x columns on y/x slabs, pencils and blocks (K5's YX
  instance, the JAX stepper's ``y_sharded``/``x_sharded`` layouts
  without their (8, 128) tiling: no y margin, no rounded x lanes).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types
from typing import Optional, Sequence

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    _check,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.stepper_base import (
    FusedStepperBase,
)
from multigpu_advectiondiffusion_tpu_torch.ops.weno import (
    HALO,
    _weno5_side_nd_e,
    _weno7_side_nd_e,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import wait_exchange
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import (
    dt_from_wave_speed,
    max_wave_speed,
)

R = HALO[5]  # WENO5 stencil radius; the WENO7 instance's is HALO[7] = 4
O4_COEFFS = (-1.0, 16.0, -30.0, 16.0, -1.0)  # / (12 dx^2), Laplace3d.m:22-25

# SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
STAGES = ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))

SOURCE = "fused_burgers_stage.cu"
# fused multiply-adds off: the kernel rounds every product and sum as
# the twin does, so the two agree to the bit
NVCC_EXTRA = ("-fmad=false", "-prec-div=true", "-ftz=false")
# z planes a block marches (each chunk reloads its threads' z windows and
# recomputes one z face). 64 was the fastest of 32, 64 and 128 alone at
# 512^3 and 400x400x406, by 0.6 % over 32 (PERF.md). A launch with fewer
# tiles than BLOCKS_PER_SM blocks an SM (four waves of the two an SM
# holds) marches shorter chunks, down to MIN_ZCHUNK planes
# (stage_zchunk), so small grids fill the card: at 64 planes a 64^3
# launch has 10 blocks for 132 SMs.
Z_CHUNK = 64
MIN_ZCHUNK = 4
BLOCKS_PER_SM = 8
# (rows, columns) of a block's output tile: TY and TX of the source
TILE = (14, 32)
# planes of the split schedule's bottom and top calls (the JAX stepper's
# z block at its usual shapes, so both split the same shards)
SPLIT_BZ = 8
FLUX_CODES = {"burgers": 0, "linear": 1, "buckley": 2}


@dataclasses.dataclass(frozen=True)
class StageParams:
    """What one configuration's stages share: the flux, the WENO variant,
    ``1/dx`` per axis and the viscous taps ``c_j nu/(12 dx^2)`` (array
    axis order, z, y, x in 3-D; ``None`` when inviscid), all rounded once
    to float32 as the TPU kernels round them, and the WENO order (5, or
    7 with the ``"js"`` variant)."""

    flux: Flux
    variant: str
    inv_dx: tuple
    lap_taps: Optional[tuple]
    order: int = 5

    @property
    def r(self) -> int:
        """The reach of the order's reconstruction (its halo)."""
        return HALO[self.order]


def stage_params(flux: Flux, variant: str, spacing: Sequence[float],
                 nu: float, order: int = 5) -> StageParams:
    if flux.name not in FLUX_CODES:
        raise ValueError(f"no stage kernel for flux {flux.name!r}")
    if order not in HALO:
        raise ValueError(f"unsupported WENO order {order}; use 5 or 7")
    if variant not in ("js", "z"):
        raise ValueError(f"unknown WENO5 variant {variant!r}; use 'js' or 'z'")
    if order == 7 and variant != "js":
        raise ValueError("WENO7 supports only the 'js' variant")
    ndim = len(spacing)
    inv_dx = tuple(float(np.float32(1.0 / spacing[i])) for i in range(ndim))
    taps = None
    if nu:
        taps = []
        for i in range(ndim):
            scale = float(nu) / (12.0 * spacing[i] * spacing[i])
            taps += [float(np.float32(c * scale)) for c in O4_COEFFS]
        taps = tuple(taps)
    return StageParams(flux, variant, inv_dx, taps, int(order))


# --------------------------------------------------------------------- #
# The plain PyTorch twin
# --------------------------------------------------------------------- #
def _edge_pad(v: torch.Tensor, r: int) -> torch.Tensor:
    """``v`` with ``r`` replicated ghosts on every side (clamped gather,
    the kernel's neighbour indexing)."""
    for axis, n in enumerate(v.shape):
        idx = torch.arange(-r, n + r, device=v.device).clamp_(0, n - 1)
        v = v.index_select(axis, idx)
    return v


def _split(flux: Flux, v):
    """Local Lax–Friedrichs splitting ``f± = (f(v) ± |f'(v)| v)/2``
    (``WENO5resAdv_X.m:58-60``); for the Burgers flux the identity
    ``f± = t (t ± |v|)`` with ``t = v/2``."""
    if flux.name == "burgers":
        t = 0.5 * v
        a = torch.abs(v)
        return t * (t + a), t * (t - a)
    a = torch.abs(flux.df(v))
    fu = flux.f(v)
    return 0.5 * (fu + a * v), 0.5 * (fu - a * v)


def _divergence(P, M, axis: int, n: int, inv_dx: float, variant: str,
                order: int = 5):
    """``(h[i+1/2] - h[i-1/2]) * (1/dx)`` along ``axis`` of the split
    fluxes ``P``/``M`` (padded by ``r = HALO[order]`` on ``axis`` only).
    Face ``f`` sits right of cell ``f-1``: its minus window is P at cells
    ``f-r..f+r-2``, its plus window M at cells ``f-r+1..f+r-1``."""
    r = HALO[order]
    p = [P.narrow(axis, j, n + 1) for j in range(2 * r - 1)]
    m = [M.narrow(axis, j + 1, n + 1) for j in range(2 * r - 1)]
    if order == 7:
        nm, dm = _weno7_side_nd_e(*(p[j + 1] - p[j] for j in range(6)),
                                  "minus")
        np_, dp = _weno7_side_nd_e(*(m[j + 1] - m[j] for j in range(6)),
                                   "plus")
    else:
        nm, dm = _weno5_side_nd_e(*(p[j + 1] - p[j] for j in range(4)),
                                  variant, "minus")
        np_, dp = _weno5_side_nd_e(*(m[j + 1] - m[j] for j in range(4)),
                                   variant, "plus")
    h = (p[r - 1] + m[r - 1]) + (nm * torch.reciprocal(dm)
                                 + np_ * torch.reciprocal(dp))
    del p, m, nm, dm, np_, dp
    return (h.narrow(axis, 1, n) - h.narrow(axis, 0, n)) * inv_dx


def stage_reference(v, u, out, dt, *, params: StageParams, a: float,
                    b: float, emit: bool = False, zpad: int = 0,
                    global_nz: int | None = None, oz: int = 0,
                    window=None, lo=None, hi=None, ypad: int = 0,
                    global_ny: int | None = None, oy: int = 0,
                    xpad: int = 0, global_nx: int | None = None,
                    ox: int = 0):
    """Plain PyTorch twin of K5 on the same layout, in any dimension (the
    2-D whole-run kernel K7 runs this stage with one axis fewer).

    Writes ``out`` (which may be ``u``) and returns it, or
    ``(out, max|f'(out)|)`` over the core cells written when ``emit``.
    Operation order and roundings are the kernel's: ``rhs = -((div_z +
    div_y) + div_x) [+ lap]`` (``-(div_y + div_x)`` in 2-D), ``rk =
    b*(v + dt*rhs)`` and ``a*u + rk``; the reach ``r`` is ``params.r``.
    A shard passes, for each axis it stores ghosts on, the pad ``r``
    (``zpad``, and in 3-D ``ypad``/``xpad``), the global extent and its
    global offset: a neighbour on that axis is clamped at the global
    edges only, and reads the stored ghosts inside the domain.
    ``window = (k_begin, k_end)`` writes those block planes only, and
    ``lo``/``hi`` replace the z ghost planes below/above (the split
    schedule's roles).
    """
    if (ypad or xpad) and v.dim() != 3:
        raise ValueError("ypad/xpad are the 3-D layout's")
    pads = (zpad, ypad, xpad)[:v.dim()]
    core = [v.shape[ax] - 2 * pads[ax] for ax in range(v.dim())]
    k0, k1 = window if window is not None else (0, core[0])
    r = params.r
    if not any(pads) and window is None:
        vp = _edge_pad(v, r)
        dst = out
    else:
        if lo is not None or hi is not None:
            v = v.clone()
            if lo is not None:
                v[:zpad] = lo
            if hi is not None:
                v[core[0] + zpad:] = hi
        extents = (global_nz, global_ny, global_nx)
        offsets = (oz, oy, ox)
        spans = [(k0, k1)] + [(0, n) for n in core[1:]]
        vp, box = v, []
        for ax, (lo_k, hi_k) in enumerate(spans):
            gn = core[ax] if extents[ax] is None else extents[ax]
            g = torch.arange(offsets[ax] + lo_k - r, offsets[ax] + hi_k + r,
                             device=v.device)
            idx = g.clamp_(0, gn - 1) - offsets[ax] + pads[ax]
            vp = vp.index_select(ax, idx)
            box.append(slice(pads[ax] + lo_k, pads[ax] + hi_k))
        box = tuple(box)
        v = v[box]
        if u is not None:
            u = u[box]
        dst = out[box]
    rk = _stage_rk(vp, v, u, dt, params, a, b)
    dst.copy_(rk)
    if emit:
        return out, max_wave_speed(dst, params.flux.df)
    return out


def _edge_pad_trailing(v: torch.Tensor, r: int) -> torch.Tensor:
    """``v`` with ``r`` replicated ghosts on every side of every axis but
    the first."""
    for axis in range(1, v.dim()):
        n = v.shape[axis]
        idx = torch.arange(-r, n + r, device=v.device).clamp_(0, n - 1)
        v = v.index_select(axis, idx)
    return v


def _stage_rk(vp, v, u, dt, params: StageParams, a: float, b: float):
    """The stage's ``rk`` on the cells of ``v`` from ``vp``, ``v`` padded
    by ``params.r`` on every side (ghosts or clamped copies)."""
    n = tuple(v.shape)
    r = params.r
    dt = torch.as_tensor(dt, dtype=torch.float32, device=v.device)
    P, M = _split(params.flux, vp)
    core = [slice(r, r + m) for m in n]
    rhs = None
    for axis in range(len(n)):
        idx = list(core)
        idx[axis] = slice(None)
        div = _divergence(P[tuple(idx)], M[tuple(idx)], axis, n[axis],
                          params.inv_dx[axis], params.variant, params.order)
        rhs = div if rhs is None else rhs + div
        del div
    del P, M
    rhs = -rhs
    if params.lap_taps is not None:
        acc = None
        for axis in range(len(n)):
            for j in range(5):
                idx = list(core)
                idx[axis] = slice(r - 2 + j, r - 2 + j + n[axis])
                term = vp[tuple(idx)] * params.lap_taps[5 * axis + j]
                acc = term if acc is None else acc + term
        rhs = rhs + acc
        del acc
    rk = b * (v + dt * rhs)
    if u is not None:
        rk = a * u + rk
    return rk


# --------------------------------------------------------------------- #
# The kernel
# --------------------------------------------------------------------- #
# f32 operations the kernel issues (csrc/fused_burgers_stage.cu's note),
# Burgers flux: the split of a value, a run of three faces and one face
# alone by WENO5 variant (RUN_OPS7 and FACE_OPS7: WENO7-JS), and a
# cell's divergences, their sum and negation, the Laplacian and the
# combine
SPLIT_OPS = 6
RUN_OPS = {"js": 305, "z": 335}
FACE_OPS = {"js": 119, "z": 129}
RUN_OPS7 = 661
FACE_OPS7 = 227


def run_ops(variant: str, order: int = 5) -> int:
    """f32 operations of a run of three faces (Burgers flux)."""
    return RUN_OPS7 if order == 7 else RUN_OPS[variant]


def face_ops(variant: str, order: int = 5) -> int:
    """f32 operations of one face computed alone (Burgers flux)."""
    return FACE_OPS7 if order == 7 else FACE_OPS[variant]


def tile_geometry(order: int = 5) -> dict:
    """A block's threads, its tile plane with the halo of the order's
    reach, the halo cells it loads a plane, its runs of three x and y
    faces a plane and its static shared memory (bytes): two buffers of v,
    f+ and f- on the tile plane, the x and y faces and a word a warp."""
    ty, tx = TILE
    r = HALO[order]
    threads = ty * tx
    plane = (ty + 2 * r) * (tx + 2 * r)
    runs = (ty * (tx + 1) + tx * (ty + 1)) // 3
    smem = 4 * (2 * 3 * plane + ty * (tx + 1) + (ty + 1) * tx
                + threads // 32)
    return {"threads": threads, "plane": plane, "halo": plane - threads,
            "runs": runs, "smem_bytes": smem}


def ops_issued(shape, zchunk: int = Z_CHUNK, *, has_u: bool, viscous: bool,
               variant: str, order: int = 5) -> int:
    """f32 operations one K5 launch issues over an ``(nz, ny, nx)`` core
    (the unsharded state, or the planes a shard's launch writes of its
    core: every sharded instance issues the unsharded one's operations
    on the same core, its integer indexing aside) with the Burgers
    flux: for every block of the grid
    (tiles a plane times z chunks), each thread splits 2r + 1 + p values
    and computes 1 + p z faces and p cells on a chunk of p planes, and
    the block splits its halo and computes its runs of faces on each
    plane. Threads outside the grid do the same work and write
    nothing."""
    nz, ny, nx = shape
    geo = tile_geometry(order)
    window = 2 * HALO[order] + 1
    blocks = -(-ny // TILE[0]) * -(-nx // TILE[1])
    cell = 6 + 3 + (30 if viscous else 0) + (5 if has_u else 3)
    total = 0
    for k in range(0, nz, zchunk):
        p = min(zchunk, nz - k)
        thread = ((window + p) * SPLIT_OPS + (1 + p) * face_ops(variant, order)
                  + p * cell)
        block = p * (geo["halo"] * SPLIT_OPS
                     + geo["runs"] * run_ops(variant, order))
        total += geo["threads"] * thread + block
    return blocks * total


def stage_zchunk(planes: int, ny: int, nx: int, sms: int) -> int:
    """The z planes a block marches when the caller gives none:
    ``Z_CHUNK``, or as few as it takes (not below ``MIN_ZCHUNK``) for a
    launch over ``planes`` planes of ``(ny, nx)`` tiles to have
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs."""
    tiles = -(-ny // TILE[0]) * -(-nx // TILE[1])
    chunks = -(-BLOCKS_PER_SM * sms // tiles)
    return max(MIN_ZCHUNK, min(Z_CHUNK, -(-planes // chunks)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def geometry(order: int = 5, yx: bool = False) -> dict:
    """The built kernel's tiling, as its library reports it: tile rows and
    columns, threads a block, static shared memory bytes, the blocks an
    SM can hold, registers and spilled bytes a thread (the unsharded
    WENO``order``-JS Burgers instance, or with ``yx`` the instance of a
    y- or x-cut shard). Needs the card."""
    out = (ctypes.c_int * 7)()
    rc = library().fused_burgers_stage_geometry(int(order), int(yx), out)
    if rc != 0:
        raise RuntimeError(f"fused_burgers_stage_geometry: CUDA error {rc}")
    keys = ("tile_y", "tile_x", "threads", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes")
    return dict(zip(keys, out))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built stage kernel (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE, NVCC_EXTRA).path))
    fn = lib.fused_burgers_stage
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, i, i, i, p, i, f, i, i, p, p, f, f, p, i, p, i,
                   i, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.fused_burgers_stage_geometry.argtypes = [i, i, p]
    lib.fused_burgers_stage_geometry.restype = ctypes.c_int
    return lib


def fused_burgers_stage(v, u, out, dt, mx=None, *, params: StageParams,
                        a: float, b: float, zchunk: int | None = None,
                        zpad: int = 0, global_nz: int | None = None,
                        oz: int = 0, window=None, lo=None, hi=None,
                        mx_init: bool = True, ypad: int = 0,
                        global_ny: int | None = None, oy: int = 0,
                        xpad: int = 0, global_nx: int | None = None,
                        ox: int = 0):
    """One fused RK stage: ``out <- stage(v, u)``.

    ``u`` is ``None`` for the first stage and may be ``out`` (in-place
    final stage); ``v`` must not be ``out``. ``dt`` is a float32 tensor
    of one element on ``v``'s device (a float is accepted for a CPU
    tensor). ``mx``, a float32 tensor of one element, receives
    ``max|f'(out)|`` over the cells written (folded into its value when
    ``mx_init`` is false). A z-slab shard passes its block with
    ``zpad = params.r`` ghost planes a side, the ``global_nz`` and its
    global z offset ``oz``; ``window = (k_begin, k_end)`` writes those
    block planes
    only, and ``lo``/``hi`` (``(zpad, ny, nx)``, the stored plane)
    replace the ghost planes below/above (the split schedule's edge
    calls). A shard of a mesh that cuts y and/or x passes for each cut
    axis ``ypad``/``xpad = params.r`` stored ghosts a side, the global
    extent and its global offset (K5's YX instance; z is then cut, with
    ``zpad``, or whole). Launches K5 on the
    current stream (no synchronisation), each block marching ``zchunk``
    z planes (:func:`stage_zchunk`'s plan when ``None``), and counts the
    launch in ``fused_burgers_stage.launches``; a CPU tensor runs
    :func:`stage_reference`. Both orders (``params.order``) take every
    form: whole block, ghost planes, a window and operands.
    """
    for name, t in (("v", v), ("u", u), ("out", out)):
        if t is not None:
            _check(name, t, v.shape, v.device)
    if v.dim() != 3:
        raise ValueError(f"3-D state expected, got {tuple(v.shape)}")
    if v.data_ptr() == out.data_ptr():
        raise ValueError("v and out must be different buffers")
    for name, pad in (("zpad", zpad), ("ypad", ypad), ("xpad", xpad)):
        if pad not in (0, params.r):
            raise ValueError(f"{name} must be 0 or {params.r}, got {pad}")
    nz, ny, nx = (v.shape[0] - 2 * zpad, v.shape[1] - 2 * ypad,
                  v.shape[2] - 2 * xpad)
    gnz = nz if global_nz is None else int(global_nz)
    gny = ny if global_ny is None else int(global_ny)
    gnx = nx if global_nx is None else int(global_nx)
    k0, k1 = window if window is not None else (0, nz)
    if not 0 <= k0 < k1 <= nz or not 0 <= oz <= gnz - nz or (
            zpad == 0 and (gnz, oz) != (nz, 0)):
        raise ValueError(f"window {window} / offset {oz} of {gnz} planes "
                         f"do not fit a block of {nz}")
    for name, n, pad, o, gn in (("y", ny, ypad, oy, gny),
                                ("x", nx, xpad, ox, gnx)):
        if n < 1 or not 0 <= o <= gn - n or (pad == 0 and (gn, o) != (n, 0)):
            raise ValueError(f"{name} offset {o} of {gn} does not fit a "
                             f"core of {n} with {pad} ghosts a side")
    for name, t in (("lo", lo), ("hi", hi)):
        if t is not None:
            _check(name, t, (zpad,) + tuple(v.shape[1:]), v.device)
    kw = dict(params=params, a=a, b=b, zpad=zpad, global_nz=gnz, oz=oz,
              window=window, lo=lo, hi=hi, ypad=ypad, global_ny=gny, oy=oy,
              xpad=xpad, global_nx=gnx, ox=ox)
    if v.device.type == "cpu":
        res = stage_reference(v, u, out, dt, emit=mx is not None, **kw)
        if mx is None:
            return res
        m = res[1].reshape(mx.shape)
        mx.copy_(m if mx_init else torch.maximum(mx, m))
        return out
    if v.device.type != "cuda":
        raise ValueError(f"no stage kernel for device {v.device}")
    for name, t in (("dt", dt), ("mx", mx)):
        if name == "mx" and t is None:
            continue  # no maximum asked for
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or t.numel() != 1 or t.device != v.device):
            raise TypeError(f"{name}: a float32 tensor of one element on "
                            f"{v.device} expected")
    inv_dx = np.asarray(params.inv_dx, dtype=np.float32)
    taps = (None if params.lap_taps is None
            else np.asarray(params.lap_taps, dtype=np.float32))
    c = params.flux.c if params.flux.c is not None else 0.0
    zgeo = np.asarray((zpad, gnz, oz, int(mx_init)), dtype=np.int32)
    yxgeo = (np.asarray((ypad, gny, oy, xpad, gnx, ox), dtype=np.int32)
             if ypad or xpad else None)
    if zchunk is None:
        zchunk = stage_zchunk(k1 - k0, ny, nx, _sm_count(v.device.index))
    with torch.cuda.device(v.device):
        rc = library().fused_burgers_stage(
            v.data_ptr(), None if u is None else u.data_ptr(),
            out.data_ptr(), nz, ny, nx, dt.data_ptr(),
            FLUX_CODES[params.flux.name], float(c),
            int(params.variant == "z"), int(params.order), inv_dx.ctypes.data,
            None if taps is None else taps.ctypes.data,
            float(a), float(b), None if mx is None else mx.data_ptr(),
            int(zchunk), zgeo.ctypes.data, int(k0), int(k1),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(),
            None if yxgeo is None else yxgeo.ctypes.data,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_burgers_stage launch failed: CUDA error {rc}")
    build.count_launch(fused_burgers_stage)
    if yxgeo is not None:
        build.count_launch(yx_instance)
    return out


fused_burgers_stage.launches = 0
# the launches of K5's YX instance (a shard with stored y/x ghosts), also
# counted in fused_burgers_stage.launches
yx_instance = types.SimpleNamespace(launches=0)


class FusedBurgersStepper(FusedStepperBase):
    """Fused WENO runner for one (grid, flux, dt mode, WENO order)
    configuration on one device, or on one shard of a mesh of any
    layout: ``dt`` fixes the step
    (CUDA-parity mode), else the CFL step ``float32(cfl min dx) /
    max(m, 1e-12)`` follows the wave speed ``m`` that the last stage of
    each step emits — the max over the shards (``reduce_max``), kept on
    the card.

    ``global_shape`` (when it differs from ``interior_shape``) makes the
    stepper shard-local: the block is stored with ``r`` ghosts a side
    (the reach: 3 at WENO5, 4 at WENO7) on each sharded axis — z when
    its extent is cut, y and x as ``y_sharded``/``x_sharded`` say (the
    JAX stepper's flags, extent-1 mesh axes filtered out by the caller)
    — e.g. ``(lz + 2r, ly + 2r, lx)`` on a z-y pencil, refreshed from the
    neighbours after every stage (``refresh``), and clamped at the global
    edges only; ``core_offsets`` is the core's origin in that layout.
    With ``overlap_split`` (z cut, and ``lz // SPLIT_BZ >= 3``) a stage
    is the split schedule's three launches: the planes ``[SPLIT_BZ, lz -
    SPLIT_BZ)`` while the z slabs are exchanged, then the bottom and top
    ``SPLIT_BZ`` planes from the exchanged slabs (``exch``); the y/x
    ghosts of a pencil or block take the serialized ``refresh``."""

    device_scalars = True
    halo = R  # WENO5's; an order-7 instance sets its own

    def __init__(self, spacing, flux: Flux, variant: str, nu: float,
                 cfl: float, device, dt: float | None = None,
                 interior_shape=None, global_shape=None,
                 overlap_split: bool = False, reduce_max=None,
                 order: int = 5, y_sharded: bool = False,
                 x_sharded: bool = False):
        self.dtype = torch.float32
        self.device = torch.device(device)
        self.params = stage_params(flux, variant, spacing, nu, order)
        self.order = int(order)
        self.halo = HALO[self.order]
        self.spacing = tuple(spacing)
        self.cfl = float(cfl)
        self.adaptive = dt is None
        self.dt = None if dt is None else torch.full(
            (), dt, dtype=torch.float32, device=self.device)
        self.interior_shape = (None if interior_shape is None
                               else tuple(interior_shape))
        self.global_shape = tuple(global_shape or interior_shape or ())
        self.sharded = self.global_shape != (self.interior_shape or ())
        cut = ([g != n for g, n in zip(self.global_shape,
                                       self.interior_shape)]
               if self.sharded else [False] * 3)
        if (bool(y_sharded), bool(x_sharded)) != (cut[1], cut[2]):
            raise ValueError(
                f"y_sharded={y_sharded}, x_sharded={x_sharded} do not match "
                f"a shard of {self.interior_shape} in {self.global_shape}")
        self.y_sharded, self.x_sharded = cut[1], cut[2]
        self.pads = tuple(self.halo if c else 0 for c in cut)
        self.zpad = self.pads[0]
        self.core_offsets = self.pads
        self.exchange_depth = self.halo
        self.reduce_max = reduce_max
        self.overlap_split = bool(
            overlap_split and cut[0]
            and self.interior_shape[0] // SPLIT_BZ >= 3)

    def embed(self, u):
        u = u.to(device=self.device, dtype=self.dtype, copy=True)
        # ghosts start as edge replicas; the refresh (or the exchanged
        # operands) replaces them where the domain goes on
        for ax, pad in enumerate(self.pads):
            if pad:
                n = u.shape[ax]
                idx = torch.arange(-pad, n + pad, device=u.device)
                u = u.index_select(ax, idx.clamp_(0, n - 1))
        return u.contiguous()

    def extract(self, S):
        if not self.sharded:
            return S
        return S[tuple(slice(p, S.shape[ax] - p)
                       for ax, p in enumerate(self.pads))]

    def _buffers(self, u):
        # every plane a stage reads is written first (a stage, or the
        # refresh of the ghost planes)
        S = self.embed(u)
        return S, torch.empty_like(S), torch.empty_like(S)

    def _initial_max(self, u):
        if not self.adaptive:
            return None
        return max_wave_speed(u.to(self.dtype), self.params.flux.df)

    def _dt_of(self, m):
        if not self.adaptive:
            return self.dt
        return dt_from_wave_speed(m, self.spacing, self.cfl,
                                  reduce_max=self.reduce_max)

    def _step(self, S, T1, T2, dt, m, refresh=None, offsets=None,
              exch=None):
        kw = dict(params=self.params)
        if self.sharded:
            zpad, ypad, xpad = self.pads
            kw.update(zpad=zpad, global_nz=self.global_shape[0],
                      oz=offsets[0])
            if ypad:
                kw.update(ypad=ypad, global_ny=self.global_shape[1],
                          oy=offsets[1])
            if xpad:
                kw.update(xpad=xpad, global_nx=self.global_shape[2],
                          ox=offsets[2])
        (a1, b1), (a2, b2), (a3, b3) = STAGES
        stages = ((S, None, T1, a1, b1, None),
                  (T1, S, T2, a2, b2, None),
                  (T2, S, S, a3, b3, m))
        for v, u, out, a, b, mx in stages:
            if self.overlap_split:
                self._split_stage(v, u, out, dt, mx, a, b, exch, kw)
            else:
                fused_burgers_stage(v, u, out, dt, mx, a=a, b=b, **kw)
            if refresh is not None:
                refresh(out)
        return S, T1, T2

    def _split_stage(self, v, u, out, dt, mx, a, b, exch, kw):
        """One stage as the split schedule's three launches; the emitted
        maximum folds the three."""
        lz, bz = self.interior_shape[0], SPLIT_BZ
        lo, hi = exch(v)
        fused_burgers_stage(v, u, out, dt, mx, a=a, b=b,
                            window=(bz, lz - bz), **kw)
        wait_exchange(lo, hi)
        fused_burgers_stage(v, u, out, dt, mx, a=a, b=b, window=(0, bz),
                            lo=lo, mx_init=False, **kw)
        fused_burgers_stage(v, u, out, dt, mx, a=a, b=b,
                            window=(lz - bz, lz), hi=hi, mx_init=False, **kw)
