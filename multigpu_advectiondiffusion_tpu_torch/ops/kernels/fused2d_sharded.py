"""Per-stage fused SSP-RK3 stepping of sharded 2-D grids (JAX
``ops/pallas/fused2d_sharded.py`` counterpart; kernels K8 and K8b,
``csrc/fused2d_sharded.cu``).

The reference runs its 2-D kernels under MPI (``MultiGPU/
Diffusion2d_Baseline/main.c:189-280``, ``MultiGPU/Burgers2d_Baseline/
main.c:186+``). One device runs them as one whole-run launch (K7,
:mod:`whole_run`), whose steps cross the points where a shard's ghosts
must refresh, so under a mesh each RK stage is one launch over the
shard and the caller refreshes the ghosts between stages, as on the TPU:

* the state lives padded by the stencil reach ``h`` on both axes,
  ``(ly + 2h, lx + 2h)`` float32 (``h`` = 2 for the O4 heat equation, 3
  for WENO5, 4 for WENO7-JS, ``HALO[order]``); the ghost rows and
  columns of a sharded axis hold
  neighbour data (``parallel/halo.py``), the rest the wall value
  (diffusion) or edge replicas (Burgers, never read: a neighbour outside
  the global domain is the nearest global edge cell, as K7 clamps);
* global walls and edges are decided from the shard's ``offsets``
  against the global shape, as the TPU kernels decide them from their
  SMEM offsets operand;
* :func:`fused2d_stage` (K8) writes one stage over the whole shard,
  :func:`fused2d_band_stage` (K8b) over the bands of the split schedule:
  the interior rows ``[h, ly - h)``, which read no ghost row, while the
  ghost slabs travel, then the bottom ``[0, h)`` and top ``[ly - h, ly)``
  rows together (:func:`edge_bands`) from the exchanged slabs
  ``lo``/``hi`` (the JAX band calls' 3h-row inputs with the slabs
  concatenated on; the kernel reads the operands in place of the
  buffer's ghost rows, so nothing is concatenated);
* a launch runs tiles of near-equal sides that :func:`plan_tiles` plans
  from the rows, the columns, the reach and the card's SMs; the Burgers
  body computes each split and each face once a tile through shared
  memory. :class:`StagePlan` packs a launch's geometry, parameters and
  tiles once; the steppers build one a stage kind and band on a shard's
  first step and launch through the lean :func:`launch`, while
  :func:`fused2d_stage` and :func:`fused2d_band_stage` check every
  operand and plan each call;
* each stage's arithmetic is K7's, rounded alike (diffusion with
  ``__fmul_rn``/``__fadd_rn``; Burgers built with ``-fmad=false``), so a
  sharded run equals K7's unsharded run to the bit. The plain twins,
  :func:`diffusion_stage_reference` and :func:`burgers_stage_reference`,
  are the JAX bodies ``_diffusion_stage`` (:143) and ``_burgers_stage``
  (:121) with ``_edge_fill_global`` (:102) and ``_global_coords`` (:95)
  in the port's layout and operation order (K1's and K5's twins).

A CUDA tensor launches the kernel or raises; a CPU tensor, and only a
CPU tensor, runs the twin. The JAX steppers' VMEM ``supported()`` gates
have no counterpart: a tiled stage needs no shard to fit a fast memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers as fb,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion as fd,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.stepper_base import (
    FusedStepperBase,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import wait_exchange
from multigpu_advectiondiffusion_tpu_torch.timestepping.cfl import (
    dt_from_wave_speed,
    max_wave_speed,
)

SOURCE = "fused2d_sharded.cu"
NVCC_EXTRA = fb.NVCC_EXTRA  # K7's flags: the Burgers body rounds as K7's
H_DIFFUSION = fd.R  # the O4 reach; Burgers' is the WENO reach, params.r


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    """What one diffusion configuration's stages share: the ten O4 taps
    ``c_j K/(12 dx^2)`` (y then x, :func:`fused_diffusion.stage_taps`),
    the frozen boundary band and the Dirichlet wall value."""

    taps: tuple
    band: int
    bc_value: float


def halo_of(params) -> int:
    """The ghost depth of a configuration's padded layout: the O4 reach,
    or the WENO reach of the order (3 or 4)."""
    return H_DIFFUSION if isinstance(params, DiffusionParams) else params.r


def split_bands(ly: int, h: int):
    """The split schedule's three bands on a shard of ``ly`` rows, in
    order: ``(rows, operand)`` of the interior band (no ghost row read),
    the bottom band (reads ``lo``) and the top band (reads ``hi``); JAX's
    three band calls (``fused2d_sharded.py:296-306``), which K8b makes two
    launches: the interior band, then both edge bands.
    The schedule needs ``ly >= 3h`` (``:400-402``)."""
    if ly < 3 * h:
        raise ValueError(
            f"the split schedule's bands need a shard of >= {3 * h} rows, "
            f"got {ly}")
    return (((h, ly - h), None), ((0, h), "lo"), ((ly - h, ly), "hi"))


def edge_bands(ly: int, h: int):
    """The rows of both edge bands, which the split schedule's second
    K8b launch writes together from ``lo`` and ``hi``."""
    split_bands(ly, h)
    return ((0, h), (ly - h, ly))


# --------------------------------------------------------------------- #
# The plain PyTorch twins
# --------------------------------------------------------------------- #
def diffusion_stage_reference(v, u, out, dt, offsets, *,
                              params: DiffusionParams, a: float, b: float,
                              global_shape, window=None, lo=None, hi=None):
    """The plain K8/K8b diffusion stage on a shard padded by 2: ``out``'s
    interior rows ``window`` (all by default) ``<- where(interior,
    a*u + b*(v + dt*acc), where(face, bc_value, v))`` on global masks —
    JAX's ``_diffusion_stage`` (``fused2d_sharded.py:143-167``), which is
    K1's twin in two dimensions (:func:`fused_diffusion.stage_reference`,
    the taps y then x, each product rounded). ``lo``/``hi`` replace the
    ghost rows below/above (the split schedule's operands)."""
    if v.dim() != 2:
        raise ValueError(f"padded 2-D shard expected, got {tuple(v.shape)}")
    return fd.stage_reference(
        v, u, out, dt, taps=params.taps, a=a, b=b, band=params.band,
        bc_value=params.bc_value, global_shape=tuple(global_shape),
        offsets=list(offsets), window=window, lo=lo, hi=hi)


def burgers_stage_reference(v, u, out, dt, offsets, *,
                            params: fb.StageParams, a: float, b: float,
                            global_shape, window=None, lo=None, hi=None,
                            emit: bool = False):
    """The plain K8/K8b Burgers stage on a shard padded by the reach
    ``r = params.r`` (3 at WENO5, 4 at WENO7):
    ``out``'s interior rows ``window`` (all by default) ``<- a*u + b*(v +
    dt*rhs)``, ``rhs = -(div_y + div_x) [+ lap]`` — JAX's
    ``_burgers_stage`` (``fused2d_sharded.py:121-140``) in K5's twin's
    operation order. A neighbour outside the global domain is the
    nearest global edge cell (``_edge_fill_global``'s replicas); one in
    another shard comes from the ghost rows and columns, or from
    ``lo``/``hi`` in place of the ghost rows below/above. With ``emit``
    also returns ``max|f'(out)|`` over the rows written."""
    if v.dim() != 2:
        raise ValueError(f"padded 2-D shard expected, got {tuple(v.shape)}")
    h = params.r
    ly, lx = (n - 2 * h for n in v.shape)
    r0, r1 = window if window is not None else (0, ly)
    (oy, ox), (gy, gx) = offsets, global_shape
    if lo is not None or hi is not None:
        v = v.clone()
        if lo is not None:
            v[:h] = lo
        if hi is not None:
            v[ly + h:] = hi
    dev = v.device
    rows = (torch.arange(r0 - h, r1 + h, device=dev) + oy).clamp_(
        0, gy - 1) - oy + h
    cols = (torch.arange(-h, lx + h, device=dev) + ox).clamp_(
        0, gx - 1) - ox + h
    vp = v.index_select(0, rows).index_select(1, cols)
    uw = None if u is None else u[r0 + h:r1 + h, h:h + lx]
    rk = fb._stage_rk(vp, vp[h:-h, h:-h], uw, dt, params, a, b)
    dst = out[r0 + h:r1 + h, h:h + lx]
    dst.copy_(rk)
    if emit:
        return out, max_wave_speed(dst, params.flux.df)
    return out


def stage_reference(v, u, out, dt, offsets, *, params, a: float, b: float,
                    global_shape, window=None, lo=None, hi=None,
                    emit: bool = False):
    """The plain stage of either family (by ``params``' type)."""
    kw = dict(params=params, a=a, b=b, global_shape=global_shape,
              window=window, lo=lo, hi=hi)
    if isinstance(params, DiffusionParams):
        if emit:
            raise ValueError("the diffusion stage emits no wave speed")
        return diffusion_stage_reference(v, u, out, dt, offsets, **kw)
    return burgers_stage_reference(v, u, out, dt, offsets, emit=emit, **kw)


# --------------------------------------------------------------------- #
# The tile planner
# --------------------------------------------------------------------- #
# the source's numbers (csrc/fused2d_sharded.cu)
CELL, TILED = 0, 1  # the bodies
CELL_BLOCK = (8, 32)  # the CELL body's largest block: threads along y, x
RUN = 3  # faces a work item computes
SPARE = 2  # rows / columns the last run of a line reads
PLANES = 5  # the TILED body's shared planes: v, f+, f-, x faces, y faces
VEC = {3: 2, 4: 4}  # floats a TILED window load moves at most, by reach
# the planner's rule (PERF.md; examples/k8_tiling_sweep.py times it
# against other tilings): a launch of at most LATENCY_CELLS cells an SM is
# bound by its latency, a larger one by the issue of its operations. A
# TILED tile bound by latency has TILE_X columns and is a tile an SM of at
# most LATENCY_THREADS threads; else THROUGHPUT's (rows, columns) and
# threads by WENO order (each measured fastest of the sweep's tilings)
LATENCY_CELLS = 1024
TILE_X = 32
LATENCY_THREADS = 512
THROUGHPUT = {5: ((32, 32), 128), 7: ((32, 64), 256)}
# the cell ops of the Burgers body after its faces: the divergences, their
# sum and negation 6, the combine 5 (the viscous taps 20 more)
CELL_OPS = 11
VISCOUS_OPS = 20
# the H100's numbers, which a plan on the CPU assumes (card() on a card)
H100 = {"sms": 132, "smem_block": 232448}


def _near_equal(n: int, m: int):
    """The ``m`` near-equal parts of ``n`` rows, as the source cuts a
    band: part ``t`` spans ``[t n // m, (t+1) n // m)``."""
    return [(t * n // m, (t + 1) * n // m) for t in range(m)]


def _fixed(n: int, side: int):
    """``n`` cells cut into parts of ``side``, the last one ragged."""
    return [(a, min(a + side, n)) for a in range(0, n, side)]


def _block_ops(ty: int, tx: int, r: int, variant: str, order: int,
               viscous: bool = False) -> int:
    """f32 operations the TILED body issues on a ``ty x tx`` tile
    (Burgers flux): the splits of its window (``r`` cells a side), its
    runs of three x faces a row and y faces a column (``n // 3 + 1`` runs
    for ``n + 1`` faces) and its cells' own work."""
    runs = ty * (tx // RUN + 1) + tx * (ty // RUN + 1)
    return (fb.SPLIT_OPS * (ty + 2 * r) * (tx + 2 * r)
            + runs * fb.run_ops(variant, order)
            + ty * tx * (CELL_OPS + (VISCOUS_OPS if viscous else 0)))


def plan_tiles(bands, lx: int, r: int, *, burgers: bool = True,
               order: int = 5, sms: int = H100["sms"],
               smem_block: int = H100["smem_block"], body: int | None = None,
               tile: tuple | None = None, threads: int | None = None,
               vec: int | None = None) -> dict:
    """A launch's tiles: ``bands`` the rows of each band it writes (one,
    or the split schedule's two edge bands), ``lx`` the columns, ``r``
    the layout's ghost depth (the WENO reach, or 2 for diffusion), on a
    card of ``sms`` SMs whose blocks may take ``smem_block`` bytes of
    shared memory (:func:`card`; the H100's where not given).

    The rule (PERF.md, ``examples/k8_tiling_sweep.py``: where each body
    measured faster): diffusion takes the CELL body (a cell a thread);
    Burgers takes the TILED body (each split and face once a tile through
    shared memory) where every band has at least ``2r`` rows and the
    launch is bound by its operations (more than :data:`LATENCY_CELLS`
    cells an SM) or is of order 7, and the CELL body otherwise (the split
    schedule's edge bands; WENO5 on the 200x400 shard).

    The CELL body's tiles are 8 rows (fewer in a thinner band) of 32
    columns, the last ones ragged, a thread a cell. A TILED tile has
    columns in parts of a fixed width (the last ragged) and near-equal
    parts of a band's rows: bound by latency, :data:`TILE_X` columns and
    as many row parts as keep a tile an SM (of at least ``2r`` rows), and
    a block of the most threads, up to :data:`LATENCY_THREADS`, that a
    full tile has cells for; else the sides and threads of
    :data:`THROUGHPUT` for the order (a forced ``tile`` takes a block
    of the most threads a full tile has cells for). Its window loads move
    :data:`VEC` floats where the padded row's pitch and the tiles'
    columns allow. ``body``, ``tile`` (the largest sides), ``threads`` and
    ``vec`` override the rule (the sweep's and the tests' plans;
    diffusion has no TILED body)."""
    return _plan_tiles(tuple(int(n) for n in bands), int(lx), int(r),
                       bool(burgers), int(order), int(sms), int(smem_block),
                       body, None if tile is None else tuple(tile), threads,
                       vec)


@functools.lru_cache(maxsize=1024)
def _plan_tiles(bands, lx, r, burgers, order, sms, smem_block, body, tile,
                threads, vec):
    if not 1 <= len(bands) <= 2 or min(bands) < 1 or lx < 1:
        raise ValueError(f"bands {bands} of {lx} columns")
    latency = sum(bands) * lx <= LATENCY_CELLS * sms
    if body is None:
        body = (TILED if burgers and min(bands) >= 2 * r
                and (not latency or order == 7) else CELL)
    if body == CELL:  # a row of threads a row of a tile
        by, bx = min(CELL_BLOCK[0], max(bands)), CELL_BLOCK[1]
        my = tuple(-(-n // by) for n in bands)
        return {"body": CELL, "my": my, "mx": -(-lx // bx), "tile": (by, bx),
                "threads": by * bx, "vec": 1, "pitch": 0, "plane": 0,
                "smem": 0, "tiles": sum(my) * -(-lx // bx)}
    if not burgers:
        raise ValueError("the diffusion stage has no TILED body")
    many = None  # the threads of a rule's tile, else a full tile's cells
    if tile is None:
        tile, many = ((None, TILE_X), None) if latency else THROUGHPUT[order]
    tx = int(tile[1])
    mx = -(-lx // tx)
    if tile[0] is None:  # a tile an SM, of at least 2r rows
        my = tuple(max(1, min(n // (2 * r), sms // (mx * len(bands))))
                   for n in bands)
    else:
        my = tuple(-(-n // int(tile[0])) for n in bands)
    ty = max(-(-n // m) for n, m in zip(bands, my))
    if threads is None:
        full = min(n // m for n, m in zip(bands, my)) * min(tx, lx)
        threads = many or max([32] + [t for t in (64, 128, 256,
                                                  LATENCY_THREADS)
                                      if t <= full])
    if vec is None:
        vec = VEC[r] if (lx + 2 * r) % VEC[r] == 0 and tx % VEC[r] == 0 \
            else 1
    pitch = tx + 2 * r + SPARE
    plane = (ty + 2 * r + SPARE) * pitch
    smem = PLANES * plane * 4
    if smem > smem_block:
        raise ValueError(f"a {ty}x{tx} tile takes {smem} B of shared "
                         f"memory, more than a block's {smem_block}")
    return {"body": TILED, "my": my, "mx": mx, "tile": (ty, tx),
            "threads": int(threads), "vec": int(vec), "pitch": pitch,
            "plane": plane, "smem": smem, "tiles": sum(my) * mx}


def tiles_of(plan: dict, rows, lx: int):
    """The tiles ``(y0, y1, x0, x1)`` of a plan's launch in the source's
    order (band 0's first), ``rows`` the ``(r0, r1)`` of each band: rows
    in parts of the block's rows (CELL) or near-equal parts (TILED),
    columns in parts of the tile's, the last ones ragged."""
    out = []
    for (r0, r1), m in zip(rows, plan["my"]):
        ys = (_fixed(r1 - r0, plan["tile"][0]) if plan["body"] == CELL
              else _near_equal(r1 - r0, m))
        xs = _fixed(lx, plan["tile"][1])
        assert len(ys) == m and len(xs) == plan["mx"]
        for a, b in ys:
            for c, d in xs:
                out.append((r0 + a, r0 + b, c, d))
    return out


def ops_issued(plan: dict, rows, lx: int, params) -> int:
    """f32 operations a TILED Burgers launch of ``plan`` issues with the
    Burgers flux (:func:`_block_ops` of every tile)."""
    visc = params.lap_taps is not None
    return sum(_block_ops(y1 - y0, x1 - x0, params.r, params.variant,
                          params.order, visc)
               for y0, y1, x0, x1 in tiles_of(plan, rows, lx))


# --------------------------------------------------------------------- #
# The kernels
# --------------------------------------------------------------------- #
class _Plan(ctypes.Structure):
    """The source's ``Plan``, field for field."""

    _I, _F = ctypes.c_int, ctypes.c_float
    _fields_ = [("scratch", ctypes.c_void_p), ("device", _I), ("ly", _I),
                ("lx", _I), ("gy", _I), ("gx", _I), ("oy", _I), ("ox", _I),
                ("nbands", _I), ("r0", _I * 2), ("r1", _I * 2),
                ("my", _I * 2), ("mx", _I), ("tx", _I), ("body", _I),
                ("threads", _I), ("vec", _I), ("pitch", _I), ("plane", _I),
                ("smem", _I), ("kind", _I), ("flux", _I), ("weno_z", _I),
                ("order", _I), ("a", _F), ("b", _F), ("taps", _F * 10),
                ("band", _I), ("bc_value", _F), ("inv_dx", _F * 2),
                ("lap", _F * 10), ("viscous", _I), ("c", _F)]


class _Args(ctypes.Structure):
    """The source's ``Args``: what a launch passes besides its plan."""

    _P = ctypes.c_void_p
    _fields_ = [("v", _P), ("u", _P), ("out", _P), ("lo", _P), ("hi", _P),
                ("dt_ptr", _P), ("mx", _P), ("stream", _P),
                ("dt", ctypes.c_float), ("mx_init", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built K8/K8b kernels (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE, NVCC_EXTRA).path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused2d_card.argtypes = [i, p]
    lib.fused2d_prepare.argtypes = [p]
    lib.fused2d_launch.argtypes = [p, p]
    for fn in (lib.fused2d_card, lib.fused2d_prepare, lib.fused2d_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def card(index: int) -> dict:
    """The numbers of card ``index`` that :func:`plan_tiles` takes: its
    SMs and the shared memory a block may opt into."""
    out = (ctypes.c_int * 2)()
    rc = library().fused2d_card(int(index), out)
    if rc != 0:
        raise RuntimeError(f"fused2d_card failed: CUDA error {rc}")
    return dict(zip(("sms", "smem_block"), out))


class StagePlan:
    """One launch of K8 or K8b, worked out once: the stage (``params``,
    ``a``, ``b``), the shard's geometry, the bands it writes with the
    operand each reads (``lo``, ``hi`` or ``None``), and on a card the
    tiles, the packed ``Plan``, the library entry, the packed ``Args``
    of a launch with the stream, and the two scratch words of the emitted
    maximum. ``buffers``, when given,
    are the only ``data_ptr()`` values :func:`launch` takes for ``v``,
    ``u`` and ``out`` (the stepper's ``S``, ``T1`` and ``T2``, checked
    once). Two bands are the split schedule's edge bands, read from
    ``lo`` and ``hi``."""

    def __init__(self, counter, params, a, b, padded, offsets, global_shape,
                 bands, device, buffers=None):
        self.counter, self.params = counter, params
        self.a, self.b = float(a), float(b)
        self.diffusion = isinstance(params, DiffusionParams)
        h = halo_of(params)
        self.offsets = tuple(int(o) for o in offsets)
        self.global_shape = tuple(int(n) for n in global_shape)
        self.bands = tuple((tuple(int(x) for x in rows), op)
                           for rows, op in bands)
        self.operands = frozenset(op for _, op in self.bands if op)
        if len(self.bands) == 2 and self.operands != {"lo", "hi"}:
            raise ValueError("two bands are the edge bands, from lo and hi")
        ly, lx = (int(n) - 2 * h for n in padded)
        self.slab = (h, lx + 2 * h)
        self.buffers = None if buffers is None else frozenset(buffers)
        self.device = torch.device(device)
        self.tiles = self.struct = self.fn = self.args = None
        if self.device.type != "cuda":
            return
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        burgers = not self.diffusion
        self.tiles = plan_tiles(
            [r1 - r0 for (r0, r1), _ in self.bands], lx, h, **card(index),
            burgers=burgers, order=getattr(params, "order", 5))
        t = self.tiles
        s = _Plan()
        if burgers:  # the scratch words, zeroed once
            self.scratch = torch.zeros(2, dtype=torch.int32,
                                       device=self.device)
            s.scratch = self.scratch.data_ptr()
        s.device = index
        s.ly, s.lx = ly, lx
        s.gy, s.gx = self.global_shape
        s.oy, s.ox = self.offsets
        s.nbands = len(self.bands)
        for i, ((r0, r1), _) in enumerate(self.bands):
            s.r0[i], s.r1[i], s.my[i] = r0, r1, t["my"][i]
        s.mx, s.tx, s.body = t["mx"], t["tile"][1], t["body"]
        s.threads, s.vec = t["threads"], t["vec"]
        s.pitch, s.plane, s.smem = t["pitch"], t["plane"], t["smem"]
        s.a, s.b = self.a, self.b
        if burgers:
            s.kind = 1
            s.flux = fb.FLUX_CODES[params.flux.name]
            s.weno_z = int(params.variant == "z")
            s.order = int(params.order)
            s.inv_dx[:] = [float(np.float32(x)) for x in params.inv_dx]
            s.viscous = int(params.lap_taps is not None)
            if s.viscous:
                s.lap[:] = [float(np.float32(x)) for x in params.lap_taps]
            s.c = float(params.flux.c if params.flux.c is not None else 0.0)
        else:
            s.kind, s.order = 0, 5
            s.taps[:] = [float(np.float32(x)) for x in params.taps]
            s.band, s.bc_value = int(params.band), float(params.bc_value)
        lib = library()
        rc = lib.fused2d_prepare(ctypes.addressof(s))
        if rc != 0:
            raise RuntimeError(f"fused2d_prepare: CUDA error {rc} for the "
                               f"plan {t}")
        self.struct, self.ptr, self.fn = s, ctypes.addressof(s), \
            lib.fused2d_launch
        self.args = _Args()
        self.args.stream = torch.cuda.current_stream(self.device).cuda_stream
        self.args_ptr = ctypes.addressof(self.args)


def _twin(plan: StagePlan, v, u, out, dt, lo, hi, mx, mx_init):
    """The plain launch of ``plan``: the twin over each band in order,
    the emitted maximum folded."""
    kw = dict(params=plan.params, a=plan.a, b=plan.b,
              global_shape=plan.global_shape)
    for i, (rows, op) in enumerate(plan.bands):
        ops = {op: lo if op == "lo" else hi} if op else {}
        res = stage_reference(v, u, out, dt, plan.offsets, window=rows,
                              emit=mx is not None, **ops, **kw)
        if mx is not None:
            m = res[1].reshape(mx.shape)
            mx.copy_(m if mx_init and i == 0 else torch.maximum(mx, m))
    return out


def launch(plan: StagePlan, v, u, out, dt, *, lo=None, hi=None, mx=None,
           mx_init: bool = True):
    """The lean entry: one launch of ``plan`` on its stream (no
    synchronisation), counted in ``plan.counter.launches``; a CPU plan
    runs the twin on CPU tensors. Raises for a buffer the plan was not
    built for, a tensor off the plan's device, or an operand it does not
    read."""
    if (lo is not None, hi is not None) != ("lo" in plan.operands,
                                            "hi" in plan.operands):
        raise ValueError(f"the plan reads {sorted(plan.operands)}")
    if plan.fn is None:
        for t in (v, u, out, lo, hi, dt, mx):
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                raise ValueError(f"a plan for the CPU was given a tensor on "
                                 f"{t.device}")
        return _twin(plan, v, u, out, dt, lo, hi, mx, mx_init)
    ok = plan.buffers
    if ok is None and not (v.is_cuda and out.is_cuda
                           and (u is None or u.is_cuda)):
        raise ValueError("a plan for the card was given a CPU tensor")
    vp, op = v.data_ptr(), out.data_ptr()
    up = None if u is None else u.data_ptr()
    if ok is not None and (vp not in ok or op not in ok
                           or (up is not None and up not in ok)):
        raise ValueError("a buffer this launch plan was not built for")
    for t in (lo, hi):
        if t is not None and (not t.is_cuda or tuple(t.shape) != plan.slab):
            raise ValueError(f"operands: {plan.slab} on the card expected")
    a = plan.args
    a.v, a.u, a.out = vp, up, op
    a.lo = None if lo is None else lo.data_ptr()
    a.hi = None if hi is None else hi.data_ptr()
    if plan.diffusion:
        a.dt = dt
    else:
        for name, t in (("dt", dt), ("mx", mx)):
            if t is not None and (type(t) is not torch.Tensor
                                  or not t.is_cuda
                                  or t.dtype != torch.float32):
                raise TypeError(f"{name}: a float32 tensor on the card "
                                f"expected")
        a.dt_ptr = dt.data_ptr()
        a.mx = None if mx is None else mx.data_ptr()
        a.mx_init = mx_init
    rc = plan.fn(plan.ptr, plan.args_ptr)
    if rc != 0:
        raise RuntimeError(f"fused2d_launch failed: CUDA error {rc}")
    build.count_launch(plan.counter)
    return out


def _checked(counter, v, u, out, dt, offsets, *, params, a, b,
             global_shape, bands, lo, hi, mx, mx_init):
    """Check every operand, then launch a plan made for this call."""
    h = halo_of(params)
    if v.dim() != 2 or min(v.shape) <= 2 * h:
        raise ValueError(
            f"a 2-D shard padded by {h} expected, got {tuple(v.shape)}")
    for name, t in (("v", v), ("u", u), ("out", out)):
        if t is not None:
            fd._check(name, t, v.shape, v.device)
    if v.data_ptr() == out.data_ptr():
        raise ValueError("v and out must be different buffers")
    ly, lx = (n - 2 * h for n in v.shape)
    oy, ox = (int(o) for o in offsets)
    gy, gx = (int(n) for n in global_shape)
    if not (0 <= oy <= gy - ly and 0 <= ox <= gx - lx):
        raise ValueError(f"a {ly}x{lx} shard at offsets {(oy, ox)} does not "
                         f"fit the global {gy}x{gx}")
    for name, t in (("lo", lo), ("hi", hi)):
        if t is not None:
            fd._check(name, t, (h, lx + 2 * h), v.device)
    diffusion = isinstance(params, DiffusionParams)
    if diffusion and mx is not None:
        raise ValueError("the diffusion stage emits no wave speed")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no 2-D sharded stage kernel for device {v.device}")
    if v.device.type == "cuda":
        if diffusion and isinstance(dt, torch.Tensor):
            raise TypeError("the diffusion stage takes dt by value")
        if not diffusion:
            for name, t in (("dt", dt), ("mx", mx)):
                if name == "mx" and t is None:
                    continue
                if (not isinstance(t, torch.Tensor)
                        or t.dtype != torch.float32 or t.numel() != 1
                        or t.device != v.device):
                    raise TypeError(f"{name}: a float32 tensor of one "
                                    f"element on {v.device} expected")
    plan = StagePlan(counter, params, a, b, v.shape, (oy, ox), (gy, gx),
                     bands, v.device)
    return launch(plan, v, u, out, dt, lo=lo, hi=hi, mx=mx,
                  mx_init=mx_init)


def fused2d_stage(v, u, out, dt, offsets, *, params, a: float, b: float,
                  global_shape, mx=None):
    """K8: one RK stage over a whole padded 2-D shard, ``out <- stage(v,
    u)``. ``params`` is :class:`DiffusionParams` (``dt`` a number) or
    :class:`fused_burgers.StageParams` (``dt`` a float32 tensor of one
    element on ``v``'s device; a float is accepted for a CPU tensor).
    ``offsets`` is the shard's global ``(oy, ox)`` and ``global_shape``
    the global interior. ``u`` is ``None`` for the first stage and may be
    ``out``; ``v`` must not be ``out``. ``mx`` (Burgers) receives
    ``max|f'(out)|``. Checks every operand, plans the launch
    (:func:`plan_tiles`), launches on the current stream (no
    synchronisation)
    and counts in ``fused2d_stage.launches``; a CPU tensor runs the
    twin."""
    h = halo_of(params)
    return _checked(fused2d_stage, v, u, out, dt, offsets, params=params,
                    a=a, b=b, global_shape=global_shape,
                    bands=(((0, v.shape[0] - 2 * h), None),), lo=None,
                    hi=None, mx=mx, mx_init=True)


fused2d_stage.launches = 0


def fused2d_band_stage(v, u, out, dt, offsets, *, params, a: float,
                       b: float, global_shape, rows, lo=None, hi=None,
                       mx=None, mx_init: bool = True):
    """K8b: :func:`fused2d_stage` over the bands of the split schedule,
    writing the interior rows ``rows`` only: ``(h, ly - h)`` with no
    operand, ``(0, h)`` with ``lo``, ``(ly - h, ly)`` with ``hi`` (``(h,
    lx + 2h)`` each, standing in for the ghost rows below/above;
    :func:`split_bands`), or both edge bands in one launch,
    ``rows=edge_bands(ly, h)`` with ``lo`` and ``hi``. Any other window
    raises, as the JAX kernel asserts its band contract
    (``fused2d_sharded.py:221``). ``mx`` folds into its value unless
    ``mx_init``. Counts in ``fused2d_band_stage.launches``."""
    h = halo_of(params)
    ly = v.shape[0] - 2 * h
    given = {(False, False): None, (True, False): "lo",
             (False, True): "hi", (True, True): "both"}[
                 (lo is not None, hi is not None)]
    rows = tuple(tuple(r) if isinstance(r, (tuple, list)) else r
                 for r in rows)
    bands = split_bands(ly, h)
    if (rows, given) in bands:
        chosen = ((rows, given),)
    elif (rows, given) == (edge_bands(ly, h), "both"):
        chosen = bands[1:]
    else:
        raise ValueError(
            f"rows {rows} with operand {given} is not a band of the split "
            f"schedule on {ly} rows: {bands}, or both edge bands "
            f"{edge_bands(ly, h)} with lo and hi")
    return _checked(fused2d_band_stage, v, u, out, dt, offsets,
                    params=params, a=a, b=b, global_shape=global_shape,
                    bands=chosen, lo=lo, hi=hi, mx=mx, mx_init=mx_init)


fused2d_band_stage.launches = 0


# --------------------------------------------------------------------- #
# The steppers
# --------------------------------------------------------------------- #
class _Sharded2DStepper(FusedStepperBase):
    """Shared plumbing of the two 2-D sharded steppers (JAX
    ``_Sharded2DStepperBase``): the three-buffer step, each stage one K8
    launch followed by the ghost ``refresh``, or under the split schedule
    (a y-sharded shard of at least ``3h`` rows) two K8b launches, the
    interior band during the exchange of the y slabs (``exch``) and both
    edge bands after it. On its first step a shard builds the launch
    plans of every stage (:class:`StagePlan`, for its own ``S``, ``T1``,
    ``T2``) and launches them through :func:`launch`.
    ``run``/``run_to`` come from :class:`FusedStepperBase`; a shard's
    global ``offsets`` reach every launch (zeros unsharded)."""

    needs_offsets = True

    def __init__(self, interior_shape, halo: int, device, global_shape,
                 overlap_split: bool):
        self.interior_shape = tuple(interior_shape)
        self.global_shape = tuple(global_shape or interior_shape)
        self.sharded = self.global_shape != self.interior_shape
        self.halo = int(halo)
        self.core_offsets = (self.halo, self.halo)
        self.exchange_depth = self.halo
        self.padded_shape = tuple(n + 2 * self.halo for n in interior_shape)
        self.dtype = torch.float32
        self.device = torch.device(device)
        # the split needs a non-degenerate interior band (>= h rows)
        self.overlap_split = bool(overlap_split and self.sharded
                                  and self.interior_shape[0] >= 3 * halo)
        # a shard's plans: the shards of a mesh share the stepper, each
        # stepping from a thread of its own
        self._local = threading.local()

    def extract(self, S):
        h = self.halo
        return S[h:S.shape[0] - h, h:S.shape[1] - h].contiguous()

    def stage_plans(self, S, T1, T2, offsets):
        """This shard's launch plans for the buffers ``S``, ``T1``,
        ``T2`` on the current stream (built on the run's first step): for
        each stage, the K8 plan, or under the split schedule the interior
        band's and the edge bands'."""
        offs = tuple(int(o) for o in offsets)
        stream = (torch.cuda.current_stream(S.device).cuda_stream
                  if S.device.type == "cuda" else None)
        key = (S.data_ptr(), T1.data_ptr(), T2.data_ptr(), offs, stream)
        held = getattr(self._local, "plans", None)
        if held is not None and held[0] == key:
            return held[1]
        ly, h = self.interior_shape[0], self.halo
        kw = dict(params=self.params, padded=S.shape, offsets=offs,
                  global_shape=self.global_shape, device=S.device,
                  buffers=key[:3])
        plans = []
        for a, b in fd.STAGES:
            if self.overlap_split:
                mid, bottom, top = split_bands(ly, h)
                plans.append((
                    StagePlan(fused2d_band_stage, a=a, b=b, bands=(mid,),
                              **kw),
                    StagePlan(fused2d_band_stage, a=a, b=b,
                              bands=(bottom, top), **kw)))
            else:
                plans.append(StagePlan(fused2d_stage, a=a, b=b,
                                       bands=(((0, ly), None),), **kw))
        self._local.plans = (key, plans)
        return plans

    def _step(self, S, T1, T2, dt, m=None, refresh=None, offsets=None,
              exch=None):
        plans = self.stage_plans(S, T1, T2, offsets or (0, 0))
        stages = ((S, None, T1, None),  # u1 = u + dt L(u)
                  (T1, S, T2, None),    # 3/4 u + 1/4 (...)
                  (T2, S, S, m))        # 1/3 u + 2/3 (...), in place
        for plan, (v, u, out, mx) in zip(plans, stages):
            if self.overlap_split:
                # the interior band while v's y slabs are exchanged on the
                # exchange stream, then both edge bands from those slabs;
                # the emitted maximum folds the two launches
                mid, edges = plan
                lo, hi = exch(v)
                launch(mid, v, u, out, dt, mx=mx)
                wait_exchange(lo, hi)
                launch(edges, v, u, out, dt, lo=lo, hi=hi, mx=mx,
                       mx_init=False)
            else:
                launch(plan, v, u, out, dt, mx=mx)
            if refresh is not None:
                refresh(out)
        return S, T1, T2


class ShardedFusedDiffusion2DStepper(_Sharded2DStepper):
    """Per-stage fused 2-D O4 diffusion on one shard of a device mesh (JAX
    ``ShardedFusedDiffusion2DStepper``): K8 three times a step with the
    ghost refresh after each, reference-parity walls on the global faces
    (``MultiGPU/Diffusion2d_Baseline/main.c:189-280``); ``dt`` and ``t``
    host scalars."""

    def __init__(self, interior_shape, spacing, diffusivity, dt, band,
                 bc_value, device, global_shape=None,
                 overlap_split: bool = False):
        super().__init__(interior_shape, H_DIFFUSION, device, global_shape,
                         overlap_split)
        self.params = DiffusionParams(fd.stage_taps(spacing, diffusivity),
                                      int(band), float(bc_value))
        self.bc_value = float(bc_value)
        self.dt = float(dt)

    def embed(self, u):
        h = self.halo
        S = torch.full(self.padded_shape, self.bc_value, dtype=self.dtype,
                       device=self.device)
        S[h:-h, h:-h].copy_(u)
        return S

    def _dt_value(self):
        return np.float32(self.dt)


class ShardedFusedBurgers2DStepper(_Sharded2DStepper):
    """Per-stage fused 2-D Burgers (WENO5-JS/Z or WENO7-JS) on one shard
    of a device mesh (JAX ``ShardedFusedBurgers2DStepper``,
    ``MultiGPU/Burgers2d_Baseline/main.c:186+``): K8 three times a step,
    the shard padded by the order's reach ``HALO[order]`` (3 or 4), the
    split schedule's bands ``3h`` rows deep as JAX's.
    ``dt`` fixes the step (CUDA parity), else the CFL step
    ``float32(cfl min dx) / max(m, 1e-12)`` follows the wave speed ``m``
    that the last stage of each step emits, the max over the shards
    (``reduce_max``) kept on the card (the device-scalar mode of
    :class:`FusedStepperBase`), as K7a takes it from the whole state."""

    device_scalars = True

    def __init__(self, interior_shape, spacing, flux: Flux, variant: str,
                 nu: float, cfl: float, device, dt: float | None = None,
                 global_shape=None, overlap_split: bool = False,
                 reduce_max=None, order: int = 5):
        self.params = fb.stage_params(flux, variant, spacing, nu, order)
        self.order = int(order)
        super().__init__(interior_shape, self.params.r, device, global_shape,
                         overlap_split)
        self.spacing = tuple(spacing)
        self.cfl = float(cfl)
        self.adaptive = dt is None
        self.dt = None if dt is None else torch.full(
            (), dt, dtype=torch.float32, device=self.device)
        self.reduce_max = reduce_max

    def embed(self, u):
        # ghosts start as edge replicas; the refresh (or the exchanged
        # operands) replaces them where the domain goes on
        return fb._edge_pad(u.to(device=self.device, dtype=self.dtype),
                            self.halo).contiguous()

    def _initial_max(self, u):
        if not self.adaptive:
            return None
        return max_wave_speed(u.to(self.dtype), self.params.flux.df)

    def _dt_of(self, m):
        if not self.adaptive:
            return self.dt
        return dt_from_wave_speed(m, self.spacing, self.cfl,
                                  reduce_max=self.reduce_max)
