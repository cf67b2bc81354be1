"""Fused SSP-RK3 advection–diffusion–reaction stepping in 3-D (JAX
``ops/pallas/fused_adr.py`` counterpart), the kernel K9.

Each RK stage is ONE kernel launch over the persistent padded state, as
K1's (:mod:`ops.kernels.fused_diffusion`): the same ``(nz+4, ny+4,
nx+4)`` float32 layout whose ghost ring holds the wall value and is
never rewritten, and the same three buffers a step, ``T1 = s1(S)``,
``T2 = s2(T1, S)``, ``S = s3(T2, S)`` in place. The stage evaluates the
ADR right-hand side of the JAX kernel in its term order:

* the UNSCALED O4 tap sum (``stage_taps(spacing, (1, 1, 1))``), which
  ``K(x) = K0 (1 + eps cos(pi ẑ) cos(pi ŷ) cos(pi x̂))`` multiplies;
* first-order upwind advection at constant velocity;
* linear decay ``-lambda u``; then the RK combine and the walls.

``K(x)``'s factors are three 1-D float32 vectors (:func:`kappa_axes`),
computed once with torch on the CPU in the JAX kernel's expression and
handed to the kernel, which forms their product per cell.

On a shard of a device mesh (``global_shape``, JAX ``fused_adr.py``'s
``sharded`` stage, ``:244-305``) the stage runs K9's sharded instance:
the wall masks are global (the shard's ``offsets``), the factors are the
global grid's, cut to the shard's cells, and the ghosts of the sharded
axes are refreshed after every stage by the caller.

:func:`fused_adr_stage` launches the CUDA kernel
(``csrc/fused_adr_stage.cu``, built ``-fmad=false``) for a CUDA tensor
and raises if it cannot; for a CPU tensor, and only then, it runs
:func:`adr_stage_reference`, the plain PyTorch twin with the kernel's
layout, term order and roundings. A block of the kernel owns a
:data:`TILE` (y, x) tile and marches a chunk of z planes, fed by
asynchronous copies; :func:`adr_schedule` plans the chunks and
:func:`copy_floats` says how wide the copies can be for a row pitch.

:func:`fused_adr_stage_bf16` is K9's instance on bfloat16 buffers (the
JAX kernel's ``compute_dtype`` upcast, ``fused_adr.py:140-148``), one
device: the stage's float32 arithmetic on the loaded bf16 values, each
written cell rounded to bf16 once, after the stage, on one device or a
shard (the sharded geometry as above). Its copies move
:func:`copy_width`'s values; its twin is
:func:`fused_diffusion.upcast_twin` of :func:`adr_stage_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import build
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.fused_diffusion import (
    R,
    STAGES,
    PaddedDiffusionState,
    _check,
    _interior,
    stage_taps,
    upcast_twin,
    write_walled,
)
from multigpu_advectiondiffusion_tpu_torch.ops.kernels.stepper_base import (
    FusedStepperBase,
)

SOURCE = "fused_adr_stage.cu"
NVCC_EXTRA = ("-fmad=false",)
# the (y, x) tile a block of the kernel owns (TY, TX in the source)
TILE = (16, 64)
# resident blocks an SM (MIN_BLOCKS in the source: 256 threads, 49 KB of
# shared memory a block)
BLOCKS_PER_SM = 4
# the z planes a block marches, as near as the split allows: the fastest
# of 4-32 in every stage kind on an H100 at 508x204x160 (PERF.md §6,
# examples/stage_kernel_timing.py --paths K9 times the path). Short
# chunks keep the blocks resident at once on a narrow band of planes.
CHUNK_PLANES = 6


def kappa_axes(global_shape: Sequence[int], device="cpu"):
    """The factors ``cos(pi (g/(n-1) - 1/2))`` of ``K(x)`` per axis, as
    three float32 vectors: the JAX kernel's ``chat`` in its float32
    expression, evaluated on the CPU so that every device gets the same
    bits, then moved to ``device``."""
    out = []
    pi = torch.tensor(math.pi, dtype=torch.float32)
    for n in global_shape:
        g = torch.arange(n, dtype=torch.float32)
        out.append(torch.cos(pi * (torch.div(g, g.new_tensor(n - 1)) - 0.5))
                   .to(device))
    return tuple(out)


def _shifted(v, n, axis, off):
    """The interior block of the padded ``v`` moved ``off`` cells along
    ``axis``."""
    idx = [slice(R, R + m) for m in n]
    idx[axis] = slice(R + off, R + off + n[axis])
    return v[tuple(idx)]


def adr_stage_reference(v, u, out, dt, *, taps, cz, cy, cx, k0, eps, adv_p,
                        adv_m, lam, a, b, band, bc_value, global_shape=None,
                        offsets=None):
    """Plain PyTorch twin of the K9 stage kernel, on the same padded
    layout. Writes the interior of ``out`` (which may be ``u``) and
    returns it. Term order and roundings are the kernel's (and the JAX
    kernel's): taps z, y, x, each product rounded; upwind terms z, y, x,
    an axis skipped only when both its coefficients are 0; then the
    coefficient, the advective and reaction terms, ``b*(v + dt*rhs)``
    and ``a*u + ...``. A shard passes the ``global_shape`` of the
    interior and its ``offsets`` (global wall masks); ``cz``/``cy``/``cx``
    are then the factors at its cells."""
    n = tuple(s - 2 * R for s in v.shape)
    lap = None
    for axis in range(3):
        for j in range(5):
            term = _shifted(v, n, axis, j - R) * taps[5 * axis + j]
            lap = term if lap is None else lap + term
    vc = _interior(v)
    adv = None
    for axis in range(3):
        cp, cm = adv_p[axis], adv_m[axis]
        if cp == 0.0 and cm == 0.0:
            continue
        lo = _shifted(v, n, axis, -1)
        hi = _shifted(v, n, axis, 1)
        term = (vc - lo) * cp + (hi - vc) * cm
        adv = term if adv is None else adv + term
    if eps:
        prod = (cz * eps).reshape(-1, 1, 1) * cy.reshape(1, -1, 1)
        rhs = ((prod * cx.reshape(1, 1, -1) + 1.0) * k0) * lap
    else:
        rhs = lap * k0
    if adv is not None:
        rhs = rhs - adv
    if lam:
        rhs = rhs - vc * lam
    dt = float(np.float32(dt))
    rk = (vc + rhs * dt) * b
    if u is not None:
        rk = _interior(u) * a + rk
    return write_walled(out, rk, vc, band, bc_value,
                        global_shape=global_shape, offsets=offsets)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built K9 kernel (compiled at first use), argtypes set."""
    lib = ctypes.CDLL(str(build.build(SOURCE, NVCC_EXTRA).path))
    fn = lib.fused_adr_stage
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, i, i, i, p, p, p, p, f, f, p, f, f, f, f, i, f,
                   i, p, p, p, p]
    fn.restype = ctypes.c_int
    fn = lib.fused_adr_stage_bf16
    fn.argtypes = lib.fused_adr_stage.argtypes
    fn.restype = ctypes.c_int
    return lib


def copy_floats(nx: int) -> int:
    """The width (floats) of the kernel's asynchronous copies for an
    interior row of ``nx`` cells (row pitch ``nx + 4``) on 16-byte aligned
    buffers: 4 (16-byte copies) where every tile row starts 16-byte
    aligned, the pitch a multiple of 4 floats (tiles start at multiples
    of 4 columns), else 1 (4-byte copies)."""
    return 4 if (int(nx) + 2 * R) % 4 == 0 else 1


def copy_width(nx: int, itemsize: int) -> int:
    """The width (values) of the kernel's copies for an interior row of
    ``nx`` cells of ``itemsize``-byte values on 16-byte aligned buffers:
    the widest of 16, 8 and 4 bytes whose value count divides the row
    pitch ``nx + 4`` (every tile row then starts aligned: tiles start at
    multiples of 8 columns), else one value. float32 takes 16 bytes or
    one value (:func:`copy_floats`); bf16 16, 8 or 4 bytes, else one
    value by a plain load."""
    if itemsize == 4:
        return copy_floats(nx)
    pitch = int(nx) + 2 * R
    for nbytes in (16, 8, 4):
        w = nbytes // itemsize
        if pitch % w == 0:
            return w
    return 1


@functools.lru_cache(maxsize=None)
def chunk_planes(nz: int) -> int:
    """The z planes a block marches on ``nz`` interior planes: nz split
    into ``ceil(nz / CHUNK_PLANES)`` near-equal chunks, the last the
    rest."""
    return -(-int(nz) // -(-int(nz) // CHUNK_PLANES))


def adr_schedule(shape, blocks: int, zchunk: int | None = None) -> dict:
    """The launch of one K9 stage on an ``(nz, ny, nx)`` interior with
    ``blocks`` resident blocks: :data:`TILE` tiles a plane, and z chunks
    of ``zchunk`` planes (the last the rest), or with None
    :func:`chunk_planes`'s; the blocks, their waves over ``blocks`` and
    the copies' width (:func:`copy_floats`)."""
    nz, ny, nx = (int(n) for n in shape)
    ty, tx = TILE
    tiles = -(-ny // ty) * -(-nx // tx)
    planes = zchunk or chunk_planes(nz)
    chunks = -(-nz // int(planes))
    return {"tile_shape": TILE, "tiles": tiles,
            "chunk_planes": int(planes), "chunks": chunks,
            "blocks": tiles * chunks, "waves": tiles * chunks / blocks,
            "copy_floats": copy_floats(nx)}


def _stage_checks(v, u, out, cz, cy, cx, global_shape, offsets, dtype):
    """Check a K9 launch's buffers (``dtype``), factors and geometry."""
    for name, t in (("v", v), ("u", u), ("out", out)):
        if t is not None:
            _check(name, t, v.shape, v.device, dtype)
    if v.dim() != 3 or min(v.shape) <= 2 * R:
        raise ValueError(f"padded 3-D state expected, got {tuple(v.shape)}")
    n = tuple(s - 2 * R for s in v.shape)
    for name, t, m in (("cz", cz, n[0]), ("cy", cy, n[1]), ("cx", cx, n[2])):
        _check(name, t, (m,), v.device)
    if v.data_ptr() == out.data_ptr():
        raise ValueError("v and out must be different buffers")
    if (global_shape is None) != (offsets is None):
        raise ValueError("a shard passes both global_shape and offsets")
    if global_shape is not None and not all(
            0 <= int(o) <= int(gn) - m
            for o, gn, m in zip(offsets, global_shape, n)):
        raise ValueError(f"a {n} block at offsets {tuple(offsets)} does not "
                         f"fit the global {tuple(global_shape)}")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ADR stage kernel for device {v.device}")


def _launch_stage(symbol, v, u, out, dt, *, taps, cz, cy, cx, k0, eps,
                  adv_p, adv_m, lam, a, b, band, bc_value, zchunk,
                  global_shape, offsets, launch, width_key):
    """Launch ``symbol`` (K9's float32 or bf16 entry) on the current
    stream, raising on a CUDA error; ``launch``, a dict, receives the
    chunk, the copies' width (under ``width_key``) and the resident
    blocks an SM."""
    n = tuple(s - 2 * R for s in v.shape)
    zchunk = zchunk or chunk_planes(n[0])
    out2 = None if launch is None else (ctypes.c_int * 2)()
    host_taps = np.asarray(taps, dtype=np.float32)
    host_adv = np.asarray(tuple(adv_p) + tuple(adv_m), dtype=np.float32)
    geo = offs = None
    if global_shape is not None:
        geo = np.asarray(global_shape, dtype=np.int32)
        offs = np.asarray(offsets, dtype=np.int32)
    with torch.cuda.device(v.device):
        rc = getattr(library(), symbol)(
            v.data_ptr(), None if u is None else u.data_ptr(),
            out.data_ptr(), *n, host_taps.ctypes.data, cz.data_ptr(),
            cy.data_ptr(), cx.data_ptr(), float(k0), float(eps),
            host_adv.ctypes.data, float(lam), float(np.float32(dt)),
            float(a), float(b), int(band), float(bc_value), int(zchunk),
            None if geo is None else geo.ctypes.data,
            None if offs is None else offs.ctypes.data,
            None if out2 is None else ctypes.byref(out2),
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    if launch is not None:
        launch.update({"zchunk": int(zchunk), width_key: out2[0],
                       "blocks_per_sm": out2[1]})


def fused_adr_stage(v, u, out, dt, *, taps, cz, cy, cx, k0, eps, adv_p,
                    adv_m, lam, a, b, band, bc_value, zchunk=None,
                    global_shape=None, offsets=None,
                    launch: dict | None = None):
    """One fused ADR RK stage: ``out <- stage(v, u)`` on padded buffers.

    ``u`` is ``None`` for the first stage (a == 0) and may be ``out``
    (in-place final stage); ``v`` must not be ``out``. ``cz``/``cy``/
    ``cx`` are :func:`kappa_axes` on ``v``'s device. Scalars are rounded
    to float32 and passed by value. A shard of a mesh passes the
    ``global_shape`` of the interior and its ``offsets`` (K9's sharded
    instance), with the factors at its cells. Launches the CUDA kernel
    on the current stream (no synchronisation), a block a :data:`TILE`
    tile and ``zchunk`` z planes (None: :func:`chunk_planes`'s), and
    counts the launch in ``fused_adr_stage.launches``; ``launch``, a
    dict, receives its chunk, the width of its copies (floats) and the
    kernel's resident blocks an SM (a query the launch skips without
    it). A CPU tensor runs
    :func:`adr_stage_reference`.
    """
    _stage_checks(v, u, out, cz, cy, cx, global_shape, offsets,
                  torch.float32)
    kw = dict(taps=taps, cz=cz, cy=cy, cx=cx, k0=k0, eps=eps, adv_p=adv_p,
              adv_m=adv_m, lam=lam, a=a, b=b, band=band, bc_value=bc_value,
              global_shape=global_shape, offsets=offsets)
    if v.device.type == "cpu":
        return adr_stage_reference(v, u, out, dt, **kw)
    _launch_stage("fused_adr_stage", v, u, out, dt, zchunk=zchunk,
                  launch=launch, width_key="copy_floats", **kw)
    build.count_launch(fused_adr_stage)
    return out


fused_adr_stage.launches = 0


def fused_adr_stage_bf16(v, u, out, dt, *, taps, cz, cy, cx, k0, eps,
                         adv_p, adv_m, lam, a, b, band, bc_value,
                         zchunk=None, global_shape=None, offsets=None,
                         launch: dict | None = None):
    """:func:`fused_adr_stage` on bfloat16 buffers (K9's bf16 instances,
    the sharded one for a shard's ``global_shape`` and ``offsets``): the
    float32 stage on the loaded bf16 values, every written cell rounded
    to bf16 once (the ghost ring keeps its bf16 wall value). Launches the
    kernel on the current stream, counted in
    ``fused_adr_stage_bf16.launches``; ``launch``, a dict, receives its
    chunk, copy width (bf16 values) and resident blocks an SM. A CPU
    tensor runs :func:`upcast_twin` of :func:`adr_stage_reference`."""
    _stage_checks(v, u, out, cz, cy, cx, global_shape, offsets,
                  torch.bfloat16)
    kw = dict(taps=taps, cz=cz, cy=cy, cx=cx, k0=k0, eps=eps, adv_p=adv_p,
              adv_m=adv_m, lam=lam, a=a, b=b, band=band, bc_value=bc_value,
              global_shape=global_shape, offsets=offsets)
    if v.device.type == "cpu":
        return upcast_twin(adr_stage_reference, v, u, out, dt, **kw)
    _launch_stage("fused_adr_stage_bf16", v, u, out, dt, zchunk=zchunk,
                  launch=launch, width_key="copy_width", **kw)
    build.count_launch(fused_adr_stage_bf16)
    return out


fused_adr_stage_bf16.launches = 0


class FusedADRStepper(PaddedDiffusionState, FusedStepperBase):
    """Fused per-stage ADR runner for one configuration on one device, or
    on one shard of a mesh: K9 three times a step. ``velocity`` is per
    array axis (z, y, x).

    ``global_shape`` (when it differs from ``interior_shape``) makes the
    stepper shard-local, as the JAX stepper's: ``interior_shape`` is this
    shard's block, the walls are global (``offsets``), ``K(x)``'s factors
    are the global grid's at the shard's cells, and ``run`` takes the
    ghost ``refresh`` run after every stage. ADR has no split-overlap
    schedule (the solver declines it to the generic rung).

    ``dtype=torch.bfloat16`` runs K9's bf16 instances
    (:func:`fused_adr_stage_bf16`, the sharded one on a shard);
    ``storage_dtype`` is the state it faces
    (``fused_diffusion.PaddedDiffusionState``)."""

    halo = R
    needs_offsets = True

    def __init__(self, interior_shape, spacing, diffusivity, velocity,
                 reaction, dt, band, bc_value, device,
                 kappa_variation: float = 0.0, global_shape=None,
                 dtype=torch.float32, storage_dtype=None):
        if len(tuple(velocity)) != 3:
            raise ValueError(
                f"fused ADR wants a 3-vector velocity, got {velocity!r}")
        # the unscaled taps: K(x) multiplies the summed Laplacian
        super().__init__(interior_shape, spacing, (1.0, 1.0, 1.0), dt, band,
                         bc_value, device, dtype, storage_dtype)
        self.k0 = float(diffusivity)
        self.eps = float(kappa_variation)
        self.lam = float(reaction)
        self.adv_p = tuple(max(float(a), 0.0) / dx
                           for a, dx in zip(velocity, spacing))
        self.adv_m = tuple(min(float(a), 0.0) / dx
                           for a, dx in zip(velocity, spacing))
        self.global_shape = tuple(global_shape or interior_shape)
        self.sharded = self.global_shape != self.interior_shape
        self.core_offsets = (R,) * 3
        self.exchange_depth = R
        # the factors over the global grid, from the global shape (a
        # shard takes its cells' window of them)
        self.cz, self.cy, self.cx = kappa_axes(self.global_shape, self.device)

    def _dt_value(self):
        return np.float32(self.dt)

    def stage_kwargs(self, offsets=None) -> dict:
        """What :func:`fused_adr_stage` takes for this configuration,
        but ``a`` and ``b``; a shard passes its ``offsets``, and gets its
        window of the factors and the global geometry."""
        kw = dict(taps=self.taps, cz=self.cz, cy=self.cy, cx=self.cx,
                  k0=self.k0, eps=self.eps, adv_p=self.adv_p,
                  adv_m=self.adv_m, lam=self.lam, band=self.band,
                  bc_value=self.bc_value)
        if not self.sharded:
            return kw
        if offsets is None:
            raise ValueError("a sharded ADR stepper needs offsets")
        for name, o, n in zip(("cz", "cy", "cx"), offsets,
                              self.interior_shape):
            kw[name] = kw[name][int(o):int(o) + n]
        kw.update(global_shape=self.global_shape,
                  offsets=tuple(int(o) for o in offsets))
        return kw

    def _step(self, S, T1, T2, dt, refresh=None, offsets=None, exch=None):
        del exch  # no split schedule
        kw = self.stage_kwargs(offsets)
        (a1, b1), (a2, b2), (a3, b3) = STAGES
        stages = ((S, None, T1, a1, b1), (T1, S, T2, a2, b2),
                  (T2, S, S, a3, b3))
        stage = (fused_adr_stage_bf16 if self.dtype == torch.bfloat16
                 else fused_adr_stage)
        for v, u, out, a, b in stages:
            stage(v, u, out, dt, a=a, b=b, **kw)
            if refresh is not None:
                refresh(out)
        return S, T1, T2
