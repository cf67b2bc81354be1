"""Device meshes, domain decompositions and the shard runtime (JAX
``parallel/mesh.py`` counterpart).

The reference decomposes 1-D z slabs, one MPI rank per GPU
(``MultiGPU/Diffusion3d_Baseline/main.c:69``). The JAX package drives
every device of a mesh from one process (``shard_map``), and so does
the port:

* a :class:`Mesh` is a grid of ``torch.device`` objects with named
  axes; ``mesh.shape`` maps each name to its extent, as
  ``jax.sharding.Mesh.shape`` does. A device may appear more than once:
  two shards on ``cuda:0`` (or four on the CPU) are the port's
  counterpart of the JAX suite's forced host-device count;
* a :class:`Decomposition` maps grid axes to mesh axes (1-D slabs, 2-D
  pencils, 3-D blocks, compound tuple axes), the JAX class;
* :func:`shard_map` runs ONE per-shard function on every shard, one
  Python thread a shard. Inside it :func:`axis_index`, :func:`ppermute`,
  :func:`pmax` and :func:`psum` give ``jax.lax``'s results: every
  collective is a rendezvous of all the mesh's shards, where each posts
  a snapshot of what it sends (a copy nobody writes again) and takes
  what it needs from the others' posts;
* :func:`launch_group` is the rendezvous of a kernel that serves every
  shard of the card in one launch (K4, the in-kernel exchange): each
  shard posts its live buffers, one leader launches.

On CUDA each shard runs on a stream of its own (one per shard and
mesh, kept for the mesh's life so the caching allocator's pools stay
per stream). A posted tensor travels with the event recorded after its
snapshot: the receiver's stream waits on it before reading (read after
write), and the snapshot is a fresh tensor that its sender never writes
again (no write after read); ``record_stream`` keeps its memory from
being reused while the receiver's stream may still read it. Shards on
different cards receive peer copies; that path is written but not
measured (PERF.md). A shard that raises aborts the rendezvous, so the
others raise too; every wait times out (``Mesh.timeout``) with an error
instead of hanging; the caller sees the first shard's exception.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

# Reserved mesh-axis name for the batched ensemble engine's member
# dimension (the JAX package's; member-sharded meshes are not ported).
MEMBER_AXIS = "members"
# seconds a shard waits at a collective for the others before it raises
DEFAULT_TIMEOUT = 600.0


def member_extent(mesh) -> int:
    """Shard count of the ensemble member axis (1 when the mesh is
    ``None`` or carries no ``members`` axis)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(MEMBER_AXIS, 1))


class Mesh:
    """A grid of devices with named axes that one process drives.

    ``devices`` is an object array of ``torch.device`` whose shape is
    the mesh's extents; ``timeout`` bounds every wait of a shard at a
    collective (seconds)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 timeout: float = DEFAULT_TIMEOUT):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("one mesh axis name per device-grid axis")
        self.timeout = float(timeout)
        self._streams: dict = {}
        self._events: dict = {}
        self._lock = threading.Lock()
        self._coords = [
            {n: int(i) for n, i in zip(self.axis_names, idx)}
            for idx in np.ndindex(self.devices.shape)]
        self._ranks = {tuple(c.values()): r
                       for r, c in enumerate(self._coords)}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """The devices in rank order (row-major over the axes)."""
        return list(self.devices.reshape(-1))

    def coords(self, rank: int) -> Dict[str, int]:
        """Shard ``rank``'s index along every mesh axis."""
        return dict(self._coords[rank])

    def rank_of(self, coords: Dict[str, int]) -> int:
        return self._ranks[tuple(coords[n] for n in self.axis_names)]

    def event(self, rank: int):
        """Shard ``rank``'s CUDA event for its posts (made at first use)."""
        with self._lock:
            if rank not in self._events:
                self._events[rank] = torch.cuda.Event()
            return self._events[rank]

    def streams(self, rank: int):
        """``(compute, exchange)``: the CUDA streams shard ``rank`` runs
        on, made at first use and kept for the mesh's life."""
        with self._lock:
            if rank not in self._streams:
                dev = self.device_list()[rank]
                self._streams[rank] = (torch.cuda.Stream(dev),
                                       torch.cuda.Stream(dev))
            return self._streams[rank]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.device_list())
        return f"Mesh({self.shape}, devices=[{devs}])"


def make_mesh(axis_sizes: Dict[str, int], devices: Sequence | None = None,
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """Build a mesh, e.g. ``make_mesh({'dz': 4, 'dy': 2})``.

    Axis order follows dict order. ``devices=None`` takes the visible
    GPUs, and raises when there are fewer than the mesh needs (as the
    JAX package's ``make_mesh`` raises); an explicit list may name one
    device more than once (``[torch.device("cpu")] * 4``, or
    ``["cuda:0", "cuda:0"]``: two shards on one card)."""
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    devices = [torch.device(d) for d in devices]
    need = math.prod(sizes)
    if need > len(devices):
        raise ValueError(
            f"mesh needs {need} devices, only {len(devices)} available")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(sizes), names, timeout=timeout)


def axis_extent(sizes, name) -> int:
    """Shard count of a mesh-axis spec: a single axis name, or a tuple of
    names (compound axis) whose extents multiply."""
    if isinstance(name, tuple):
        return math.prod(sizes[n] for n in name)
    return sizes[name]


def reduce_axis_names(decomp: "Decomposition", axis_sizes) -> Tuple[str, ...]:
    """The pmax/psum axis-name set of a decomposition under the given
    mesh extents: every individual mesh axis in use whose extent
    exceeds 1 (the JAX package's single source of the reduction set)."""
    sizes = dict(axis_sizes)
    return tuple(
        n for n in decomp.mesh_axis_names() if sizes.get(n, 1) > 1
    )


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """Maps array axes of the grid to mesh axes (the JAX class).

    ``axes[array_axis] = mesh_axis_name`` (axes not present are
    unsharded). The reference's slab split is ``Decomposition.slab()``:
    z, array axis 0 (``_Nz = Nz/np``, ``main.c:69``). A mesh-axis entry
    may be a *tuple* of names — a compound axis splitting one grid axis
    over several mesh axes, outermost first, addressed by its flattened
    row-major index."""

    axes: Tuple[Tuple[int, object], ...]

    @staticmethod
    def of(mapping: Dict[int, object]) -> "Decomposition":
        norm = {
            ax: tuple(n) if isinstance(n, (list, tuple)) else n
            for ax, n in mapping.items()
        }
        return Decomposition(tuple(sorted(norm.items())))

    @staticmethod
    def slab(mesh_axis: str = "dz") -> "Decomposition":
        """Reference-style 1-D slab decomposition along z (array axis 0)."""
        return Decomposition.of({0: mesh_axis})

    @property
    def mapping(self) -> Dict[int, object]:
        return dict(self.axes)

    def mesh_axis(self, array_axis: int):
        return self.mapping.get(array_axis)

    def mesh_axis_names(self) -> Tuple[str, ...]:
        """All individual mesh axis names in use (compound axes flattened)."""
        out = []
        for _, name in self.axes:
            out.extend(name if isinstance(name, tuple) else (name,))
        return tuple(out)

    def validate(self, mesh: Mesh, global_shape: Sequence[int]) -> None:
        """Startup topology assertions (the reference's ``MPIDeviceCheck``,
        ``Util.cu:43-61``): every mesh axis named exists and every sharded
        axis divides evenly."""
        for ax, name in self.axes:
            for n in name if isinstance(name, tuple) else (name,):
                if n not in mesh.shape:
                    raise ValueError(f"mesh has no axis {n!r}")
            parts = axis_extent(mesh.shape, name)
            if global_shape[ax] % parts:
                raise ValueError(
                    f"axis {ax} size {global_shape[ax]} not divisible by "
                    f"mesh axis {name!r} ({parts} shards)"
                )

    def local_shape(self, mesh: Mesh,
                    global_shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(global_shape)
        for ax, name in self.axes:
            out[ax] //= axis_extent(mesh.shape, name)
        return tuple(out)

    def block_index(self, mesh: Mesh, rank: int, ndim: int):
        """Shard ``rank``'s block index along every array axis (0 on an
        unsharded axis)."""
        coords = mesh.coords(rank)
        out = []
        for ax in range(ndim):
            name = self.mesh_axis(ax)
            out.append(0 if name is None else _flat_index(
                mesh.shape, coords, name))
        return tuple(out)


def _flat_index(sizes, coords, name) -> int:
    """Row-major index of ``coords`` along a (possibly compound) axis."""
    idx = 0
    for n in name if isinstance(name, tuple) else (name,):
        idx = idx * sizes[n] + coords[n]
    return idx


# --------------------------------------------------------------------- #
# The shard runtime
# --------------------------------------------------------------------- #
class ShardAborted(RuntimeError):
    """Raised in a shard whose collective was abandoned because another
    shard failed (the caller sees that shard's exception instead)."""


class _Rendezvous:
    """All-gather of one value from every shard, reusable: each shard's
    ``k``-th call of :meth:`gather` is round ``k``, and returns every
    shard's value of that round. Each shard has an inbox (a
    ``queue.SimpleQueue``): a round puts this shard's value into every
    other inbox and takes the others' from its own — a handoff, not a
    condition every shard wakes on. :meth:`abort` wakes every waiter
    with :class:`ShardAborted`.

    An inbox never holds a later round before an earlier one: a shard
    posts to every inbox while it holds the baton, and posts round
    ``k + 1`` only after it has received every round-``k`` post, so each
    of those already sits in every inbox, and an inbox is FIFO.

    The baton: one shard thread runs Python at a time and hands over only
    while it waits at a round. Torch calls drop and retake the
    interpreter lock, so two runnable shard threads would trade it at
    every call (four small calls ran 6x slower in two threads than in
    one); the device work stays asynchronous on the shards' streams."""

    _ABORT = object()

    def __init__(self, size: int, timeout: float):
        self._n = size
        self._timeout = timeout
        self._inbox = [queue.SimpleQueue() for _ in range(size)]
        self._round = [0] * size
        self._error = None
        self.baton = threading.Lock()

    def take_baton(self) -> None:
        if not self.baton.acquire(timeout=self._timeout):
            err = TimeoutError(
                f"a shard waited {self._timeout} s for its turn to run")
            self.abort(err)
            raise err
        _local.baton = True

    def give_baton(self) -> None:
        """Hand the baton on, if this thread holds it."""
        if getattr(_local, "baton", False):
            _local.baton = False
            self.baton.release()

    def gather(self, rank: int, value):
        if self._error is not None:
            raise ShardAborted("another shard failed") from self._error
        rnd = self._round[rank]
        self._round[rank] += 1
        for other in range(self._n):
            if other != rank:
                self._inbox[other].put((rnd, rank, value))
        got = {rank: value}
        self.give_baton()
        try:
            while len(got) < self._n:
                try:
                    msg = self._inbox[rank].get(timeout=self._timeout)
                except queue.Empty:
                    err = TimeoutError(
                        f"shard {rank} waited {self._timeout} s at a "
                        "collective for the other shards")
                    self.abort(err)
                    raise err from None
                if msg is self._ABORT:
                    raise ShardAborted(
                        "another shard failed") from self._error
                r, sender, v = msg
                if r != rnd:
                    raise RuntimeError(
                        f"shard {rank} got a post of round {r} from shard "
                        f"{sender} while in round {rnd}")
                got[sender] = v
        finally:
            self.take_baton()
        return [got[j] for j in range(self._n)]

    def abort(self, exc: BaseException) -> None:
        if self._error is None:
            self._error = exc
        for box in self._inbox:
            box.put(self._ABORT)

    @property
    def error(self):
        return self._error


@dataclasses.dataclass
class _Shard:
    mesh: Mesh
    rank: int
    device: torch.device
    group: _Rendezvous

    def __post_init__(self):
        self.cuda = self.device.type == "cuda"
        self.coords = self.mesh.coords(self.rank)
        self.sizes = self.mesh.shape


_local = threading.local()


def current_shard() -> _Shard | None:
    """This thread's shard, or ``None`` outside :func:`shard_map`."""
    return getattr(_local, "shard", None)


def _shard() -> _Shard:
    shard = current_shard()
    if shard is None:
        raise RuntimeError("collectives run inside shard_map only")
    return shard


def axis_index(name) -> int:
    """This shard's index along a mesh axis (a compound tuple axis by
    its flattened row-major index), as ``jax.lax.axis_index``."""
    shard = _shard()
    return _flat_index(shard.sizes, shard.coords, name)


def _rank_at(shard: _Shard, name, index: int) -> int:
    """The rank that shares this shard's coordinates off ``name`` and
    stands at ``index`` along it."""
    coords = dict(shard.coords)
    names = name if isinstance(name, tuple) else (name,)
    sizes = shard.sizes
    for n in reversed(names):
        coords[n] = index % sizes[n]
        index //= sizes[n]
    return shard.mesh.rank_of(coords)


def _post(shard: _Shard, xs):
    """What a shard posts for the tensors ``xs``: ONE snapshot holding
    all of them (a tensor nobody writes again), their shapes, and on
    CUDA the shard's event recorded after it on this stream (one event a
    shard, recorded again for every post: a receiver that waits on a
    later record waits on later work of the same stream)."""
    snap = torch.cat([x.detach().reshape(-1) for x in xs])
    ev = None
    if snap.is_cuda:
        ev = shard.mesh.event(shard.rank)
        ev.record(torch.cuda.current_stream(shard.device))
    return snap, [tuple(x.shape) for x in xs], ev


def _take(shard: _Shard, posted):
    """The tensors of a post, as this shard may use them on its current
    stream (read after the sender's snapshot; memory kept from reuse
    while this stream may read it)."""
    snap, shapes, ev = posted
    if ev is not None:
        stream = torch.cuda.current_stream(shard.device)
        stream.wait_event(ev)
        snap.record_stream(stream)
        if snap.device != shard.device:
            # a peer copy: it runs on the source card's current stream,
            # which torch orders after this shard's stream
            snap.record_stream(torch.cuda.current_stream(snap.device))
            snap = snap.to(shard.device, non_blocking=True)
    elif snap.device != shard.device:
        snap = snap.to(shard.device)
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(snap[at:at + n].view(shape))
        at += n
    return out


def _gather(shard: _Shard, xs):
    return shard.group.gather(shard.rank, _post(shard, xs))


def ppermute_many(xs, name, perms):
    """Several ``jax.lax.ppermute`` calls along one axis in ONE round of
    the rendezvous: result ``i`` is ``xs[i]`` moved by ``perms[i]`` (the
    halo exchange's two shifts)."""
    shard = _shard()
    posted = _gather(shard, xs)
    me = axis_index(name)
    taken = {}
    out = []
    for i, (x, perm) in enumerate(zip(xs, perms)):
        src = [a for a, b in perm if b == me]
        if not src:
            out.append(torch.zeros_like(x))
            continue
        rank = _rank_at(shard, name, src[0])
        if rank not in taken:
            taken[rank] = _take(shard, posted[rank])
        out.append(taken[rank][i])
    return out


def ppermute(x, name, perm):
    """``jax.lax.ppermute``: the shard at index ``j`` along ``name``
    receives ``x`` of the shard at ``i`` for each pair ``(i, j)`` of
    ``perm``; a shard no pair names receives zeros."""
    return ppermute_many([x], name, [perm])[0]


def _group_values(shard: _Shard, x, names):
    """Every value posted for ``x`` by the shards that share this one's
    coordinates off ``names``, in rank order, ready on this shard."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, device=shard.device)
    posted = _gather(shard, [x])
    names = set(names if isinstance(names, tuple) else (names,))
    mine = shard.coords
    out = []
    for rank, c in enumerate(shard.mesh._coords):
        if all(c[n] == mine[n] for n in c if n not in names):
            out.append(_take(shard, posted[rank])[0])
    return out


def pmax(x, names):
    """``jax.lax.pmax`` over the mesh axes ``names`` (a NaN wins); a
    tensor result, as ``jax.lax``'s is an array."""
    vals = _group_values(_shard(), x, names)
    acc = vals[0]
    for v in vals[1:]:
        acc = torch.maximum(acc, v)
    return acc


def psum(x, names):
    """``jax.lax.psum`` over the mesh axes ``names``, summed in rank
    order on every shard (so every shard holds the same bits); a tensor
    result."""
    vals = _group_values(_shard(), x, names)
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


def launch_group(tensors: Sequence[torch.Tensor],
                 launch: Callable[[list], object]) -> None:
    """One kernel launch for every shard of the mesh (K4's launch group):
    each shard posts its LIVE ``tensors`` (not a snapshot: the launch
    writes them in place) and the leader, rank 0, calls ``launch`` once
    with every shard's list in rank order. On CUDA each shard records
    its event after its pending work and the leader's stream waits on
    every one before the launch; the leader records an event after it,
    which every shard's stream waits on before it goes on, and
    ``record_stream`` keeps each shard's memory from reuse while the
    leader's stream may still use it. On the CPU the same rendezvous
    runs ``launch`` (the kernel's twin) once for all shards. The
    rendezvous keeps the collectives' abort and timeout rules. A mesh
    whose shards sit on more than one device raises: a launch group
    spans one card, and cross-card K4 is not ported."""
    shard = _shard()
    if len(set(shard.mesh.device_list())) > 1:
        raise NotImplementedError(
            "the in-kernel exchange (K4) runs every shard of a mesh in one "
            "launch on one device; shards on several devices are not "
            "ported yet (ROADMAP queue 1 item 8g)")
    ev = None
    if shard.cuda:
        ev = shard.mesh.event(shard.rank)
        ev.record(torch.cuda.current_stream(shard.device))
    posts = shard.group.gather(shard.rank, (list(tensors), ev))
    done = None
    if shard.rank == 0:
        if shard.cuda:
            stream = torch.cuda.current_stream(shard.device)
            for _, e in posts:
                stream.wait_event(e)
        launch([ts for ts, _ in posts])
        if shard.cuda:
            done = torch.cuda.Event()
            done.record(stream)
            for ts, _ in posts:
                for t in ts:
                    t.record_stream(stream)
    dones = shard.group.gather(shard.rank, done)
    if shard.cuda:
        torch.cuda.current_stream(shard.device).wait_event(dones[0])


@contextlib.contextmanager
def exchange_stream():
    """Inside a CUDA shard: run the block on the shard's exchange stream,
    ordered after everything issued so far on its compute stream, so the
    compute stream goes on (the split schedule's interior call) while the
    exchange is in flight. :func:`wait_exchange` joins the two. Outside a
    CUDA shard it does nothing."""
    shard = current_shard()
    if shard is None or not shard.cuda:
        yield
        return
    compute, xs = shard.mesh.streams(shard.rank)
    xs.wait_stream(compute)
    with torch.cuda.stream(xs):
        yield


def wait_exchange(*tensors) -> None:
    """Order this shard's compute stream after its exchange stream, and
    mark ``tensors`` (what the exchange produced) as used on the compute
    stream, so their memory is not reused before it has read them (a
    no-op outside a CUDA shard)."""
    shard = current_shard()
    if shard is not None and shard.cuda:
        compute, xs = shard.mesh.streams(shard.rank)
        compute.wait_stream(xs)
        for t in tensors:
            t.record_stream(compute)


def shard_map(fn: Callable, mesh: Mesh, in_specs: Sequence,
              out_specs: Sequence):
    """Run ``fn`` on every shard of ``mesh`` (``jax.shard_map``).

    ``in_specs``/``out_specs`` hold one entry an argument/result: a
    :class:`Decomposition` for a field sharded by it (an argument is a
    :class:`~models.state.ShardedArray` of this mesh, or a global tensor
    that is scattered; a result is gathered into a ``ShardedArray``), or
    ``None`` for a value every shard shares (an argument is passed
    through; a result is shard 0's — ``fn`` computes it alike on every
    shard). ``fn`` returns a tuple of as many results as ``out_specs``.
    """
    from multigpu_advectiondiffusion_tpu_torch.models.state import (
        ShardedArray,
    )

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError("one in_spec an argument")
        local = []
        for arg, spec in zip(args, in_specs):
            if spec is not None and not isinstance(arg, ShardedArray):
                arg = ShardedArray.scatter(arg, mesh, spec)
            local.append(arg)
        results = run_shards(mesh, lambda rank: fn(*(
            a.shards[rank] if s is not None else a
            for a, s in zip(local, in_specs))))
        outs = []
        for i, spec in enumerate(out_specs):
            if spec is None:
                outs.append(results[0][i])
            else:
                outs.append(ShardedArray(
                    [r[i] for r in results], mesh, spec,
                    _global_shape(mesh, spec, results[0][i].shape)))
        return tuple(outs)

    return call


def _global_shape(mesh: Mesh, decomp: Decomposition, local_shape):
    out = list(local_shape)
    for ax, name in decomp.axes:
        out[ax] *= axis_extent(mesh.shape, name)
    return tuple(out)


def run_shards(mesh: Mesh, body: Callable[[int], object]) -> list:
    """``body(rank)`` on one thread a shard; returns the results in rank
    order, or raises the first failing shard's exception (its rank
    named). On CUDA each shard runs on its own stream, which first waits
    for the caller's pending work on that device; the caller's streams
    wait for every shard's before this returns."""
    n = mesh.size
    devices = mesh.device_list()
    group = _Rendezvous(n, mesh.timeout)
    starts = {}
    for dev in devices:
        if dev.type == "cuda" and dev not in starts:
            starts[dev] = torch.cuda.Event()
            starts[dev].record(torch.cuda.current_stream(dev))
    results = [None] * n
    errors = [None] * n
    ends = [None] * n

    def work(rank: int) -> None:
        dev = devices[rank]
        _local.shard = _Shard(mesh, rank, dev, group)
        try:
            group.take_baton()
        except TimeoutError as exc:
            errors[rank] = exc
            return
        try:
            if dev.type == "cuda":
                compute, _ = mesh.streams(rank)
                with torch.cuda.device(dev), torch.cuda.stream(compute):
                    compute.wait_event(starts[dev])
                    results[rank] = body(rank)
                    ends[rank] = torch.cuda.Event()
                    ends[rank].record(compute)
            else:
                results[rank] = body(rank)
        except BaseException as exc:  # re-raised in the caller below
            errors[rank] = exc
            group.abort(exc)
        finally:
            _local.shard = None
            group.give_baton()

    threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                name=f"shard-{r}") for r in range(n)]
    for t in threads:
        t.start()
    _join(threads, group, mesh.timeout)
    failed = [(r, e) for r, e in enumerate(errors) if e is not None]
    if failed:
        rank, exc = next(((r, e) for r, e in failed
                          if not isinstance(e, ShardAborted)), failed[0])
        if hasattr(exc, "add_note"):
            exc.add_note(f"(raised in shard {rank} of {n})")
        raise exc
    for rank, dev in enumerate(devices):
        if ends[rank] is not None:
            torch.cuda.current_stream(dev).wait_event(ends[rank])
    return results


def _join(threads, group: _Rendezvous, timeout: float) -> None:
    """Join every shard thread. Shards end by themselves (every wait at a
    collective times out); once one has failed, the others get
    ``timeout`` seconds to reach a collective and abort, else this
    raises rather than wait on."""
    deadline = None
    for t in threads:
        while t.is_alive():
            t.join(0.5)
            if group.error is not None and deadline is None:
                deadline = time.monotonic() + timeout
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{t.name} did not stop {timeout} s after another "
                    "shard failed") from group.error
