"""The port's device meshes (``parallel/mesh.py``) against the JAX
package's: ``Decomposition``, ``make_mesh``, ``local_shape``, the
``validate`` errors and ``reduce_axis_names`` equal JAX's; the port's
``shard_map`` runs one function on every shard, and inside it
``axis_index``, ``ppermute``, ``pmax`` and ``psum`` give ``jax.lax``'s
results under ``jax.shard_map`` on the same number of CPU devices, to
the bit (integer-valued data, so every sum is exact). A shard that
raises, or a shard that misses a collective, fails the caller within
the mesh's timeout instead of hanging.

Every test that starts shard threads builds its mesh with a timeout of
a few seconds: a deadlock fails that test, not the suite.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch.models.state import ShardedArray
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
TIMEOUT = 20.0  # seconds a shard waits at a collective in these tests


def _pmesh(sizes, timeout=TIMEOUT):
    n = int(np.prod(list(sizes.values())))
    return pmesh.make_mesh(sizes, devices=[CPU] * n, timeout=timeout)


DECOMPS = [
    ({"dz": 4}, {0: "dz"}),
    ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"}),
    ({"dz": 2, "dy": 2, "dx": 2}, {0: "dz", 1: "dy", 2: "dx"}),
    ({"dz_dcn": 2, "dz_ici": 2}, {0: ("dz_dcn", "dz_ici")}),
    ({"dz": 2, "dy": 1}, {0: "dz", 1: "dy"}),
]


@pytest.mark.parametrize("sizes,mapping", DECOMPS)
def test_decomposition_and_mesh_match_jax(devices, sizes, mapping):
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(sizes, devices=devices[:n])
    pm = _pmesh(sizes)
    jd, pd = jmesh.Decomposition.of(mapping), pmesh.Decomposition.of(mapping)
    assert dict(jm.shape) == pm.shape and pm.size == n
    assert pd.axes == jd.axes and pd.mapping == jd.mapping
    assert pd.mesh_axis_names() == jd.mesh_axis_names()
    for ax in range(3):
        assert pd.mesh_axis(ax) == jd.mesh_axis(ax)
    shape = (16, 12, 8)
    jd.validate(jm, shape)
    pd.validate(pm, shape)
    assert pd.local_shape(pm, shape) == jd.local_shape(jm, shape)
    assert (pmesh.reduce_axis_names(pd, pm.shape)
            == jmesh.reduce_axis_names(jd, jm.shape))
    for _, name in pd.axes:
        assert (pmesh.axis_extent(pm.shape, name)
                == jmesh.axis_extent(jm.shape, name))
    assert pmesh.member_extent(pm) == jmesh.member_extent(jm) == 1
    assert pmesh.Decomposition.slab().axes == jmesh.Decomposition.slab().axes


@pytest.mark.parametrize("sizes,mapping,shape", [
    ({"dz": 4}, {0: "dz"}, (10, 8, 8)),
    ({"dz": 2}, {0: "dq"}, (8, 8, 8)),
    ({"dz": 2, "dy": 2}, {1: ("dz", "dy")}, (8, 6, 8)),
])
def test_validate_errors_match_jax(devices, sizes, mapping, shape):
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(sizes, devices=devices[:n])
    with pytest.raises(ValueError) as want:
        jmesh.Decomposition.of(mapping).validate(jm, shape)
    with pytest.raises(ValueError) as got:
        pmesh.Decomposition.of(mapping).validate(_pmesh(sizes), shape)
    assert str(got.value) == str(want.value)


def test_make_mesh_devices(devices, monkeypatch):
    """A repeated explicit device list is allowed (the CPU tests' and
    the one-card runs' counterpart of the forced host-device count);
    too few devices raises as in JAX — with no GPU visible, none."""
    m = pmesh.make_mesh({"dz": 2, "dy": 2}, devices=["cpu"] * 5)
    assert m.device_list() == [CPU] * 4 and m.shape == {"dz": 2, "dy": 2}
    assert m.coords(3) == {"dz": 1, "dy": 1} and m.rank_of(m.coords(2)) == 2
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh({"dz": 16}, devices=devices[:8])
    with pytest.raises(ValueError) as got:
        pmesh.make_mesh({"dz": 16}, devices=[CPU] * 8)
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="mesh needs 2 devices, only 0"):
        pmesh.make_mesh({"dz": 2})


def _jax_collectives(devices, sizes, x):
    """axis_index, the ppermute pair, pmax and psum of each shard under
    jax.shard_map; the field sharded on its leading axis over the first
    mesh axis."""
    names = tuple(sizes)
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(sizes, devices=devices[:n])
    ax = names[0]
    k = sizes[ax]
    fwd = [(i, (i + 1) % k) for i in range(k)]
    bwd = [((i + 1) % k, i) for i in range(k)]
    partial = [(i, i + 1) for i in range(k - 1)]

    def body(u):
        idx = lax.axis_index(ax)
        return (jnp.full(u.shape, idx, u.dtype), lax.ppermute(u, ax, fwd),
                lax.ppermute(u, ax, bwd), lax.ppermute(u, ax, partial),
                lax.pmax(u, names), lax.psum(u, names))

    spec = P(ax)
    f = jax.jit(jmesh.shard_map(body, mesh=jm, in_specs=(spec,),
                                out_specs=(spec,) * 6, check=False))
    return [np.asarray(o) for o in f(jnp.asarray(x))]


@pytest.mark.parametrize("sizes", [{"dz": 4}, {"dz": 2, "dy": 2}])
def test_collectives_match_jax(devices, sizes):
    rng = np.random.default_rng(0)
    x = rng.integers(-50, 50, (8, 3, 5)).astype(np.float32)
    want = _jax_collectives(devices, sizes, x)
    mesh = _pmesh(sizes)
    ax = tuple(sizes)[0]
    k = sizes[ax]
    fwd = [(i, (i + 1) % k) for i in range(k)]
    bwd = [((i + 1) % k, i) for i in range(k)]
    partial = [(i, i + 1) for i in range(k - 1)]
    names = tuple(sizes)

    def body(u):
        idx = pmesh.axis_index(ax)
        return (torch.full(u.shape, float(idx)), pmesh.ppermute(u, ax, fwd),
                pmesh.ppermute(u, ax, bwd), pmesh.ppermute(u, ax, partial),
                pmesh.pmax(u, names), pmesh.psum(u, names))

    d = pmesh.Decomposition.of({0: ax})
    outs = pmesh.shard_map(body, mesh, (d,), (d,) * 6)(torch.from_numpy(x))
    for g, w in zip(outs, want):
        assert isinstance(g, ShardedArray)
        assert np.array_equal(g.numpy(), w)


def test_sharded_array_scatter_assemble():
    mesh = _pmesh({"dz": 2, "dy": 2})
    d = pmesh.Decomposition.of({0: "dz", 1: "dy"})
    u = torch.arange(8 * 6 * 5, dtype=torch.float32).reshape(8, 6, 5)
    s = ShardedArray.scatter(u, mesh, d)
    assert [tuple(b.shape) for b in s.shards] == [(4, 3, 5)] * 4
    assert torch.equal(s.shards[3], u[4:, 3:])
    assert torch.equal(s.assemble(), u) and s.shape == (8, 6, 5)


def test_failing_shard_raises_in_caller():
    """A shard that raises aborts the rendezvous: the others leave their
    collective and the caller sees the failing shard's exception."""
    mesh = _pmesh({"dz": 4})
    d = pmesh.Decomposition.slab()

    def body(u):
        if pmesh.axis_index("dz") == 2:
            raise ArithmeticError("shard two failed")
        return (pmesh.pmax(u, ("dz",)),)

    t0 = time.monotonic()
    with pytest.raises(ArithmeticError, match="shard two failed"):
        pmesh.shard_map(body, mesh, (d,), (d,))(torch.zeros(8, 2, 2))
    assert time.monotonic() - t0 < TIMEOUT
    assert threading.active_count() < 50


def test_missed_collective_times_out():
    """A shard that skips a collective leaves the others waiting: they
    give up after the mesh's timeout with an error, not a hang."""
    mesh = _pmesh({"dz": 2}, timeout=0.5)
    d = pmesh.Decomposition.slab()

    def body(u):
        if pmesh.axis_index("dz") == 0:
            u = pmesh.pmax(u, ("dz",))
        return (u,)

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="collective"):
        pmesh.shard_map(body, mesh, (d,), (d,))(torch.zeros(4, 2, 2))
    assert time.monotonic() - t0 < 10.0


def test_collectives_outside_a_shard_raise():
    with pytest.raises(RuntimeError, match="inside shard_map"):
        pmesh.axis_index("dz")
    with pytest.raises(RuntimeError, match="inside shard_map"):
        pmesh.pmax(torch.zeros(()), ("dz",))
