"""The port's halo exchange (``parallel/halo.py``) against the JAX
package's under ``jax.shard_map`` on 4 CPU devices, to the bit (0
difference): ``exchange_ghosts`` (the ppermute pair, boundary ghosts on
the global-edge shards, periodic wrap), ``exchange_axis``/``make_padder``
and ``make_ghost_refresh`` (with ``core_offsets``) for Dirichlet, edge
and periodic walls, at the per-step depth G and the k-step depth k·G;
``axis_offsets``; and the bytes counter.

Every port mesh here has a timeout of a few seconds: a deadlock fails
its test, not the suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from multigpu_advectiondiffusion_tpu.core.bc import Boundary as JBoundary
from multigpu_advectiondiffusion_tpu.parallel import halo as jhalo
from multigpu_advectiondiffusion_tpu.parallel import mesh as jmesh
from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.parallel import halo as phalo
from multigpu_advectiondiffusion_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
BCS = {"dirichlet": ("dirichlet", 0.3), "edge": ("edge", 0.0),
       "periodic": ("periodic", 0.0)}
# (depth, local z): the per-step halo G of diffusion's slab rung and the
# k-step depth 3 G, each on shards deep enough to serve it
DEPTHS = [(6, 8), (18, 18)]
MESHES = [({"dz": 4}, {0: "dz"}), ({"dz": 2, "dy": 2}, {0: "dz", 1: "dy"})]


def _meshes(devices, sizes):
    n = int(np.prod(list(sizes.values())))
    return (jmesh.make_mesh(sizes, devices=devices[:n]),
            pmesh.make_mesh(sizes, devices=[CPU] * n, timeout=20.0))


def _spec(mapping):
    return P(*[mapping.get(ax) for ax in range(3)])


def _field(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("sizes,mapping", MESHES)
@pytest.mark.parametrize("depth,lz", DEPTHS)
@pytest.mark.parametrize("bc", list(BCS))
def test_exchange_ghosts_matches_jax(devices, bc, depth, lz, sizes, mapping):
    kind, value = BCS[bc]
    jm, pm = _meshes(devices, sizes)
    x = _field((lz * sizes["dz"], 6, 5), depth)
    nz = sizes["dz"]
    spec = _spec(mapping)

    def jbody(u):
        lo, hi = jhalo.exchange_ghosts(u, 0, depth, "dz", nz,
                                       JBoundary(kind, value))
        return lo, hi

    f = jax.jit(jmesh.shard_map(jbody, mesh=jm, in_specs=(spec,),
                                out_specs=(spec, spec)))
    want = [np.asarray(o) for o in f(jnp.asarray(x))]

    def pbody(u):
        return phalo.exchange_ghosts(u, 0, depth, "dz", nz,
                                     Boundary(kind, value))

    d = pmesh.Decomposition.of(mapping)
    before = phalo.exchange_ghosts.bytes_per_execution.value
    got = pmesh.shard_map(pbody, pm, (d,), (d, d))(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    # two depth-deep slabs sent by each shard
    sent = phalo.exchange_ghosts.bytes_per_execution.value - before
    block = (depth * 6 * 5 // (2 if "dy" in sizes else 1)) * 4
    assert sent == pm.size * 2 * block


@pytest.mark.parametrize("depth,lz", DEPTHS)
@pytest.mark.parametrize("bc", list(BCS))
def test_padder_matches_jax(devices, bc, depth, lz):
    """``make_padder`` on a pencil mesh: the z axis exchanged, y padded
    from the neighbour too, x padded with the boundary's ghosts."""
    kind, value = BCS[bc]
    sizes, mapping = MESHES[1]
    jm, pm = _meshes(devices, sizes)
    x = _field((lz * 2, 12, 5), 3 + depth)
    spec = _spec(mapping)
    jd, pd = jmesh.Decomposition.of(mapping), pmesh.Decomposition.of(mapping)
    jb, pb = [JBoundary(kind, value)] * 3, [Boundary(kind, value)] * 3

    def jbody(u):
        jp = jhalo.make_padder(jd, dict(jm.shape), jb)
        return jp(jp(jp(u, 0, depth), 1, 3), 2, 2)

    f = jax.jit(jmesh.shard_map(jbody, mesh=jm, in_specs=(spec,),
                                out_specs=spec))
    want = np.asarray(f(jnp.asarray(x)))

    def pbody(u):
        pp = phalo.make_padder(pd, pm.shape, pb)
        return (pp(pp(pp(u, 0, depth), 1, 3), 2, 2),)

    (got,) = pmesh.shard_map(pbody, pm, (pd,), (pd,))(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth,lz", DEPTHS)
@pytest.mark.parametrize("bc", list(BCS))
def test_ghost_refresh_matches_jax(devices, bc, depth, lz):
    """``make_ghost_refresh`` rewrites a padded buffer's sharded-axis
    ghosts (z and y, ``depth`` deep; x frozen, its core 3 in) with
    ``core_offsets``; the port writes them in place."""
    kind, value = BCS[bc]
    sizes, mapping = MESHES[1]
    jm, pm = _meshes(devices, sizes)
    core = (lz, lz, 5)
    offs = (depth, depth, 3)
    padded = (lz + 2 * depth, lz + 2 * depth, 5 + 6)
    x = _field((padded[0] * 2, padded[1] * 2, padded[2]), 11 + depth)
    spec = _spec(mapping)
    jd, pd = jmesh.Decomposition.of(mapping), pmesh.Decomposition.of(mapping)
    jb, pb = [JBoundary(kind, value)] * 3, [Boundary(kind, value)] * 3

    def jbody(S):
        refresh = jhalo.make_ghost_refresh(jd, dict(jm.shape), jb, depth,
                                           core, core_offsets=offs)
        return refresh(S)

    f = jax.jit(jmesh.shard_map(jbody, mesh=jm, in_specs=(spec,),
                                out_specs=spec))
    want = np.asarray(f(jnp.asarray(x)))

    def pbody(S):
        refresh = phalo.make_ghost_refresh(pd, pm.shape, pb, depth, core,
                                           core_offsets=offs)
        assert refresh(S) is S  # in place
        return (S,)

    (got,) = pmesh.shard_map(pbody, pm, (pd,), (pd,))(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)


def test_axis_offsets_and_boundary_halo(devices):
    sizes, mapping = MESHES[1]
    _, pm = _meshes(devices, sizes)
    pd = pmesh.Decomposition.of(mapping)

    def body(u):
        offs = phalo.axis_offsets(pd, (4, 3, 5))
        return (torch.tensor(offs, dtype=torch.float32).reshape(1, 1, 3),)

    (got,) = pmesh.shard_map(body, pm, (pd,), (pd,))(torch.zeros(2, 2, 3))
    assert got.numpy().reshape(2, 2, 3).tolist() == [
        [[0, 0, 0], [0, 3, 0]], [[4, 0, 0], [4, 3, 0]]]
    from multigpu_advectiondiffusion_tpu.core.bc import (
        boundary_halo as jboundary_halo,
    )
    from multigpu_advectiondiffusion_tpu_torch.core.bc import boundary_halo

    x = _field((5, 4, 3), 1)
    for kind, value in (("dirichlet", 0.3), ("edge", 0.0)):
        for side in ("left", "right"):
            want = np.asarray(jboundary_halo(jnp.asarray(x), 1, 2,
                                             JBoundary(kind, value), side))
            got = boundary_halo(torch.from_numpy(x), 1, 2,
                                Boundary(kind, value), side)
            assert np.array_equal(got.numpy(), want)
    assert phalo.exchange_spec() == jhalo.exchange_spec()


@pytest.mark.parametrize("bc", ["dirichlet", "edge"])
def test_bf16_wires_match_jax(devices, bc):
    """The bf16 wire (``wire_dtype``): the exchanged slabs and the edge
    shards' boundary ghosts rounded to bf16 and back, equal to the JAX
    package's to the bit; the counter adds the bf16 slabs' bytes."""
    kind, value = BCS[bc]
    sizes, mapping = MESHES[0]
    jm, pm = _meshes(devices, sizes)
    x = _field((8 * 4, 6, 5), 3)
    spec = _spec(mapping)

    def jbody(u):
        return jhalo.exchange_ghosts(u, 0, 6, "dz", 4,
                                     JBoundary(kind, value),
                                     wire_dtype=jnp.bfloat16)

    f = jax.jit(jmesh.shard_map(jbody, mesh=jm, in_specs=(spec,),
                                out_specs=(spec, spec)))
    want = [np.asarray(o) for o in f(jnp.asarray(x))]

    def pbody(u):
        return phalo.exchange_ghosts(u, 0, 6, "dz", 4,
                                     Boundary(kind, value),
                                     wire_dtype=torch.bfloat16)

    d = pmesh.Decomposition.of(mapping)
    before = phalo.exchange_ghosts.bytes_per_execution.value
    got = pmesh.shard_map(pbody, pm, (d,), (d, d))(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), w)
        assert np.array_equal(w, torch.tensor(w).bfloat16().float())
    assert phalo.exchange_ghosts.bytes_per_execution.value - before == (
        4 * 2 * 6 * 6 * 5 * 2)
