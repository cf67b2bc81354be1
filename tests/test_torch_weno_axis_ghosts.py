"""The per-axis WENO kernel's entry on unpadded arrays (K12/K12b,
``ops/kernels/weno.py``), on the CPU, where it runs its twin.

* The twin equals, bit for bit, the composition the per-axis rung made
  before the ghosts, the sum and the sign moved into the kernel:
  ``core.bc.pad_axis`` -> ``flux_divergence_reference`` -> ``acc + div``
  -> the negation. Every boundary kind (edge, periodic, Dirichlet with a
  non-zero value) x every sweep axis x WENO5-JS, WENO5-Z and WENO7-JS x
  2-D and 3-D x the three stores, on odd shapes.
* The ghost-slab source (a sharded axis) equals the boundary source when
  the slabs are what the halo exchange hands a global edge
  (``core.bc.boundary_halo``) or, on a periodic axis, a wrapped slice of
  ``u``.
* A CUDA tensor never runs the twin: without a card the launch raises.
"""

import numpy as np
import pytest
import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import (
    Boundary,
    boundary_halo,
    pad_axis,
)
from multigpu_advectiondiffusion_tpu_torch.ops import flux as pflux
from multigpu_advectiondiffusion_tpu_torch.ops import weno as pweno
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import weno as kweno

torch.set_num_threads(1)

DX = 0.07
SHAPES = {3: (10, 12, 14), 2: (18, 20)}
SWEEPS = [(3, 0), (3, 1), (3, 2), (2, 0), (2, 1)]
BCS = {"edge": Boundary("edge"), "periodic": Boundary("periodic"),
       "dirichlet": Boundary("dirichlet", 0.37)}
SCHEMES = [(5, "js"), (5, "z"), (7, "js")]
STORES = ["div", "sum", "negated-sum"]


def _data(ndim, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.1, 1.1, SHAPES[ndim]).astype(np.float32)
    acc = rng.standard_normal(SHAPES[ndim]).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(acc)


def _entry(ndim):
    return kweno.flux_divergence_3d if ndim == 3 else kweno.flux_divergence_2d


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("order,variant", SCHEMES)
@pytest.mark.parametrize("ndim,axis", SWEEPS)
@pytest.mark.parametrize("kind", list(BCS))
def test_twin_equals_the_padded_composition(kind, ndim, axis, order,
                                            variant, store):
    bc = BCS[kind]
    fx = pflux.burgers()
    u, acc = _data(ndim, seed=100 * ndim + 10 * axis + order)
    div = kweno.flux_divergence_reference(
        pad_axis(u, axis, kweno.HALO[order], bc), axis, DX, fx, variant,
        order)
    want = div if store == "div" else acc + div
    if store == "negated-sum":
        want = -want
    fn = _entry(ndim)
    launches = fn.launches
    target = None if store == "div" else acc.clone()
    got = fn(u, axis, DX, fx, variant, order, bc=bc, acc=target,
             negate=store == "negated-sum")
    assert fn.launches == launches  # the CPU runs the twin, no kernel
    assert torch.equal(got, want)
    if target is not None:  # the running sum is updated in place
        assert got is target
    # the operator dispatches to the same entry
    op = pweno.flux_divergence(u, axis, DX, fx, order=order, variant=variant,
                               bc=bc, impl="pallas",
                               acc=None if target is None else acc.clone(),
                               negate=store == "negated-sum")
    assert torch.equal(op, want)


def _slabs(u, axis, r, bc):
    """The (lo, hi) a halo exchange hands a shard that holds the whole
    axis: the boundary's ghosts, or the wrapped neighbours."""
    n = u.shape[axis]
    if bc.kind == "periodic":
        return (u.narrow(axis, n - r, r).contiguous(),
                u.narrow(axis, 0, r).contiguous())
    return (boundary_halo(u, axis, r, bc, "left").contiguous(),
            boundary_halo(u, axis, r, bc, "right").contiguous())


@pytest.mark.parametrize("order,variant", SCHEMES)
@pytest.mark.parametrize("ndim,axis", SWEEPS)
@pytest.mark.parametrize("kind", list(BCS))
def test_slab_ghosts_equal_boundary_ghosts(kind, ndim, axis, order,
                                           variant):
    bc = BCS[kind]
    fx = pflux.get("buckley") if order == 7 else pflux.linear(c=-0.7)
    u, acc = _data(ndim, seed=7 + axis)
    fn = _entry(ndim)
    want = fn(u, axis, DX, fx, variant, order, bc=bc, acc=acc.clone())
    got = fn(u, axis, DX, fx, variant, order,
             ghosts=_slabs(u, axis, kweno.HALO[order], bc), acc=acc.clone())
    assert torch.equal(got, want)


def test_operand_checks():
    u, acc = _data(3, 0)
    fx = pflux.burgers()
    bc = BCS["edge"]
    with pytest.raises(ValueError, match="exactly one ghost source"):
        kweno.flux_divergence_3d(u, 0, DX, fx, bc=bc,
                                 ghosts=_slabs(u, 0, 3, bc))
    with pytest.raises(ValueError, match="ghost slab lo"):
        kweno.flux_divergence_3d(u, 0, DX, fx, ghosts=_slabs(u, 1, 3, bc))
    with pytest.raises(ValueError, match="acc"):
        kweno.flux_divergence_3d(u, 0, DX, fx, bc=bc, acc=acc[:5])
    with pytest.raises(ValueError, match="give acc"):
        kweno.flux_divergence_3d(u, 0, DX, fx, bc=bc, negate=True)
    with pytest.raises(ValueError, match="2-D array expected"):
        kweno.flux_divergence_2d(u, 0, DX, fx, bc=bc)
    with pytest.raises(ValueError, match="not a padder"):
        pweno.flux_divergence(u, 0, DX, fx, impl="pallas",
                              padder=lambda x, a, h: pad_axis(x, a, h, bc))


def test_cuda_tensor_without_a_card_raises(monkeypatch):
    """A CUDA tensor launches the kernel or raises: the twin is never its
    fallback."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def twin(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(kweno, "flux_divergence_axis_reference", twin)
    with FakeTensorMode(allow_non_fake_inputs=True):
        u = torch.empty(SHAPES[3], device="cuda")
    assert u.device.type == "cuda"
    launches = kweno.flux_divergence_3d.launches
    with pytest.raises(RuntimeError):
        kweno.flux_divergence_3d(u, 1, DX, pflux.burgers(), bc=BCS["edge"])
    assert kweno.flux_divergence_3d.launches == launches
