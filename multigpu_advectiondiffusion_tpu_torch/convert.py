"""Carry configs and states between the JAX package and this port.

A solver has no weights; what one package hands the other is a config
and a state. Both cross as plain data — field dicts and numpy arrays —
so this module needs neither package's framework from the other side:

* :func:`config_from_fields` builds a :class:`DiffusionConfig` from the
  fields of a JAX config (``dataclasses.asdict(cfg)`` or ``vars(cfg)``),
  :func:`burgers_config_from_fields` a :class:`BurgersConfig` and
  :func:`adr_config_from_fields` an :class:`ADRConfig`;
* :func:`state_from_numpy` / :func:`state_to_numpy` move a state
  ``(u, t, it)`` in and out as numpy, keeping ``t``'s precision; with
  ``mesh=``/``decomp=`` the field is scattered onto the mesh's shards
  (and gathered back).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.adr import ADRConfig
from multigpu_advectiondiffusion_tpu_torch.models.base import resolve_device
from multigpu_advectiondiffusion_tpu_torch.models.burgers import BurgersConfig
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import (
    ShardedArray,
    SolverState,
    time_dtype,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
    Decomposition,
)


def _grid(g) -> Grid:
    """A grid from a field dict (``{"shape", "bounds"}``) or any object
    with ``shape``/``bounds`` attributes."""
    shape = g["shape"] if isinstance(g, dict) else g.shape
    bounds = g["bounds"] if isinstance(g, dict) else g.bounds
    return Grid(shape=tuple(int(n) for n in shape),
                bounds=tuple((float(lo), float(hi)) for lo, hi in bounds))


def _bc(spec):
    if isinstance(spec, str):
        return spec
    if isinstance(spec, (list, tuple)):
        return tuple(_bc(s) for s in spec)
    if isinstance(spec, dict):
        return Boundary(**spec)
    return Boundary(kind=spec.kind, value=float(spec.value))


def _from_fields(cls, fields: dict):
    """A port config of ``cls`` from a JAX config's fields. Unknown
    fields raise, so a field added on one side cannot be dropped
    silently."""
    fields = dict(fields)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(
            f"fields the port's {cls.__name__} lacks: {unknown}")
    fields["grid"] = _grid(fields["grid"])
    if "bc" in fields:
        fields["bc"] = _bc(fields["bc"])
    for name in ("ic_params", "flux_params"):
        if name in fields:
            fields[name] = tuple(fields[name])
    return cls(**fields)


def config_from_fields(fields: dict) -> DiffusionConfig:
    """A port config from a JAX ``DiffusionConfig``'s fields."""
    return _from_fields(DiffusionConfig, fields)


def burgers_config_from_fields(fields: dict) -> BurgersConfig:
    """A port config from a JAX ``BurgersConfig``'s fields."""
    return _from_fields(BurgersConfig, fields)


def adr_config_from_fields(fields: dict) -> ADRConfig:
    """A port config from a JAX ``ADRConfig``'s fields; a velocity list
    (as ``dataclasses.asdict`` leaves a tuple) stays a tuple."""
    fields = dict(fields)
    if isinstance(fields.get("velocity"), list):
        fields["velocity"] = tuple(fields["velocity"])
    return _from_fields(ADRConfig, fields)


def state_from_numpy(u, t, it=0, device=None, mesh=None,
                     decomp=None) -> SolverState:
    """A port state from numpy ``u`` (``(nz, ny, nx)``, float32/float64),
    time ``t`` and step count ``it``; ``device=None`` means the GPU.
    With ``mesh`` the field is scattered onto its shards (``decomp``
    defaulting to slabs of array axis 0 over the mesh's first axis, as
    a solver's does) and ``device`` must be ``None``."""
    arr = np.array(u, order="C")  # a writable copy the tensor may own
    if arr.dtype not in (np.float32, np.float64):
        raise TypeError(f"float32/float64 field expected, got {arr.dtype}")
    if mesh is not None:
        if device is not None:
            raise ValueError("a mesh names its devices; pass device=None")
        for dev in mesh.device_list():
            resolve_device(dev)
        decomp = decomp or Decomposition.slab(tuple(mesh.shape)[0])
        ut = ShardedArray.scatter(torch.from_numpy(arr), mesh, decomp)
    else:
        ut = torch.from_numpy(arr).to(resolve_device(device))
    return SolverState(u=ut, t=time_dtype(ut.dtype)(t), it=int(it))


def state_to_numpy(state: SolverState):
    """``(u, t, it)`` as a numpy array (a sharded field gathered), a
    numpy scalar and an int."""
    u = state.u
    if isinstance(u, ShardedArray):
        return u.numpy(), state.t, int(state.it)
    return u.detach().cpu().numpy(), state.t, int(state.it)
