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
  (and gathered back). numpy has no bfloat16 here (the port does not
  depend on ``ml_dtypes``), so a bf16 state crosses as a float32 array
  whose values are bf16-representable: ``dtype="bfloat16"`` checks that
  and converts it, and a bf16 state comes out as such an array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.core.dtypes import canonicalize
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


def _to_bf16(arr: np.ndarray) -> torch.Tensor:
    """A float32 array of bf16-representable values as a bf16 tensor;
    raises where a value would round (NaNs pass as NaNs)."""
    if arr.dtype != np.float32:
        raise TypeError("a bfloat16 field crosses as a float32 array of "
                        f"bf16-representable values, got {arr.dtype}")
    t = torch.from_numpy(arr).to(torch.bfloat16)
    back = t.float().numpy()
    exact = (back == arr) | (np.isnan(back) & np.isnan(arr))
    if not exact.all():
        raise ValueError(
            f"{int((~exact).sum())} values are not bf16-representable "
            "(round them to bfloat16 first)")
    return t


def state_from_numpy(u, t, it=0, device=None, mesh=None,
                     decomp=None, dtype=None) -> SolverState:
    """A port state from numpy ``u`` (``(nz, ny, nx)``, float32/float64),
    time ``t`` and step count ``it``; ``device=None`` means the GPU.
    With ``mesh`` the field is scattered onto its shards (``decomp``
    defaulting to slabs of array axis 0 over the mesh's first axis, as
    a solver's does) and ``device`` must be ``None``. ``dtype=
    "bfloat16"`` makes a bf16 state from a float32 array of
    bf16-representable values (``t`` then float32, as the JAX package
    keeps it)."""
    arr = np.array(u, order="C")  # a writable copy the tensor may own
    if arr.dtype not in (np.float32, np.float64):
        raise TypeError(f"float32/float64 field expected, got {arr.dtype}")
    if dtype is not None and canonicalize(dtype) == torch.bfloat16:
        host = _to_bf16(arr)
    else:
        host = torch.from_numpy(arr)
    if mesh is not None:
        if device is not None:
            raise ValueError("a mesh names its devices; pass device=None")
        for dev in mesh.device_list():
            resolve_device(dev)
        decomp = decomp or Decomposition.slab(tuple(mesh.shape)[0])
        ut = ShardedArray.scatter(host, mesh, decomp)
    else:
        ut = host.to(resolve_device(device))
    return SolverState(u=ut, t=time_dtype(ut.dtype)(t), it=int(it))


def state_to_numpy(state: SolverState):
    """``(u, t, it)`` as a numpy array (a sharded field gathered; a bf16
    field as float32), a numpy scalar and an int."""
    u = state.u
    if isinstance(u, ShardedArray):
        u = u.assemble("cpu")
    u = u.detach().cpu()
    if u.dtype == torch.bfloat16:
        u = u.float()
    return u.numpy(), state.t, int(state.it)
