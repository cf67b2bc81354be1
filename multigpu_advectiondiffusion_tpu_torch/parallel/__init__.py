"""Device meshes, decompositions, the shard runtime and the halo
exchange (JAX ``parallel/`` counterpart; ``multihost.py`` is not
ported: one process drives every shard)."""

from multigpu_advectiondiffusion_tpu_torch.parallel.halo import (
    exchange_axis,
    make_padder,
)
from multigpu_advectiondiffusion_tpu_torch.parallel.mesh import (
    Decomposition,
    Mesh,
    make_mesh,
    shard_map,
)

__all__ = [
    "Decomposition",
    "Mesh",
    "make_mesh",
    "shard_map",
    "exchange_axis",
    "make_padder",
]
