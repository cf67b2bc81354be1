"""PyTorch + CUDA port of ``multigpu_advectiondiffusion_tpu``.

The JAX package beside this one is the reference; this package keeps
its module paths, class names, config fields and ``impl`` strings so
that one config builds both solvers and each counterpart is easy to
find. It imports ``torch`` and numpy, never ``jax`` and never the JAX
package.

Ported so far: the 3-D diffusion main path on one device — the
generic PyTorch path (``impl="xla"``) and the fused per-stage rung
(``impl="pallas"``/``"pallas_stage"``) whose stage kernel is a
hand-written CUDA kernel for Hopper (``csrc/fused_diffusion_stage.cu``).

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig,
    DiffusionSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import SolverState

__all__ = [
    "Boundary",
    "DiffusionConfig",
    "DiffusionSolver",
    "Grid",
    "SolverState",
]
