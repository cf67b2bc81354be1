"""PyTorch + CUDA port of ``multigpu_advectiondiffusion_tpu``.

The JAX package beside this one is the reference; this package keeps
its module paths, class names, config fields and ``impl`` strings so
that one config builds both solvers and each counterpart is easy to
find. It imports ``torch`` and numpy, never ``jax`` and never the JAX
package.

Ported so far, on one device, each with the generic PyTorch path
(``impl="xla"``) and a fused rung (``impl="pallas"``) whose kernel is
hand-written CUDA for Hopper:

* 3-D diffusion, one launch per RK stage
  (``csrc/fused_diffusion_stage.cu``, K1);
* 3-D Burgers / scalar conservation laws with WENO5, one launch per RK
  stage (``csrc/fused_burgers_stage.cu``, K5); WENO7 on the generic path;
* 2-D diffusion and 2-D Burgers/WENO5, one cooperative launch per run
  (``csrc/whole_run_diffusion2d.cu`` and ``csrc/whole_run_burgers2d.cu``,
  K7 and K7a).

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig,
    BurgersSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig,
    DiffusionSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import SolverState

__all__ = [
    "Boundary",
    "BurgersConfig",
    "BurgersSolver",
    "DiffusionConfig",
    "DiffusionSolver",
    "Grid",
    "SolverState",
]
