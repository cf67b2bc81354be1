"""PyTorch + CUDA port of ``multigpu_advectiondiffusion_tpu``.

The JAX package beside this one is the reference; this package keeps
its module paths, class names, config fields and ``impl`` strings so
that one config builds both solvers and each counterpart is easy to
find. It imports ``torch`` and numpy, never ``jax`` and never the JAX
package.

Ported so far, each family with the generic PyTorch path
(``impl="xla"``) and rungs whose kernels are hand-written CUDA for
Hopper (ids as in PERF.md's kernel table):

* 3-D diffusion: one launch per RK stage (K1,
  ``csrc/fused_diffusion_stage.cu``), per step (K10) or per run (K2,
  ``csrc/fused_step_diffusion.cu``);
* 3-D Burgers / scalar conservation laws with WENO5: one launch per RK
  stage (K5, ``csrc/fused_burgers_stage.cu``) or per fixed-dt run (K6,
  ``csrc/slab_run_burgers.cu``);
* 2-D diffusion and 2-D Burgers/WENO5: one cooperative launch per run
  (K7 and K7a, ``csrc/whole_run_diffusion2d.cu`` and
  ``csrc/whole_run_burgers2d.cu``);
* the per-axis rung of every family: the O4 Laplacian (K11/K11b,
  ``csrc/laplacian_o4.cu``) and the WENO5/7 flux divergence along one
  axis (K12/K12b, ``csrc/weno_axis.cu``);
* 3-D advection–diffusion–reaction: one launch per RK stage (K9,
  ``csrc/fused_adr_stage.cu``);
* the batched ensemble engine (:class:`EnsembleSolver`,
  ``models/ensemble.py``): B members per dispatch, uniform physics
  folded into one cooperative launch of the slab kernel with a member
  axis (K2b, ``csrc/fused_step_diffusion.cu`` and
  ``csrc/slab_run_burgers.cu``) or the stage kernel launched per member,
  member-varying scalars on the generic loop, differentiable by
  ``torch.autograd`` (``examples/inverse_diffusivity.py``).

* device meshes (``parallel/mesh.py``, ``parallel/halo.py``): one
  process drives every shard, one thread and CUDA stream a shard;
  every family runs the rungs the JAX package runs on a mesh —
  the generic and per-axis rungs on any decomposition, K1 and K5
  shard-local on z slabs with global offsets, the slab rung as K3,
  one launch over an output window a step (``csrc/fused_step_diffusion.cu``,
  ``csrc/slab_run_burgers.cu``), on 2-D meshes a launch a stage and
  shard (K8, or K8b's interior band and both edge bands, two launches,
  under the split schedule, ``csrc/fused2d_sharded.cu``), and ADR's K9
  shard-local with global
  walls and ``K(x)``. ``make_mesh({"dz": 2}, devices=[...])`` may name
  one device twice (two shards on one card, or CPU shards).

The families register in ``models/registry.py``; the CLI generates its
verbs from that registry.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.adr import (
    ADRConfig,
    ADRSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.burgers import (
    BurgersConfig,
    BurgersSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig,
    DiffusionSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.ensemble import (
    EnsembleSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import (
    EnsembleState,
    SolverState,
)
from multigpu_advectiondiffusion_tpu_torch.resilience.errors import (
    EnsembleMemberDivergedError,
)

__all__ = [
    "ADRConfig",
    "ADRSolver",
    "Boundary",
    "BurgersConfig",
    "BurgersSolver",
    "DiffusionConfig",
    "DiffusionSolver",
    "EnsembleMemberDivergedError",
    "EnsembleSolver",
    "EnsembleState",
    "Grid",
    "SolverState",
]
