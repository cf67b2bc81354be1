from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary, pad_axis
from multigpu_advectiondiffusion_tpu_torch.core.dtypes import canonicalize
from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid

__all__ = ["Boundary", "Grid", "canonicalize", "pad_axis"]
