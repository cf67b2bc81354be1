"""Raw float32 binaries in the reference ``SaveBinary3D`` layout.

Byte-compatible with the JAX package's ``utils/io.save_binary`` /
``load_binary``: C-order, x innermost, float32, no header.
"""

from __future__ import annotations

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.models.state import ShardedArray


def save_binary(u, path: str) -> None:
    """Write ``u`` (tensor, sharded field or array) as float32 raw
    binary."""
    if isinstance(u, ShardedArray):
        u = u.numpy()
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    np.ascontiguousarray(u, dtype=np.float32).ravel().tofile(path)


def load_binary(path: str, shape) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(shape)
