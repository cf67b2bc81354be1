"""Floating-point policy: float32 by default, float64 opt-in.

The JAX package also accepts ``bfloat16`` (a storage experiment); that
rung is not ported yet and raises here rather than mislabeling a run.
"""

from __future__ import annotations

import torch

_ALIASES = {
    "f32": torch.float32,
    "float32": torch.float32,
    "single": torch.float32,
    "f64": torch.float64,
    "float64": torch.float64,
    "double": torch.float64,
}

_UNPORTED = ("bf16", "bfloat16")


def canonicalize(dtype) -> torch.dtype:
    """Resolve a user-facing dtype name to ``torch.float32``/``float64``."""
    key = str(dtype).lower()
    if key in _UNPORTED:
        raise NotImplementedError(
            "bfloat16 storage is not ported yet; use float32 or float64"
        )
    if key not in _ALIASES:
        raise ValueError(
            f"unknown dtype {dtype!r}; use one of {sorted(_ALIASES)}"
        )
    return _ALIASES[key]
