"""Floating-point policy: float32 by default, float64 opt-in for
accuracy studies, bfloat16 for the all-bf16 experiment (the JAX
package's ``core/dtypes.py``).

bfloat16 is also the storage type of the ``precision="bf16"`` rung: a
float32 compute state kept in bfloat16 between steps, whose generic loop
carries a bf16 compensation term (:func:`bf16_carry_enabled`).
"""

from __future__ import annotations

import os

import torch

_ALIASES = {
    "f32": torch.float32,
    "float32": torch.float32,
    "single": torch.float32,
    "f64": torch.float64,
    "float64": torch.float64,
    "double": torch.float64,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
}


def bf16_carry_enabled() -> bool:
    """Whether the generic loop of ``precision="bf16"`` carries the
    Kahan compensation term: a bf16 ``lo`` next to the bf16 ``hi`` state,
    so that increments that round away at the bf16 ulp still accumulate.
    On by default; ``TPUCFD_BF16_NO_CARRY=1`` turns it off (the JAX
    package's knob, with its values)."""
    return os.environ.get("TPUCFD_BF16_NO_CARRY", "").lower() not in (
        "1", "true", "yes",
    )


def canonicalize(dtype) -> torch.dtype:
    """Resolve a user-facing dtype name to ``torch.float32``,
    ``torch.float64`` or ``torch.bfloat16``."""
    key = str(dtype).lower()
    if key not in _ALIASES:
        raise ValueError(
            f"unknown dtype {dtype!r}; use one of {sorted(_ALIASES)}"
        )
    return _ALIASES[key]
