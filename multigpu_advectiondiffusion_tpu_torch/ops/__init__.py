"""Operators and the kernel-strategy vocabulary shared with the JAX package."""

# Every kernel-strategy rung a config may name — the JAX package's
# list, so one config dict builds both solvers. Which rungs the port
# can run is decided at solver construction (models/diffusion.py).
IMPLS = (
    "xla", "pallas", "pallas_axis", "pallas_step", "pallas_slab",
    "pallas_stage", "auto",
)


def is_pallas_impl(impl: str) -> bool:
    """Whether ``impl`` names a kernel rung rather than the generic path."""
    return impl.startswith("pallas")


def is_fused_impl(impl: str) -> bool:
    """Whether the flavor may engage a fused stepper. ``"pallas_axis"``
    opts out: it pins the per-axis kernels (K11/K12), the rung of the
    reference's non-fused baseline codes."""
    return is_pallas_impl(impl) and impl != "pallas_axis"


def op_impl(impl: str) -> str:
    """Normalize a solver ``impl`` flavor to what the per-op dispatchers
    (``laplacian``, ``flux_divergence``) accept: every kernel flavor
    maps to ``"pallas"``."""
    return "pallas" if is_pallas_impl(impl) else impl
