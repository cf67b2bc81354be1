"""Operators and the kernel-strategy vocabulary shared with the JAX package."""

# Every kernel-strategy rung a config may name — the JAX package's
# list, so one config dict builds both solvers. Which rungs the port
# can run is decided at solver construction (models/diffusion.py).
IMPLS = (
    "xla", "pallas", "pallas_axis", "pallas_step", "pallas_slab",
    "pallas_stage", "auto",
)


def is_pallas_impl(impl: str) -> bool:
    """Whether ``impl`` names a kernel rung rather than the generic path.
    Of these the port runs only the fused rungs; the rest raise at
    solver construction."""
    return impl.startswith("pallas")
