"""Resilience (JAX ``resilience/`` counterpart): so far the structured
divergence errors the ensemble engine raises."""
