"""Worked examples on the port (the JAX package's ``examples/``
counterparts that run on its solvers)."""
