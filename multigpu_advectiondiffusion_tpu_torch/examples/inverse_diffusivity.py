"""Gradient-based inverse problem on the batched ensemble engine (JAX
``examples/inverse_diffusivity.py`` counterpart).

Recover an unknown diffusivity K* from one observed field by
differentiating through the batched dispatch: ``torch.autograd`` runs
through ``SolverBase.advance_to_ensemble(..., max_steps=...)`` with the
member diffusivities as operands (dt and the Laplacian's coefficient are
tensors of them), so one dispatch yields the loss and its gradient for
B independent optimization trajectories.

The JAX example runs a 1-D grid; the port has no 1-D grids yet, so this
one runs the same problem on a 2-D grid (48 x 40 nodes, lengths 10).

Run on the GPU (or ``--device cpu``)::

    python -m multigpu_advectiondiffusion_tpu_torch.examples.inverse_diffusivity
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from multigpu_advectiondiffusion_tpu_torch.core.grid import Grid
from multigpu_advectiondiffusion_tpu_torch.models.diffusion import (
    DiffusionConfig,
    DiffusionSolver,
)
from multigpu_advectiondiffusion_tpu_torch.models.state import EnsembleState

N = (48, 40)  # physical (nx, ny)


def make_problem(n=N, k_true: float = 1.0, t_window: float = 0.05,
                 device=None):
    """``(solver, initial state, t_end, observed field)`` for a 2-D
    heat-kernel workload with ground-truth diffusivity ``k_true``."""
    grid = Grid.make(*n, lengths=10.0)
    cfg = DiffusionConfig(grid=grid, diffusivity=k_true, dtype="float32",
                          impl="xla")
    solver = DiffusionSolver(cfg, device=device)
    s0 = solver.initial_state()
    t_end = float(s0.t) + t_window
    obs = solver.advance_to(s0, t_end)
    return solver, s0, t_end, obs.u


def ensemble_loss(solver, est0: EnsembleState, t_end, u_obs, ks,
                  max_steps: int):
    """The summed per-member misfits after marching every member with
    its own diffusivity ``ks[i]`` to ``t_end``: members are independent,
    so one backward pass serves every trajectory."""
    out = solver.advance_to_ensemble(
        est0, t_end, operands={"diffusivity": ks}, max_steps=max_steps,
    )
    axes = tuple(range(1, out.u.dim()))
    return torch.sum(torch.mean((out.u - u_obs[None]) ** 2, dim=axes))


def recover_diffusivity(guesses, n=N, k_true: float = 1.0,
                        t_window: float = 0.05, iterations: int = 60,
                        lr: float = 0.05, max_steps: int = 64,
                        device=None):
    """Run B simultaneous gradient-descent trajectories (one per initial
    guess) against the observed field; returns ``(recovered, history)``,
    the ``(B,)`` final estimates and the loss at each iteration.

    ``max_steps`` bounds every member's step count; it must cover the
    steepest member (largest K, smallest stability dt, most steps)."""
    solver, s0, t_end, u_obs = make_problem(n, k_true, t_window, device)
    B = len(guesses)
    est0 = EnsembleState.stack([s0] * B)
    # sign descent on log K with a geometrically decaying step, as the
    # JAX example: the members' misfit scales differ by orders of
    # magnitude, which a raw gradient step would not survive
    theta = torch.log(torch.tensor(guesses, dtype=torch.float32))
    step = lr
    history = []
    for _ in range(iterations):
        ks = torch.exp(theta).requires_grad_(True)
        value = ensemble_loss(solver, est0, t_end, u_obs, ks, max_steps)
        (grads,) = torch.autograd.grad(value, ks)
        history.append(value.item())
        theta = theta - step * torch.sign(grads)
        step *= 0.97
    return torch.exp(theta), history


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda)")
    args = p.parse_args(argv)
    k_true = 1.3
    guesses = [0.4, 0.9, 2.2, 3.5]
    recovered, history = recover_diffusivity(guesses, k_true=k_true,
                                             device=args.device)
    print(f"true diffusivity: {k_true}")
    for g, k in zip(guesses, recovered.tolist()):
        err = abs(k - k_true) / k_true
        print(f"  guess {g:4.2f} -> recovered {k:6.4f} "
              f"(rel err {100 * err:.2f}%)")
    print(f"loss: {history[0]:.3e} -> {history[-1]:.3e} "
          f"({len(history)} gradient steps through the batched dispatch)")
    return 0 if np.isfinite(history[-1]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
