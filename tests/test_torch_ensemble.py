"""The port's batched ensemble engine on the CPU: against the port's own
looped single runs (to the bit, on every rung), against the JAX
package's ensemble engine (``models/ensemble.py``, ``models/base.py``),
its declines, donation, member-attributed divergence, autograd through
``advance_to_ensemble(..., max_steps=...)`` and the CLI.

Tolerances, each the JAX suite's own where it has one:

* port ensemble against port looped single runs: to the bit, ``t`` and
  ``it`` equal (uniform physics on the generic, per-stage K1/K5/K9 and
  K2b fold rungs);
* port against JAX, uniform physics on the generic rung: ``rtol 1e-5,
  atol 1e-6 max|u|`` (the JAX suite's fused bound, as the port's generic
  tests use), ``t`` equal;
* member-varying operands (K, K0/lambda, CFL): ``t`` exact and ``u``
  within ``atol 1e-5`` (``tests/test_ensemble.py:152-158``), per-member
  ``it`` equal;
* autograd against ``jax.grad`` on the example's loss: the loss within
  1e-5 relative and every member's gradient within 1e-4 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigpu_advectiondiffusion_tpu as J
from multigpu_advectiondiffusion_tpu.models.ensemble import (
    EnsembleSolver as JEnsemble,
)
from multigpu_advectiondiffusion_tpu.models.state import (
    EnsembleState as JEState,
)
import multigpu_advectiondiffusion_tpu_torch as P
from multigpu_advectiondiffusion_tpu_torch.cli.__main__ import main as pmain
from multigpu_advectiondiffusion_tpu_torch.examples import (
    inverse_diffusivity as pinv,
)
from multigpu_advectiondiffusion_tpu_torch.models.ensemble import (
    parse_sweep_spec,
)

torch.set_num_threads(1)

G3 = ((12, 10, 8), (1.2, 1.0, 0.8))  # the JAX suite's ensemble grid
G3K = ((16, 12, 10), (1.6, 1.2, 1.0))  # its fused-stage grid
GB = ((24, 8, 8), 2.0)  # its Burgers grid


def _cfg(pkg, family, grid, impl="xla", **kw):
    """The same config in either package (``pkg`` is the JAX or the port
    module); float32 as both suites pin it."""
    n, lengths = grid
    g = pkg.Grid.make(*n, lengths=lengths)
    if family == "diffusion":
        return pkg.DiffusionConfig(grid=g, dtype="float32", impl=impl,
                                   **{"ic": "gaussian", **kw})
    if family == "burgers":
        return pkg.BurgersConfig(grid=g, dtype="float32", impl=impl,
                                 **{"nu": 1e-5, "adaptive_dt": False, **kw})
    return pkg.ADRConfig(grid=g, dtype="float32", impl=impl,
                         **{"velocity": 0.5, "kappa_variation": 0.2,
                            "reaction_rate": 0.25, **kw})


def _solver_cls(pkg, family):
    return getattr(pkg, {"diffusion": "DiffusionSolver",
                         "burgers": "BurgersSolver",
                         "adr": "ADRSolver"}[family])


def _widths(B):
    """The JAX suite's width sweep (``tests/test_ensemble.py:61-64``)."""
    return [{"ic_params": (("width", 0.1 + 0.02 * i),)} for i in range(B)]


def _port(family, grid, members, impl="xla", **kw):
    return P.EnsembleSolver(_solver_cls(P, family),
                            _cfg(P, family, grid, impl, **kw), members,
                            device="cpu")


def _jax(family, grid, members, impl="xla", **kw):
    return JEnsemble(_solver_cls(J, family), _cfg(J, family, grid, impl,
                                                  **kw), members)


def _from_jax(est) -> P.EnsembleState:
    """A JAX ensemble state handed over as numpy (both start identical)."""
    return P.EnsembleState(
        u=torch.from_numpy(np.array(est.u)), t=np.array(est.t),
        it=np.array(est.it, dtype=np.int32))


# --------------------------------------------------------------------- #
# Every rung: each member equals its looped single run, to the bit
# --------------------------------------------------------------------- #
# name: (family, grid, impl, config kwargs, steps, engaged stepper)
RUNGS = {
    "diffusion-generic": ("diffusion", G3, "xla", {}, 3,
                          "ensemble-vmap[generic-xla]"),
    "diffusion-2d-generic": ("diffusion", ((12, 10), (1.2, 1.0)), "xla",
                             {}, 3, "ensemble-vmap[generic-xla]"),
    "diffusion-k1": ("diffusion", G3K, "pallas_stage", {}, 2,
                     "ensemble-vmap[fused-stage]"),
    "diffusion-k2b-fold": ("diffusion", G3, "pallas_slab", {}, 3,
                           "ensemble-fold[fused-whole-run-slab]"),
    "burgers-generic": ("burgers", GB, "xla", {}, 2,
                        "ensemble-vmap[generic-xla]"),
    "burgers-k5": ("burgers", GB, "pallas_stage", {}, 2,
                   "ensemble-vmap[fused-stage]"),
    "burgers-k5-adaptive": ("burgers", GB, "pallas", {"adaptive_dt": True},
                            2, "ensemble-vmap[fused-stage]"),
    "burgers-k2b-fold": ("burgers", GB, "pallas_slab", {}, 3,
                         "ensemble-fold[fused-whole-run-slab]"),
    "adr-generic": ("adr", G3, "xla", {"ic": "gaussian"}, 2,
                    "ensemble-vmap[generic-xla]"),
    "adr-k9": ("adr", G3, "pallas", {"ic": "gaussian"}, 2,
               "ensemble-vmap[fused-stage]"),
}


@pytest.mark.parametrize("name", list(RUNGS))
def test_ensemble_equals_looped_single_runs(name):
    family, grid, impl, kw, steps, stepper = RUNGS[name]
    es = _port(family, grid, _widths(4), impl, **kw)
    est = es.initial_state()
    out = es.run(est, steps)
    assert es.engaged_path()["stepper"] == stepper
    assert out.members == 4 and out.u.shape == est.u.shape
    np.testing.assert_array_equal(out.it, [steps] * 4)
    for i in range(4):
        ms = es.member_solver(i)
        ref = ms.run(ms.initial_state(), steps)
        assert torch.equal(out.u[i], ref.u), f"member {i}"
        assert out.t[i] == ref.t and out.t.dtype == np.float32


# --------------------------------------------------------------------- #
# Against the JAX ensemble engine
# --------------------------------------------------------------------- #
def _assert_close_members(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale,
                                   err_msg=f"member {i}")


@pytest.mark.parametrize("family,grid,kw", [
    ("diffusion", G3, {}),
    ("burgers", ((40, 30), 2.0), {}),
], ids=["diffusion", "burgers-2d"])
def test_generic_ensemble_matches_jax(family, grid, kw):
    """Uniform physics (the width sweep), ``impl="xla"``: fields, times,
    step counts, the engaged rung and the per-member summaries."""
    jes = _jax(family, grid, _widths(4), **kw)
    pes = _port(family, grid, _widths(4), **kw)
    jest = jes.initial_state()
    pest = _from_jax(jest)
    pes.arm(pest)
    want, got = jes.run(jest, 3), pes.run(pest, 3)
    assert pes.engaged_path()["stepper"] == jes.engaged_path()["stepper"]
    np.testing.assert_array_equal(got.t, np.asarray(want.t))
    np.testing.assert_array_equal(got.it, np.asarray(want.it))
    _assert_close_members(got.u.numpy(), want.u)
    jrows, prows = jes.member_summaries(want), pes.member_summaries(got)
    for jr, pr in zip(jrows, prows):
        assert pr["member"] == jr["member"] and pr["it"] == jr["it"]
        assert pr["overrides"] == jr["overrides"]
        for key in ("max_abs", "min", "max", "l2", "mass"):
            assert pr[key] == pytest.approx(jr[key], rel=1e-5, abs=1e-7)
        # a difference of two float32 sums, each in its own order
        assert pr["mass_drift"] == pytest.approx(jr["mass_drift"],
                                                 abs=1e-5)


# name: (family, grid, config kwargs, operand members, rtol of t). t is
# exact where dt is the operand's float32 formula alone. ADR: XLA's CPU
# compiler folds the constant chain K0 (1+eps) 2 S / safety into one
# constant and turns the division by safety into a product with its
# reciprocal, which rounds unlike the JAX source's operation-by-operation
# float32 that the port follows (1 ulp of dt on one member here).
# Adaptive Burgers: dt reads max|u|, and the two packages' generic WENO
# fields differ by ulps after the first step.
OPERANDS = {
    "diffusion-K": ("diffusion", G3, {},
                    [{"diffusivity": k} for k in (0.5, 0.7, 1.3, 2.0)], 0),
    "adr-K0-lambda": ("adr", G3, {"ic": "gaussian"},
                      [{"diffusivity": k, "reaction_rate": r}
                       for k, r in ((0.5, 0.0), (0.8, 0.3), (1.3, 0.25),
                                    (2.0, 1.5))], 1e-6),
    "burgers-cfl-fixed": ("burgers", GB, {},
                          [{"cfl": c} for c in (0.2, 0.3, 0.35, 0.45)], 0),
    "burgers-cfl-adaptive": ("burgers", ((40, 30), 2.0),
                             {"adaptive_dt": True},
                             [{"cfl": c} for c in (0.2, 0.3, 0.35, 0.45)],
                             1e-6),
}


@pytest.mark.parametrize("name", list(OPERANDS))
def test_operand_ensemble_matches_jax(name):
    """Member-varying scalars on the generic rung, dt derived from the
    float32 operand as the JAX package's source derives it."""
    family, grid, kw, members, t_rtol = OPERANDS[name]
    jes, pes = _jax(family, grid, members, **kw), _port(family, grid,
                                                         members, **kw)
    jest = jes.initial_state()
    pest = _from_jax(jest)
    want, got = jes.run(jest, 3), pes.run(pest, 3)
    jpath, ppath = jes.engaged_path(), pes.engaged_path()
    assert ppath["stepper"] == jpath["stepper"] == (
        "ensemble-vmap[generic-xla]")
    assert ppath["operands"] == jpath["operands"]
    np.testing.assert_allclose(got.t, np.asarray(want.t), rtol=t_rtol,
                               atol=0)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("horizon", ["scalar", "per-member"])
def test_advance_to_ensemble_matches_jax(horizon):
    members = [{"diffusivity": k} for k in (0.5, 1.0, 2.0)]
    jes, pes = _jax("diffusion", G3, members), _port("diffusion", G3,
                                                      members)
    jest = jes.initial_state()
    pest = _from_jax(jest)
    t0 = float(jest.t[0])
    t_end = (t0 + 0.002 if horizon == "scalar"
             else [t0 + 0.001, t0 + 0.002, t0 + 0.0015])
    want, got = jes.advance_to(jest, t_end), pes.advance_to(pest, t_end)
    np.testing.assert_array_equal(got.it, np.asarray(want.it))
    assert len(set(got.it.tolist())) > 1  # members take their own counts
    np.testing.assert_array_equal(got.t, np.asarray(want.t))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0,
                               atol=1e-5)
    # max_steps mode: the same trajectory while it covers every member,
    # frozen members where it does not
    bounded = pes.advance_to(pest, t_end, max_steps=int(got.it.max()))
    assert torch.equal(bounded.u, got.u)
    cut = pes.advance_to(pest, t_end, max_steps=2)
    jcut = jes.advance_to(jest, t_end, max_steps=2)
    np.testing.assert_array_equal(cut.it, np.asarray(jcut.it))
    np.testing.assert_array_equal(cut.t, np.asarray(jcut.t))


# --------------------------------------------------------------------- #
# Which rung engages: the JAX package's batched dispatch decision
# --------------------------------------------------------------------- #
def _jax_rung(solver, operand: bool):
    """The rung JAX's ``run_ensemble`` dispatches to
    (``models/base.py:1447-1460``) and the fused decline it records,
    without compiling anything."""
    if operand:
        solver._fused_stepper(mode="iters")
        return "ensemble-vmap[generic-xla]", solver._fused_fallback
    fused = solver._ensemble_fused()
    if fused is None:
        return "ensemble-vmap[generic-xla]", solver._fused_fallback
    if fused.engaged_label == "fused-whole-run-slab":
        return "ensemble-fold[fused-whole-run-slab]", solver._fused_fallback
    return f"ensemble-vmap[{fused.engaged_label}]", solver._fused_fallback


IMPLS = ("xla", "pallas", "pallas_stage", "pallas_step", "pallas_slab",
         "pallas_axis")
MATRIX = [(fam, nd, impl, mode)
          for fam in ("diffusion", "burgers", "adr")
          for nd in (2, 3) for impl in IMPLS
          for mode in ("uniform", "operand")]
# the deliberate difference: the port's slab gate, measured on the H100,
# never prefers K6 to K5 (ops/kernels/fused_slab_run.py), so fixed-dt
# 3-D Burgers under impl="pallas" launches K5 per member where the JAX
# package folds B into K6
DELIBERATE = {("burgers", 3, "pallas", "uniform"):
              ("ensemble-fold[fused-whole-run-slab]",
               "ensemble-vmap[fused-stage]")}


@pytest.mark.parametrize("fam,nd,impl,mode", MATRIX,
                         ids=["-".join(map(str, c)) for c in MATRIX])
def test_engaged_rung_matches_jax(fam, nd, impl, mode):
    grid = G3 if nd == 3 else ((12, 10), (1.2, 1.0))
    op = {"diffusion": "diffusivity", "burgers": "cfl",
          "adr": "diffusivity"}[fam]
    members = 2 if mode == "uniform" else [{op: 0.3}, {op: 0.45}]
    kw = {"ic": "gaussian"} if fam == "adr" else {}
    if impl == "pallas_slab" and mode == "operand":
        for make in (_jax, _port):
            with pytest.raises(ValueError, match="uniform physics"):
                make(fam, grid, members, impl, **kw)
        return
    jsolver = _jax(fam, grid, members, impl, **kw).solver
    want, want_fallback = _jax_rung(jsolver, mode == "operand")
    pes = _port(fam, grid, members, impl, **kw)
    pes.run(pes.initial_state(), 1)
    got = pes.engaged_path()
    if (fam, nd, impl, mode) in DELIBERATE:
        assert (want, got["stepper"]) == DELIBERATE[fam, nd, impl, mode]
        return
    assert got["stepper"] == want
    assert got["fallback"] == want_fallback
    assert (got["devices"], got["member_sharding"], got["mesh"]) == (
        1, 1, None)


# --------------------------------------------------------------------- #
# Declines, with the JAX package's words
# --------------------------------------------------------------------- #
def test_declines_match_jax(devices):
    two = [{"diffusivity": 0.5}, {"diffusivity": 2.0}]
    for make in (_jax, _port):
        with pytest.raises(ValueError, match="uniform physics"):
            make("diffusion", G3, two, "pallas_slab")
        with pytest.raises(ValueError, match="weno_order"):
            make("burgers", GB, [{"weno_order": 7}])
        with pytest.raises(ValueError, match="single-run rung"):
            make("diffusion", G3, 2, precision="bf16")
        with pytest.raises(ValueError, match="steps_per_exchange > 1"):
            make("diffusion", G3, 2, steps_per_exchange=2)
        with pytest.raises(ValueError, match="exchange='dma'"):
            make("diffusion", G3, 2, exchange="dma")
        es = make("diffusion", G3, 3)
        est = es.initial_state()
        with pytest.raises(ValueError, match="1 values for 3 members"):
            es.solver.run_ensemble(est, 1, operands={"diffusivity": [1.0]})
        with pytest.raises(ValueError, match="no member-varying operand"):
            es.solver.run_ensemble(est, 1, operands={"cfl": [0.1] * 3})
        with pytest.raises(ValueError, match="2 values for 3 members"):
            es.advance_to(est, [0.2, 0.3])
    from multigpu_advectiondiffusion_tpu.parallel.mesh import (
        Decomposition,
        make_mesh,
    )

    mesh = make_mesh({"dz": 2}, devices=devices[:2])
    with pytest.raises(ValueError, match="members"):
        JEnsemble(J.DiffusionSolver, _cfg(J, "diffusion", G3), 4,
                  mesh=mesh, decomp=Decomposition.slab("dz"))
    with pytest.raises(ValueError, match="members"):
        P.EnsembleSolver(P.DiffusionSolver, _cfg(P, "diffusion", G3), 4,
                         mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="auto"):
        P.EnsembleSolver(P.DiffusionSolver,
                         _cfg(P, "diffusion", G3, "auto"), 2, device="cpu")


def test_sweep_grammar():
    assert parse_sweep_spec("K=0.5:2", 4) == (
        "K", pytest.approx([0.5, 1.0, 1.5, 2.0]))
    assert parse_sweep_spec("cfl=0.1,0.2", 2) == ("cfl", [0.1, 0.2])
    with pytest.raises(ValueError, match="NAME=a:b"):
        parse_sweep_spec("K", 2)
    with pytest.raises(ValueError, match="3 values for 2 members"):
        parse_sweep_spec("K=1,2,3", 2)


# --------------------------------------------------------------------- #
# Donation and divergence
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("impl,advance", [
    ("xla", False), ("pallas_stage", False), ("pallas_slab", False),
    ("xla", True),
], ids=["generic", "k1", "k2b-fold", "advance_to"])
def test_donated_state_is_consumed(impl, advance):
    es = _port("diffusion", G3, _widths(3), impl)
    est = es.initial_state()
    if advance:
        keep = es.advance_to(est, float(est.t[0]) + 0.001)
        out = es.advance_to(est, float(est.t[0]) + 0.001, donate=True)
    else:
        keep = es.run(est, 2)
        out = es.run(est, 2, donate=True)
    assert torch.equal(out.u, keep.u)
    np.testing.assert_array_equal(out.t, keep.t)
    for use in (lambda: est.u + 1, lambda: est.u[0], lambda: est.u.sum(),
                lambda: es.run(est, 1)):
        with pytest.raises(RuntimeError, match="donated"):
            use()
    es.run(out, 1, donate=True)  # the returned state is live


def test_zero_step_donation_keeps_the_output():
    es = _port("diffusion", G3, 2, "pallas_slab")
    est = es.initial_state()
    want = est.u.clone()
    out = es.run(est, 0, donate=True)
    assert torch.equal(out.u, want)
    with pytest.raises(RuntimeError):
        est.u.clone()


@pytest.mark.parametrize("impl", ["xla", "pallas_slab"])
def test_diverging_member_is_named_others_unaffected(impl):
    es = _port("diffusion", G3, _widths(6), impl)
    est = es.initial_state()
    u = est.u.clone()
    u[3, 4, 5, 6] = float("nan")  # interior: walls would re-clamp
    out = es.run(P.EnsembleState(u=u, t=est.t, it=est.it), 2)
    with pytest.raises(P.EnsembleMemberDivergedError) as exc:
        es.check_health(out)
    assert exc.value.members == [3]
    assert "member" in str(exc.value) and exc.value.step == 2
    for i in (0, 1, 2, 4, 5):
        ms = es.member_solver(i)
        ref = ms.run(ms.initial_state(), 2)
        assert torch.equal(out.u[i], ref.u), f"member {i} was poisoned"
    with pytest.raises(P.EnsembleMemberDivergedError, match="initial"):
        es.arm(P.EnsembleState(u=u, t=est.t, it=est.it))


def test_ensemble_state_stack_and_member():
    ps = P.DiffusionSolver(_cfg(P, "diffusion", G3), device="cpu")
    s0 = ps.initial_state()
    est = P.EnsembleState.stack([s0, s0._replace(t=np.float32(0.5))])
    assert est.members == 2 and est.t.dtype == np.float32
    assert est.it.dtype == np.int32
    m = est.member(1)
    assert torch.equal(m.u, s0.u) and m.t == np.float32(0.5) and m.it == 0
    with pytest.raises(ValueError, match="at least one member"):
        P.EnsembleState.stack([])


# --------------------------------------------------------------------- #
# torch.autograd through max_steps against jax.grad (the example's loss)
# --------------------------------------------------------------------- #
def test_autograd_through_max_steps_matches_jax_grad():
    guesses = [0.4, 0.9, 2.2, 3.5]
    n, t_window, max_steps = pinv.N, 0.05, 64
    jsolver = J.DiffusionSolver(J.DiffusionConfig(
        grid=J.Grid.make(*n, lengths=10.0), diffusivity=1.0,
        dtype="float32", impl="xla"))
    s0 = jsolver.initial_state()
    t_end = float(s0.t) + t_window
    u_obs = jsolver.advance_to(s0, t_end).u
    B = len(guesses)
    jest = JEState(u=jnp.stack([s0.u] * B), t=jnp.stack([s0.t] * B),
                   it=jnp.zeros((B,), jnp.int32))

    def jloss(ks):
        out = jsolver.advance_to_ensemble(
            jest, t_end, operands={"diffusivity": ks}, max_steps=max_steps)
        axes = tuple(range(1, out.u.ndim))
        return jnp.sum(jnp.mean((out.u - u_obs[None]) ** 2, axis=axes))

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(guesses,
                                                        jnp.float32))
    psolver, _, _, _ = pinv.make_problem(n, 1.0, t_window, device="cpu")
    pest = _from_jax(jest)
    ks = torch.tensor(guesses, dtype=torch.float32, requires_grad=True)
    pval = pinv.ensemble_loss(psolver, pest, t_end,
                              torch.from_numpy(np.array(u_obs)), ks,
                              max_steps)
    (pgrad,) = torch.autograd.grad(pval, ks)
    print(f"loss port {pval.item()!r} jax {float(jval)!r}; grad port "
          f"{pgrad.tolist()} jax {np.asarray(jgrad).tolist()}")
    assert pval.item() == pytest.approx(float(jval), rel=1e-5)
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad), rtol=1e-4)


def test_inverse_example_descends():
    recovered, history = pinv.recover_diffusivity(
        [0.6, 2.5], k_true=1.3, iterations=12, device="cpu")
    assert history[-1] < 0.25 * history[0]
    assert np.all(np.abs(recovered.numpy() - 1.3) < np.abs(
        np.array([0.6, 2.5]) - 1.3))


# --------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------- #
def test_cli_ensemble_sweep(tmp_path, capsys):
    save = str(tmp_path / "out")
    assert pmain(["diffusion3d", "--n", "12", "10", "8", "--iters", "3",
                  "--ensemble", "3", "--sweep", "K=0.5:2", "--device",
                  "cpu", "--save", save]) == 0
    summary = json.load(open(os.path.join(save, "ensemble_summary.json")))
    assert summary["ensemble"] == 3 and len(summary["members"]) == 3
    ks = [m["overrides"]["diffusivity"] for m in summary["members"]]
    assert ks == pytest.approx([0.5, 1.25, 2.0])
    assert summary["mlups_members"] > 0
    assert summary["engaged"]["stepper"] == "ensemble-vmap[generic-xla]"
    assert summary["engaged"]["operands"] == ["diffusivity"]
    assert summary["launches"] == {}  # the CPU launches no kernel
    assert os.path.getsize(os.path.join(save, "ensemble_result.bin")) == (
        3 * 12 * 10 * 8 * 4)
    assert "MLUPS*members" in capsys.readouterr().out


def test_cli_ensemble_fold_and_rejections(tmp_path):
    save = str(tmp_path / "fold")
    pmain(["burgers3d", "--n", "24", "8", "8", "--iters", "2", "--fixed-dt",
           "--impl", "pallas_slab", "--ensemble", "2", "--sweep",
           "ic.width=0.1:0.2", "--device", "cpu", "--save", save])
    summary = json.load(open(os.path.join(save, "ensemble_summary.json")))
    assert summary["engaged"]["stepper"] == (
        "ensemble-fold[fused-whole-run-slab]")
    assert summary["members"][1]["overrides"]["ic_params"] == [
        ["width", 0.2]]
    with pytest.raises(SystemExit):  # not a flag of the port's CLI
        pmain(["diffusion3d", "--n", "12", "10", "8", "--iters", "2",
               "--ensemble", "2", "--checkpoint-every", "1", "--device",
               "cpu"])
    with pytest.raises(ValueError, match="'members' axis"):
        pmain(["diffusion3d", "--n", "12", "10", "8", "--iters", "2",
               "--ensemble", "2", "--mesh", "dz=2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="not ported"):
        pmain(["diffusion3d", "--n", "12", "10", "8", "--iters", "2",
               "--ensemble", "2", "--mesh", "members=2", "--device", "cpu"])
