"""WENO5-JS / WENO5-Z / WENO7-JS flux-divergence operators (JAX
``ops/weno.py`` counterpart, on tensors).

* WENO5-JS dual reconstruction — ``Reconstruct1d``
  (``MultiGPU/Burgers3d_Baseline/Kernels.cu:112-220``) and the MATLAB
  ground truth ``Matlab_Prototipes/InviscidBurgersNd/WENO5resAdv_X.m:57-125``.
* WENO5-Z weights — ``WENO5Zreconstruction``
  (``SingleGPU/Burgers3d_WENO5_SharedMem/kernels.cu:153-207``).
* WENO7-JS — ``Matlab_Prototipes/InviscidBurgersNd/WENO7resAdv_X.m``.

Splitting is component-wise (local) Lax–Friedrichs,
``f^{+-} = (f(u) +- |f'(u)| u)/2`` per point (``WENO5resAdv_X.m:58-60``).

Two forms of the same reconstruction live here, as in the JAX package:

* the q-form (``_weno5_minus``/``_weno5_plus``, ``_weno7_*``) behind
  :func:`flux_divergence` — the generic path (``impl="xla"``), plain
  PyTorch over shifted slices of an axis-padded array; the per-axis
  kernel K12 evaluates the WENO7 q-form too, its betas written on
  forward differences (``_weno7_betas``);
* the forward-difference e-form (``_curv``, ``_weno5_side_nd``,
  ``_weno5_side_nd_e``, ``_weno7_side_nd_e``) that the fused kernels
  K5, K6 and K7 at both orders, the per-axis kernel K12 at order 5 and
  their plain twins (``ops/kernels/fused_burgers.py``,
  ``ops/kernels/weno.py``) evaluate.

Every expression keeps the JAX package's operation order, so float64
results agree with it to rounding; the WENO7 betas take the order of
the JAX package's difference form. Squares are written ``x * x``.
"""

from __future__ import annotations

import torch

from multigpu_advectiondiffusion_tpu_torch.core.bc import Boundary, pad_axis
from multigpu_advectiondiffusion_tpu_torch.ops.flux import Flux
from multigpu_advectiondiffusion_tpu_torch.ops.stencils import (
    GhostFn,
    Padder,
    shifted,
    split_axis_apply,
)

HALO = {5: 3, 7: 4}
EPSILON = 1e-6  # WENO5resAdv_X.m:75

# Optimal linear weights, upwind-biased ("minus") side.
_D5 = (0.1, 0.6, 0.3)  # WENO5resAdv_X.m:75
_D7 = (1.0 / 35.0, 12.0 / 35.0, 18.0 / 35.0, 4.0 / 35.0)  # WENO7resAdv_X.m:85


def _sq(x):
    return x * x


def _weno5_betas(q0, q1, q2, q3, q4):
    b0 = 13.0 / 12.0 * _sq(q0 - 2 * q1 + q2) + 0.25 * _sq(q0 - 4 * q1 + 3 * q2)
    b1 = 13.0 / 12.0 * _sq(q1 - 2 * q2 + q3) + 0.25 * _sq(q1 - q3)
    b2 = 13.0 / 12.0 * _sq(q2 - 2 * q3 + q4) + 0.25 * _sq(3 * q2 - 4 * q3 + q4)
    return b0, b1, b2


def _weno5_alphas_unnormalized(betas, d, variant):
    """Unnormalized nonlinear weights in the single-division form
    ``alpha_k' = d_k (prod_{j != k} (eps+beta_j))^2`` (JS) or
    ``d_k (beta_k+eps+tau5) prod_{j != k} (beta_j+eps)`` (Z); the
    normalization cancels the common factor exactly."""
    s0, s1, s2 = (b + EPSILON for b in betas)
    if variant == "js":
        return (
            d[0] * _sq(s1 * s2),
            d[1] * _sq(s0 * s2),
            d[2] * _sq(s0 * s1),
        )
    if variant == "z":
        tau5 = torch.abs(betas[0] - betas[2])
        return (
            d[0] * (s0 + tau5) * (s1 * s2),
            d[1] * (s1 + tau5) * (s0 * s2),
            d[2] * (s2 + tau5) * (s0 * s1),
        )
    raise ValueError(f"unknown WENO5 variant {variant!r}; use 'js' or 'z'")


def _weno5_minus(q0, q1, q2, q3, q4, variant):
    """Reconstruct u^- at the interface right of center cell q2."""
    a0, a1, a2 = _weno5_alphas_unnormalized(
        _weno5_betas(q0, q1, q2, q3, q4), _D5, variant
    )
    num = (
        a0 * (2 * q0 - 7 * q1 + 11 * q2)
        + a1 * (-q1 + 5 * q2 + 2 * q3)
        + a2 * (2 * q2 + 5 * q3 - q4)
    )
    return num / (6.0 * (a0 + a1 + a2))


def _weno5_plus(q0, q1, q2, q3, q4, variant):
    """Reconstruct u^+ at the interface left of center cell q2."""
    d = tuple(reversed(_D5))
    a0, a1, a2 = _weno5_alphas_unnormalized(
        _weno5_betas(q0, q1, q2, q3, q4), d, variant
    )
    num = (
        a0 * (-q0 + 5 * q1 + 2 * q2)
        + a1 * (2 * q1 + 5 * q2 - q3)
        + a2 * (11 * q2 - 7 * q3 + 2 * q4)
    )
    return num / (6.0 * (a0 + a1 + a2))


_C13 = 13.0 / 12.0  # curvature coefficient of the smoothness indicators


def _curv(dd):
    """Curvature term ``13/12 dd^2`` of a second difference, associated
    ``(c * dd) * dd`` as in every sweep of the JAX package."""
    return _C13 * dd * dd


def _weno5_side_nd_e(e0, e1, e2, e3, variant, side):
    """:func:`_weno5_side_nd` with the curvature terms recomputed from
    the four first differences of the window."""
    return _weno5_side_nd(
        e0, e1, e2, e3,
        _curv(e1 - e0), _curv(e2 - e1), _curv(e3 - e2),
        variant, side,
    )


def _weno5_side_nd(e0, e1, e2, e3, cd0, cd1, cd2, variant, side):
    """One WENO5 reconstruction in forward-difference form, returned as
    unnormalized ``(numerator, denominator)`` of the deviation from the
    center cell: the reconstructed value is ``q2 + num/den``.

    ``e_j = q_{j+1} - q_j`` over the 5-cell window ``q0..q4`` and
    ``cd_k = 13/12 (e_{k+1} - e_k)^2``; ``side`` is ``"minus"`` (u^- at
    the interface right of the center) or ``"plus"`` (u^+ at the
    interface left of it). The ``6 q2`` term of every candidate cancels
    against the normalization, the ``1/6`` is folded into the
    e-coefficients, and the betas' ``0.25 l^2`` is ``(l/2)^2``.
    """
    l0 = 1.5 * e1 - 0.5 * e0
    l1 = 0.5 * e1 + 0.5 * e2  # -(q1 - q3)/2; sign irrelevant, squared
    l2 = 0.5 * e3 - 1.5 * e2
    betas = (
        cd0 + l0 * l0,
        cd1 + l1 * l1,
        cd2 + l2 * l2,
    )
    d = _D5 if side == "minus" else tuple(reversed(_D5))
    a0, a1, a2 = _weno5_alphas_unnormalized(betas, d, variant)
    s = 1.0 / 6.0
    if side == "minus":
        num = (
            a0 * (5.0 * s * e1 - 2.0 * s * e0)
            + a1 * (s * e1 + 2.0 * s * e2)
            + a2 * (4.0 * s * e2 - s * e3)
        )
    else:
        num = (
            a0 * (s * e0 - 4.0 * s * e1)
            + a1 * (-2.0 * s * e1 - s * e2)
            + a2 * (2.0 * s * e3 - 5.0 * s * e2)
        )
    return num, a0 + a1 + a2


# WENO7 smoothness indicators as quadratic forms in the three forward
# differences ``(ea, eb, ec) = (e_k, e_{k+1}, e_{k+2})``, ``e_j = q_{j+1} -
# q_j``, of each 4-cell stencil k: ``beta_k = A ea^2 + B eb^2 + C ec^2 +
# D ea eb + E eb ec + F ea ec`` (the JAX package's ``ops/weno.py::_B7``;
# rows ``(A, B, C, D, E, F)``). The same betas as the classical form on
# the values (``WENO7resAdv_X.m:60-83``), exactly, since the betas are
# shift-invariant; but the value form sums 1e5-scale products of the
# values that almost all cancel on smooth data, and the differences do
# not, so float32 keeps its digits.
_B7 = (
    (6649.0, 45076.0, 25729.0, -33916.0, -63436.0, 22778.0),
    (3169.0, 17236.0, 6649.0, -13036.0, -17116.0, 5978.0),
    (6649.0, 17236.0, 3169.0, -17116.0, -13036.0, 5978.0),
    (25729.0, 45076.0, 6649.0, -63436.0, -33916.0, 22778.0),
)


# Candidate-polynomial deviations from the center cell (x12) in the same
# difference windows (the JAX package's ``ops/weno.py::_C7``): stencil
# k's candidate is ``c + (ca e_k + cb e_{k+1} + cc e_{k+2})/12``; the plus
# side is the minus side under ``e_j -> -e_{5-j}``.
_C7 = {
    "minus": ((3.0, -10.0, 13.0), (-1.0, 4.0, 3.0),
              (1.0, 6.0, -1.0), (9.0, -4.0, 1.0)),
    "plus": ((-1.0, 4.0, -9.0), (1.0, -6.0, -1.0),
             (-3.0, -4.0, 1.0), (-13.0, 10.0, -3.0)),
}


def _weno7_side_nd_e(e0, e1, e2, e3, e4, e5, side):
    """One WENO7-JS reconstruction in forward-difference form, returned
    as unnormalized ``(numerator, denominator)`` of the deviation from
    the center cell: the reconstructed value is ``q3 + num/den`` (the
    e-form of the fused kernels K5, K6 and K7 at order 7).

    ``e_j = q_{j+1} - q_j`` over the 7-cell window ``q0..q6``; ``side``
    as in :func:`_weno5_side_nd`. The betas are the :data:`_B7` forms,
    the weights the division-free ``alpha_k' = d_k (prod_{j != k}
    s_j)^2`` with ``s_j = beta_j + eps``, and each coefficient ``ca/12``
    a Python double rounded once to the tensor's dtype. The alphas scale
    as ``beta^6``: in float32 they overflow for split-flux jumps above
    about 3.6, which bounded solver states stay under.
    """
    e = (e0, e1, e2, e3, e4, e5)
    d = _D7 if side == "minus" else tuple(reversed(_D7))
    cs = _C7[side]
    s = []
    for k in range(4):
        A, B, C, D, E, F = _B7[k]
        ea, eb, ec = e[k], e[k + 1], e[k + 2]
        beta = ((A * ea + D * eb + F * ec) * ea + (B * eb + E * ec) * eb
                + C * (ec * ec))
        s.append(beta + EPSILON)
    p01 = s[0] * s[1]
    p23 = s[2] * s[3]
    m = (s[1] * p23, s[0] * p23, p01 * s[3], p01 * s[2])
    t = 1.0 / 12.0
    num = den = None
    for k in range(4):
        a = d[k] * (m[k] * m[k])
        ca, cb, cc = cs[k]
        dev = (ca * t) * e[k] + (cb * t) * e[k + 1] + (cc * t) * e[k + 2]
        num = a * dev if num is None else num + a * dev
        den = a if den is None else den + a
    return num, den


def _weno7_betas(q):
    """The four betas of the 7-cell window ``q``, each as its ``_B7``
    form in the term order of the JAX package's ``_weno7_side_nd_e``:
    ``(A ea + D eb + F ec) ea + (B eb + E ec) eb + C (ec ec)``."""
    e = [q[j + 1] - q[j] for j in range(6)]
    betas = []
    for k, (A, B, C, D, E, F) in enumerate(_B7):
        ea, eb, ec = e[k], e[k + 1], e[k + 2]
        betas.append((A * ea + D * eb + F * ec) * ea
                     + (B * eb + E * ec) * eb + C * (ec * ec))
    return tuple(betas)


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as a true division (PyTorch evaluates ``float / tensor``
    as ``reciprocal(x) * c``, which rounds twice)."""
    return torch.div(x.new_tensor(c), x)


def _twelve(x: torch.Tensor) -> torch.Tensor:
    """12 as a tensor on ``x``'s device: ``t / 12.0`` would run on the GPU
    as a product with the reciprocal, which rounds twice; a division by
    a tensor is a true division on every device, as in the JAX package
    and in the per-axis kernel K12 (``csrc/weno7.cuh``)."""
    return x.new_tensor(12.0)


def _weno7_weights(betas, d):
    alphas = [_rdiv(dk, _sq(EPSILON + b)) for dk, b in zip(d, betas)]
    inv = _rdiv(1.0, sum(alphas[1:], alphas[0]))
    return [a * inv for a in alphas]


def _weno7_minus(q):
    m3, m2, m1, c, p1, p2, p3 = q
    w0, w1, w2, w3 = _weno7_weights(_weno7_betas(q), _D7)
    return (
        w0 * (-3 * m3 + 13 * m2 - 23 * m1 + 25 * c)
        + w1 * (m2 - 5 * m1 + 13 * c + 3 * p1)
        + w2 * (-m1 + 7 * c + 7 * p1 - p2)
        + w3 * (3 * c + 13 * p1 - 5 * p2 + p3)
    ).div(_twelve(m3))


def _weno7_plus(q):
    m3, m2, m1, c, p1, p2, p3 = q
    d = tuple(reversed(_D7))
    w0, w1, w2, w3 = _weno7_weights(_weno7_betas(q), d)
    return (
        w0 * (m3 - 5 * m2 + 13 * m1 + 3 * c)
        + w1 * (-m2 + 7 * m1 + 7 * c - p1)
        + w2 * (3 * m1 + 13 * c - 5 * p1 + p2)
        + w3 * (25 * c - 23 * p1 + 13 * p2 - 3 * p3)
    ).div(_twelve(m3))


def interface_flux_from_padded(
    up: torch.Tensor,
    axis: int,
    flux: Flux,
    order: int = 5,
    variant: str = "js",
) -> torch.Tensor:
    """Numerical flux at all ``N+1`` interfaces along ``axis``.

    ``up`` must be padded with ``HALO[order]`` ghost cells on both ends of
    ``axis``. Interface ``i`` sits between cells ``i-1`` and ``i``.
    """
    r = HALO[order]
    n_if = up.shape[axis] - 2 * r + 1  # N + 1 interfaces

    a = torch.abs(flux.df(up))
    fu = flux.f(up)
    vp_ = 0.5 * (fu + a * up)  # upwind-from-left state f^+
    vm_ = 0.5 * (fu - a * up)  # upwind-from-right state f^-

    if order == 5:
        # minus side: cells i-3..i+1 -> padded offsets 0..4
        v = [shifted(vp_, axis, j, n_if) for j in range(5)]
        # plus side: cells i-2..i+2 -> padded offsets 1..5
        u = [shifted(vm_, axis, j + 1, n_if) for j in range(5)]
        return _weno5_minus(*v, variant) + _weno5_plus(*u, variant)
    if order == 7:
        if variant != "js":
            raise ValueError("WENO7 supports only the 'js' variant")
        v = [shifted(vp_, axis, j, n_if) for j in range(7)]
        u = [shifted(vm_, axis, j + 1, n_if) for j in range(7)]
        return _weno7_minus(v) + _weno7_plus(u)
    raise ValueError(f"unsupported WENO order {order}; use 5 or 7")


def flux_divergence(
    u: torch.Tensor,
    axis: int,
    dx: float,
    flux: Flux,
    order: int = 5,
    variant: str = "js",
    padder: Padder | None = None,
    bc: Boundary | None = None,
    impl: str = "xla",
    ghost_fn: GhostFn | None = None,
    acc: torch.Tensor | None = None,
    negate: bool = False,
) -> torch.Tensor:
    """Conservative residual ``d f(u) / dx`` along one axis — the role of
    ``Compute_dF/dG/dH`` (``MultiGPU/Burgers3d_Baseline/Kernels.cu:225-452``).
    Exactly one of ``padder``/``bc`` selects the ghost-cell source.
    ``impl``: ``"xla"`` (the generic q-form over shifted slices) or
    ``"pallas"`` (the per-axis WENO kernel K12/K12b,
    :mod:`ops.kernels.weno`, on unpadded ``u``: its ghosts from ``bc``,
    or on an axis that ``ghost_fn`` shards from the ``(lo, hi)`` slabs
    it returns; a padder is not taken). A problem the kernel does not
    compute raises: the caller names that decline and asks for
    ``"xla"``. With ``impl="xla"``, ``ghost_fn`` switches sharded axes to
    the overlapped interior/boundary schedule
    (:func:`ops.stencils.split_axis_apply`). ``acc`` (a running sum over
    the axes) is added and ``negate`` negates the result: in the
    kernel's store, into ``acc`` in place, under ``"pallas"``.
    """
    if (padder is None) == (bc is None):
        raise ValueError("provide exactly one of padder/bc")
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown WENO impl {impl!r}; use 'xla'/'pallas'")
    if impl == "pallas" and bc is None:
        raise ValueError("impl='pallas' forms the ghosts in the kernel: "
                         "give bc (and ghost_fn for sharded axes), not a "
                         "padder")
    r = HALO[order]
    ghosts = None if ghost_fn is None else ghost_fn(u, axis, r)
    if impl == "pallas":
        from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
            weno as kweno,
        )

        return kweno.flux_divergence_kernel(
            u.contiguous(), axis, dx, flux, variant, order,
            bc=bc if ghosts is None else None, ghosts=ghosts, acc=acc,
            negate=negate)

    def div_from_padded(up):
        h = interface_flux_from_padded(up, axis, flux, order, variant)
        m = up.shape[axis] - 2 * r
        return (shifted(h, axis, 1, m) - shifted(h, axis, 0, m)) / dx

    if ghosts is not None:
        div = split_axis_apply(div_from_padded, u, axis, r, *ghosts)
    else:
        div = div_from_padded(padder(u, axis, r) if padder is not None
                              else pad_axis(u, axis, r, bc))
    if acc is not None:
        div = acc + div
    return -div if negate else div
