"""Robust loss kernels (Huber / Cauchy / arctan) with IRLS weights.

Capability parity: BASELINE.json:9 "Robust kernels (Huber/Cauchy)". The
reference class of package applies robust weighting inside its LM loop
(SURVEY.md §2.1 R3; reference mount empty — §0).

Formulation: for a residual block with squared norm ``s = |r|²`` the robust
cost is ``ρ(s)`` and the IRLS (triggs-style first-order) weight is
``w = ρ'(s)``; the weighted Gauss-Newton system uses ``√w·r`` and ``√w·J``.
Kernels are selected by a *static* integer id so the choice is baked into the
compiled XLA program (no data-dependent branching on the device).

ρ conventions (scale a in pixels):
  none:    ρ(s) = s
  huber:   ρ(s) = s                        if s ≤ a²
           ρ(s) = 2a√s − a²                otherwise
  cauchy:  ρ(s) = a² log(1 + s/a²)
  arctan:  ρ(s) = a² arctan(s/a²)
"""

from __future__ import annotations

import jax.numpy as jnp

ROBUST_NONE = 0
ROBUST_HUBER = 1
ROBUST_CAUCHY = 2
ROBUST_ARCTAN = 3
ROBUST_KINDS = {"none": ROBUST_NONE, "huber": ROBUST_HUBER,
                "cauchy": ROBUST_CAUCHY, "arctan": ROBUST_ARCTAN}


def robust_rho(kind: int, s, scale):
    """ρ(s) for squared residual norms s. ``kind`` must be static."""
    a2 = scale * scale
    if kind == ROBUST_NONE:
        return s
    if kind == ROBUST_HUBER:
        s_safe = jnp.maximum(s, a2)
        return jnp.where(s <= a2, s, 2.0 * scale * jnp.sqrt(s_safe) - a2)
    if kind == ROBUST_CAUCHY:
        return a2 * jnp.log1p(s / a2)
    if kind == ROBUST_ARCTAN:
        return a2 * jnp.arctan(s / a2)
    raise ValueError(f"unknown robust kind {kind}")


def robust_weight(kind: int, s, scale):
    """IRLS weight w = ρ'(s). ``kind`` must be static."""
    a2 = scale * scale
    if kind == ROBUST_NONE:
        return jnp.ones_like(s)
    if kind == ROBUST_HUBER:
        s_safe = jnp.maximum(s, a2)
        return jnp.where(s <= a2, jnp.ones_like(s), scale / jnp.sqrt(s_safe))
    if kind == ROBUST_CAUCHY:
        return 1.0 / (1.0 + s / a2)
    if kind == ROBUST_ARCTAN:
        return 1.0 / (1.0 + (s / a2) ** 2)
    raise ValueError(f"unknown robust kind {kind}")


def robust_cost(kind: int, r2d, scale, mask=None):
    """Total robust cost ½ Σ ρ(|r_o|²) over observations.

    r2d: (O, 2) per-observation residuals; mask: (O,) validity (padding).
    """
    s = jnp.sum(r2d * r2d, axis=-1)
    rho = robust_rho(kind, s, scale)
    if mask is not None:
        rho = jnp.where(mask, rho, jnp.zeros_like(rho))
    return 0.5 * jnp.sum(rho)
