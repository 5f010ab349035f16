"""Preconditioned conjugate gradients on the reduced camera system.

Capability parity: replaces the reference's direct "backslash" solve with a
distributed-friendly iterative solve (BASELINE.json:5 "preconditioned CG",
SURVEY.md §2.2 N6). Host-free: one ``lax.while_loop`` whose body is a single
S-matvec (plus its psums under sharding — SURVEY.md §3.2a);
early exit on the relative-residual test keeps rejected-λ retries cheap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pcg(matvec, b, precond, *, max_iters: int, tol: float, x0=None):
    """Solve A x = b with preconditioned CG.

    matvec: x ↦ A·x, precond: r ↦ M⁻¹·r — both over arbitrary pytree-free
    array shapes (reductions use the full array).
    Returns (x, iterations_used, ok) — ``ok`` is False when a pᵀAp ≤ 0
    breakdown was hit (A not positive definite at this damping). The
    iteration stops at the breakdown and the caller (the LM λ-retry loop)
    must treat the direction as unusable and raise λ instead of silently
    absorbing a garbage step (VERDICT.md round 1, weak #7).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)

    def dot(a, c):
        return jnp.sum(a * c)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    b_norm2 = dot(b, b)
    tol2 = tol * tol * jnp.maximum(b_norm2, jnp.asarray(1e-30, b.dtype))

    def cond(state):
        _, r, _, _, k, ok = state
        go = jnp.logical_and(k < max_iters, dot(r, r) > tol2)
        return jnp.logical_and(go, ok)     # stop immediately on breakdown

    def body(state):
        x, r, p, rz, k, ok = state
        Ap = matvec(p)
        pAp = dot(p, Ap)
        # breakdown (pAp ≤ 0 ⇒ S not PD at this damping; rz ≤ 0 ⇒ the
        # PRECONDITIONER is not PD — possible for the block-tridiagonal PCR
        # preconditioner on weakly-damped indefinite bands): freeze the iterate,
        # flag not-ok; cond exits on the next check
        broke = jnp.logical_or(pAp <= 0, rz <= 0)
        alpha = jnp.where(broke, 0.0, rz / jnp.where(jnp.abs(pAp) < 1e-30, 1e-30, pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = z + beta * p
        return (x, r, p, rz_new, k + 1, jnp.logical_and(ok, jnp.logical_not(broke)))

    x, r, p, rz, k, ok = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, jnp.asarray(0, jnp.int32), jnp.asarray(True))
    )
    return x, k, ok
