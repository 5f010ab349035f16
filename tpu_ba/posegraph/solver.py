"""Pose-graph refinement: LM over SE(3) relative-pose constraints.

Capability parity: "downstream pose-graph refinement" (BASELINE.json:5,
SURVEY.md §2.1 R7). Same host-free LM skeleton as the BA core (SURVEY.md
§3.1c: "same LM skeleton with relative-SE(3) residuals"), specialized:

  * residual per edge: r_e = log( Z_e⁻¹ · (g_i · g_j⁻¹) ) ∈ ℝ⁶ with an
    optional 6×6 information weighting,
  * 6×6 Jacobian blocks per edge endpoint via vmapped ``jacfwd`` (pose
    graphs are thousands of nodes at most — autodiff is exact and the
    whole linearization is one fused batch),
  * dense damped normal equations solved with Cholesky — one 6N×6N
    dense solve instead of sparse bookkeeping, which bounds N by memory
    (ROADMAP 2f); the gauge is fixed by an anchor prior on node 0.

Right-multiplicative local update: g ← exp(δ) ∘ g.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpu_ba.geometry.se3 import se3_compose, se3_exp, se3_inverse, se3_log


def _edge_residual(g_i, g_j, z_ij):
    """r = log(Z⁻¹ ∘ g_i ∘ g_j⁻¹) — zero when the relative pose matches."""
    rel = se3_compose(g_i, se3_inverse(g_j))
    return se3_log(se3_compose(se3_inverse(z_ij), rel))


def _edge_residual_local(delta_i, delta_j, g_i, g_j, z_ij):
    """Residual after right-multiplicative perturbations exp(δ)∘g."""
    gi = se3_compose(se3_exp(delta_i), g_i)
    gj = se3_compose(se3_exp(delta_j), g_j)
    return _edge_residual(gi, gj, z_ij)


_jac_i = jax.vmap(jax.jacfwd(_edge_residual_local, argnums=0),
                  in_axes=(None, None, 0, 0, 0))
_jac_j = jax.vmap(jax.jacfwd(_edge_residual_local, argnums=1),
                  in_axes=(None, None, 0, 0, 0))
_res_batch = jax.vmap(_edge_residual, in_axes=(0, 0, 0))


def pose_graph_cost(nodes, ei, ej, meas, sqrt_info=None):
    """½ Σ_e |Ω_e^{1/2} r_e|²."""
    r = _res_batch(nodes[ei], nodes[ej], meas)
    if sqrt_info is not None:
        r = jnp.einsum("eij,ej->ei", sqrt_info, r)
    return 0.5 * jnp.sum(r * r)


@partial(jax.jit, static_argnames=("max_iters",))
def solve_pose_graph(nodes0, ei, ej, meas, sqrt_info=None, *,
                     max_iters: int = 30, init_lambda: float = 1e-4,
                     anchor_weight: float = 1e8):
    """LM pose-graph optimization.

    nodes0: (N, 6) initial poses [aa, t]; ei, ej: (E,) edge endpoints;
    meas: (E, 6) measured relative poses g_i ∘ g_j⁻¹; sqrt_info: optional
    (E, 6, 6) square-root information matrices.
    Returns (nodes, final_cost, iterations).
    """
    N = nodes0.shape[0]
    dtype = nodes0.dtype
    zero6 = jnp.zeros(6, dtype)

    def linearize(nodes):
        gi, gj = nodes[ei], nodes[ej]
        r = _res_batch(gi, gj, meas)                       # (E,6)
        Ji = _jac_i(zero6, zero6, gi, gj, meas)            # (E,6,6)
        Jj = _jac_j(zero6, zero6, gi, gj, meas)
        if sqrt_info is not None:
            r = jnp.einsum("eij,ej->ei", sqrt_info, r)
            Ji = jnp.einsum("eij,ejk->eik", sqrt_info, Ji)
            Jj = jnp.einsum("eij,ejk->eik", sqrt_info, Jj)
        cost = 0.5 * jnp.sum(r * r)

        # dense H (6N × 6N) from the four blocks of each edge
        H = jnp.zeros((N * 6, N * 6), dtype)
        g = jnp.zeros(N * 6, dtype)
        a6 = jnp.arange(6)
        ri = ei[:, None, None] * 6 + a6[None, :, None]
        rj = ej[:, None, None] * 6 + a6[None, :, None]
        ci = ei[:, None, None] * 6 + a6[None, None, :]
        cj = ej[:, None, None] * 6 + a6[None, None, :]
        JiTJi = jnp.einsum("eki,ekj->eij", Ji, Ji)
        JjTJj = jnp.einsum("eki,ekj->eij", Jj, Jj)
        JiTJj = jnp.einsum("eki,ekj->eij", Ji, Jj)
        H = H.at[ri, ci].add(JiTJi)
        H = H.at[rj, cj].add(JjTJj)
        H = H.at[ri, cj].add(JiTJj)
        H = H.at[rj, ci].add(jnp.swapaxes(JiTJj, -1, -2))
        gi_v = jnp.einsum("eki,ek->ei", Ji, r)
        gj_v = jnp.einsum("eki,ek->ei", Jj, r)
        g = g.at[(ei[:, None] * 6 + a6[None, :]).reshape(-1)].add(gi_v.reshape(-1))
        g = g.at[(ej[:, None] * 6 + a6[None, :]).reshape(-1)].add(gj_v.reshape(-1))

        # gauge anchor on node 0
        H = H.at[jnp.arange(6), jnp.arange(6)].add(anchor_weight)
        return r, H, g, cost

    _, _, _, cost0 = linearize(nodes0)

    def cond(state):
        _, _, _, it, done = state
        return jnp.logical_and(it < max_iters, jnp.logical_not(done))

    def body(state):
        nodes, lam, cost, it, _ = state
        _, H, g, _ = linearize(nodes)
        d = jnp.clip(jnp.diagonal(H), 1e-8, 1e32)
        delta = jnp.linalg.solve(H + lam * jnp.diag(d), -g).reshape(N, 6)
        new_nodes = se3_compose(se3_exp(delta), nodes)
        new_cost = pose_graph_cost(new_nodes, ei, ej, meas, sqrt_info)
        accept = jnp.logical_and(new_cost < cost, jnp.isfinite(new_cost))
        nodes = jnp.where(accept, new_nodes, nodes)
        cost_next = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12),
                        jnp.minimum(lam * 4.0, 1e10))
        rel = (cost - cost_next) / jnp.maximum(cost, 1e-30)
        done = jnp.logical_and(accept, rel < 1e-10)
        return (nodes, lam, cost_next, it + 1, done)

    nodes, lam, cost, it, _ = jax.lax.while_loop(
        cond, body, (nodes0, jnp.asarray(init_lambda, dtype), cost0,
                     jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return nodes, cost, it
