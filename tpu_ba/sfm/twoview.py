"""Two-view geometry: essential-matrix RANSAC and decomposition.

Capability parity: the reference pipeline's two-view initialization
(E/F matrix + RANSAC — SURVEY.md §2.1 R6). RANSAC is a *batch*
of hypotheses evaluated simultaneously under ``vmap`` (one (M,8)-sample
8-point solve + one (M,K) Sampson-distance matrix), not a sequential loop —
the classic trade of latency for throughput on a wide machine.

All functions work in **normalized camera coordinates** (K⁻¹ already
applied), +z look direction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _eight_point(x1, x2):
    """Essential matrix from 8+ normalized correspondences (N, 2) each.
    Returns E (3, 3) with singular values projected to (1, 1, 0)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    # epipolar constraint x2ᵀ E x1 = 0, rows of A are kron(x2, x1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1
    )
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    E = vt[-1].reshape(3, 3)
    U, s, Vt = jnp.linalg.svd(E)
    s_proj = jnp.array([1.0, 1.0, 0.0], E.dtype)
    return U @ jnp.diag(s_proj) @ Vt


def sampson_distance(E, x1, x2):
    """Squared Sampson distance of correspondences to the epipolar model."""
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    p1 = jnp.concatenate([x1, ones], axis=-1)  # (K,3)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    Ex1 = p1 @ E.T          # (K,3)
    Etx2 = p2 @ E           # (K,3)
    num = jnp.sum(p2 * Ex1, axis=-1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


@partial(jax.jit, static_argnames=("n_hypotheses",))
def estimate_essential_ransac(key, x1, x2, valid, *, n_hypotheses: int = 512,
                              inlier_thresh: float = 1e-3):
    """Batched-RANSAC essential matrix.

    x1, x2: (K, 2) normalized correspondences; valid: (K,) mask.
    Returns (E (3,3), inliers (K,) bool, n_inliers).
    """
    K = x1.shape[0]
    p = valid.astype(x1.dtype)
    p = p / jnp.maximum(jnp.sum(p), 1.0)

    def one_hypothesis(k):
        idx = jax.random.choice(k, K, shape=(8,), replace=False, p=p)
        E = _eight_point(x1[idx], x2[idx])
        d = sampson_distance(E, x1, x2)
        inl = (d < inlier_thresh) & valid
        return E, jnp.sum(inl)

    keys = jax.random.split(key, n_hypotheses)
    Es, counts = jax.vmap(one_hypothesis)(keys)
    best = jnp.argmax(counts)
    E_best = Es[best]

    # local optimization: iterate (refit on inliers → recompute inliers),
    # keeping the best model seen (LO-RANSAC style, fixed trip count)
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A_full = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, jnp.ones_like(u1)],
        axis=-1,
    )

    def refit_round(carry, mult):
        # refit on inliers taken at a wider threshold (annealing ladder),
        # score at the target threshold; keep the best model seen
        E_cur, inl_cur, n_cur = carry
        d_cur = sampson_distance(E_cur, x1, x2)
        fit_set = (d_cur < inlier_thresh * mult) & valid
        w = fit_set.astype(x1.dtype)[:, None]
        _, _, vt = jnp.linalg.svd(A_full * w, full_matrices=True)
        E_new = vt[-1].reshape(3, 3)
        U, s, Vt = jnp.linalg.svd(E_new)
        E_new = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], x1.dtype)) @ Vt
        d = sampson_distance(E_new, x1, x2)
        inl_new = (d < inlier_thresh) & valid
        n_new = jnp.sum(inl_new)
        better = n_new >= n_cur
        return (jnp.where(better, E_new, E_cur),
                jnp.where(better, inl_new, inl_cur),
                jnp.maximum(n_new, n_cur)), None

    d0 = sampson_distance(E_best, x1, x2)
    inl0 = (d0 < inlier_thresh) & valid
    mults = jnp.asarray([16.0, 8.0, 4.0, 2.0, 1.0, 1.0], x1.dtype)
    (E_out, inl_out, n_out), _ = jax.lax.scan(
        refit_round, (E_best, inl0, jnp.sum(inl0)), mults)
    return E_out, inl_out, n_out


def decompose_essential(E, x1, x2, inliers):
    """E → (R, t) with cheirality disambiguation (most points in front of
    both cameras). Returns (R (3,3), t (3,) unit-norm, n_good)."""
    from tpu_ba.sfm.triangulate import triangulate_points

    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[:, 2]

    eye34 = jnp.concatenate([jnp.eye(3, dtype=E.dtype), jnp.zeros((3, 1), E.dtype)], 1)

    def score(R, tt):
        P2 = jnp.concatenate([R, tt[:, None]], axis=1)
        X = triangulate_points(eye34, P2, x1, x2)
        z1 = X[:, 2]
        z2 = (X @ R[2].T) + tt[2]
        good = (z1 > 0) & (z2 > 0) & inliers
        return jnp.sum(good)

    cands = [(Ra, t), (Ra, -t), (Rb, t), (Rb, -t)]
    scores = jnp.stack([score(R, tt) for R, tt in cands])
    best = jnp.argmax(scores)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return Rs[best], ts[best], scores[best]
