"""Perspective-n-Point camera registration with batched RANSAC.

Capability parity: the reference pipeline's incremental camera registration
(PnP — SURVEY.md §2.1 R6). DLT minimal solves for a batch of
hypotheses under ``vmap``, then a short fixed-iteration Gauss-Newton pose
refinement on the inlier set — all shape-static.

Normalized camera coordinates (K⁻¹ applied), +z convention; pose maps world
to camera: x ≃ R X + t.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpu_ba.geometry.rotations import rotate_aa, matrix_to_aa, aa_to_matrix


def _dlt_pnp(X, x):
    """DLT pose from ≥6 2D–3D correspondences. X: (N, 3), x: (N, 2) →
    (R (3,3), t (3,)). Linear, up-to-scale; orthonormalized via SVD."""
    N = X.shape[0]
    zeros = jnp.zeros((N, 4), X.dtype)
    Xh = jnp.concatenate([X, jnp.ones((N, 1), X.dtype)], axis=1)  # (N,4)
    r1 = jnp.concatenate([Xh, zeros, -x[:, 0:1] * Xh], axis=1)    # (N,12)
    r2 = jnp.concatenate([zeros, Xh, -x[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)                          # (2N,12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=False)
    P = vt[-1].reshape(3, 4)
    M = P[:, 0:3]
    # orthonormalize M → R, fix scale/sign with det
    U, s, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    R = U @ jnp.diag(jnp.array([1.0, 1.0, 1.0], X.dtype) * d) @ Vt
    scale = d * 3.0 / jnp.maximum(jnp.sum(s), 1e-12)
    t = P[:, 3] * scale
    return R, t


def _reproj_errors(R, t, X, x):
    P = X @ R.T + t
    z = jnp.where(jnp.abs(P[:, 2:3]) < 1e-9, 1e-9, P[:, 2:3])
    return jnp.sum((P[:, 0:2] / z - x) ** 2, axis=-1)


def _gn_refine(aa, t, X, x, w, iters: int = 8):
    """Fixed-iteration damped Gauss-Newton on the 6-dof pose."""

    def residual(params):
        P = rotate_aa(params[None, 0:3], X) + params[3:6]
        z = jnp.where(jnp.abs(P[:, 2:3]) < 1e-9, 1e-9, P[:, 2:3])
        return ((P[:, 0:2] / z - x) * w[:, None]).reshape(-1)

    params0 = jnp.concatenate([aa, t])

    def body(_, params):
        r = residual(params)
        J = jax.jacfwd(residual)(params)       # (2N, 6)
        H = J.T @ J + 1e-6 * jnp.eye(6, dtype=params.dtype)
        g = J.T @ r
        step = jnp.linalg.solve(H, -g)
        new = params + step
        return jnp.where(jnp.sum(residual(new) ** 2) < jnp.sum(r**2), new, params)

    params = jax.lax.fori_loop(0, iters, body, params0)
    return params[0:3], params[3:6]


@partial(jax.jit, static_argnames=("n_hypotheses", "sample_size"))
def pnp_ransac(key, X, x, valid, *, n_hypotheses: int = 256,
               sample_size: int = 6, inlier_thresh: float = 1e-3):
    """RANSAC PnP. X: (K, 3) world points, x: (K, 2) normalized obs,
    valid: (K,) mask. Returns (aa (3,), t (3,), inliers (K,), n_inliers)."""
    K = X.shape[0]
    p = valid.astype(X.dtype)
    p = p / jnp.maximum(jnp.sum(p), 1.0)

    def hyp(k):
        idx = jax.random.choice(k, K, shape=(sample_size,), replace=False, p=p)
        R, t = _dlt_pnp(X[idx], x[idx])
        e = _reproj_errors(R, t, X, x)
        inl = (e < inlier_thresh) & valid & ((X @ R[2].T + t[2]) > 0)
        return matrix_to_aa(R), t, jnp.sum(inl)

    keys = jax.random.split(key, n_hypotheses)
    aas, ts, counts = jax.vmap(hyp)(keys)
    best = jnp.argmax(counts)
    aa, t = aas[best], ts[best]

    R = aa_to_matrix(aa)
    e = _reproj_errors(R, t, X, x)
    inl = (e < inlier_thresh) & valid
    aa, t = _gn_refine(aa, t, X, x, inl.astype(X.dtype))
    R = aa_to_matrix(aa)
    e = _reproj_errors(R, t, X, x)
    inl = (e < inlier_thresh) & valid
    return aa, t, inl, jnp.sum(inl)
