"""Batched small-matrix linear algebra in pure jnp ops.

BA only ever inverts *damped SPD* blocks (3×3 point blocks, 9×9 camera
preconditioner blocks), so an unrolled Gauss-Jordan without pivoting is
exact enough and compiles to dense elementwise ops over the batch instead
of a batched pivoted LU (diagonal dominance from λ·diag damping keeps
pivots healthy; a floor guards exact zeros).
"""

from __future__ import annotations

import jax.numpy as jnp


def inv_spd_small(M, *, pivot_floor: float = 1e-30):
    """Batched inverse of small SPD matrices. M: (..., k, k), k static & small
    (unrolled k-step Gauss-Jordan, no pivoting)."""
    k = M.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(k, dtype=M.dtype), M.shape)
    A = jnp.concatenate([M, eye], axis=-1)  # (..., k, 2k)
    for i in range(k):
        piv = A[..., i, i:i + 1]
        piv = jnp.where(jnp.abs(piv) < pivot_floor,
                        jnp.asarray(pivot_floor, M.dtype), piv)
        row = A[..., i, :] / piv                        # (..., 2k)
        col = A[..., :, i]                              # (..., k)
        A = A - col[..., :, None] * row[..., None, :]
        A = A.at[..., i, :].set(row)
    return A[..., k:]
