"""Batched reprojection residuals.

Capability parity: "reprojection-error evaluation" (BASELINE.json:5,
SURVEY.md §2.1 R1). One gather per observation for the camera row and the
point row, then a vectorized projection — XLA fuses the whole residual
evaluation, which is bound by the memory traffic of the two gathers.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_ba.geometry.cameras import project_bal, project_pinhole


def residuals_bal(cameras, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Per-observation residuals for the BAL model.

    cameras: (C, 9), points: (P, 3), obs_2d: (O, 2), cam_idx/pt_idx: (O,).
    Returns (O, 2) residuals (predicted − measured); masked rows are zero.
    """
    cam = cameras[cam_idx]          # (O, 9) gather
    X = points[pt_idx]              # (O, 3) gather
    r = project_bal(cam, X) - obs_2d
    if mask is not None:
        r = jnp.where(mask[:, None], r, jnp.zeros_like(r))
    return r


def residuals_pinhole(cameras, intrinsics, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Per-observation residuals for the pinhole fixed-K model.

    cameras: (C, 6), intrinsics: (C, 4), rest as :func:`residuals_bal`.
    """
    cam = cameras[cam_idx]
    K = intrinsics[cam_idx]
    X = points[pt_idx]
    r = project_pinhole(cam, K, X) - obs_2d
    if mask is not None:
        r = jnp.where(mask[:, None], r, jnp.zeros_like(r))
    return r


def cost_from_residuals(r, mask=None):
    """Plain (non-robust) cost ½ Σ |r_o|²."""
    s = jnp.sum(r * r, axis=-1)
    if mask is not None:
        s = jnp.where(mask, s, jnp.zeros_like(s))
    return 0.5 * jnp.sum(s)
