"""Hand-derived analytic Jacobian blocks for the BAL camera model.

The production fast path ("analytic Jacobian construction (camera + point
blocks)", BASELINE.json:5). Per observation the full chain is computed in
closed form — ~10× fewer FLOPs than the 12-tangent jacfwd oracle — and the
whole thing fuses with the residual into one elementwise XLA kernel over the
observation axis.

Chain (see tpu_ba/geometry/cameras.py for the model):
    P = R(aa)X + t,  p = -P_xy/P_z,  s = |p|²,  d = 1 + k1·s + k2·s²,
    u = f·d·p,       r = u − obs

    ∂u/∂p  = f·(d·I₂ + 2(k1 + 2k2 s)·p pᵀ)
    ∂p/∂P  = [[-1/z, 0, x/z²], [0, -1/z, y/z²]]
    ∂P/∂t  = I₃,  ∂P/∂X = R
    ∂P/∂aa = −R[X]×(aa aaᵀ + (Rᵀ−I)[aa]×)/θ²   (Gallego–Yezzi compact
             formula; → −[X]× as θ→0, guarded with a Taylor switch)
    ∂u/∂f = d·p,  ∂u/∂k1 = f·s·p,  ∂u/∂k2 = f·s²·p
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_ba.geometry.rotations import aa_to_matrix, skew

_SMALL_THETA2 = 1e-12


def _jac_one(cam, X, obs):
    """Single-observation residual + Jacobian blocks. cam: (9,), X: (3,)."""
    aa, t = cam[0:3], cam[3:6]
    f, k1, k2 = cam[6], cam[7], cam[8]

    R = aa_to_matrix(aa)
    P = R @ X + t
    x, y, z = P[0], P[1], P[2]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, jnp.asarray(1e-12, z.dtype), z)
    inv_z = 1.0 / z_safe
    p = -P[0:2] * inv_z
    s = p @ p
    d = 1.0 + s * (k1 + s * k2)
    u = f * d * p
    r = u - obs

    # ∂u/∂p (2,2)
    dd_ds = k1 + 2.0 * k2 * s
    du_dp = f * (d * jnp.eye(2, dtype=cam.dtype) + 2.0 * dd_ds * jnp.outer(p, p))

    # ∂p/∂P (2,3)
    dp_dP = jnp.array(
        [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=cam.dtype
    ) * inv_z + jnp.outer(p, jnp.array([0.0, 0.0, -1.0], dtype=cam.dtype)) * inv_z
    # row i: [-δ/z, ..., P_i/z²] — written as (-I₂|0)/z + outer(p, e_z)·(-1/z)
    # since p = -P_xy/z ⇒ P_i/z² = -p_i/z.

    du_dP = du_dp @ dp_dP  # (2,3)

    # ∂P/∂aa via Gallego–Yezzi, with small-angle fallback −[X]×
    theta2 = aa @ aa
    small = theta2 < _SMALL_THETA2
    theta2_safe = jnp.where(small, jnp.asarray(1.0, cam.dtype), theta2)
    K_aa = skew(aa)
    core = (jnp.outer(aa, aa) + (R.T - jnp.eye(3, dtype=cam.dtype)) @ K_aa) / theta2_safe
    dP_daa_full = -R @ skew(X) @ core
    dP_daa = jnp.where(small, -skew(X), dP_daa_full)

    Jc = jnp.concatenate(
        [
            du_dP @ dP_daa,            # (2,3) wrt aa
            du_dP,                     # (2,3) wrt t
            (d * p)[:, None],          # (2,1) wrt f
            (f * s * p)[:, None],      # (2,1) wrt k1
            (f * s * s * p)[:, None],  # (2,1) wrt k2
        ],
        axis=1,
    )
    Jp = du_dP @ R  # (2,3) wrt X
    return r, Jc, Jp


# out_axes=-1: the observation axis is the last (contiguous) axis, the
# lane-major layout the assembly (tpu_ba/solver/normal.py) consumes.
_jac_batch = jax.vmap(_jac_one, in_axes=(0, 0, 0), out_axes=-1)


def jacobian_blocks_bal(cameras, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Returns lane-major (r (2,O), Jc (2,9,O), Jp (2,3,O)); masked
    observations zeroed.

    Same contract as the autodiff oracle
    (:func:`tpu_ba.jacobians.autodiff.jacobian_blocks_bal_autodiff`).
    """
    cam = cameras[cam_idx]
    X = points[pt_idx]
    r, Jc, Jp = _jac_batch(cam, X, obs_2d)
    if mask is not None:
        r = jnp.where(mask[None, :], r, 0.0)
        Jc = jnp.where(mask[None, None, :], Jc, 0.0)
        Jp = jnp.where(mask[None, None, :], Jp, 0.0)
    return r, Jc, Jp
