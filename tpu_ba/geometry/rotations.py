"""Rotation parameterizations: angle-axis (Rodrigues), quaternions, matrices.

Design notes:
  * Every function is a pure, dtype-polymorphic jnp function, safe under
    ``vmap``/``jit``/``grad`` — small-angle branches are handled with
    ``jnp.where`` on *safe* intermediates (no NaN gradients at theta=0).
  * The production BA path rotates points directly with :func:`rotate_aa`
    (never materializing 3x3 matrices per observation) so the per-observation
    work stays elementwise and fuses into the residual kernel.

Capability parity: the reference package's rotation utilities (angle-axis /
quaternion / matrix conversions used by its LM camera blocks — SURVEY.md §1.1
"Geometry / camera model" layer; reference mount empty, see SURVEY.md §0).
"""

from __future__ import annotations

import jax.numpy as jnp

# Below this squared angle we switch to 2nd-order Taylor forms. Safe for both
# f32 (eps~1e-7) and f64 tests.
_SMALL_THETA2 = 1e-12


def _safe_theta(theta2):
    """sqrt(theta2) that is NaN-free (value and gradient) at theta2==0."""
    small = theta2 < _SMALL_THETA2
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    return small, jnp.sqrt(theta2_safe)


def rotate_aa(aa, x):
    """Rotate point(s) ``x`` (..., 3) by angle-axis ``aa`` (..., 3).

    Rodrigues: R x = x cos(t) + (k × x) sin(t) + k (k·x)(1 − cos(t)),
    with k = aa/t, t = |aa|.  Near t=0 uses the 2nd-order Taylor expansion
    R x ≈ x + aa × x + ½ aa × (aa × x), exact to O(t³).
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    small, theta = _safe_theta(theta2)
    k = aa / theta
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    kxx = jnp.cross(k, x)
    kdx = jnp.sum(k * x, axis=-1, keepdims=True)
    rot = x * c + kxx * s + k * kdx * (1.0 - c)
    aaxx = jnp.cross(aa, x)
    rot_small = x + aaxx + 0.5 * jnp.cross(aa, aaxx)
    return jnp.where(small, rot_small, rot)


def rotate_aa_transpose(aa, x):
    """Apply the inverse rotation: R(aa)ᵀ x = R(−aa) x."""
    return rotate_aa(-aa, x)


def aa_to_matrix(aa):
    """Angle-axis (..., 3) → rotation matrix (..., 3, 3)."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), aa.shape[:-1] + (3, 3))
    cols = rotate_aa(aa[..., None, :], eye)  # rotates each basis vector
    return jnp.swapaxes(cols, -1, -2)


def matrix_to_aa(R):
    """Rotation matrix (..., 3, 3) → angle-axis (..., 3).

    Uses the quaternion route for numerical robustness near pi.
    """
    return quat_to_aa(matrix_to_quat(R))


def aa_to_quat(aa):
    """Angle-axis (..., 3) → unit quaternion (..., 4) in (w, x, y, z) order."""
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    small, theta = _safe_theta(theta2)
    half = 0.5 * theta
    # sin(t/2)/t, Taylor: 1/2 - t²/48
    sinc_half = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([w, aa * sinc_half], axis=-1)


def quat_to_aa(q):
    """Unit quaternion (..., 4) (w,x,y,z) → angle-axis (..., 3).

    Branch-free over hemispheres: uses atan2(|v|, w) and handles w<0 by the
    sign-flip invariance q ≡ −q.
    """
    q = jnp.where(q[..., :1] < 0, -q, q)
    w = q[..., :1]
    v = q[..., 1:]
    sin_half2 = jnp.sum(v * v, axis=-1, keepdims=True)
    small, sin_half = _safe_theta(sin_half2)
    theta = 2.0 * jnp.arctan2(sin_half, w)
    # theta / sin(theta/2), Taylor: 2 + theta²/12 ≈ 2 + sin_half2/3
    scale = jnp.where(small, 2.0 + sin_half2 / 3.0, theta / sin_half)
    return v * scale


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4) (w,x,y,z).

    Shepperd's method, branch-free via jnp.where over the four cases.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # case w: t = 1 + tr
    tw = 1.0 + tr
    sw = 2.0 * jnp.sqrt(jnp.maximum(tw, 1e-30))
    qw = jnp.stack([sw / 4.0, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], axis=-1)
    # case x
    tx = 1.0 + m00 - m11 - m22
    sx = 2.0 * jnp.sqrt(jnp.maximum(tx, 1e-30))
    qx = jnp.stack([(m21 - m12) / sx, sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx], axis=-1)
    # case y
    ty = 1.0 - m00 + m11 - m22
    sy = 2.0 * jnp.sqrt(jnp.maximum(ty, 1e-30))
    qy = jnp.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy], axis=-1)
    # case z
    tz = 1.0 - m00 - m11 + m22
    sz = 2.0 * jnp.sqrt(jnp.maximum(tz, 1e-30))
    qz = jnp.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0], axis=-1)

    use_w = (tr > 0.0)[..., None]
    use_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    use_y = (m11 >= m22)[..., None]
    q = jnp.where(use_w, qw, jnp.where(use_x, qx, jnp.where(use_y, qy, qz)))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) (w,x,y,z) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack([
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ], axis=-2)


def quat_mul(q1, q2):
    """Hamilton product of quaternions in (w,x,y,z) order."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def skew(v):
    """(..., 3) → skew-symmetric matrix [v]× (..., 3, 3)."""
    zeros = jnp.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([
        jnp.stack([zeros, -vz, vy], axis=-1),
        jnp.stack([vz, zeros, -vx], axis=-1),
        jnp.stack([-vy, vx, zeros], axis=-1),
    ], axis=-2)
