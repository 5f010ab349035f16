"""Feature detection and description — Harris corners + normalized patches.

Capability parity: the reference pipeline's "upstream feature detect+match"
(BASELINE.json:5, SURVEY.md §2.1 R5; that class of package wraps
KLT/Harris-style detectors). Everything is convolution / window reductions
over the full image, with a fixed top-K so shapes stay static for jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _sobel(img):
    """Image gradients via 3×3 Sobel. img: (H, W) → (gx, gy)."""
    kx = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], img.dtype) / 8.0
    ky = kx.T
    pad = jnp.pad(img, 1, mode="edge")[None, None]
    gx = jax.lax.conv(pad, kx[None, None], (1, 1), "VALID")[0, 0]
    gy = jax.lax.conv(pad, ky[None, None], (1, 1), "VALID")[0, 0]
    return gx, gy


def _box_filter(x, radius: int):
    """Mean filter with (2r+1)² window via two 1-D convs."""
    k = jnp.ones((2 * radius + 1,), x.dtype) / (2 * radius + 1)
    xp = jnp.pad(x, ((radius, radius), (0, 0)), mode="edge")
    x1 = jax.lax.conv(xp[None, None], k[None, None, :, None], (1, 1), "VALID")[0, 0]
    xp = jnp.pad(x1, ((0, 0), (radius, radius)), mode="edge")
    return jax.lax.conv(xp[None, None], k[None, None, None, :], (1, 1), "VALID")[0, 0]


@partial(jax.jit, static_argnames=("max_corners", "nms_radius", "window_radius"))
def detect_harris(img, max_corners: int = 512, k: float = 0.04,
                  nms_radius: int = 4, window_radius: int = 2):
    """Harris corner detector with non-max suppression and static top-K.

    img: (H, W) float. Returns (xy (K, 2) float [x, y], score (K,)).
    Weak/padded slots have score ≤ 0.
    """
    gx, gy = _sobel(img)
    Ixx = _box_filter(gx * gx, window_radius)
    Iyy = _box_filter(gy * gy, window_radius)
    Ixy = _box_filter(gx * gy, window_radius)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    R = det - k * tr * tr

    # non-max suppression: keep pixels equal to their window max
    w = 2 * nms_radius + 1
    Rmax = jax.lax.reduce_window(
        R, -jnp.inf, jax.lax.max, (w, w), (1, 1), "SAME")
    is_peak = (R >= Rmax) & (R > 0)
    score = jnp.where(is_peak, R, -jnp.inf)

    # kill a border band (descriptor windows must fit)
    H, W = img.shape
    yy, xx = jnp.mgrid[0:H, 0:W]
    border = 8
    inside = (xx >= border) & (xx < W - border) & (yy >= border) & (yy < H - border)
    score = jnp.where(inside, score, -jnp.inf)

    flat = score.reshape(-1)
    top_scores, top_idx = jax.lax.top_k(flat, max_corners)
    ys = (top_idx // W).astype(jnp.int32)
    xs = (top_idx % W).astype(jnp.int32)

    # sub-pixel refinement: quadratic fit of the Harris response around the
    # peak (dx = -0.5 R'/R'' per axis, clamped to ±0.5)
    def _subpix(x0, y0):
        rm = R[y0, jnp.maximum(x0 - 1, 0)]
        rp = R[y0, jnp.minimum(x0 + 1, W - 1)]
        rc = R[y0, x0]
        denom_x = rm - 2 * rc + rp
        dx = jnp.where(jnp.abs(denom_x) > 1e-12,
                       0.5 * (rm - rp) / jnp.where(jnp.abs(denom_x) > 1e-12, denom_x, 1.0),
                       0.0)
        um = R[jnp.maximum(y0 - 1, 0), x0]
        up = R[jnp.minimum(y0 + 1, H - 1), x0]
        denom_y = um - 2 * rc + up
        dy = jnp.where(jnp.abs(denom_y) > 1e-12,
                       0.5 * (um - up) / jnp.where(jnp.abs(denom_y) > 1e-12, denom_y, 1.0),
                       0.0)
        return jnp.clip(dx, -0.5, 0.5), jnp.clip(dy, -0.5, 0.5)

    dxs, dys = jax.vmap(_subpix)(xs, ys)
    xy = jnp.stack([xs.astype(jnp.float32) + dxs, ys.astype(jnp.float32) + dys], axis=-1)
    return xy, top_scores


@partial(jax.jit, static_argnames=("patch_radius",))
def describe_patches(img, xy, patch_radius: int = 4):
    """Normalized intensity-patch descriptors at integer corner locations.

    img: (H, W); xy: (K, 2) → (K, (2r+1)²) zero-mean unit-norm descriptors.
    """
    r = patch_radius
    d = 2 * r + 1

    def _one(p):
        x0 = jnp.clip(p[0].astype(jnp.int32) - r, 0, img.shape[1] - d)
        y0 = jnp.clip(p[1].astype(jnp.int32) - r, 0, img.shape[0] - d)
        patch = jax.lax.dynamic_slice(img, (y0, x0), (d, d)).reshape(-1)
        patch = patch - jnp.mean(patch)
        return patch / (jnp.linalg.norm(patch) + 1e-8)

    return jax.vmap(_one)(xy)
