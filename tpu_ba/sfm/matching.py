"""Descriptor matching: mutual nearest neighbors + Lowe ratio test.

Capability parity: "feature detect+match" (BASELINE.json:5, SURVEY.md §2.1
R5). The K×K similarity matrix is one matmul; mutual-
NN and ratio tests are elementwise; output is fixed-size (K matches with a
validity mask) so downstream stays shape-static.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=())
def match_descriptors(desc1, desc2, score1=None, score2=None,
                      ratio: float = 0.8, min_sim: float = 0.5):
    """Match normalized descriptors (K1, D) × (K2, D).

    Returns (idx2 (K1,) int32 — best match in image 2 for each keypoint of
    image 1, valid (K1,) bool). Valid requires: mutual nearest neighbor,
    Lowe ratio (on 1−sim distances), similarity floor, and both keypoints
    real (score > 0 when scores given).
    """
    sim = desc1 @ desc2.T  # (K1, K2) cosine similarity
    if score1 is not None:
        sim = jnp.where(score1[:, None] > 0, sim, -jnp.inf)
    if score2 is not None:
        sim = jnp.where(score2[None, :] > 0, sim, -jnp.inf)

    best2, idx2 = jax.lax.top_k(sim, 2)            # per row: two best in img2
    best1 = jnp.max(sim, axis=0)                   # per col: best in img1
    mutual = best1[idx2[:, 0]] <= best2[:, 0] + 1e-12
    d1 = 1.0 - best2[:, 0]
    d2 = 1.0 - best2[:, 1]
    ratio_ok = d1 <= ratio * d2
    valid = mutual & ratio_ok & (best2[:, 0] > min_sim) & jnp.isfinite(best2[:, 0])
    return idx2[:, 0].astype(jnp.int32), valid
