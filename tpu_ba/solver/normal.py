"""Block-sparse Gauss-Newton system assembly.

Capability parity: "sparse JᵀJ assembly" of the reference's normal-equation
step (BASELINE.json:5, SURVEY.md §2.1 R4). Instead of a global sparse
matrix, the system is kept in *block* form:

    H = [ U   W ]     U: (C, dc, dc) camera diagonal blocks
        [ Wᵀ  V ]     V: (P, 3, 3)  point diagonal blocks
                      W: (O, dc, 3) one coupling block per observation
                         (each (camera, point) pair is observed at most once,
                          so W's sparsity pattern IS the observation list)

U, V and the gradient are segment-sums over the observation axis — batched
outer products followed by a segmented reduction. Observations arrive sorted
by camera (tpu_ba.core.make_problem), so the camera-indexed segment sums
reduce over contiguous runs (``indices_are_sorted=True``).

Robust IRLS weighting (√ρ′ scaling of r and J) happens here, once per
linearization, following the standard first-order robustified Gauss-Newton.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_ba.residuals.robust import robust_weight


class BlockSystem(NamedTuple):
    """The assembled (robust-weighted) Gauss-Newton system in block form.

    Observation/point-indexed arrays are **lane-major** (batch axis last), so
    the per-block algebra is row arithmetic over long contiguous rows and no
    layout pads the tiny (dc, 3) block dims.
    """

    U: jax.Array        # (C, dc, dc) camera diagonal blocks of JᵀJ
    V: jax.Array        # (9, P)      point diagonal blocks, row 3a+b = V[a,b]
    W: jax.Array        # (3·dc, O)   coupling blocks, row 3m+n = W[m,n]
    gc: jax.Array       # (C, dc)     camera gradient Jᵀr
    gp: jax.Array       # (3, P)      point gradient Jᵀr
    cost: jax.Array     # scalar, ½ Σ ρ(|r|²)
    cam_idx: jax.Array  # (O,)
    pt_idx: jax.Array   # (O,)


def apply_irls_weights(r, Jc, Jp, robust_kind: int, robust_scale: float, mask=None):
    """Scale residuals and Jacobian blocks by √ρ′(|r|²). Lane-major inputs:
    r (2,O), Jc (2,dc,O), Jp (2,3,O).

    Returns (r_w, Jc_w, Jp_w, cost) where cost is the *robust* cost of the
    unweighted residuals.
    """
    s = jnp.sum(r * r, axis=0)
    from tpu_ba.residuals.robust import robust_rho

    rho = robust_rho(robust_kind, s, robust_scale)
    if mask is not None:
        rho = jnp.where(mask, rho, 0.0)
    cost = 0.5 * jnp.sum(rho)

    w = robust_weight(robust_kind, s, robust_scale)
    if mask is not None:
        w = jnp.where(mask, w, 0.0)
    sw = jnp.sqrt(w)
    return r * sw[None, :], Jc * sw[None, None, :], Jp * sw[None, None, :], cost


def assemble(r, Jc, Jp, cam_idx, pt_idx, n_cameras: int, n_points: int,
             robust_kind: int = 0, robust_scale: float = 1.0, mask=None,
             axis_name: str | None = None) -> BlockSystem:
    """Assemble the block system from per-observation residuals/Jacobians.

    All inputs already have masked rows zeroed (see jacobian_blocks_*); the
    IRLS weighting re-applies the mask to guard the ρ′ of padded rows.

    Under ``shard_map`` (observations sharded over ``axis_name``,
    cameras/points replicated — SURVEY.md §2.2 N8) the segment sums become
    local partial sums followed by one ``psum`` each; U/V/g/cost come back
    replicated, while W and the index maps stay shard-local (the Schur matvec
    consumes them shard-locally with its own psums).
    """
    r, Jc, Jp, cost = apply_irls_weights(r, Jc, Jp, robust_kind, robust_scale, mask)

    # per-observation outer products — row products over the batch axis
    O = r.shape[-1]
    dc = Jc.shape[1]
    UtU = jnp.einsum("smo,sno->mno", Jc, Jc).reshape(dc * dc, O)
    VtV = jnp.einsum("smo,sno->mno", Jp, Jp).reshape(9, O)
    W = jnp.einsum("smo,sno->mno", Jc, Jp).reshape(dc * 3, O)
    gco = jnp.einsum("smo,so->mo", Jc, r)      # (dc, O)
    gpo = jnp.einsum("smo,so->mo", Jp, r)      # (3, O)

    # one packed reduction per side (camera: dc²+dc rows, point: 12)
    cam_packed = jax.ops.segment_sum(
        jnp.concatenate([UtU, gco], axis=0).T, cam_idx, n_cameras,
        indices_are_sorted=True).T
    U = cam_packed[: dc * dc].reshape(dc, dc, n_cameras).transpose(2, 0, 1)
    gc = cam_packed[dc * dc:].T
    pt_packed = jax.ops.segment_sum(
        jnp.concatenate([VtV, gpo], axis=0).T, pt_idx, n_points).T
    V = pt_packed[:9]
    gp = pt_packed[9:]

    if axis_name is not None:
        U = jax.lax.psum(U, axis_name)
        V = jax.lax.psum(V, axis_name)
        gc = jax.lax.psum(gc, axis_name)
        gp = jax.lax.psum(gp, axis_name)
        cost = jax.lax.psum(cost, axis_name)

    return BlockSystem(U=U, V=V, W=W, gc=gc, gp=gp, cost=cost,
                       cam_idx=cam_idx, pt_idx=pt_idx)


def damp_blocks(B, lam, diag_floor: float, diag_ceil: float):
    """Marquardt damping: add λ·clamp(diag) to the diagonal of each block.

    Returns (U_λ (C,dc,dc), V_λ (9,P) lane-major). Matches the reference's
    per-iteration damping of the normal equations (BASELINE.json:5), in
    Ceres' diagonal-scaled form.
    """
    dU = jnp.clip(jnp.diagonal(B.U, axis1=-2, axis2=-1), diag_floor, diag_ceil)
    n = B.U.shape[-1]
    Ul = B.U + lam * dU[..., None] * jnp.eye(n, dtype=B.U.dtype)

    V = B.V
    Vl = V
    for a in range(3):
        Vl = Vl.at[4 * a].add(lam * jnp.clip(V[4 * a], diag_floor, diag_ceil))
    return Ul, Vl
