"""Matrix-free Schur complement: eliminate points, solve cameras.

Capability parity: "Schur-complement elimination of points" (BASELINE.json:5,
SURVEY.md §2.1 R4). Design (SURVEY.md §3.2a): the reduced camera system

    S = U_λ − W V_λ⁻¹ Wᵀ,      b = −g_c + W V_λ⁻¹ g_p

is never materialized. Its matvec is two gather→row-product→segment-sum
sweeps over the observation axis. All per-observation/point block data is
**lane-major** ((3dc, O) / (9, P) — batch axis on lanes; see
tpu_ba/solver/normal.py), so the block algebra is pure row arithmetic over
the batch axis. Under ``shard_map`` the two
segment-sums become local partial sums followed by one ``psum`` each
(tpu_ba/sharding/).

The explicit reduced-system paths (tpu_ba/solver/pairs.py) build S once per
λ-retry instead; this one never forms it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_ba.solver.normal import BlockSystem, damp_blocks


def inv3x3(M):
    """Batched closed-form 3×3 inverse via the adjugate, AoS layout
    (..., 3, 3) → (..., 3, 3). Test/oracle helper; the solver paths use the
    lane-major :func:`inv3x3_rows`."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    det_safe = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
        jnp.stack([Cc, -(a * h - b * g), a * e - b * d], axis=-1),
    ], axis=-2)
    return adj / det_safe[..., None, None]


def inv3x3_rows(v):
    """Batched 3×3 inverse on flat lane-major layout: v (9, N) with
    v[3a+b] = M[a,b] per column → (9, N). Adjugate/det closed form; assumes
    damped SPD blocks (det floored for padded/empty blocks)."""
    a, b, c, d, e, f, g, h, i = (v[k] for k in range(9))
    A = e * i - f * h
    B = f * g - d * i
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    inv = jnp.stack([
        A, c * h - b * i, b * f - c * e,
        B, a * i - c * g, c * d - a * f,
        Cc, b * g - a * h, a * e - b * d,
    ])
    return inv / det


def _matmul_rows_33(v, x):
    """Per-column 3×3 · 3-vector on lane-major rows: v (9,N), x (3,N) → (3,N)."""
    return jnp.stack([
        v[0] * x[0] + v[1] * x[1] + v[2] * x[2],
        v[3] * x[0] + v[4] * x[1] + v[5] * x[2],
        v[6] * x[0] + v[7] * x[1] + v[8] * x[2],
    ])


def _w_dot(W, x, dc: int):
    """Per-observation W·u: W (3dc,O) rows 3m+n, u (3,O) → (dc,O)."""
    return jnp.stack([
        sum(W[3 * m + n] * x[n] for n in range(3)) for m in range(dc)
    ])


def _wt_dot(W, x, dc: int):
    """Per-observation Wᵀ·y: W (3dc,O), y (dc,O) → (3,O)."""
    return jnp.stack([
        sum(W[3 * m + n] * x[m] for m in range(dc)) for n in range(3)
    ])


def _reduce(x, axis_name):
    return x if axis_name is None else jax.lax.psum(x, axis_name)


def _cam_sum_t(values_t, cam_idx, n, axis_name):
    """Camera-keyed lane-major segment sum (D, O) → (D, C); observations are
    camera-sorted (tpu_ba.core.make_problem), also within a shard."""
    out = jax.ops.segment_sum(values_t.T, cam_idx, n,
                              indices_are_sorted=True).T
    return _reduce(out, axis_name)


def _pt_sum_t(values_t, pt_idx, n, axis_name):
    """Point-keyed lane-major segment sum (D, O) → (D, P); unsorted keys."""
    out = jax.ops.segment_sum(values_t.T, pt_idx, n).T
    return _reduce(out, axis_name)


def w_vinv_wt_diag(W, Vinv, cam_idx, pt_idx, n_cameras: int, axis_name=None):
    """Σ_obs W_o V⁻¹[pt_o] W_oᵀ accumulated per camera → (C, dc, dc).

    This is the second term of diag(S); used for the block-Jacobi
    preconditioner (exact block diagonal of S). W (3dc,O), Vinv (9,P).
    """
    dc = W.shape[0] // 3
    Vg = Vinv[:, pt_idx]                                 # (9, O) lane gather
    # WVi rows (m,b) = Σ_a W[3m+a]·Vg[3a+b] → (3dc, O)
    WVi = jnp.stack([
        sum(W[3 * m + a] * Vg[3 * a + b] for a in range(3))
        for m in range(dc) for b in range(3)
    ])
    # (m,m') = Σ_b WVi[3m+b]·W[3m'+b] → (dc², O)
    WViWt = jnp.stack([
        sum(WVi[3 * m + b] * W[3 * m2 + b] for b in range(3))
        for m in range(dc) for m2 in range(dc)
    ])
    out = _cam_sum_t(WViWt, cam_idx, n_cameras, axis_name)  # (dc², C)
    return out.reshape(dc, dc, n_cameras).transpose(2, 0, 1)


def schur_rhs(B: BlockSystem, Vinv, axis_name=None):
    """b = −g_c + W V_λ⁻¹ g_p → (C, dc). Vinv (9,P) lane-major."""
    dc = B.W.shape[0] // 3
    t = _matmul_rows_33(Vinv, B.gp)                      # (3, P)
    tg = t[:, B.pt_idx]                                  # (3, O)
    Wt = _w_dot(B.W, tg, dc)                             # (dc, O)
    n_cameras = B.U.shape[0]
    return -B.gc + _cam_sum_t(Wt, B.cam_idx, n_cameras, axis_name).T


def make_schur_matvec(Ul, W, Vinv, cam_idx, pt_idx, n_points: int,
                      axis_name=None):
    """Returns x ↦ S·x for x of shape (C, dc), matrix-free.

    Under sharding: x, Ul, Vinv are replicated; W and the index maps are
    shard-local; the two observation segment-sums each psum (the per-CG-iter
    cross-device reductions of SURVEY.md §3.2a).
    """
    n_cameras = Ul.shape[0]
    dc = W.shape[0] // 3

    def matvec(x):
        y = jnp.einsum("cij,cj->ci", Ul, x)              # U_λ x (replicated)
        xg = x.T[:, cam_idx]                             # (dc, O)
        wtx = _wt_dot(W, xg, dc)                         # (3, O)
        t = _pt_sum_t(wtx, pt_idx, n_points, axis_name)          # (3, P)
        u = _matmul_rows_33(Vinv, t)                     # (3, P)
        ug = u[:, pt_idx]                                # (3, O)
        z = _w_dot(W, ug, dc)                            # (dc, O)
        z = _cam_sum_t(z, cam_idx, n_cameras, axis_name)         # (dc, C)
        return y - z.T

    return matvec


def back_substitute(B: BlockSystem, Vinv, dx_cam, axis_name=None):
    """δ_p = V_λ⁻¹ (−g_p − Wᵀ δ_c) → (P, 3)."""
    dc = B.W.shape[0] // 3
    dxg = dx_cam.T[:, B.cam_idx]                         # (dc, O)
    wtd = _wt_dot(B.W, dxg, dc)                          # (3, O)
    n_points = B.V.shape[-1]
    s = _pt_sum_t(wtd, B.pt_idx, n_points, axis_name)            # (3, P)
    return _matmul_rows_33(Vinv, -B.gp - s).T


def solve_schur_pcg(B: BlockSystem, lam, *, cg_max_iters: int, cg_tol,
                    cg_x0=None, diag_floor: float, diag_ceil: float,
                    axis_name=None):
    """Full Schur+PCG linear solve.

    Returns (δ_cameras, δ_points, cg_iters, ok) — ``ok`` is the PCG
    no-breakdown flag (False ⇒ the LM loop must reject and raise λ)."""
    from tpu_ba.solver.pcg import pcg

    Ul, Vl = damp_blocks(B, lam, diag_floor, diag_ceil)
    Vinv = inv3x3_rows(Vl)                               # (9, P)
    n_cameras = Ul.shape[0]
    n_points = Vl.shape[-1]

    b = schur_rhs(B, Vinv, axis_name)
    matvec = make_schur_matvec(Ul, B.W, Vinv, B.cam_idx, B.pt_idx, n_points,
                               axis_name)

    # exact block-Jacobi preconditioner: inv of diag(S); batched unrolled
    # Gauss-Jordan (tpu_ba/solver/batched_linalg.py)
    from tpu_ba.solver.batched_linalg import inv_spd_small

    diag_S = Ul - w_vinv_wt_diag(B.W, Vinv, B.cam_idx, B.pt_idx, n_cameras,
                                 axis_name)
    Minv = inv_spd_small(diag_S)

    def precond(r):
        return jnp.einsum("cij,cj->ci", Minv, r)

    dx_cam, cg_iters, ok = pcg(matvec, b, precond, max_iters=cg_max_iters,
                               tol=cg_tol, x0=cg_x0)
    dx_pt = back_substitute(B, Vinv, dx_cam, axis_name)
    return dx_cam, dx_pt, cg_iters, ok
