"""Track-major band assembly (tpu_ba/solver/tracks.py) vs the
pair-enumeration oracles."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ba.core import make_problem
from tpu_ba.io.synthetic import make_synthetic_problem
from tpu_ba.jacobians import jacobian_blocks_bal
from tpu_ba.solver.dense import solve_dense
from tpu_ba.solver.normal import assemble
from tpu_ba.solver.pairs import (_compact_blocks, build_pair_plan,
                                 precompute_pair_data, solve_schur_sparse)
from tpu_ba.solver.tracks import split_tracks


def _mixed_system(n_cams=30, pts_per_cam=10, seed=5, dtype=np.float64):
    """Ring problem: most points have consecutive 3-camera tracks; tracks
    starting at the last two cameras WRAP (non-consecutive ⇒ legacy)."""
    rng = np.random.default_rng(seed)
    n_pts = n_cams * pts_per_cam
    cam_of_pt = np.repeat(np.arange(n_cams), pts_per_cam)
    ci = np.stack([cam_of_pt, (cam_of_pt + 1) % n_cams,
                   (cam_of_pt + 2) % n_cams], -1).reshape(-1).astype(np.int32)
    pi = np.repeat(np.arange(n_pts, dtype=np.int32), 3)
    base, _ = make_synthetic_problem(n_cams, n_pts, obs_per_point=3,
                                     pixel_noise=0.5, seed=seed,
                                     dtype=dtype, pad_multiple=8)
    obs = rng.normal(0.0, 50.0, (ci.shape[0], 2))
    problem = make_problem(np.asarray(base.cameras), np.asarray(base.points),
                           obs, ci, pi, dtype=dtype, pad_multiple=8)
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx,
                 n_cams, n_pts, 0, 1.0, problem.mask)
    return problem, B


def test_split_tracks():
    problem, _ = _mixed_system()
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    tracked, order, starts, deg = split_tracks(
        problem.cam_idx, problem.pt_idx, problem.n_obs, P)
    # wrapped tracks: start cameras C−2 and C−1 (their windows wrap to 0/1)
    start_cam = np.asarray(problem.cam_idx)[order[starts]]
    pt_start = np.repeat(np.arange(C), P // C)
    assert tracked.sum() == (C - 2) * (P // C)
    assert not tracked[pt_start >= C - 2].any()
    assert tracked[pt_start < C - 2].all()


def test_tracked_plan_matches_dense_and_legacy():
    """solve_schur_sparse with the track-major plan == dense oracle ==
    the pure pair-enumeration plan (f64, jnp fallback path)."""
    problem, B = _mixed_system()
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    kw = dict(pad_multiple=16, symmetric=True, banded=True)
    pairs_t = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                              C, P, tracks=True, **kw)
    pairs_l = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                              C, P, tracks=False, **kw)
    assert pairs_t.track is not None
    assert pairs_t.track.n_tracked > 0
    # legacy pair count collapses: only the wrapped tracks remain enumerated
    n_wrapped_pts = 2 * (P // C)
    assert int(np.sum(np.asarray(pairs_t.pair_key) < C * C)) == \
        n_wrapped_pts * 6            # triu(3) incl diagonal = 6 pairs each
    # λ=1e-6 makes this random geometry too ill-conditioned for CG to reach
    # 1e-14 in any reasonable budget (both plans hit the cap identically);
    # equivalence is meaningful only where CG converges
    for lam in [1e-4, 1e-3, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        for pp in (pairs_t, pairs_l):
            dxc, dxp, _, ok = solve_schur_sparse(
                B, lam, pp, cg_max_iters=2000, cg_tol=1e-14,
                diag_floor=1e-6, diag_ceil=1e32)
            np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_compact_blocks_track_vs_legacy():
    """_compact_blocks with the track path == pure pair enumeration, f64."""
    problem, B = _mixed_system(seed=9)
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    kw = dict(pad_multiple=16, symmetric=True, banded=True)
    pairs_t = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                              C, P, tracks=True, **kw)
    pairs_l = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                              C, P, tracks=False, **kw)
    assert pairs_t.c_pad == pairs_l.c_pad  # same band grid ⇒ comparable
    assert pairs_t.band_offsets == pairs_l.band_offsets
    pd_t = precompute_pair_data(B, pairs_t)
    pd_l = precompute_pair_data(B, pairs_l)
    for lam in [1e-5, 1e-1]:
        blk_t = _compact_blocks(B, jnp.asarray(lam, B.U.dtype), pairs_t, pd_t,
                                1e-6, 1e32)
        blk_l = _compact_blocks(B, jnp.asarray(lam, B.U.dtype), pairs_l, pd_l,
                                1e-6, 1e32)
        np.testing.assert_allclose(np.asarray(blk_t[:, :pairs_t.k_band]),
                                   np.asarray(blk_l[:, :pairs_l.k_band]),
                                   rtol=1e-9, atol=1e-12)
