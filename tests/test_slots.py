"""Slot-major band assembly (tpu_ba/solver/slots.py) vs the legacy
pair-enumeration oracle.

The slot path generalizes the track-major split to arbitrary short tracks
(gaps allowed): Venice-window structure. Equivalence bar: _compact_blocks
with the slot plan == pure pair enumeration, and the full solve matches the
dense oracle (f64 CPU)."""

import numpy as np
import jax.numpy as jnp

from tpu_ba.core import make_problem
from tpu_ba.io.synthetic import make_synthetic_problem
from tpu_ba.jacobians import jacobian_blocks_bal
from tpu_ba.solver.dense import solve_dense
from tpu_ba.solver.normal import assemble
from tpu_ba.solver.pairs import (_compact_blocks, build_pair_plan,
                                 precompute_pair_data, solve_schur_sparse)
from tpu_ba.solver.slots import slot_eligible


def _gappy_system(n_cams=40, pts_per_cam=12, seed=3, drop=True):
    """Windowed visibility WITH dropouts: each point sees 4 cameras of a
    6-wide window with one or two missing — non-consecutive tracks, the
    structure the track path cannot take (split_tracks rejects gaps) but
    the slot path owns. A couple of wrapped points keep the legacy pair
    path engaged too."""
    rng = np.random.default_rng(seed)
    n_pts = n_cams * pts_per_cam
    cam_of_pt = np.repeat(np.arange(n_cams), pts_per_cam)
    rows = []
    pis = []
    for p in range(n_pts):
        c0 = cam_of_pt[p]
        win = (c0 + np.array([0, 1, 2, 3, 4, 5])) % n_cams
        take = np.sort(rng.choice(6, 4, replace=False)) if drop \
            else np.arange(4)
        cams = np.sort(win[take])
        rows.append(cams)
        pis.append(np.full(cams.size, p))
    ci = np.concatenate(rows).astype(np.int32)
    pi = np.concatenate(pis).astype(np.int32)

    base, _ = make_synthetic_problem(n_cams, n_pts, obs_per_point=3,
                                     pixel_noise=0.5, seed=seed,
                                     dtype=np.float64, pad_multiple=8)
    obs = rng.normal(0.0, 50.0, (ci.shape[0], 2))
    problem = make_problem(np.asarray(base.cameras), np.asarray(base.points),
                           obs, ci, pi, dtype=np.float64, pad_multiple=8)
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx,
                 n_cams, n_pts, 0, 1.0, problem.mask)
    return problem, B


def test_slot_eligible_classification():
    problem, _ = _gappy_system()
    P = problem.points.shape[0]
    ok, order, starts, deg, span = slot_eligible(
        problem.cam_idx, problem.pt_idx, problem.n_obs, P)
    # non-wrapped points (window fits without wraparound) are all eligible
    assert ok.sum() > 0.8 * P
    assert (span[ok] <= 16).all()
    assert (deg[ok] <= 16).all()


def test_slot_plan_engages_and_matches_legacy_blocks():
    problem, B = _gappy_system()
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    kw = dict(pad_multiple=16, symmetric=True, banded=True)
    pairs_s = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                              C, P, slots=True, tracks=False, **kw)
    pairs_l = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                              C, P, slots=False, tracks=False, **kw)
    assert pairs_s.slot is not None
    assert pairs_s.track is None
    assert pairs_s.slot.n_tracked > 0.8 * P
    # same band grid ⇒ blk comparison is meaningful
    assert pairs_s.c_pad == pairs_l.c_pad
    assert pairs_s.band_offsets == pairs_l.band_offsets
    # slot points left pair enumeration: far fewer legacy pairs
    n_real_s = int(np.sum(np.asarray(pairs_s.pair_key) < C * C))
    n_real_l = int(np.sum(np.asarray(pairs_l.pair_key) < C * C))
    assert n_real_s < 0.3 * n_real_l
    pd_s = precompute_pair_data(B, pairs_s)
    pd_l = precompute_pair_data(B, pairs_l)
    assert pd_s.slot_W is not None
    for lam in [1e-5, 1e-1]:
        blk_s = _compact_blocks(B, jnp.asarray(lam, B.U.dtype), pairs_s, pd_s,
                                1e-6, 1e32)
        blk_l = _compact_blocks(B, jnp.asarray(lam, B.U.dtype), pairs_l, pd_l,
                                1e-6, 1e32)
        np.testing.assert_allclose(
            np.asarray(blk_s[:, :pairs_s.k_band]),
            np.asarray(blk_l[:, :pairs_l.k_band]), rtol=1e-9, atol=1e-12)


def test_slot_solve_matches_dense_oracle():
    problem, B = _gappy_system(seed=11)
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            C, P, pad_multiple=16, symmetric=True,
                            banded=True, slots=True, tracks=False)
    assert pairs.slot is not None
    for lam in [1e-4, 1e-1, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        dxc, dxp, _, ok = solve_schur_sparse(
            B, lam, pairs, cg_max_iters=2000, cg_tol=1e-14,
            diag_floor=1e-6, diag_ceil=1e32)
        np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_ring_problems_still_prefer_tracks():
    """Consecutive-track structure (the ladybug regime) must keep the
    cheaper track path — slots only take over when tracks don't cover."""
    problem, _ = _gappy_system(seed=2, drop=False)  # consecutive windows
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            C, P, pad_multiple=16, symmetric=True,
                            banded=True)
    assert pairs.track is not None
    assert pairs.slot is None
