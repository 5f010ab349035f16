"""Explicit dense-Schur (covisibility-pair) solver vs the oracles.

The pair plan + dense S path (tpu_ba/solver/pairs.py) must reproduce the
full dense solve and the matrix-free Schur/PCG solve exactly (fp64 CPU),
for every damping regime and with robust kernels active.
"""

import numpy as np
import jax.numpy as jnp

from tpu_ba.core import LMConfig
from tpu_ba.io.synthetic import make_synthetic_problem
from tpu_ba.jacobians import jacobian_blocks_bal
from tpu_ba.solver.dense import solve_dense
from tpu_ba.solver.lm import solve
from tpu_ba.solver.normal import assemble, damp_blocks
from tpu_ba.solver.pairs import (build_dense_schur, build_pair_plan,
                                 precompute_pair_data, solve_schur_dense,
                                 solve_schur_sparse)
from tpu_ba.solver.schur import inv3x3


def _system(seed=0, n_cams=4, n_pts=25, robust=0):
    problem, _ = make_synthetic_problem(
        n_cams, n_pts, obs_per_point=3, pixel_noise=0.5,
        seed=seed, dtype=np.float64, pad_multiple=8,
    )
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask,
    )
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx,
                 n_cams, n_pts, robust, 1.0, problem.mask)
    return problem, B


def _plan(problem):
    return build_pair_plan(
        problem.cam_idx, problem.pt_idx, problem.n_obs,
        problem.cameras.shape[0], problem.points.shape[0], pad_multiple=16)


def test_dense_schur_matrix_matches_reference_loop():
    """S built from the pair plan equals the brute-force S = Uλ − W Vλ⁻¹ Wᵀ."""
    problem, B = _system()
    pairs = _plan(problem)
    lam = 1e-3
    S2, diag_S = build_dense_schur(B, lam, pairs, precompute_pair_data(B, pairs),
                                   1e-6, 1e32)

    # brute force via dense scatter of W blocks (convert lane-major to AoS)
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    dc = B.U.shape[-1]
    O = B.W.shape[-1]
    Ul, Vl_t = damp_blocks(B, lam, 1e-6, 1e32)
    Wfull = np.zeros((C * dc, P * 3))
    W = np.asarray(B.W).T.reshape(O, dc, 3)
    for o in range(O):
        if not bool(problem.mask[o]):
            continue
        c, p = int(B.cam_idx[o]), int(B.pt_idx[o])
        Wfull[c * dc:(c + 1) * dc, p * 3:(p + 1) * 3] += W[o]
    Vinv = np.asarray(inv3x3(jnp.asarray(np.asarray(Vl_t).T.reshape(P, 3, 3))))
    Vinv_full = np.zeros((P * 3, P * 3))
    for p in range(P):
        Vinv_full[p * 3:(p + 1) * 3, p * 3:(p + 1) * 3] = Vinv[p]
    Ufull = np.zeros((C * dc, C * dc))
    for c in range(C):
        Ufull[c * dc:(c + 1) * dc, c * dc:(c + 1) * dc] = np.asarray(Ul)[c]
    S_ref = Ufull - Wfull @ Vinv_full @ Wfull.T

    np.testing.assert_allclose(np.asarray(S2), S_ref, rtol=1e-9, atol=1e-9)
    for c in range(C):
        np.testing.assert_allclose(
            np.asarray(diag_S)[c], S_ref[c * dc:(c + 1) * dc, c * dc:(c + 1) * dc],
            rtol=1e-9, atol=1e-9)


def test_schur_dense_solve_matches_dense_oracle():
    problem, B = _system(seed=1)
    pairs = _plan(problem)
    for lam in [1e-6, 1e-3, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        dxc, dxp, _, _ = solve_schur_dense(
            B, lam, pairs, cg_max_iters=500, cg_tol=1e-14,
            diag_floor=1e-6, diag_ceil=1e32)
        np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_lm_with_schur_dense_converges_like_schur_pcg():
    problem, gt = make_synthetic_problem(
        8, 120, obs_per_point=4, pixel_noise=0.5, seed=3,
        dtype=np.float64, pad_multiple=64)
    cfg_pcg = LMConfig(max_iters=15, linear_solver="schur_pcg",
                       cg_max_iters=200, cg_tol=1e-12)
    cfg_dense = LMConfig(max_iters=15, linear_solver="schur_dense",
                         cg_max_iters=200, cg_tol=1e-12)
    res_pcg = solve(problem, cfg_pcg)
    res_dense = solve(problem, cfg_dense)
    assert float(res_dense.cost) <= float(res_pcg.cost) * 1.01
    np.testing.assert_allclose(float(res_dense.cost), float(res_pcg.cost),
                               rtol=1e-4)


def test_schur_dense_with_robust_kernel():
    problem, B = _system(seed=2, robust=1)  # Huber
    pairs = _plan(problem)
    dxc_d, dxp_d = solve_dense(B, 1e-3)
    dxc, dxp, _, _ = solve_schur_dense(
        B, 1e-3, pairs, cg_max_iters=500, cg_tol=1e-14,
        diag_floor=1e-6, diag_ceil=1e32)
    np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_schur_sparse_solve_matches_oracles():
    """The compact block-sparse path equals both solve_schur_dense and the
    full dense solve across damping regimes (ADVICE.md round 1, medium)."""
    problem, B = _system(seed=5)
    pairs = _plan(problem)
    for lam in [1e-6, 1e-3, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        dxc_e, dxp_e, _, _ = solve_schur_dense(
            B, lam, pairs, cg_max_iters=500, cg_tol=1e-14,
            diag_floor=1e-6, diag_ceil=1e32)
        dxc, dxp, _, _ = solve_schur_sparse(
            B, lam, pairs, cg_max_iters=500, cg_tol=1e-14,
            diag_floor=1e-6, diag_ceil=1e32)
        np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dxc, dxc_e, rtol=1e-8, atol=1e-11)


def test_schur_sparse_disconnected_camera():
    """A camera with zero observations has no (c,c) covisibility segment:
    diag_pos points at the trash column, which must read exact zeros
    (ADVICE.md round 1: diag_pos / trash-segment edge case)."""
    problem, _ = make_synthetic_problem(
        4, 30, obs_per_point=3, pixel_noise=0.5, seed=7,
        dtype=np.float64, pad_multiple=8)
    n_obs = problem.n_obs
    # same observations, but declare 5 cameras — camera 4 observes nothing
    from tpu_ba.core import make_problem
    cams5 = np.concatenate([np.asarray(problem.cameras),
                            np.asarray(problem.cameras)[-1:]], axis=0)
    problem = make_problem(cams5, np.asarray(problem.points),
                           np.asarray(problem.obs_2d)[:n_obs],
                           np.asarray(problem.cam_idx)[:n_obs],
                           np.asarray(problem.pt_idx)[:n_obs],
                           dtype=np.float64, pad_multiple=8)
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx, 5, 30, 0, 1.0,
                 problem.mask)
    pairs = _plan(problem)
    assert int(pairs.diag_pos[4]) == pairs.k_pad - 1  # absent diag → trash
    dxc_d, dxp_d = solve_dense(B, 1e-3)
    dxc, dxp, _, _ = solve_schur_sparse(
        B, 1e-3, pairs, cg_max_iters=500, cg_tol=1e-14,
        diag_floor=1e-6, diag_ceil=1e32)
    np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_lm_with_schur_sparse_converges_like_schur_pcg():
    problem, gt = make_synthetic_problem(
        8, 120, obs_per_point=4, pixel_noise=0.5, seed=9,
        dtype=np.float64, pad_multiple=64)
    cfg_pcg = LMConfig(max_iters=15, linear_solver="schur_pcg",
                       cg_max_iters=200, cg_tol=1e-12)
    cfg_sp = LMConfig(max_iters=15, linear_solver="schur_sparse",
                      cg_max_iters=200, cg_tol=1e-12)
    res_pcg = solve(problem, cfg_pcg)
    res_sp = solve(problem, cfg_sp)
    np.testing.assert_allclose(float(res_sp.cost), float(res_pcg.cost),
                               rtol=1e-4)


def test_heavy_tracks_go_hybrid_and_match_oracle():
    """Tracks longer than max_degree are split into the matrix-free heavy
    side channel; the hybrid solve must still equal the dense oracle
    (VERDICT.md round 1, next #2: max_degree must not be a hard failure)."""
    problem, _ = make_synthetic_problem(
        30, 12, obs_per_point=25, pixel_noise=0.5, seed=4,
        dtype=np.float64, pad_multiple=8)
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            30, 12, max_degree=8, pad_multiple=16)
    assert pairs.n_heavy_pts > 0 and pairs.n_heavy_obs > 0

    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx, 30, 12, 0, 1.0,
                 problem.mask)
    for lam in [1e-6, 1e-3, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        for solver in (solve_schur_dense, solve_schur_sparse):
            dxc, dxp, _, ok = solver(
                B, lam, pairs, cg_max_iters=800, cg_tol=1e-14,
                diag_floor=1e-6, diag_ceil=1e32)
            np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_all_heavy_tracks_hybrid():
    """Degenerate split: every point is heavy (no pair segments at all)."""
    problem, _ = make_synthetic_problem(
        20, 6, obs_per_point=15, pixel_noise=0.5, seed=6,
        dtype=np.float64, pad_multiple=8)
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            20, 6, max_degree=2, pad_multiple=16)
    assert pairs.n_heavy_pts == 6
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx, 20, 6, 0, 1.0,
                 problem.mask)
    dxc_d, dxp_d = solve_dense(B, 1e-3)
    dxc, dxp, _, _ = solve_schur_sparse(
        B, 1e-3, pairs, cg_max_iters=800, cg_tol=1e-14,
        diag_floor=1e-6, diag_ceil=1e32)
    np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_schur_sparse_symmetric_matches_oracles():
    """Symmetric (ci ≤ cj) pair storage + transposed matvec pass equals the
    full enumeration and the dense oracle."""
    problem, B = _system(seed=13)
    pairs_full = _plan(problem)
    pairs_sym = build_pair_plan(
        problem.cam_idx, problem.pt_idx, problem.n_obs,
        problem.cameras.shape[0], problem.points.shape[0], pad_multiple=16,
        symmetric=True)
    assert pairs_sym.n_pairs < pairs_full.n_pairs
    for lam in [1e-6, 1e-3, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        dxc, dxp, _, _ = solve_schur_sparse(
            B, lam, pairs_sym, cg_max_iters=500, cg_tol=1e-14,
            diag_floor=1e-6, diag_ceil=1e32)
        np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_schur_sparse_symmetric_heavy_hybrid():
    """Symmetric storage composes with the heavy-track side channel."""
    problem, _ = make_synthetic_problem(
        30, 12, obs_per_point=25, pixel_noise=0.5, seed=4,
        dtype=np.float64, pad_multiple=8)
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            30, 12, max_degree=8, pad_multiple=16,
                            symmetric=True)
    assert pairs.n_heavy_pts > 0
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx, 30, 12, 0, 1.0,
                 problem.mask)
    dxc_d, dxp_d = solve_dense(B, 1e-3)
    dxc, dxp, _, _ = solve_schur_sparse(
        B, 1e-3, pairs, cg_max_iters=800, cg_tol=1e-14,
        diag_floor=1e-6, diag_ceil=1e32)
    np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def _ring_system(n_cams=24, pts_per_cam=12, seed=7):
    """Trajectory-style problem: each point is tracked by a 3-camera window
    of a camera ring, giving a genuinely banded covisibility (offsets 0,1,2)
    plus wraparound leftover pairs — the structure the banded pair layout
    (build_pair_plan(banded=True)) is designed for."""
    rng = np.random.default_rng(seed)
    n_pts = n_cams * pts_per_cam
    cam_of_pt = np.repeat(np.arange(n_cams), pts_per_cam)
    ci = np.stack([cam_of_pt, (cam_of_pt + 1) % n_cams,
                   (cam_of_pt + 2) % n_cams], -1).reshape(-1).astype(np.int32)
    pi = np.repeat(np.arange(n_pts, dtype=np.int32), 3)

    from tpu_ba.core import make_problem
    from tpu_ba.io.synthetic import make_synthetic_problem

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


def test_banded_plan_structure_and_equivalence():
    """On a ring problem the banded plan includes EVERY populated offset
    (window {0,1,2} plus the wraparound offsets — ≤ 32 total, so the plan is
    FULLY banded with zero leftover segments), and solves identically to the
    dense oracle and the non-banded symmetric path."""
    problem, B = _ring_system()
    C = problem.cameras.shape[0]
    pairs_b = build_pair_plan(
        problem.cam_idx, problem.pt_idx, problem.n_obs, C,
        problem.points.shape[0], pad_multiple=16, symmetric=True, banded=True)
    pairs_s = build_pair_plan(
        problem.cam_idx, problem.pt_idx, problem.n_obs, C,
        problem.points.shape[0], pad_multiple=16, symmetric=True, banded=False)
    assert pairs_b.banded
    assert set(pairs_b.band_offsets) >= {0, 1, 2}       # window offsets
    assert max(pairs_b.band_offsets) > 2                # + wraparound offsets
    assert pairs_b.n_segments <= pairs_b.k_band         # fully banded
    for lam in [1e-6, 1e-3, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        for pp in (pairs_b, pairs_s):
            dxc, dxp, _, _ = solve_schur_sparse(
                B, lam, pp, cg_max_iters=800, cg_tol=1e-14,
                diag_floor=1e-6, diag_ceil=1e32)
            np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_banded_plan_offband_leftovers_equivalence():
    """> 32 distinct camera offsets: the 32 heaviest stay in the band and
    the rest are routed to off-band leftover segments — both paths must
    still reproduce the dense oracle."""
    rng = np.random.default_rng(13)
    n_cams, n_pts = 40, 200
    # ring window (offsets 0..2) + random long-range pairs over many offsets
    cam_of_pt = np.repeat(np.arange(n_cams), 5)[:n_pts]
    win = np.stack([cam_of_pt, (cam_of_pt + 1) % n_cams,
                    (cam_of_pt + 2) % n_cams], -1)
    # every point also seen by one far camera (never in its window — a
    # camera observes a point at most once)
    far = (cam_of_pt + 3 + rng.integers(0, n_cams - 3, n_pts)) % n_cams
    rows = np.concatenate([win, far[:, None]], axis=1)
    ci = rows.reshape(-1).astype(np.int32)
    pi = np.repeat(np.arange(n_pts, dtype=np.int32), 4)

    from tpu_ba.core import make_problem
    from tpu_ba.io.synthetic import make_synthetic_problem

    base, _ = make_synthetic_problem(n_cams, n_pts, obs_per_point=3,
                                     pixel_noise=0.5, seed=13,
                                     dtype=np.float64, pad_multiple=8)
    obs = rng.normal(0.0, 50.0, (ci.shape[0], 2))
    problem = make_problem(np.asarray(base.cameras), np.asarray(base.points),
                           obs, ci, pi, dtype=np.float64, pad_multiple=8)
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx,
                 n_cams, n_pts, 0, 1.0, problem.mask)

    pairs_b = build_pair_plan(
        problem.cam_idx, problem.pt_idx, problem.n_obs, n_cams, n_pts,
        pad_multiple=16, symmetric=True, banded=True)
    assert pairs_b.banded
    assert len(pairs_b.band_offsets) == 32               # capped
    assert pairs_b.n_segments > pairs_b.k_band           # leftovers exist
    dxc_d, dxp_d = solve_dense(B, 1e-3)
    dxc, dxp, _, _ = solve_schur_sparse(
        B, 1e-3, pairs_b, cg_max_iters=800, cg_tol=1e-14,
        diag_floor=1e-6, diag_ceil=1e32)
    np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)


def test_community_covis_disables_banding_and_matches_oracle():
    """Community-photo covisibility (VERDICT r4 missing #1): camera IDs carry
    no spatial order, so distinct index offsets ≈ C and a ≤32-offset band
    would cover almost nothing. The coverage admission must fall back to the
    non-banded symmetric compact layout, and the solve must still match the
    dense oracle."""
    rng = np.random.default_rng(21)
    # C large enough that 32 offsets of the triangular random-pair offset
    # distribution cover < 50% of pairs (at C=150: ~38%)
    n_cams, n_pts = 150, 400
    # each point observed by 4 cameras drawn by Zipf popularity — unordered
    pop = (1.0 + np.arange(n_cams)) ** -0.9
    pop = rng.permutation(pop / pop.sum())
    rows = np.stack([rng.choice(n_cams, 4, replace=False, p=pop)
                     for _ in range(n_pts)])
    ci = rows.reshape(-1).astype(np.int32)
    pi = np.repeat(np.arange(n_pts, dtype=np.int32), 4)

    from tpu_ba.core import make_problem

    base, _ = make_synthetic_problem(n_cams, n_pts, obs_per_point=3,
                                     pixel_noise=0.5, seed=21,
                                     dtype=np.float64, pad_multiple=8)
    obs = rng.normal(0.0, 50.0, (ci.shape[0], 2))
    problem = make_problem(np.asarray(base.cameras), np.asarray(base.points),
                           obs, ci, pi, dtype=np.float64, pad_multiple=8)
    r, Jc, Jp = jacobian_blocks_bal(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx,
                 n_cams, n_pts, 0, 1.0, problem.mask)

    pairs = build_pair_plan(
        problem.cam_idx, problem.pt_idx, problem.n_obs, n_cams, n_pts,
        pad_multiple=16, symmetric=True, banded=True)
    assert not pairs.banded            # coverage admission rejected the band
    assert pairs.track is None         # tracked points re-enumerated as pairs
    dxc_d, dxp_d = solve_dense(B, 1e-3)
    dxc, dxp, _, _ = solve_schur_sparse(
        B, 1e-3, pairs, cg_max_iters=800, cg_tol=1e-14,
        diag_floor=1e-6, diag_ceil=1e32)
    np.testing.assert_allclose(dxc, dxc_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dxp, dxp_d, rtol=1e-6, atol=1e-9)
