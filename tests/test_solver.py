import dataclasses

import jax.numpy as jnp
import numpy as np

from tpu_ba.core import LMConfig
from tpu_ba.io.synthetic import make_synthetic_problem
from tpu_ba.jacobians import jacobian_blocks_bal
from tpu_ba.residuals.reprojection import residuals_bal
from tpu_ba.solver.dense import solve_dense
from tpu_ba.solver.lm import solve
from tpu_ba.solver.normal import assemble
from tpu_ba.solver.schur import solve_schur_pcg, inv3x3
from tpu_ba.solver.pcg import pcg


def _tiny_system(seed=0, n_cams=3, n_pts=12, robust=0):
    problem, gt = make_synthetic_problem(
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


def test_inv3x3_matches_linalg():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((50, 3, 3))
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3)
    np.testing.assert_allclose(inv3x3(jnp.asarray(M)), np.linalg.inv(M), atol=1e-10)


def test_pcg_matches_direct():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((40, 40))
    A = A @ A.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    x, iters, _ok = pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                   lambda r: r / jnp.asarray(np.diagonal(A)),
                   max_iters=200, tol=1e-12)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), atol=1e-8)
    assert int(iters) < 200


def test_schur_matches_dense():
    """The Schur-eliminated PCG solve equals the full dense solve."""
    _, B = _tiny_system()
    for lam in [1e-6, 1e-3, 1e0]:
        dxc_d, dxp_d = solve_dense(B, lam)
        dxc_s, dxp_s, _, _ = solve_schur_pcg(
            B, lam, cg_max_iters=500, cg_tol=1e-14, diag_floor=1e-6, diag_ceil=1e32)
        np.testing.assert_allclose(dxc_s, dxc_d, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dxp_s, dxp_d, rtol=1e-6, atol=1e-9)


def test_dense_solve_decreases_cost():
    problem, B = _tiny_system()
    dxc, dxp = solve_dense(B, 1e-4)
    r0 = residuals_bal(problem.cameras, problem.points, problem.obs_2d,
                       problem.cam_idx, problem.pt_idx, problem.mask)
    r1 = residuals_bal(problem.cameras + dxc, problem.points + dxp, problem.obs_2d,
                       problem.cam_idx, problem.pt_idx, problem.mask)
    assert float(jnp.sum(r1 * r1)) < float(jnp.sum(r0 * r0))


def _converge_check(config, n_cams=10, n_pts=100, seed=3, noise=0.5):
    problem, gt = make_synthetic_problem(
        n_cams, n_pts, obs_per_point=4, pixel_noise=noise,
        seed=seed, dtype=np.float64, pad_multiple=64,
    )
    res = solve(problem, config)
    # converged reprojection RMSE should be near the injected noise floor
    n_eff = gt["n_obs"]
    rmse = np.sqrt(2.0 * float(res.cost) / n_eff)
    assert rmse < 2.0 * noise, f"rmse {rmse} vs noise {noise}"
    assert float(res.cost) < float(res.initial_cost) * 0.5
    # cost history non-increasing (accepted steps only ever lower it)
    hist = np.asarray(res.cost_history)
    assert np.all(np.diff(hist) <= 1e-9)
    return res


def test_lm_dense_converges():
    _converge_check(LMConfig(max_iters=30, linear_solver="dense"))


def test_lm_schur_converges():
    _converge_check(LMConfig(max_iters=30, linear_solver="schur_pcg",
                             cg_max_iters=200, cg_tol=1e-10))


def test_lm_schur_matches_dense_trajectory():
    problem, _ = make_synthetic_problem(
        6, 40, obs_per_point=4, pixel_noise=0.3, seed=5,
        dtype=np.float64, pad_multiple=32,
    )
    res_d = solve(problem, LMConfig(max_iters=15, linear_solver="dense"))
    res_s = solve(problem, LMConfig(max_iters=15, linear_solver="schur_pcg",
                                    cg_max_iters=500, cg_tol=1e-14))
    np.testing.assert_allclose(float(res_s.cost), float(res_d.cost), rtol=1e-6)


def test_lm_robust_converges():
    # inject outliers; Huber should still reach a good fit
    problem, gt = make_synthetic_problem(
        10, 100, obs_per_point=4, pixel_noise=0.3, seed=7,
        dtype=np.float64, pad_multiple=64,
    )
    rng = np.random.default_rng(0)
    n_out = 20
    idx = rng.choice(gt["n_obs"], n_out, replace=False)
    obs = np.array(problem.obs_2d)
    obs[idx] += rng.normal(0, 50.0, (n_out, 2))
    problem = dataclasses.replace(problem, obs_2d=jnp.asarray(obs))
    cfg = LMConfig(max_iters=30, linear_solver="schur_pcg",
                   robust_kind=1, robust_scale=1.0)
    res = solve(problem, cfg)
    assert float(res.cost) < float(res.initial_cost) * 0.5


def test_gauge_invariance():
    """Global rigid transform of the scene leaves the cost unchanged."""
    from tpu_ba.geometry.rotations import aa_to_matrix
    from tpu_ba.io.synthetic import _matrix_to_aa_np

    problem, _ = make_synthetic_problem(5, 30, obs_per_point=3, seed=9,
                                        dtype=np.float64, pad_multiple=16)
    r0 = residuals_bal(problem.cameras, problem.points, problem.obs_2d,
                       problem.cam_idx, problem.pt_idx, problem.mask)
    c0 = float(jnp.sum(r0 * r0))

    # transform: X' = G X + h ; camera R' = R Gᵀ, t' = t − R Gᵀ h
    G = np.asarray(aa_to_matrix(jnp.asarray([0.3, -0.2, 0.5])))
    h = np.array([1.0, -2.0, 0.7])
    cams = np.asarray(problem.cameras).copy()
    pts = np.asarray(problem.points) @ G.T + h
    for c in range(cams.shape[0]):
        R = np.asarray(aa_to_matrix(jnp.asarray(cams[c, 0:3])))
        Rp = R @ G.T
        cams[c, 0:3] = _matrix_to_aa_np(Rp)
        cams[c, 3:6] = cams[c, 3:6] - Rp @ h
    r1 = residuals_bal(jnp.asarray(cams), jnp.asarray(pts), problem.obs_2d,
                       problem.cam_idx, problem.pt_idx, problem.mask)
    c1 = float(jnp.sum(r1 * r1))
    np.testing.assert_allclose(c1, c0, rtol=1e-8)


def test_inv_spd_small_matches_linalg():
    from tpu_ba.solver.batched_linalg import inv_spd_small

    rng = np.random.default_rng(7)
    for k in (3, 6, 9):
        A = rng.standard_normal((40, k, k))
        M = A @ A.transpose(0, 2, 1) + k * np.eye(k)
        np.testing.assert_allclose(np.asarray(inv_spd_small(jnp.asarray(M))),
                                   np.linalg.inv(M), rtol=1e-9, atol=1e-10)


def test_degenerate_geometry_stays_finite():
    """A point at a camera's optical center (z=0 in camera frame) must not
    poison the solve with NaNs — guarded divisions + accept/reject keep the
    state finite (SURVEY.md §5 'NaN guards')."""
    from tpu_ba.geometry.cameras import camera_center_bal

    problem, gt = make_synthetic_problem(6, 50, obs_per_point=3,
                                         pixel_noise=0.5, seed=13,
                                         dtype=np.float64, pad_multiple=16)
    pts = np.array(problem.points)
    center = np.asarray(camera_center_bal(problem.cameras[0]))
    pts[0] = center  # exactly at the optical center
    pts[1] = center + 1e-9
    problem = dataclasses.replace(problem, points=jnp.asarray(pts))
    res = solve(problem, LMConfig(max_iters=10))
    assert np.isfinite(np.asarray(res.cameras)).all()
    assert np.isfinite(np.asarray(res.points)).all()
    assert np.isfinite(float(res.cost))


def test_freeze_camera_cols_holds_params_exactly():
    """Frozen camera columns (e.g. distortion during SfM windowed BA) never
    move, and the rest still converges (VERDICT round 1, weak #6)."""
    import numpy as np

    from tpu_ba.core import LMConfig
    from tpu_ba.io.synthetic import make_synthetic_problem
    from tpu_ba.solver.lm import solve

    problem, _ = make_synthetic_problem(6, 80, obs_per_point=4,
                                        pixel_noise=0.5, seed=21,
                                        dtype=np.float64, pad_multiple=64)
    cfg = LMConfig(max_iters=10, linear_solver="schur_sparse",
                   cg_max_iters=200, cg_tol=1e-10,
                   freeze_camera_cols=(7, 8))
    res = solve(problem, cfg)
    cams0 = np.asarray(problem.cameras)
    cams1 = np.asarray(res.cameras)
    np.testing.assert_array_equal(cams1[:, 7:9], cams0[:, 7:9])
    assert float(res.cost) < float(res.initial_cost) * 0.5
    assert np.any(cams1[:, 0:7] != cams0[:, 0:7])


def test_pinhole_model_freezes_intrinsics():
    """model="pinhole" (VERDICT round 2, next #9): solve() accepts fixed-K
    pinhole problems directly — intrinsic columns stay bit-identical while
    poses/points optimize, matching an explicit frozen-column BAL solve."""
    import dataclasses

    from tpu_ba.core import make_problem

    problem, _ = make_synthetic_problem(6, 80, obs_per_point=4,
                                        pixel_noise=0.5, seed=11,
                                        dtype=np.float64, pad_multiple=64)
    pin = dataclasses.replace(problem, model="pinhole")
    cfg = LMConfig(max_iters=8, linear_solver="schur_sparse",
                   cg_max_iters=200, cg_tol=1e-12)
    res = solve(pin, cfg)
    np.testing.assert_array_equal(np.asarray(res.cameras)[:, 6:9],
                                  np.asarray(problem.cameras)[:, 6:9])
    assert float(res.cost) < float(res.initial_cost)

    cfg_frozen = dataclasses.replace(cfg, freeze_camera_cols=(6, 7, 8))
    res_bal = solve(problem, cfg_frozen)
    np.testing.assert_allclose(float(res.cost), float(res_bal.cost),
                               rtol=1e-12)
