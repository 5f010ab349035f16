"""Distributed BA on the forced 8-device CPU mesh (SURVEY.md §4.5).

Invariant: the sharded solve equals the single-device solve up to
floating-point reduction order (tight tolerance on fp64 CPU).
"""

import jax
import numpy as np

from tpu_ba.core import LMConfig
from tpu_ba.io.synthetic import make_synthetic_problem
from tpu_ba.sharding import make_mesh, shard_problem, solve_sharded
from tpu_ba.solver.lm import solve


def _problem(seed=0):
    return make_synthetic_problem(
        12, 120, obs_per_point=5, pixel_noise=0.5, seed=seed,
        dtype=np.float64, pad_multiple=128,
    )[0]


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device():
    problem = _problem()
    cfg = LMConfig(max_iters=12, linear_solver="schur_pcg",
                   cg_max_iters=300, cg_tol=1e-12)
    res_1 = solve(problem, cfg)
    mesh = make_mesh()
    res_8 = solve_sharded(shard_problem(problem, mesh), cfg, mesh)
    np.testing.assert_allclose(float(res_8.cost), float(res_1.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res_8.cameras), np.asarray(res_1.cameras),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_8.points), np.asarray(res_1.points),
                               rtol=1e-4, atol=1e-6)
    assert int(res_8.iterations) == int(res_1.iterations)


def test_sharded_two_device_submesh():
    problem = _problem(seed=1)
    cfg = LMConfig(max_iters=8, cg_max_iters=300, cg_tol=1e-12)
    mesh = make_mesh(jax.devices()[:2])
    res_2 = solve_sharded(shard_problem(problem, mesh), cfg, mesh)
    res_1 = solve(problem, cfg)
    np.testing.assert_allclose(float(res_2.cost), float(res_1.cost), rtol=1e-6)


def test_sharded_converges():
    problem, gt = make_synthetic_problem(
        12, 120, obs_per_point=5, pixel_noise=0.5, seed=2,
        dtype=np.float64, pad_multiple=128,
    )
    mesh = make_mesh()
    res = solve_sharded(shard_problem(problem, mesh), LMConfig(max_iters=20), mesh)
    rmse = np.sqrt(2.0 * float(res.cost) / gt["n_obs"])
    assert rmse < 1.0


def test_sharded_schur_sparse_matches_single_device():
    """The production compact/banded solver sharded over the mesh (pairs
    partitioned, one blk psum per λ-retry, communication-free CG) equals the
    single-device solve (VERDICT round 2, next #4)."""
    problem = _problem(seed=3)
    cfg = LMConfig(max_iters=10, linear_solver="schur_sparse",
                   cg_max_iters=300, cg_tol=1e-12)
    res_1 = solve(problem, cfg)
    mesh = make_mesh()
    res_8 = solve_sharded(shard_problem(problem, mesh), cfg, mesh)
    np.testing.assert_allclose(float(res_8.cost), float(res_1.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(res_8.cameras),
                               np.asarray(res_1.cameras),
                               rtol=1e-6, atol=1e-8)
    assert int(res_8.iterations) == int(res_1.iterations)


def test_sharded_schur_sparse_f32_parity():
    """schur_sparse SHARDED in f32 (the precision the card runs): the
    per-retry psum of the compact blocks reorders f32 sums, yet the solve
    must match the single-device f32 solve."""
    problem = make_synthetic_problem(
        12, 120, obs_per_point=5, pixel_noise=0.5, seed=4,
        dtype=np.float32, pad_multiple=128,
    )[0]
    cfg = LMConfig(max_iters=8, linear_solver="schur_sparse",
                   cg_max_iters=100, cg_tol=1e-6)
    res_1 = solve(problem, cfg)
    mesh = make_mesh()
    res_8 = solve_sharded(shard_problem(problem, mesh), cfg, mesh)
    np.testing.assert_allclose(float(res_8.cost), float(res_1.cost),
                               rtol=1e-5)
    # parameter tolerance is loose by necessity: 8 f32 LM iterations
    # amplify psum reduction-order noise along gauge-weak directions;
    # the converged COST is the invariant that matters
    np.testing.assert_allclose(np.asarray(res_8.cameras),
                               np.asarray(res_1.cameras),
                               rtol=1e-2, atol=1e-3)
    assert int(res_8.iterations) == int(res_1.iterations)


def test_sharded_trackband_engages_and_matches():
    """The track-major band path runs SHARDED — the sharded plan carries a
    stacked per-device track layout (shard_stack_track_layout; leading device axis on the point-sharded
    leaves) and the per-device band partials psum with the pair blocks.
    Verifies (a) the layout actually engaged, (b) sharded ≡ single-device."""
    problem = make_synthetic_problem(
        16, 400, obs_per_point=6, pixel_noise=0.5, seed=7,
        dtype=np.float64, pad_multiple=128,
    )[0]
    cfg = LMConfig(max_iters=8, linear_solver="schur_sparse",
                   cg_max_iters=300, cg_tol=1e-12)
    res_1 = solve(problem, cfg)
    mesh = make_mesh()
    res_8 = solve_sharded(shard_problem(problem, mesh), cfg, mesh)

    from tpu_ba.solver.lm import _PLAN_MEMO

    sharded_plans = [plan for (tag, *_), plan in _PLAN_MEMO.items()
                     if tag.startswith("pairs-sharded-8")]
    assert any(p.track is not None and p.track.slot_idx.ndim == 3
               for p in sharded_plans), \
        "sharded plan did not engage the stacked track layout"
    np.testing.assert_allclose(float(res_8.cost), float(res_1.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(res_8.cameras),
                               np.asarray(res_1.cameras),
                               rtol=1e-6, atol=1e-8)
    assert int(res_8.iterations) == int(res_1.iterations)
