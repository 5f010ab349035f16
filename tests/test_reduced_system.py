"""The reduced camera system's plain building blocks vs independent dense
oracles (f64 CPU).

* the camera/point segment reductions vs ``numpy.add.at``;
* the compact, track and slot S-block builds vs T = W V_λ⁻¹ Wᵀ assembled
  with scipy.sparse from the per-observation blocks;
* PCG over the banded matvec vs a dense Cholesky solve of S.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

from tpu_ba.core import make_problem
from tpu_ba.io.bal import make_bal_like_problem
from tpu_ba.io.synthetic import make_synthetic_problem
from tpu_ba.jacobians import jacobian_blocks_bal
from tpu_ba.solver.batched_linalg import inv_spd_small
from tpu_ba.solver.normal import assemble, damp_blocks
from tpu_ba.solver.pairs import (_compact_blocks, build_pair_plan,
                                 make_banded_matvec, precompute_pair_data)
from tpu_ba.solver.pcg import pcg
from tpu_ba.solver.schur import _cam_sum_t, _pt_sum_t, inv3x3_rows, schur_rhs
from tpu_ba.solver.slots import slot_blocks_jnp
from tpu_ba.solver.tracks import track_blocks_jnp

FLOOR, CEIL = 1e-6, 1e32


# ---------------------------------------------------------------- reductions

def _case(O, N, D, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        sizes = rng.integers(1, 10, N).astype(np.float64)
        sizes[: max(N // 50, 1)] *= 100
        keys = np.sort(rng.choice(N, O, p=sizes / sizes.sum()))
    else:
        keys = np.sort(rng.integers(0, N, O))
    return rng.standard_normal((O, D)), keys.astype(np.int32)


def _check_reductions(values, keys, N):
    ref = np.zeros((N, values.shape[1]))
    np.add.at(ref, keys, values)
    cam = _cam_sum_t(jnp.asarray(values.T), jnp.asarray(keys), N, None)
    np.testing.assert_allclose(np.asarray(cam).T, ref, rtol=1e-12,
                               atol=1e-12)
    perm = np.random.default_rng(1).permutation(keys.shape[0])
    pt = _pt_sum_t(jnp.asarray(values[perm].T), jnp.asarray(keys[perm]), N,
                   None)
    np.testing.assert_allclose(np.asarray(pt).T, ref, rtol=1e-12, atol=1e-12)
    return np.asarray(cam).T, np.asarray(pt).T


@pytest.mark.parametrize("O,N,D,skew", [
    (4096, 37, 12, False),       # camera-like: few dense segments
    (4096, 1500, 12, False),     # point-like: many sparse segments
    (8192, 300, 90, False),      # wide D (packed U+g)
    (4096, 1000, 3, True),       # skewed sizes, tiny D
    (2048, 5, 9, False),         # tiny N
])
def test_segment_reductions_match_add_at(O, N, D, skew):
    """Camera side (sorted keys) and point side (shuffled keys)."""
    values, keys = _case(O, N, D, skew=skew)
    _check_reductions(values, keys, N)


def test_segment_reductions_empty_segments_are_zero():
    rng = np.random.default_rng(1)
    keys = np.sort(rng.choice([0, 3, 7, 19], 2048)).astype(np.int32)
    values = rng.standard_normal((2048, 8))
    cam, pt = _check_reductions(values, keys, 20)
    empty = ~np.isin(np.arange(20), keys)
    assert np.all(cam[empty] == 0) and np.all(pt[empty] == 0)


# ------------------------------------------------------------ dense oracles

def _system(problem):
    C, P = problem.cameras.shape[0], problem.points.shape[0]
    r, Jc, Jp = jacobian_blocks_bal(problem.cameras, problem.points,
                                    problem.obs_2d, problem.cam_idx,
                                    problem.pt_idx, problem.mask)
    return assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx, C, P, 0, 1.0,
                    problem.mask)


def _dense_T(problem, B, lam, obs_sel=None):
    """T = W V_λ⁻¹ Wᵀ (9C × 9C) from sparse matrices of the per-observation
    blocks; ``obs_sel`` restricts W to a subset of observations."""
    C, P = problem.cameras.shape[0], problem.points.shape[0]
    m = np.asarray(problem.mask).copy()
    if obs_sel is not None:
        keep = np.zeros_like(m)
        keep[obs_sel] = True
        m &= keep
    obs = np.nonzero(m)[0]
    ci, pi = np.asarray(problem.cam_idx)[obs], np.asarray(problem.pt_idx)[obs]
    Wb = np.asarray(B.W).T.reshape(-1, 9, 3)[obs]
    rows = (9 * ci[:, None, None] + np.arange(9)[None, :, None]
            + np.zeros((1, 1, 3), int))
    cols = (3 * pi[:, None, None] + np.arange(3)[None, None, :]
            + np.zeros((1, 9, 1), int))
    W = sp.csr_matrix((Wb.reshape(-1), (rows.reshape(-1), cols.reshape(-1))),
                      shape=(9 * C, 3 * P))
    _, Vl = damp_blocks(B, lam, FLOOR, CEIL)
    Vinv = np.linalg.inv(np.asarray(Vl).T.reshape(P, 3, 3))
    Vi = sp.block_diag(list(Vinv), format="csr")
    return (W @ Vi @ W.T).toarray()


def _dense_S(problem, B, lam):
    Ul, _ = damp_blocks(B, lam, FLOOR, CEIL)
    return scipy.linalg.block_diag(*np.asarray(Ul)) - _dense_T(problem, B, lam)


def _blocks(T, c, d):
    return T[9 * c:9 * c + 9, 9 * d:9 * d + 9]


# ------------------------------------------------------------ block builds

def test_compact_blocks_match_dense_T():
    """Non-banded symmetric compact segments: blk[:, k] == T[ci_k, cj_k]."""
    problem, _ = make_synthetic_problem(10, 80, obs_per_point=4,
                                        pixel_noise=0.5, seed=21,
                                        dtype=np.float64, pad_multiple=64)
    B = _system(problem)
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            10, 80, pad_multiple=16, symmetric=True,
                            banded=False)
    lam = 1e-2
    blk = np.asarray(_compact_blocks(B, jnp.asarray(lam), pairs,
                                     precompute_pair_data(B, pairs),
                                     FLOOR, CEIL))
    T = _dense_T(problem, B, lam)
    scale = np.abs(T).max()
    ci, cj = np.asarray(pairs.seg_ci), np.asarray(pairs.seg_cj)
    for k in range(pairs.n_segments):
        np.testing.assert_allclose(blk[:, k].reshape(9, 9),
                                   _blocks(T, ci[k], cj[k]),
                                   rtol=1e-9, atol=1e-12 * scale)
    assert np.all(blk[:, pairs.n_segments:] == 0)


def _ring_problem(n_cams, pts_per_cam, seed):
    """Each point seen by a consecutive 3-camera window of a ring."""
    rng = np.random.default_rng(seed)
    n_pts = n_cams * pts_per_cam
    cam_of_pt = np.repeat(np.arange(n_cams), pts_per_cam)
    ci = np.stack([cam_of_pt, (cam_of_pt + 1) % n_cams,
                   (cam_of_pt + 2) % n_cams], -1).reshape(-1)
    pi = np.repeat(np.arange(n_pts), 3)
    base, _ = make_synthetic_problem(n_cams, n_pts, obs_per_point=3,
                                     pixel_noise=0.5, seed=seed,
                                     dtype=np.float64, pad_multiple=8)
    obs = rng.normal(0.0, 50.0, (ci.shape[0], 2))
    return make_problem(np.asarray(base.cameras), np.asarray(base.points),
                        obs, ci, pi, dtype=np.float64, pad_multiple=8)


def _band_check(out, T, offsets, c_pad, n_cams):
    """out (81, n_off·c_pad) band grid: slot (o, c) == T[c, c + offsets[o]]."""
    scale = np.abs(T).max()
    for o, off in enumerate(offsets):
        for c in range(n_cams - off):
            np.testing.assert_allclose(
                np.asarray(out[:, o * c_pad + c]).reshape(9, 9),
                _blocks(T, c, c + off), rtol=1e-9, atol=1e-12 * scale)


@pytest.mark.parametrize("n_cams,pts_per_cam", [(30, 10), (300, 3)])
def test_track_blocks_match_dense_T(n_cams, pts_per_cam):
    """track_blocks_jnp == T of the tracked points alone, on a small ring
    and on one with ~10× more band rows (many reduction keys)."""
    problem = _ring_problem(n_cams, pts_per_cam, seed=5)
    B = _system(problem)
    P = problem.points.shape[0]
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            n_cams, P, pad_multiple=16, symmetric=True,
                            banded=True, tracks=True)
    tl = pairs.track
    assert tl is not None and tl.n_tracked > 0
    pd = precompute_pair_data(B, pairs)
    lam = 1e-2
    out = track_blocks_jnp(pd.trk_W, pd.trk_V, jnp.asarray(lam), tl, 9,
                           FLOOR, CEIL)
    mask = np.asarray(tl.slot_mask) > 0
    T = _dense_T(problem, B, lam, obs_sel=np.asarray(tl.slot_idx)[mask])
    d2 = 81
    grid = np.concatenate([np.asarray(out[g * d2:(g + 1) * d2])
                           for g in range(tl.dmax)], axis=1)
    _band_check(grid, T, tuple(range(tl.dmax)), tl.n_out, n_cams)


def test_slot_blocks_match_dense_T():
    """slot_blocks_jnp == T of the slot points alone (gappy windows)."""
    rng = np.random.default_rng(3)
    n_cams, n_pts = 40, 480
    rows, pis = [], []
    for p in range(n_pts):
        c0 = p // 12
        take = np.sort(rng.choice(6, 4, replace=False))
        cams = np.sort((c0 + take) % n_cams)
        rows.append(cams)
        pis.append(np.full(4, p))
    ci, pi = np.concatenate(rows), np.concatenate(pis)
    base, _ = make_synthetic_problem(n_cams, n_pts, obs_per_point=3,
                                     pixel_noise=0.5, seed=3,
                                     dtype=np.float64, pad_multiple=8)
    problem = make_problem(np.asarray(base.cameras), np.asarray(base.points),
                           rng.normal(0.0, 50.0, (ci.shape[0], 2)), ci, pi,
                           dtype=np.float64, pad_multiple=8)
    B = _system(problem)
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            n_cams, n_pts, pad_multiple=16, symmetric=True,
                            banded=True, slots=True, tracks=False)
    sl = pairs.slot
    assert sl is not None and sl.n_tracked > 0
    pd = precompute_pair_data(B, pairs)
    lam = 1e-2
    out = slot_blocks_jnp(pd.slot_W, pd.slot_V, jnp.asarray(lam), sl, 9,
                          FLOOR, CEIL)
    sel = np.concatenate([np.asarray(i)[np.asarray(m) > 0]
                          for i, m in zip(sl.slot_idx, sl.slot_mask)])
    T = _dense_T(problem, B, lam, obs_sel=sel)
    _band_check(out, T, pairs.band_offsets, pairs.c_pad, n_cams)


# -------------------------------------------------- PCG on the banded matvec

@pytest.fixture(scope="module")
def ladybug49():
    """A real trajectory band (ladybug-49 stand-in), f64."""
    problem, _ = make_bal_like_problem("ladybug-49", dtype=np.float64)
    B = _system(problem)
    C, P = problem.cameras.shape[0], problem.points.shape[0]
    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            C, P, symmetric=True, banded=True)
    assert pairs.banded and pairs.n_heavy_pts == 0
    return problem, B, pairs, precompute_pair_data(B, pairs)


def _banded(problem, B, pairs, pd, lam):
    lam = jnp.asarray(lam)
    blk = _compact_blocks(B, lam, pairs, pd, FLOOR, CEIL)
    Ul, Vl = damp_blocks(B, lam, FLOOR, CEIL)
    C = pairs.n_cameras
    diag_S = Ul - blk[:, :C].reshape(9, 9, C).transpose(2, 0, 1)
    Minv = inv_spd_small(diag_S)
    b = schur_rhs(B, inv3x3_rows(Vl))
    return (blk, diag_S, make_banded_matvec(blk, Ul, pairs, 9),
            lambda r: jnp.einsum("cij,cj->ci", Minv, r), b)


def _cholesky_solve(S, b):
    return scipy.linalg.cho_solve(scipy.linalg.cho_factor(S),
                                  np.asarray(b).reshape(-1)).reshape(-1, 9)


def test_banded_pcg_jacobi_matches_cholesky(ladybug49):
    problem, B, pairs, pd = ladybug49
    lam = 1e-3
    _, _, matvec, jacobi, b = _banded(problem, B, pairs, pd, lam)
    x, it, ok = pcg(matvec, b, jacobi, max_iters=2000, tol=1e-13)
    assert bool(ok) and int(it) < 2000
    ref = _cholesky_solve(_dense_S(problem, B, lam), b)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-6,
                               atol=1e-8 * np.abs(ref).max())


def test_banded_pcg_warm_start_and_early_exit(ladybug49):
    problem, B, pairs, pd = ladybug49
    lam = 1e-2
    _, _, matvec, jacobi, b = _banded(problem, B, pairs, pd, lam)
    ref = _cholesky_solve(_dense_S(problem, B, lam), b)
    # early exit: a loose tolerance stops well before the budget and meets
    # its own residual contract
    x1, it1, ok1 = pcg(matvec, b, jacobi, max_iters=500, tol=1e-3)
    assert bool(ok1) and 0 < int(it1) < 500
    assert (np.linalg.norm(np.asarray(b - matvec(x1)))
            <= 1e-3 * np.linalg.norm(np.asarray(b)) * (1 + 1e-9))
    x2, it2, _ = pcg(matvec, b, jacobi, max_iters=2000, tol=1e-12)
    # warm start from the converged solution: (almost) nothing left to do
    x3, it3, ok3 = pcg(matvec, b, jacobi, max_iters=2000, tol=1e-12, x0=x2)
    assert bool(ok3) and int(it3) <= 2 < int(it2)
    for x in (x2, x3):
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-6,
                                   atol=1e-8 * np.abs(ref).max())


def test_banded_pcg_tridiag_matches_cholesky(ladybug49):
    """The PCR block-tridiagonal preconditioner: same solution as dense
    Cholesky, in fewer CG iterations than block-Jacobi."""
    from tpu_ba.solver.tridiag import pcr_apply, pcr_factor, tridiag_from_band

    problem, B, pairs, pd = ladybug49
    assert pairs.band_offsets[1] == 1
    lam = 1e-3
    blk, diag_S, matvec, jacobi, b = _banded(problem, B, pairs, pd, lam)
    pcr = pcr_factor(*tridiag_from_band(blk, diag_S, pairs, 9))
    x_t, it_t, ok_t = pcg(matvec, b, lambda r: pcr_apply(*pcr, r),
                          max_iters=2000, tol=1e-12)
    _, it_j, _ = pcg(matvec, b, jacobi, max_iters=2000, tol=1e-12)
    assert bool(ok_t) and int(it_t) < int(it_j)
    ref = _cholesky_solve(_dense_S(problem, B, lam), b)
    np.testing.assert_allclose(np.asarray(x_t), ref, rtol=1e-6,
                               atol=1e-8 * np.abs(ref).max())


@pytest.mark.parametrize("lam", [1e-4, 1e-1, 1e1])
def test_banded_operator_equals_dense_S_across_damping(ladybug49, lam):
    """The banded matvec is S(λ) column for column, and PCG on it reaches
    the Cholesky solution, at light, medium and heavy damping."""
    problem, B, pairs, pd = ladybug49
    _, _, matvec, jacobi, b = _banded(problem, B, pairs, pd, lam)
    S = _dense_S(problem, B, lam)
    C = pairs.n_cameras
    cols = np.asarray(jax.jit(jax.vmap(matvec))(
        jnp.eye(9 * C).reshape(9 * C, C, 9))).reshape(9 * C, -1).T
    np.testing.assert_allclose(cols, S, rtol=1e-9,
                               atol=1e-12 * np.abs(S).max())
    x, _, ok = pcg(matvec, b, jacobi, max_iters=4000, tol=1e-13)
    ref = _cholesky_solve(S, b)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-6,
                               atol=1e-7 * np.abs(ref).max())
