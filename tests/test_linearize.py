"""The plain linearize+assemble path and the trial cost vs independent f64
oracles.

Linearization: tpu_ba.solver.normal.assemble over the analytic Jacobian
blocks against a dense Gauss-Newton system built from ``jax.jacfwd`` of the
residual function, IRLS weights from ``jax.grad`` of ρ. Trial cost: the
LM loop's cost function against a numpy projection and closed-form ρ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_ba.core import make_problem
from tpu_ba.io.synthetic import _project_bal_np, make_synthetic_problem
from tpu_ba.jacobians import jacobian_blocks_bal
from tpu_ba.residuals.reprojection import residuals_bal
from tpu_ba.residuals.robust import robust_rho
from tpu_ba.solver.lm import _robust_cost
from tpu_ba.solver.normal import assemble

SCALE = 2.0


def _jacfwd_system(problem, kind):
    """Dense H = Jᵀ diag(w) J, g = Jᵀ w r and the robust cost, from jacfwd
    of the residuals w.r.t. (cameras, points) — no block algebra."""
    cams, pts = problem.cameras, problem.points
    C, P = cams.shape[0], pts.shape[0]
    args = (problem.obs_2d, problem.cam_idx, problem.pt_idx, problem.mask)

    def f(c, p):
        return residuals_bal(c, p, *args)

    r = np.asarray(f(cams, pts))                              # (O, 2)
    Jc, Jp = jax.jacfwd(f, argnums=(0, 1))(cams, pts)
    O = r.shape[0]
    J = np.concatenate([np.asarray(Jc).reshape(2 * O, 9 * C),
                        np.asarray(Jp).reshape(2 * O, 3 * P)], axis=1)
    s = jnp.asarray(np.sum(r * r, axis=1))
    w = np.asarray(jax.vmap(jax.grad(lambda x: robust_rho(kind, x, SCALE)))(s))
    m = np.asarray(problem.mask)
    w = np.where(m, w, 0.0)
    rho = np.where(m, np.asarray(robust_rho(kind, s, SCALE)), 0.0)
    w2 = np.repeat(w, 2)
    H = J.T @ (w2[:, None] * J)
    g = J.T @ (w2 * r.reshape(-1))
    return H, g, 0.5 * rho.sum()


def _check_against_jacfwd(problem, kind, rtol):
    C, P = problem.cameras.shape[0], problem.points.shape[0]
    r, Jc, Jp = jacobian_blocks_bal(problem.cameras, problem.points,
                                    problem.obs_2d, problem.cam_idx,
                                    problem.pt_idx, problem.mask)
    B = assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx, C, P, kind,
                 SCALE, problem.mask)
    H, g, cost = _jacfwd_system(problem, kind)
    hs = float(np.max(np.abs(H)))
    U = np.stack([H[9 * c:9 * c + 9, 9 * c:9 * c + 9] for c in range(C)])
    np.testing.assert_allclose(np.asarray(B.U), U, rtol=rtol, atol=rtol * hs)
    off = 9 * C
    V = np.stack([H[off + 3 * p:off + 3 * p + 3, off + 3 * p:off + 3 * p + 3]
                  for p in range(P)])
    np.testing.assert_allclose(np.asarray(B.V).T.reshape(P, 3, 3), V,
                               rtol=rtol, atol=rtol * hs)
    # each (camera, point) is observed once: W_o is H's (c, p) block
    Wb = np.asarray(B.W).T.reshape(-1, 9, 3)
    ci, pi = np.asarray(problem.cam_idx), np.asarray(problem.pt_idx)
    for o in np.nonzero(np.asarray(problem.mask))[0]:
        c, p = ci[o], pi[o]
        np.testing.assert_allclose(
            Wb[o], H[9 * c:9 * c + 9, off + 3 * p:off + 3 * p + 3],
            rtol=rtol, atol=rtol * hs)
    gs = float(np.max(np.abs(g)))
    np.testing.assert_allclose(np.asarray(B.gc).reshape(-1), g[:off],
                               rtol=rtol, atol=rtol * gs)
    np.testing.assert_allclose(np.asarray(B.gp).T.reshape(-1), g[off:],
                               rtol=rtol, atol=rtol * gs)
    np.testing.assert_allclose(float(B.cost), cost, rtol=1e-12)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_assembly_matches_jacfwd_system(kind):
    """U, V, W, g and the robust cost of the plain path == the dense
    jacfwd Gauss-Newton system, per robust kind, with padded rows."""
    problem, _ = make_synthetic_problem(
        6, 40, obs_per_point=4, pixel_noise=0.5, cam_perturb=0.1, seed=12,
        dtype=np.float64, pad_multiple=128)
    assert problem.obs_2d.shape[0] > problem.n_obs         # padding present
    _check_against_jacfwd(problem, kind, rtol=1e-9)


def test_assembly_small_angle_matches_jacfwd():
    """θ → 0 cameras take the analytic Taylor branch; the assembled system
    still equals the jacfwd oracle."""
    rng = np.random.default_rng(3)
    C, P, O = 2, 8, 16
    cams = np.zeros((C, 9))
    cams[:, 0:3] = 1e-9
    cams[:, 5] = -20.0
    cams[:, 6] = 300.0
    pts = rng.standard_normal((P, 3))
    ci = np.repeat(np.arange(C), P)
    pi = np.tile(np.arange(P), C)
    obs = rng.standard_normal((O, 2))
    problem = make_problem(cams, pts, obs, ci, pi, dtype=np.float64,
                           pad_multiple=8)
    _check_against_jacfwd(problem, 0, rtol=1e-7)


def _rho_np(kind, s, a):
    a2 = a * a
    if kind == 0:
        return s
    if kind == 1:
        return np.where(s <= a2, s, 2.0 * a * np.sqrt(np.maximum(s, a2)) - a2)
    if kind == 2:
        return a2 * np.log1p(s / a2)
    return a2 * np.arctan(s / a2)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_trial_cost_matches_numpy(kind):
    """The LM loop's trial cost (residuals_bal + _robust_cost) == numpy
    projection + closed-form ρ; padded rows carry garbage and must not
    count."""
    problem, _ = make_synthetic_problem(
        6, 40, obs_per_point=4, pixel_noise=3.0, cam_perturb=0.05, seed=15,
        dtype=np.float64, pad_multiple=128)
    n = problem.n_obs
    obs = np.asarray(problem.obs_2d).copy()
    obs[n:] = 1e4                                  # garbage on padding
    cams, pts = np.asarray(problem.cameras), np.asarray(problem.points)
    ci, pi = np.asarray(problem.cam_idx), np.asarray(problem.pt_idx)
    r = _project_bal_np(cams[ci[:n]], pts[pi[:n]]) - obs[:n]
    s = np.sum(r * r, axis=1)
    assert (s > SCALE ** 2).any() and (s < SCALE ** 2).any()  # both branches
    ref = 0.5 * _rho_np(kind, s, SCALE).sum()
    r_j = residuals_bal(problem.cameras, problem.points, jnp.asarray(obs),
                        problem.cam_idx, problem.pt_idx, problem.mask)
    out = float(_robust_cost(r_j, kind, SCALE, problem.mask))
    np.testing.assert_allclose(out, ref, rtol=1e-12)
