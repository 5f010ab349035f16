"""Levenberg–Marquardt trust-region driver — host-free, one XLA program.

Capability parity: the reference's LM loop ("Levenberg-Marquardt …
per-iteration damping/trust-region logic", BASELINE.json:5; SURVEY.md §2.1
R3) recast as jit-compiled control flow: the whole solve — linearize →
assemble → Schur/PCG solve → gain-ratio accept/reject → λ update — is one
``lax.while_loop`` with no host round-trips (SURVEY.md §3.2a). λ adaptation
follows Nielsen's rule (accept: λ·max(⅓, 1−(2ρ−1)³), ν=2; reject: λ·ν, ν·2).

The same loop body runs single-device and under ``shard_map``: all
cross-device communication is confined to the psums inside the assembly and
Schur routines (keyed off ``axis_name``), so the distributed solver
(tpu_ba/sharding/) is this exact code over observation shards.

The linear solver is selected statically from LMConfig.linear_solver:
  * "dense"        — full H solve (oracle / tiny problems)
  * "schur_pcg"    — matrix-free Schur + block-Jacobi PCG
  * "schur_dense"  — explicit dense reduced camera system from the
                     covisibility-pair plan (single device, C ≲ 2000)
  * "schur_sparse" — explicit *block-sparse* reduced system: K compact
                     covisibility blocks instead of the dense C² grid (the
                     default, single-device and sharded)

A PCG pᵀAp ≤ 0 breakdown (non-PD S at low damping) marks the step not-ok;
the trust-region loop force-rejects it and raises λ instead of evaluating a
garbage direction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpu_ba.core import BAProblem, LMConfig, LMResult
from tpu_ba.jacobians.analytic import jacobian_blocks_bal
from tpu_ba.residuals.reprojection import residuals_bal
from tpu_ba.residuals.robust import robust_rho
from tpu_ba.solver import dense as dense_mod
from tpu_ba.solver import schur as schur_mod
from tpu_ba.solver.normal import assemble

LINEAR_SOLVERS = ("dense", "schur_pcg", "schur_dense", "schur_sparse")


def _robust_cost(r, kind, scale, mask, axis_name=None):
    s = jnp.sum(r * r, axis=-1)
    rho = robust_rho(kind, s, scale)
    rho = jnp.where(mask, rho, 0.0)
    cost = 0.5 * jnp.sum(rho)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    return cost


def lm_loop(cams0, pts0, obs, ci, pi, mask, n_cameras: int, n_points: int,
            config: LMConfig, axis_name: str | None = None,
            pairs=None, init_state=None, stop_at=None) -> LMResult:
    """The LM trust-region loop over (possibly shard-local) observation
    arrays. cams0/pts0 are replicated; obs/ci/pi/mask are the local shard
    when ``axis_name`` is set. Returns a fully replicated LMResult.

    ``init_state`` = (lam, nu, it[, warm_dxc, gnorm0]) resumes the
    trust-region state from a checkpoint or a previous chunk — together
    with cams0/pts0 from the same source the resumed trajectory is
    bit-identical to the uninterrupted one (the loop state is exactly
    (params, λ, ν, warm-start step, g₀); tested in
    tests/test_cli_and_aux.py). ``stop_at`` (dynamic scalar) pauses the loop
    at that iteration count — the chunked-checkpointing driver's boundary —
    without recompiling per chunk."""
    dtype = cams0.dtype
    kind, scale = config.robust_kind, config.robust_scale
    def cost_fn(cams, pts):
        r = residuals_bal(cams, pts, obs, ci, pi, mask)
        return _robust_cost(r, kind, scale, mask, axis_name)

    def linear_solve(B, lam, pair_data=None, cg_x0=None, cg_tol=None):
        tol = config.cg_tol if cg_tol is None else cg_tol
        if config.linear_solver == "dense":
            if axis_name is not None:
                raise ValueError("dense solver has no sharded path")
            dxc, dxp = dense_mod.solve_dense(B, lam, config.diag_floor, config.diag_ceil)
            return dxc, dxp, jnp.asarray(0, jnp.int32), jnp.asarray(True)
        elif config.linear_solver == "schur_dense":
            if axis_name is not None:
                raise ValueError("schur_dense has no sharded path; use schur_pcg")
            from tpu_ba.solver import pairs as pairs_mod

            return pairs_mod.solve_schur_dense(
                B, lam, pairs, pair_data,
                cg_max_iters=config.cg_max_iters, cg_tol=tol, cg_x0=cg_x0,
                diag_floor=config.diag_floor, diag_ceil=config.diag_ceil,
            )
        elif config.linear_solver == "schur_sparse":
            from tpu_ba.solver import pairs as pairs_mod

            return pairs_mod.solve_schur_sparse(
                B, lam, pairs, pair_data,
                cg_max_iters=config.cg_max_iters, cg_tol=tol, cg_x0=cg_x0,
                diag_floor=config.diag_floor, diag_ceil=config.diag_ceil,
                axis_name=axis_name, precond=config.precond,
            )
        elif config.linear_solver == "schur_pcg":
            return schur_mod.solve_schur_pcg(
                B, lam,
                cg_max_iters=config.cg_max_iters, cg_tol=tol, cg_x0=cg_x0,
                diag_floor=config.diag_floor, diag_ceil=config.diag_ceil,
                axis_name=axis_name,
            )
        raise ValueError(f"unknown linear_solver {config.linear_solver!r}")

    cost0 = cost_fn(cams0, pts0)
    hist0 = jnp.full((config.max_iters,), cost0, dtype)
    lam_hist0 = jnp.zeros((config.max_iters,), dtype)
    cg_hist0 = jnp.zeros((config.max_iters,), jnp.int32)

    # state: cams, pts, lam, nu, cost, it, n_accepted, gnorm, done,
    #        warm dxc, gnorm0, histories
    ws00 = jnp.zeros_like(cams0)
    g000 = jnp.asarray(0.0, dtype)
    if init_state is not None:
        lam00, nu00, it00 = init_state[:3]
        lam00 = jnp.asarray(lam00, dtype)
        nu00 = jnp.asarray(nu00, dtype)
        it00 = jnp.asarray(it00, jnp.int32)
        if len(init_state) > 3:
            ws00 = jnp.asarray(init_state[3], dtype)
            g000 = jnp.asarray(init_state[4], dtype)
    else:
        lam00 = jnp.asarray(config.init_lambda, dtype)
        nu00 = jnp.asarray(2.0, dtype)
        it00 = jnp.asarray(0, jnp.int32)
    limit = (jnp.asarray(config.max_iters, jnp.int32) if stop_at is None
             else jnp.minimum(jnp.asarray(stop_at, jnp.int32),
                              config.max_iters))
    init = (
        cams0, pts0, lam00, nu00,
        cost0, it00, jnp.asarray(0, jnp.int32),
        jnp.asarray(jnp.inf, dtype), jnp.asarray(False),
        ws00, g000,
        (hist0, lam_hist0, cg_hist0),
    )

    def cond(state):
        it, done = state[5], state[8]
        return jnp.logical_and(it < limit, jnp.logical_not(done))

    def body(state):
        """One *linearization*: assemble once, then retry λ until a step is
        accepted (or budget/λ-ceiling reached). Rejected retries reuse the
        linearization — they only redo the linear solve and a cost eval —
        which is exactly equivalent to relinearizing at unchanged params,
        but skips the Jacobian+assembly work (two-level trust-region loop).
        Each λ try counts as one iteration (one linear solve).

        ``dxc_ws`` carries the last computed camera step as the CG warm
        start; ``gnorm0`` the first linearization's ‖g‖∞ for the forcing
        sequence (VERDICT.md round 2, next #2)."""
        (cams, pts, lam, nu, cost, it, n_acc, _, _,
         dxc_ws, gnorm0, hists) = state
        hist, lam_hist, cg_hist = hists

        r, Jc, Jp = jacobian_blocks_bal(cams, pts, obs, ci, pi, mask)
        if config.freeze_camera_cols:
            colmask = jnp.asarray(
                [0.0 if m in config.freeze_camera_cols else 1.0
                 for m in range(cams.shape[-1])], dtype)
            Jc = Jc * colmask[None, :, None]
        B = assemble(r, Jc, Jp, ci, pi, n_cameras, n_points, kind, scale,
                     mask, axis_name)
        # λ-free pair-space gathers, amortized over the λ-retry loop
        if pairs is not None:
            from tpu_ba.solver import pairs as pairs_mod

            if axis_name is not None:
                # pair indices are GLOBAL observation ids; each device holds
                # a pair shard — gather W once per linearization (λ-free)
                Wg = jax.lax.all_gather(B.W, axis_name, axis=1, tiled=True)
                pair_data = pairs_mod.precompute_pair_data(B, pairs, Wg)
            else:
                pair_data = pairs_mod.precompute_pair_data(B, pairs)
        else:
            pair_data = None

        gnorm = jnp.maximum(jnp.max(jnp.abs(B.gc)), jnp.max(jnp.abs(B.gp)))
        gnorm0 = jnp.where(gnorm0 > 0, gnorm0, gnorm)
        if config.cg_forcing > 0:
            cg_tol_dyn = jnp.clip(
                jnp.sqrt(gnorm / jnp.maximum(gnorm0, 1e-30)),
                config.cg_tol, config.cg_forcing)
        else:
            cg_tol_dyn = None
        dU = jnp.clip(jnp.diagonal(B.U, axis1=-2, axis2=-1),
                      config.diag_floor, config.diag_ceil)
        # V is lane-major (9, P); its diagonal is rows 0, 4, 8 → (P, 3)
        dV = jnp.clip(jnp.stack([B.V[0], B.V[4], B.V[8]], axis=-1),
                      config.diag_floor, config.diag_ceil)

        def try_cond(tstate):
            lam, nu, it, accepted, *_ = tstate
            go = jnp.logical_and(jnp.logical_not(accepted), it < limit)
            return jnp.logical_and(go, lam < config.max_lambda)

        def try_body(tstate):
            lam, nu, it, _, dxc0, dxp0, nc0, np0, cn0, rg0, hists = tstate
            hist, lam_hist, cg_hist = hists
            x0 = dxc0 if config.cg_warm_start else None
            dxc, dxp, _cg, solve_ok = linear_solve(B, lam, pair_data,
                                                   cg_x0=x0,
                                                   cg_tol=cg_tol_dyn)
            new_cams = cams + dxc
            new_pts = pts + dxp
            new_cost = cost_fn(new_cams, new_pts)

            # predicted reduction ½(λ δᵀDδ − δᵀg) with D the damping diagonal
            dTDd = jnp.sum(dU * dxc * dxc) + jnp.sum(dV * dxp * dxp)
            dTg = jnp.sum(B.gc * dxc) + jnp.sum(B.gp.T * dxp)
            pred = 0.5 * (lam * dTDd - dTg)

            rho_gain = (cost - new_cost) / jnp.maximum(
                pred, jnp.asarray(1e-30, dtype))
            accept = jnp.logical_and(new_cost < cost, jnp.isfinite(new_cost))
            accept = jnp.logical_and(accept, pred > 0)
            # PCG breakdown ⇒ the direction is unusable: force-reject so the
            # retry raises λ deliberately (restores positive definiteness)
            accept = jnp.logical_and(accept, solve_ok)

            factor = jnp.maximum(
                jnp.asarray(1.0 / 3.0, dtype),
                1.0 - (2.0 * rho_gain - 1.0) ** 3,
            )
            lam_acc = jnp.clip(lam * factor, config.min_lambda, config.max_lambda)
            lam_rej = jnp.clip(lam * nu, config.min_lambda, config.max_lambda)
            lam_next = jnp.where(accept, lam_acc, lam_rej)
            nu_next = jnp.where(accept, jnp.asarray(2.0, dtype), nu * 2.0)
            hist = hist.at[it].set(jnp.where(accept, new_cost, cost))
            lam_hist = lam_hist.at[it].set(lam)
            cg_hist = cg_hist.at[it].set(_cg)
            return (lam_next, nu_next, it + 1, accept,
                    dxc, dxp, new_cams, new_pts, new_cost, rho_gain,
                    (hist, lam_hist, cg_hist))

        zero_p = jnp.zeros_like(pts)
        (lam, nu, it, accepted, dxc, dxp, new_cams, new_pts,
         new_cost, rho_gain, hists) = jax.lax.while_loop(
            try_cond, try_body,
            (lam, nu, it, jnp.asarray(False),
             dxc_ws, zero_p, cams, pts, cost, jnp.asarray(0.0, dtype),
             (hist, lam_hist, cg_hist)))

        cams = jnp.where(accepted, new_cams, cams)
        pts = jnp.where(accepted, new_pts, pts)
        cost_next = jnp.where(accepted, new_cost, cost)

        # convergence tests (evaluated on the last attempted step)
        step_norm = jnp.sqrt(jnp.sum(dxc * dxc) + jnp.sum(dxp * dxp))
        x_norm = jnp.sqrt(jnp.sum(cams * cams) + jnp.sum(pts * pts))
        rel_decrease = (cost - cost_next) / jnp.maximum(cost, 1e-30)
        done = gnorm < config.grad_tol
        done = jnp.logical_or(
            done, jnp.logical_and(accepted, rel_decrease < config.cost_rel_tol)
        )
        done = jnp.logical_or(
            done,
            jnp.logical_and(accepted,
                            step_norm < config.step_tol * (x_norm + config.step_tol)),
        )
        done = jnp.logical_or(done, lam >= config.max_lambda)

        n_acc = n_acc + accepted.astype(jnp.int32)

        return (cams, pts, lam, nu, cost_next, it, n_acc, gnorm, done,
                dxc, gnorm0, hists)

    (cams, pts, lam, nu, cost, it, n_acc, gnorm, done,
     warm_dxc, gnorm0_out, hists) = jax.lax.while_loop(cond, body, init)
    hist, lam_hist, cg_hist = hists
    # forward-fill history for iterations that never ran
    idx = jnp.arange(config.max_iters)
    hist = jnp.where(idx < it, hist, cost)

    return LMResult(
        cameras=cams, points=pts, cost=cost, initial_cost=cost0, lam=lam,
        iterations=it, accepted=n_acc, grad_inf_norm=gnorm, converged=done,
        cost_history=hist, lam_history=lam_hist, cg_history=cg_hist,
        nu=nu, warm_dxc=warm_dxc, gnorm0=gnorm0_out,
    )


@partial(jax.jit, static_argnums=(1,))
def _solve_jit(problem: BAProblem, config: LMConfig, pairs=None,
               init_state=None, stop_at=None) -> LMResult:
    return lm_loop(
        problem.cameras, problem.points, problem.obs_2d,
        problem.cam_idx, problem.pt_idx, problem.mask,
        problem.cameras.shape[0], problem.points.shape[0], config,
        pairs=pairs, init_state=init_state, stop_at=stop_at,
    )


# host-side plan memo: repeated solves of the same problem (bench loops,
# windowed SfM buckets) skip the pair enumeration / work-list construction,
# which costs seconds to minutes of numpy at BAL scale
_PLAN_MEMO: dict = {}
_PLAN_MEMO_MAX = 8


def check_linear_solver(name: str) -> None:
    """Reject an unknown ``LMConfig.linear_solver`` before any plan build."""
    if name not in LINEAR_SOLVERS:
        raise ValueError(f"unknown linear_solver {name!r}; "
                         f"have {', '.join(LINEAR_SOLVERS)}")


def _plan_key(problem: BAProblem, tag: str) -> tuple:
    import hashlib

    import numpy as np

    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(problem.cam_idx).tobytes())
    h.update(np.asarray(problem.pt_idx).tobytes())
    return (tag, problem.n_obs, problem.cameras.shape[0],
            problem.points.shape[0], h.hexdigest())


def _memoized(key, builder):
    if key not in _PLAN_MEMO:
        if len(_PLAN_MEMO) >= _PLAN_MEMO_MAX:
            _PLAN_MEMO.pop(next(iter(_PLAN_MEMO)))
        _PLAN_MEMO[key] = builder()
    return _PLAN_MEMO[key]


def solve(problem: BAProblem, config: LMConfig | None = None,
          resume_from: str | None = None) -> LMResult:
    """Bundle-adjust ``problem`` with Levenberg–Marquardt. jit-compiled,
    shape-static; repeated calls with same-shaped problems reuse the cache.

    ``linear_solver="schur_dense"`` builds the static covisibility-pair plan
    (tpu_ba/solver/pairs.py) on the host and solves on the explicit dense
    reduced camera system; ``"schur_sparse"`` (the default) keeps S
    block-sparse/symmetric-compact.
    """
    if config is None:
        config = LMConfig()
    check_linear_solver(config.linear_solver)
    if problem.model == "pinhole":
        # fixed-K pinhole: the BAL 9-slot camera layout with the intrinsic
        # columns (f, k1, k2) frozen EXACTLY (zeroed Jacobian ⇒ zero update,
        # damping-safe) — SfM solves pinhole directly instead of routing
        # through a conversion bridge (VERDICT.md round 2, next #9). Callers
        # set cameras[:, 6] = focal and k1 = k2 = 0.
        import dataclasses as _dc

        config = _dc.replace(
            config,
            freeze_camera_cols=tuple(sorted(
                set(config.freeze_camera_cols) | {6, 7, 8})))
    elif problem.model != "bal":
        raise ValueError(
            f"solve() handles the 'bal' and 'pinhole' models; got {problem.model!r}")
    init_state = None
    if resume_from:
        # full trust-region state: resumed runs match uninterrupted ones
        # exactly (VERDICT round 1, weak #8; round 2 — warm-start step and
        # g₀ are part of the loop state now and restored too)
        import numpy as np

        from tpu_ba.checkpoint.state import load_checkpoint

        ck = load_checkpoint(resume_from)
        dt = problem.cameras.dtype
        problem = problem.with_params(
            jnp.asarray(ck["cameras"], dt), jnp.asarray(ck["points"], dt))
        ex = ck["extra_tensors"]
        nu = float(np.asarray(ex.get("nu", 2.0)))
        ws = jnp.asarray(ex["warm_dxc"], dt) if "warm_dxc" in ex \
            else jnp.zeros_like(problem.cameras)
        g0 = float(np.asarray(ex.get("gnorm0", 0.0)))
        init_state = (ck["lam"], nu, ck["iteration"], ws, g0)
    pairs = None
    if config.linear_solver in ("schur_dense", "schur_sparse"):
        from tpu_ba.solver.pairs import build_pair_plan

        sparse = config.linear_solver == "schur_sparse"
        pairs = _memoized(
            _plan_key(problem, f"pairs-{sparse}"),
            # S = Sᵀ: the compact path stores only ci ≤ cj blocks (half the
            # pair data); the dense-T4 path needs the full enumeration
            lambda: build_pair_plan(
                problem.cam_idx, problem.pt_idx, problem.n_obs,
                problem.cameras.shape[0], problem.points.shape[0],
                symmetric=sparse))

    chunk = config.checkpoint_every if config.checkpoint_every > 0 \
        else (8 if config.nan_guard else 0)
    if chunk <= 0:
        return _solve_jit(problem, config, pairs, init_state)
    return _solve_chunked(problem, config, pairs, init_state, chunk)


def _solve_chunked(problem: BAProblem, config: LMConfig, pairs,
                   init_state, chunk: int) -> LMResult:
    """Host-driven chunked solve: run the compiled while_loop ``chunk``
    iterations at a time, dumping the FULL loop state (params, λ, ν,
    iteration, warm-start step, g₀) to ``config.checkpoint_path`` and
    checking finiteness between chunks. One compiled program serves every
    chunk (the boundary is the dynamic ``stop_at`` operand), so it needs no
    host callbacks and dumps are ordered + atomic by construction. Resumed
    runs are bit-identical to uninterrupted ones
    (tests/test_cli_and_aux.py)."""
    import numpy as np

    from tpu_ba.checkpoint.state import save_checkpoint

    it = int(init_state[2]) if init_state is not None else 0
    state = init_state
    hist = lam_hist = cg_hist = None
    initial_cost = None
    accepted_total = 0
    res = None
    while it < config.max_iters:
        stop = min(it + chunk, config.max_iters)
        res = _solve_jit(problem, config, pairs, state,
                         jnp.asarray(stop, jnp.int32))
        it_new = int(res.iterations)
        # splice this chunk's history slots into the merged views
        h = np.asarray(res.cost_history)
        lh = np.asarray(res.lam_history)
        ch = np.asarray(res.cg_history)
        if hist is None:
            hist, lam_hist, cg_hist = h.copy(), lh.copy(), ch.copy()
            initial_cost = res.initial_cost
        else:
            hist[it:] = h[it:]
            lam_hist[it:it_new] = lh[it:it_new]
            cg_hist[it:it_new] = ch[it:it_new]
        accepted_total += int(res.accepted)

        cost = float(res.cost)
        if config.nan_guard and not (
                np.isfinite(cost)
                and np.all(np.isfinite(np.asarray(res.cameras)))
                and np.all(np.isfinite(np.asarray(res.points)))):
            print(f"[tpu-ba nan-guard] non-finite state at iteration "
                  f"{it_new} (cost={cost:.6g}, lambda={float(res.lam):.3g})",
                  flush=True)
        if config.checkpoint_every > 0 and config.checkpoint_path:
            save_checkpoint(
                config.checkpoint_path,
                cameras=res.cameras, points=res.points, lam=res.lam,
                iteration=it_new, cost=cost,
                extra={"nu": np.asarray(float(res.nu)),
                       "warm_dxc": np.asarray(res.warm_dxc),
                       "gnorm0": np.asarray(float(res.gnorm0))})
        if bool(res.converged) or it_new >= config.max_iters or it_new <= it:
            break
        it = it_new
        state = (res.lam, res.nu, res.iterations, res.warm_dxc, res.gnorm0)
        problem = problem.with_params(res.cameras, res.points)

    import dataclasses as _dc

    return _dc.replace(res, initial_cost=initial_cost,
                       accepted=jnp.asarray(accepted_total, jnp.int32),
                       cost_history=jnp.asarray(hist),
                       lam_history=jnp.asarray(lam_hist),
                       cg_history=jnp.asarray(cg_hist))
