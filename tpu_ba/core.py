"""Core containers: the BA problem, solver config, and solver result.

Design decisions:
  * ``BAProblem`` is a registered JAX pytree dataclass with **static shapes**:
    the observation/camera/point arrays may be padded (``n_obs`` etc. record
    the true counts; ``mask`` kills padded rows). Padding keeps every compiled
    program shape-stable so jit caches hit across problems of the same bucket.
  * Observations are expected **sorted by camera index** (``sort_by_camera``
    enforces it). Sorted order makes the block-sparse assembly a segmented
    reduction over contiguous runs (``indices_are_sorted=True``) and makes
    keyframe-partitioned sharding a contiguous slice per device.

Capability parity: the problem layout covers the reference's scene
representation (cameras/points/observations — SURVEY.md §1.1, §2.1 R1-R4;
reference mount empty, see SURVEY.md §0).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ba.residuals.robust import ROBUST_NONE


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask"],
    meta_fields=["n_cameras", "n_points", "n_obs", "model"],
)
@dataclasses.dataclass(frozen=True)
class BAProblem:
    """A (possibly padded) bundle-adjustment problem.

    cameras: (C, cam_dim) — BAL: 9 = [aa(3), t(3), f, k1, k2]
    points:  (P, 3)
    obs_2d:  (O, 2) measured pixel coordinates
    cam_idx: (O,) int32, pt_idx: (O,) int32 — observation incidence
    mask:    (O,) bool — False on padded rows
    n_cameras/n_points/n_obs: true (unpadded) counts — static metadata
    model:   "bal" (9-param) — static metadata
    """

    cameras: jax.Array
    points: jax.Array
    obs_2d: jax.Array
    cam_idx: jax.Array
    pt_idx: jax.Array
    mask: jax.Array
    n_cameras: int
    n_points: int
    n_obs: int
    model: str = "bal"

    @property
    def cam_dim(self) -> int:
        return self.cameras.shape[-1]

    def with_params(self, cameras, points) -> "BAProblem":
        return dataclasses.replace(self, cameras=cameras, points=points)


def make_problem(
    cameras,
    points,
    obs_2d,
    cam_idx,
    pt_idx,
    *,
    model: str = "bal",
    pad_obs_to: int | None = None,
    pad_multiple: int = 1024,
    dtype=jnp.float32,
    sort: bool = True,
) -> BAProblem:
    """Build a BAProblem from numpy/JAX arrays: sorts observations by camera,
    pads the observation axis to a bucket size, and casts dtypes.

    Padded rows point at camera 0 / point 0 with mask=False; every consumer
    multiplies by the mask before reducing, so they contribute exact zeros.
    """
    cameras = np.asarray(cameras)
    points = np.asarray(points)
    obs_2d = np.asarray(obs_2d)
    cam_idx = np.asarray(cam_idx, dtype=np.int32)
    pt_idx = np.asarray(pt_idx, dtype=np.int32)
    n_obs = int(obs_2d.shape[0])

    if sort:
        order = np.argsort(cam_idx, kind="stable")
        obs_2d, cam_idx, pt_idx = obs_2d[order], cam_idx[order], pt_idx[order]

    target = pad_obs_to if pad_obs_to is not None else _round_up(max(n_obs, 1), pad_multiple)
    pad = target - n_obs
    if pad < 0:
        raise ValueError(f"pad_obs_to={pad_obs_to} < n_obs={n_obs}")
    mask = np.concatenate([np.ones(n_obs, bool), np.zeros(pad, bool)])
    obs_2d = np.concatenate([obs_2d, np.zeros((pad, 2), obs_2d.dtype)])
    # padding rows repeat the LAST index: keeps cam_idx sorted (the sorted
    # segment sums rely on it) and stays in-bounds for gathers; the mask
    # zeroes their contributions
    last_c = cam_idx[-1] if n_obs else np.int32(0)
    last_p = pt_idx[-1] if n_obs else np.int32(0)
    cam_idx = np.concatenate([cam_idx, np.full(pad, last_c, np.int32)])
    pt_idx = np.concatenate([pt_idx, np.full(pad, last_p, np.int32)])

    return BAProblem(
        cameras=jnp.asarray(cameras, dtype),
        points=jnp.asarray(points, dtype),
        obs_2d=jnp.asarray(obs_2d, dtype),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        mask=jnp.asarray(mask),
        n_cameras=int(cameras.shape[0]),
        n_points=int(points.shape[0]),
        n_obs=n_obs,
        model=model,
    )


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Levenberg–Marquardt trust-region configuration (all static).

    Mirrors the per-iteration damping/accept-reject logic of the reference's
    LM loop (BASELINE.json:5 "per-iteration damping/trust-region logic"),
    recast as host-free ``lax.while_loop`` state transitions.
    """

    max_iters: int = 50
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e12
    # convergence thresholds
    grad_tol: float = 1e-10       # on ‖g‖∞
    cost_rel_tol: float = 1e-8    # on relative cost decrease of accepted steps
    step_tol: float = 1e-12       # on ‖δ‖ / (‖x‖ + eps)
    # robustification
    robust_kind: int = ROBUST_NONE
    robust_scale: float = 1.0
    # inner linear solver — see tpu_ba/solver/lm.py for the full list;
    # "schur_sparse" is the production path (bench.py and the CLI default)
    linear_solver: str = "schur_pcg"
    # CG quality drives LM step quality: cg_tol 1e-3 with 100 iters measured
    # BOTH faster time-to-cost and f64-parity final cost on ladybug-1723
    # (loose 1e-2/50 stalled ~1-2.5% above the f64 oracle at 80 LM iters)
    cg_max_iters: int = 100
    cg_tol: float = 1e-3
    # warm-start CG from the previous linear solve's solution (across
    # λ-retries and linearizations). Pure iteration-count saver: the solve
    # still converges to the same tolerance (VERDICT.md round 2, next #2).
    cg_warm_start: bool = True
    # >0 enables an Eisenstat–Walker-style forcing sequence: the CG relative
    # tolerance per linearization is clip(sqrt(‖g‖∞/‖g₀‖∞), cg_tol,
    # cg_forcing) — loose solves while far from the optimum, cg_tol near it.
    cg_forcing: float = 0.0
    # PCG preconditioner on the reduced camera system: "jacobi" (damped
    # diagonal block inverse) or "tridiag" (EXACT inverse of the
    # block-tridiagonal part of S via parallel cyclic reduction —
    # tpu_ba/solver/tridiag.py; banded schur_sparse plans with an offset-1
    # band only, falls back to jacobi elsewhere).
    precond: str = "jacobi"
    # minimum added to diagonal damping for conditioning
    diag_floor: float = 1e-6
    diag_ceil: float = 1e32
    # camera parameter columns held fixed (zeroed Jacobian ⇒ zero update —
    # exact, damping-safe). E.g. (7, 8) freezes the BAL radial distortion
    # during SfM windowed BA where K is known (VERDICT round 1, weak #6).
    freeze_camera_cols: tuple = ()
    # periodic checkpointing (SURVEY.md §5 failure detection / elastic
    # recovery): the solve runs as host-driven CHUNKS of N iterations of the
    # same compiled while_loop (the loop state — params, λ, ν, iteration,
    # warm-start step, g₀ — round-trips exactly), dumping the full state to
    # checkpoint_path between chunks. Needs no host callbacks; dumps are
    # ordered and atomic by construction. 0 = off.
    checkpoint_every: int = 0
    checkpoint_path: str = ""
    # NaN guard: host-side finiteness check of (cost, params) between chunks
    # (the in-loop λ-retry already force-rejects non-finite steps; this is
    # the observability/early-abort layer)
    nan_guard: bool = False

    def __post_init__(self):
        # JSON configs deliver lists (no tuples in JSON); LMConfig must stay
        # hashable for jit static_argnums (ADVICE.md round 2)
        if not isinstance(self.freeze_camera_cols, tuple):
            object.__setattr__(self, "freeze_camera_cols",
                               tuple(self.freeze_camera_cols))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "cameras", "points", "cost", "initial_cost", "lam",
        "iterations", "accepted", "grad_inf_norm", "converged",
        "cost_history", "lam_history", "cg_history",
        "nu", "warm_dxc", "gnorm0",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class LMResult:
    """Solver output. ``cost_history`` has one slot per outer iteration
    (padded with the final cost) so metrics like time-to-1%-cost can be
    computed without host round-trips during the solve.

    ``nu``/``warm_dxc``/``gnorm0`` are the remaining trust-region loop state
    beyond (params, λ, iteration): together they make a resumed solve
    bit-identical to an uninterrupted one (the chunked checkpointing driver
    in tpu_ba/solver/lm.py threads them between chunks)."""

    cameras: jax.Array
    points: jax.Array
    cost: jax.Array
    initial_cost: jax.Array
    lam: jax.Array
    iterations: jax.Array
    accepted: jax.Array
    grad_inf_norm: jax.Array
    converged: jax.Array
    cost_history: jax.Array
    lam_history: jax.Array   # λ used at each linear solve
    cg_history: jax.Array    # CG iterations used at each linear solve
    nu: jax.Array            # Nielsen rejection growth factor
    warm_dxc: jax.Array      # last camera step (CG warm start)
    gnorm0: jax.Array        # first linearization's ‖g‖∞ (forcing sequence)
