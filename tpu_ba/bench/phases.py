"""One LM iteration of the production ``schur_sparse`` solve, phase by phase.

Each phase is its own jitted program over the same arrays the solver
(tpu_ba/solver/lm.py) passes between them, so a phase can be run on any
device, compared across devices and precisions, and timed alone:

  linearize     analytic residual + Jacobian blocks, IRLS, U/V/W/g assembly
  pack          λ-free pair/track/slot gathers (once per linearization)
  s_build       compact S blocks for one λ, damping, block-Jacobi inverse
  rhs           point-block inverses and the reduced right-hand side
  cg_iteration  PCG iterations on the banded reduced camera system
  back_sub      point step from the camera step
  trial_cost    robust cost at a trial step

``compare_on_devices`` runs linearize, s_build and one full PCG solve
(``solve_schur_sparse``) on an accelerator in f32 and on the CPU in f64 and
reports each output's max error relative to its max entry.
``device_phase_ms`` times each phase on the device from a profiler trace.
"""

from __future__ import annotations

import glob
import os
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ba.jacobians.analytic import jacobian_blocks_bal
from tpu_ba.residuals.reprojection import residuals_bal
from tpu_ba.solver.batched_linalg import inv_spd_small
from tpu_ba.solver.lm import _robust_cost
from tpu_ba.solver.normal import assemble, damp_blocks
from tpu_ba.solver.pairs import (_compact_blocks, make_banded_matvec,
                                 precompute_pair_data, solve_schur_sparse)
from tpu_ba.solver.pcg import pcg
from tpu_ba.solver.schur import back_substitute, inv3x3_rows, schur_rhs

DIAG_FLOOR, DIAG_CEIL = 1e-6, 1e32
PHASES = ("linearize", "pack", "s_build", "rhs", "cg_iteration", "back_sub",
          "trial_cost")


@partial(jax.jit, static_argnames=("n_cameras", "n_points", "kind", "scale"))
def linearize(cams, pts, obs, ci, pi, mask, *, n_cameras, n_points,
              kind=0, scale=1.0):
    r, Jc, Jp = jacobian_blocks_bal(cams, pts, obs, ci, pi, mask)
    return assemble(r, Jc, Jp, ci, pi, n_cameras, n_points, kind, scale, mask)


@jax.jit
def pack(B, pairs):
    return precompute_pair_data(B, pairs)


@jax.jit
def s_build(B, pair_data, pairs, lam):
    """(blk, Ul, Minv): compact S blocks, damped camera blocks and the
    block-Jacobi inverse — the per-λ work of a banded plan."""
    blk = _compact_blocks(B, lam, pairs, pair_data, DIAG_FLOOR, DIAG_CEIL)
    Ul, _ = damp_blocks(B, lam, DIAG_FLOOR, DIAG_CEIL)
    dc = Ul.shape[-1]
    C = pairs.n_cameras
    diag_S = Ul - blk[:, :C].reshape(dc, dc, C).transpose(2, 0, 1)
    return blk, Ul, inv_spd_small(diag_S)


@jax.jit
def rhs(B, lam):
    _, Vl = damp_blocks(B, lam, DIAG_FLOOR, DIAG_CEIL)
    Vinv = inv3x3_rows(Vl)
    return schur_rhs(B, Vinv), Vinv


@partial(jax.jit, static_argnames=("iters",))
def cg_fixed(blk, Ul, Minv, b, pairs, *, iters):
    """``iters`` PCG iterations (tol 0: no early exit)."""
    matvec = make_banded_matvec(blk, Ul, pairs, Ul.shape[-1])
    x, _, _ = pcg(matvec, b, lambda r: jnp.einsum("cij,cj->ci", Minv, r),
                  max_iters=iters, tol=0.0)
    return x


@jax.jit
def back_sub(B, Vinv, dx_cam):
    return back_substitute(B, Vinv, dx_cam)


@partial(jax.jit, static_argnames=("kind", "scale"))
def trial_cost(cams, pts, obs, ci, pi, mask, *, kind=0, scale=1.0):
    r = residuals_bal(cams, pts, obs, ci, pi, mask)
    return _robust_cost(r, kind, scale, mask)


@partial(jax.jit, static_argnames=("cg_iters", "cg_tol"))
def pcg_solve(B, pair_data, pairs, lam, *, cg_iters, cg_tol):
    return solve_schur_sparse(B, lam, pairs, pair_data, cg_max_iters=cg_iters,
                              cg_tol=cg_tol, diag_floor=DIAG_FLOOR,
                              diag_ceil=DIAG_CEIL)


def _problem_args(problem):
    return (problem.cameras, problem.points, problem.obs_2d,
            problem.cam_idx, problem.pt_idx, problem.mask)


def _rel_err(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = float(np.max(np.abs(ref))) or 1.0
    return float(np.max(np.abs(a - ref))) / scale


def compare_on_devices(problem, pairs, device, ref_device, *, lam=1e-1,
                       cg_iters=500, cg_tol=1e-6) -> dict:
    """Run linearize → s_build → one PCG solve in f32 on ``device`` and in
    f64 on ``ref_device`` from the same (f32-rounded) inputs. Returns
    {output: max |a − ref| / max |ref|} plus the two CG iteration counts.

    The solve is compared at λ = 0.1 by default: there the damped S is
    conditioned well enough that a 1e-6 relative CG residual pins the step
    down in f32. At small λ two valid solves differ by ~cond(S)·tol, which
    measures the conditioning, not the arithmetic (the LM loop's own check
    is the final-cost gap to the golden)."""
    C, P = problem.cameras.shape[0], problem.points.shape[0]
    outs = {}
    for name, dev, dtype in (("test", device, jnp.float32),
                             ("ref", ref_device, jnp.float64)):
        with jax.enable_x64(dtype == jnp.float64):
            args = [jax.device_put(np.asarray(a, dtype)
                                   if np.issubdtype(np.asarray(a).dtype,
                                                    np.floating)
                                   else np.asarray(a), dev)
                    for a in _problem_args(problem)]
            pl = jax.device_put(pairs, dev)
            B = linearize(*args, n_cameras=C, n_points=P)
            pd = pack(B, pl)
            lam_d = jax.device_put(jnp.asarray(lam, dtype), dev)
            blk, _, _ = s_build(B, pd, pl, lam_d)
            dxc, dxp, it, ok = pcg_solve(B, pd, pl, lam_d, cg_iters=cg_iters,
                                         cg_tol=cg_tol)
            outs[name] = jax.device_get(dict(
                U=B.U, gc=B.gc, W=B.W, V=B.V, gp=B.gp, blk=blk, dx_cam=dxc,
                dx_pt=dxp, cg_iters=it, ok=ok))
    t, r = outs["test"], outs["ref"]
    errs = {k: _rel_err(t[k], r[k])
            for k in ("U", "gc", "W", "V", "gp", "blk", "dx_cam", "dx_pt")}
    errs["cg_iters"] = (int(t["cg_iters"]), int(r["cg_iters"]))
    errs["cg_ok"] = (bool(t["ok"]), bool(r["ok"]))
    return errs


def _device_busy_ns(trace_dir: str, platform_prefix: str) -> tuple[int, dict]:
    """Union of device event intervals in the newest trace under
    ``trace_dir``; also the per-line event counts seen (for inspection)."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    data = ProfileData.from_file(path)
    intervals, lines_seen = [], {}
    for plane in data.planes:
        if not plane.name.startswith(platform_prefix):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for ln in streams or lines:
            evs = list(ln.events)
            lines_seen[f"{plane.name}|{ln.name}"] = len(evs)
            intervals += [(e.start_ns, e.start_ns + e.duration_ns)
                          for e in evs]
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return int(busy), lines_seen


def device_phase_ms(problem, pairs, *, lam=1e-2, reps=5,
                    cg_short=10, cg_long=60,
                    platform_prefix="/device:GPU") -> dict:
    """Device time of each phase (ms per call) at ``problem``'s size on the
    default device. Each phase runs ``reps`` times in a profiler trace of its
    own; its time is the union of device event intervals over ``reps``. One
    CG iteration is (t(cg_long) − t(cg_short)) / (cg_long − cg_short)."""
    C, P = problem.cameras.shape[0], problem.points.shape[0]
    args = _problem_args(problem)
    B = linearize(*args, n_cameras=C, n_points=P)
    pd = pack(B, pairs)
    lam = jnp.asarray(lam, problem.cameras.dtype)
    blk, Ul, Minv = s_build(B, pd, pairs, lam)
    b, Vinv = rhs(B, lam)
    dx = cg_fixed(blk, Ul, Minv, b, pairs, iters=cg_short)
    calls = {
        "linearize": lambda: linearize(*args, n_cameras=C, n_points=P),
        "pack": lambda: pack(B, pairs),
        "s_build": lambda: s_build(B, pd, pairs, lam),
        "rhs": lambda: rhs(B, lam),
        "cg_short": lambda: cg_fixed(blk, Ul, Minv, b, pairs,
                                     iters=cg_short),
        "cg_long": lambda: cg_fixed(blk, Ul, Minv, b, pairs, iters=cg_long),
        "back_sub": lambda: back_sub(B, Vinv, dx),
        "trial_cost": lambda: trial_cost(*args),
    }
    ms, lines = {}, {}
    for name, fn in calls.items():
        jax.block_until_ready(fn())                       # compile + warm
        with tempfile.TemporaryDirectory() as d:
            with jax.profiler.trace(d):
                for _ in range(reps):
                    jax.block_until_ready(fn())
            busy, lines[name] = _device_busy_ns(d, platform_prefix)
        ms[name] = busy / reps / 1e6
    ms["cg_iteration"] = (ms["cg_long"] - ms["cg_short"]) / (cg_long
                                                            - cg_short)
    return {"ms": ms, "lines": lines}
