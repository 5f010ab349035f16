"""Distributed bundle adjustment over a device mesh.

Capability parity: the multi-host "keyframe-partitioned" distributed BA
mandated by BASELINE.json:5,11 (the reference is single-process MATLAB —
SURVEY.md §2.1 — so this layer is new capability, not a port).

Design (SURVEY.md §2.2 N8, §3.2):
  * 1-D mesh over all devices (within a host, and across hosts when
    launched under ``jax.distributed.initialize``).
  * **Observations are sharded** along the mesh axis. Because observations
    are sorted by camera (tpu_ba.core.make_problem), equal-size observation
    shards are contiguous camera ranges — i.e. a keyframe partition: each
    device owns the observations of a contiguous run of cameras.
  * **Camera and point states are replicated.** Camera state is tiny
    (C×9); point state (P×3) and the V blocks (P×3×3) are tens of MB even
    for Venice-1778 — well within device memory, and replication makes the
    Schur reduction a pure psum pattern with no gather traffic.
  * All communication is ``psum`` of segment-sum partials: 4 per
    linearization (U, V, g_c, g_p + cost), then for ``schur_pcg`` 2 per CG
    iteration (the point- and camera-side reductions of the S matvec) and
    for ``schur_sparse`` one of the compact S blocks per λ-retry, 1 each
    for RHS/diag/back-substitution. Everything rides XLA collectives.

The solver body is literally ``tpu_ba.solver.lm.lm_loop`` with
``axis_name="obs"`` — single-device and distributed results are identical
up to floating-point reduction order (tested in tests/test_sharding.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_ba.core import BAProblem, LMConfig, LMResult
from tpu_ba.solver.lm import lm_loop

AXIS = "obs"


def make_mesh(devices=None, axis_name: str = AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_problem(problem: BAProblem, mesh: Mesh) -> BAProblem:
    """Re-pad the observation axis to a multiple of the mesh size and place
    the arrays: observation-indexed arrays sharded over the mesh axis,
    camera/point state replicated."""
    n_dev = mesh.devices.size
    O = problem.obs_2d.shape[0]
    q = n_dev * 128
    O_pad = ((O + q - 1) // q) * q
    pad = O_pad - O
    if pad:
        # index padding repeats the LAST index (edge mode), preserving the
        # global camera-sorted key order the sorted segment sums rely on
        # (zero padding would place key 0 after the largest key whenever
        # the real length is not shard-aligned); mask=False keeps the rows
        # inert
        problem = dataclasses.replace(
            problem,
            obs_2d=jnp.pad(problem.obs_2d, ((0, pad), (0, 0))),
            cam_idx=jnp.pad(problem.cam_idx, (0, pad), mode="edge"),
            pt_idx=jnp.pad(problem.pt_idx, (0, pad), mode="edge"),
            mask=jnp.pad(problem.mask, (0, pad)),
        )
    obs_sh = NamedSharding(mesh, P(AXIS))
    rep_sh = NamedSharding(mesh, P())
    return dataclasses.replace(
        problem,
        cameras=jax.device_put(problem.cameras, rep_sh),
        points=jax.device_put(problem.points, rep_sh),
        obs_2d=jax.device_put(problem.obs_2d, obs_sh),
        cam_idx=jax.device_put(problem.cam_idx, obs_sh),
        pt_idx=jax.device_put(problem.pt_idx, obs_sh),
        mask=jax.device_put(problem.mask, obs_sh),
    )


def _pairplan_specs(pairs):
    """PartitionSpec pytree for a PairPlan: the pair axis is sharded over
    the mesh (each device reduces its own pair shard — see
    solve_schur_sparse's sharded contract); segment/heavy maps replicated."""
    kw = {f.name: None for f in dataclasses.fields(pairs)}
    for name in ("pair_i", "pair_j", "pair_pt", "pair_key", "pair_seg"):
        kw[name] = P(AXIS)
    if pairs.track is not None:
        # stacked per-device track layout (shard_stack_track_layout): the
        # tracked-point axis is sharded; band partials psum with the blocks
        from tpu_ba.solver.tracks import TrackLayout

        tl = pairs.track
        if tl.slot_idx.ndim != 3:     # static shape info — trace-safe
            raise ValueError(
                "sharded PairPlan carries an UNSTACKED TrackLayout — a "
                "replicated global layout would add the full track band "
                "contribution on every device and the psum would multiply "
                "it by the mesh size. Build the plan with tracks=False or "
                "stack it with shard_stack_track_layout().")
        kw["track"] = TrackLayout(
            slot_idx=P(AXIS), slot_mask=P(AXIS), vperm=P(AXIS), keys=P(AXIS),
            dmax=tl.dmax, n_tracked=tl.n_tracked, pt_pad=tl.pt_pad,
            n_out=tl.n_out)
    for name in ("seg_ci", "seg_cj", "diag_pos", "nondiag",
                 "heavy_obs", "heavy_cam", "heavy_seg", "heavy_pt_ids"):
        kw[name] = P()
    # meta fields must carry their real values (they live in the treedef)
    for name in ("n_pairs", "n_cameras", "max_degree", "n_segments", "k_pad",
                 "n_heavy_obs", "n_heavy_pts", "symmetric", "banded",
                 "band_offsets", "c_pad", "k_band"):
        kw[name] = getattr(pairs, name)
    return type(pairs)(**kw)


@partial(jax.jit, static_argnums=(1, 2))
def _solve_sharded_jit(problem: BAProblem, config: LMConfig, mesh: Mesh,
                       init_state=None, pairs=None) -> LMResult:
    def body(cams, pts, obs, ci, pi, mask, init_state, pairs):
        if pairs is not None and pairs.track is not None:
            import dataclasses as _dc

            from tpu_ba.solver.tracks import unstack_track_layout

            pairs = _dc.replace(pairs,
                                track=unstack_track_layout(pairs.track))
        return lm_loop(cams, pts, obs, ci, pi, mask,
                       n_cameras=problem.cameras.shape[0],
                       n_points=problem.points.shape[0],
                       config=config, axis_name=AXIS,
                       init_state=init_state, pairs=pairs)

    pair_specs = _pairplan_specs(pairs) if pairs is not None else None
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(),
                  pair_specs),
        out_specs=P(),
        check_vma=False,
    )
    return fn(problem.cameras, problem.points, problem.obs_2d,
              problem.cam_idx, problem.pt_idx, problem.mask, init_state,
              pairs)


def solve_sharded(problem: BAProblem, config: LMConfig | None = None,
                  mesh: Mesh | None = None,
                  resume_from: str | None = None) -> LMResult:
    """Distributed LM bundle adjustment. ``problem`` should have been placed
    with :func:`shard_problem` (done automatically otherwise).

    ``resume_from`` restores the full trust-region state (params, λ, ν,
    iteration) from a checkpoint, exactly like the single-device
    ``solve(..., resume_from=...)`` — distributed runs are the main consumer
    of elastic recovery."""
    from tpu_ba.solver.lm import _memoized, _plan_key, check_linear_solver

    if config is None:
        config = LMConfig()
    check_linear_solver(config.linear_solver)
    if config.linear_solver == "dense":
        raise ValueError("dense solver has no sharded path; use schur_pcg")
    if config.linear_solver == "schur_dense":
        raise ValueError("schur_dense has no sharded path; use schur_sparse")
    if mesh is None:
        mesh = make_mesh()
    pairs = None
    if config.linear_solver == "schur_sparse":
        # the production compact/banded solver, keyframe-partitioned
        # (BASELINE.json:11): pairs sharded over the mesh, ONE psum of the
        # compact blocks per λ-retry, communication-free CG
        from tpu_ba.solver.pairs import build_pair_plan

        n_dev = mesh.devices.size
        def _build_sharded_pairs():
            # tracks=True: the global track layout is split into per-device
            # point chunks (shard_stack_track_layout) whose band partials
            # psum with the pair blocks. slots=False: the degree-bucketed
            # slot tuples would need a per-device re-bucketing pass
            # (community plans are slot-free anyway, and ring plans route
            # most points through tracks).
            pp = build_pair_plan(
                problem.cam_idx, problem.pt_idx, problem.n_obs,
                problem.cameras.shape[0], problem.points.shape[0],
                symmetric=True, tracks=True, slots=False,
                pad_multiple=max(2048, n_dev))
            if pp.track is not None:
                from tpu_ba.solver.tracks import shard_stack_track_layout

                pp = dataclasses.replace(pp, track=shard_stack_track_layout(
                    pp.track, n_dev))
            return pp

        pairs = _memoized(_plan_key(problem, f"pairs-sharded-{n_dev}"),
                          _build_sharded_pairs)
        if pairs.n_pairs % n_dev:
            raise ValueError(
                f"pair count {pairs.n_pairs} not divisible by mesh size "
                f"{n_dev}; use a power-of-two mesh or adjust pad_multiple")
    init_state = None
    if resume_from:
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
        init_state = (jnp.asarray(ck["lam"], dt), jnp.asarray(nu, dt),
                      jnp.asarray(ck["iteration"], jnp.int32),
                      ws, jnp.asarray(g0, dt))
    O = problem.obs_2d.shape[0]
    if O % (mesh.devices.size * 128) != 0:
        problem = shard_problem(problem, mesh)
    return _solve_sharded_jit(problem, config, mesh, init_state, pairs)
