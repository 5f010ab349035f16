"""Command-line interface: run_ba / run_sfm / run_posegraph / run_bench.

Capability parity: the reference is driven by demo scripts (SURVEY.md §1.1
top layer); these subcommands are their equivalent, over the framework API
(SURVEY.md §1.3). Config is plain argparse + optional JSON config files
(SURVEY.md §5 "Config / flag system" row).

Usage:
    python -m tpu_ba.cli ba --problem ladybug-49 --max-iters 30
    python -m tpu_ba.cli ba --bal-file path/to/problem.txt --robust huber
    python -m tpu_ba.cli sfm --frames 8 --points 300
    python -m tpu_ba.cli posegraph --nodes 50 --noise 0.03
    python -m tpu_ba.cli bench --quick
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _add_ba(sub):
    p = sub.add_parser("ba", help="bundle-adjust a BAL problem")
    p.add_argument("--problem", default="ladybug-49",
                   help="BAL stand-in name (see tpu_ba.io.bal.BAL_DATASET_DIMS) "
                        "or 'synthetic'")
    p.add_argument("--bal-file", default=None, help="path to a real BAL file")
    p.add_argument("--max-iters", type=int, default=50)
    p.add_argument("--cg-iters", type=int, default=50)
    p.add_argument("--cg-tol", type=float, default=1e-2)
    p.add_argument("--solver", default="schur_sparse",
                   choices=["dense", "schur_pcg", "schur_dense",
                            "schur_sparse"],
                   help="linear solver for the LM inner step")
    p.add_argument("--robust", choices=["none", "huber", "cauchy", "arctan"],
                   default="none")
    p.add_argument("--robust-scale", type=float, default=2.0)
    p.add_argument("--precond", choices=["jacobi", "tridiag"],
                   default="jacobi",
                   help="PCG preconditioner (tridiag = block-tridiagonal "
                        "PCR inverse; banded schur_sparse plans only)")
    p.add_argument("--sharded", action="store_true",
                   help="run over all local devices (observation-sharded)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--metrics", default=None, help="JSONL metrics output path")
    p.add_argument("--checkpoint", default=None, help="checkpoint dir to write")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also dump state every N accepted LM iterations "
                        "from inside the jitted loop (0 = end only)")
    p.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p.add_argument("--config", default=None, help="JSON file of LMConfig overrides")
    p.add_argument("--scene", default=None,
                   help="load the problem from a scene file (.npz/.mat)")
    p.add_argument("--save-scene", default=None,
                   help="save the optimized scene (.npz/.mat)")
    p.add_argument("--plot-scene", default=None,
                   help="write a 3-D scene plot (PNG) after solving")
    p.add_argument("--plot-convergence", default=None,
                   help="write cost/lambda/CG-history plot (PNG)")
    p.add_argument("--plot-reproj", default=None,
                   help="write a reprojection overlay for camera 0 (PNG)")


def _add_sfm(sub):
    p = sub.add_parser("sfm", help="incremental SfM on an image sequence")
    p.add_argument("--sequence", default=None,
                   help="TUM or KITTI sequence dir (synthetic render if omitted)")
    p.add_argument("--format", choices=["tum", "kitti"], default="tum")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--points", type=int, default=300)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--corners", type=int, default=512)
    p.add_argument("--out", default=None, help="write resulting scene as BAL file")


def _add_posegraph(sub):
    p = sub.add_parser("posegraph", help="pose-graph refinement demo")
    p.add_argument("--nodes", type=int, default=50)
    p.add_argument("--noise", type=float, default=0.03)
    p.add_argument("--max-iters", type=int, default=30)


def _add_bench(sub):
    p = sub.add_parser("bench", help="run the benchmark harness")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--problem", default="ladybug-1723")


def _robust_kind(name: str) -> int:
    from tpu_ba.residuals.robust import (
        ROBUST_ARCTAN, ROBUST_CAUCHY, ROBUST_HUBER, ROBUST_NONE)

    return {"none": ROBUST_NONE, "huber": ROBUST_HUBER,
            "cauchy": ROBUST_CAUCHY, "arctan": ROBUST_ARCTAN}[name]


def jnp_asarray(x, dtype):
    import jax.numpy as jnp
    import numpy as np

    return jnp.asarray(np.asarray(x), dtype)


def cmd_ba(args) -> int:
    import numpy as np

    from tpu_ba.bench.metrics import MetricsLogger
    from tpu_ba.core import LMConfig
    from tpu_ba.io.bal import load_bal, make_bal_like_problem
    from tpu_ba.io.synthetic import make_synthetic_problem
    from tpu_ba.utils import enable_compilation_cache

    enable_compilation_cache()
    if args.scene:
        from tpu_ba.io.scene import load_scene

        problem = load_scene(args.scene)
        n_obs = problem.n_obs
    elif args.bal_file:
        problem = load_bal(args.bal_file)
        n_obs = problem.n_obs
    elif args.problem == "synthetic":
        problem, gt = make_synthetic_problem(20, 500)
        n_obs = gt["n_obs"]
    else:
        problem, gt = make_bal_like_problem(args.problem)
        n_obs = gt["n_obs"]

    kwargs = dict(max_iters=args.max_iters, cg_max_iters=args.cg_iters,
                  cg_tol=args.cg_tol, robust_kind=_robust_kind(args.robust),
                  robust_scale=args.robust_scale,
                  linear_solver=args.solver, precond=args.precond)
    if args.checkpoint and args.checkpoint_every:
        kwargs.update(checkpoint_every=args.checkpoint_every,
                      checkpoint_path=args.checkpoint)
    if args.config:
        kwargs.update(json.load(open(args.config)))  # JSON wins over flags
    cfg = LMConfig(**kwargs)

    log = MetricsLogger(args.metrics)
    t0 = time.time()
    if args.sharded:
        from tpu_ba.sharding import make_mesh, shard_problem, solve_sharded
        from tpu_ba.sharding.multihost import init_distributed

        init_distributed(args.coordinator, args.num_processes, args.process_id)
        mesh = make_mesh()
        res = solve_sharded(shard_problem(problem, mesh), cfg, mesh,
                            resume_from=args.resume)
    else:
        from tpu_ba.solver.lm import solve

        # --resume restores the FULL trust-region state (params, λ, ν,
        # iteration) — resumed ≡ uninterrupted (tests/test_cli_and_aux.py)
        res = solve(problem, cfg, resume_from=args.resume)
    final = float(res.cost)
    wall = time.time() - t0
    log.log_lm_result(res, wall_s=wall, label=args.bal_file or args.problem)
    log.close()

    if args.checkpoint:
        from tpu_ba.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, cameras=res.cameras, points=res.points,
                        lam=res.lam, iteration=int(res.iterations), cost=final)

    if args.save_scene:
        from tpu_ba.io.scene import save_scene

        save_scene(args.save_scene, problem.with_params(res.cameras, res.points))
    if args.plot_scene:
        from tpu_ba.viz import plot_scene

        plot_scene(res.cameras, res.points, args.plot_scene,
                   title=args.bal_file or args.problem)
    if args.plot_convergence:
        from tpu_ba.viz import plot_convergence

        plot_convergence(res, args.plot_convergence)
    if args.plot_reproj:
        from tpu_ba.viz import plot_reprojection

        plot_reprojection(problem, res.cameras, res.points, args.plot_reproj)

    rmse = math.sqrt(2.0 * final / max(n_obs, 1))
    print(json.dumps({
        "problem": args.bal_file or args.problem,
        "iterations": int(res.iterations), "accepted": int(res.accepted),
        "initial_cost": float(res.initial_cost), "final_cost": final,
        "rmse_px": rmse, "wall_s": wall, "converged": bool(res.converged),
    }))
    return 0


def cmd_sfm(args) -> int:
    import numpy as np

    from tpu_ba.sfm.incremental import SfMConfig, run_incremental_sfm

    if args.sequence:
        if args.format == "tum":
            from tpu_ba.io.sequences import read_tum_sequence

            frames, gt = read_tum_sequence(args.sequence, args.max_frames)
        else:
            from tpu_ba.io.sequences import read_kitti_sequence

            frames, gt = read_kitti_sequence(args.sequence, args.max_frames)
        K = gt.get("K")
        if K is None:
            H, W = frames.shape[1:3]
            K = (0.9 * W, 0.9 * W, W / 2.0, H / 2.0)  # rough default intrinsics
    else:
        from tpu_ba.io.sequences import render_blob_sequence

        frames, gt = render_blob_sequence(n_frames=args.frames, n_points=args.points)
        K = gt["K"]

    res = run_incremental_sfm(frames, K, SfMConfig(max_corners=args.corners))
    rmse = math.sqrt(2 * res.final_cost / max(res.report["n_obs"], 1))
    print(json.dumps({**res.report, "final_cost": res.final_cost, "rmse_px": rmse}))

    if args.out:
        from tpu_ba.core import make_problem
        from tpu_ba.io.bal import save_bal
        from tpu_ba.sfm.incremental import _to_bal_camera

        fx, fy, cx, cy = K
        reg = np.where(res.registered)[0]
        fmap = {f: i for i, f in enumerate(reg)}
        cams = np.stack([_to_bal_camera(res.poses[f, 0:3], res.poses[f, 3:6],
                                        0.5 * (fx + fy)) for f in reg])
        sel = np.isin(res.track_frame, reg)
        ci = np.asarray([fmap[f] for f in res.track_frame[sel]], np.int32)
        pi = res.track_point[sel].astype(np.int32)
        uv = res.track_xy[sel] - np.array([cx, cy])
        prob = make_problem(cams, res.points, uv, ci, pi, pad_multiple=1)
        save_bal(args.out, prob)
    return 0


def cmd_posegraph(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from tpu_ba.geometry.se3 import se3_compose, se3_exp, se3_relative
    from tpu_ba.posegraph import pose_graph_cost, solve_pose_graph

    rng = np.random.default_rng(0)
    n = args.nodes
    gt = np.zeros((n, 6))
    for i in range(n):
        ang = 2 * np.pi * i / n
        gt[i] = [0, ang, 0, np.cos(ang), 0, np.sin(ang)]
    gt_j = jnp.asarray(gt)
    ei = np.r_[np.arange(1, n), 0].astype(np.int32)
    ej = np.r_[np.arange(0, n - 1), n - 1].astype(np.int32)
    meas = np.stack([
        np.asarray(se3_compose(se3_exp(jnp.asarray(args.noise * rng.standard_normal(6))),
                               se3_relative(gt_j[i], gt_j[j])))
        for i, j in zip(ei, ej)])
    init = gt + 0.1 * rng.standard_normal(gt.shape)
    init[0] = gt[0]
    c0 = float(pose_graph_cost(jnp.asarray(init), jnp.asarray(ei), jnp.asarray(ej),
                               jnp.asarray(meas)))
    nodes, cost, iters = solve_pose_graph(
        jnp.asarray(init), jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(meas),
        max_iters=args.max_iters)
    print(json.dumps({"nodes": n, "initial_cost": c0, "final_cost": float(cost),
                      "iterations": int(iters)}))
    return 0


def cmd_bench(args) -> int:
    """Run bench.py in a child process. This process never touches JAX's
    devices, so the child is the only process on the card."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, os.path.join(repo, "bench.py"),
           "--problem", args.problem]
    if args.quick:
        cmd.append("--quick")
    return subprocess.call(cmd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_ba", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_ba(sub)
    _add_sfm(sub)
    _add_posegraph(sub)
    _add_bench(sub)
    args = ap.parse_args(argv)
    return {"ba": cmd_ba, "sfm": cmd_sfm, "posegraph": cmd_posegraph,
            "bench": cmd_bench}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
