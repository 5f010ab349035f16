#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line.

Headline metric (BASELINE.json:2,5): BA iterations/second on the
Ladybug-1723-dimension BAL problem on one GPU through the block-sparse
Schur path (``schur_sparse``), with ``vs_baseline`` the speedup of
time-per-LM-iteration against the in-repo MATLAB-class CPU baseline
(scipy Schur + dense Cholesky — tpu_ba/bench/cpu_baseline.py) measured
directly at the same problem scale. The reference itself has no retrievable
numbers (empty mount, no published benchmarks — SURVEY.md §0/§6), so the
CPU baseline is the documented stand-in denominator, and the BAL problem is
a dimension-matched synthetic stand-in (real BAL files load via
tpu_ba.io.bal if provided).

bench_detail.json carries the breakdown: the device (platform, kind,
count, nvidia-smi name and power limit), accepted-steps/s alongside
iters/s, first-call (compile) vs steady-state split, peak device memory,
and f64-oracle parity (data/goldens/<problem>.json —
scripts/golden_oracle.py). The run refuses to start without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="ladybug-1723",
                    help="BAL stand-in name or 'synthetic'")
    ap.add_argument("--covis", default="ring", choices=("ring", "community"),
                    help="stand-in covisibility structure ('community' = "
                         "unordered photo-collection graph)")
    ap.add_argument("--max-iters", type=int, default=80)
    ap.add_argument("--cg-iters", type=int, default=100)
    # 1e-4: the goldens (data/goldens/) are recorded at this config, and it
    # gave better f64 parity than 1e-3 at the cost of extra CG iterations
    ap.add_argument("--cg-tol", type=float, default=1e-4)
    ap.add_argument("--cg-forcing", type=float, default=0.0,
                    help=">0 enables the Eisenstat-Walker forcing sequence "
                         "(loose CG tol far from the optimum, cg_tol near it)")
    ap.add_argument("--baseline-iters", type=int, default=2)
    ap.add_argument("--baseline-problem", default=None,
                    help="problem for the CPU denominator (default: the bench "
                         "problem itself — direct, no extrapolation)")
    ap.add_argument("--quick", action="store_true", help="small problem, few iters")
    ap.add_argument("--robust", default="none",
                    choices=["none", "huber", "cauchy", "arctan"],
                    help="robust kernel (config 3: huber on trafalgar-257)")
    ap.add_argument("--robust-scale", type=float, default=1.0)
    ap.add_argument("--precond", default="jacobi",
                    choices=["jacobi", "tridiag"],
                    help="PCG preconditioner (tridiag = block-tridiagonal "
                         "PCR inverse, tpu_ba/solver/tridiag.py)")
    ap.add_argument("--solver", default="schur_sparse",
                    choices=["schur_sparse", "schur_dense", "schur_pcg"],
                    help="linear solver (schur_sparse is the production "
                         "path)")
    args = ap.parse_args()

    import jax

    from tpu_ba.bench.device import (device_record, peak_bytes_in_use,
                                     require_gpu)

    require_gpu()

    from tpu_ba.utils import enable_compilation_cache

    enable_compilation_cache()

    from tpu_ba.bench.cpu_baseline import solve_cpu_baseline
    from tpu_ba.core import LMConfig
    from tpu_ba.io.bal import make_bal_like_problem
    from tpu_ba.io.synthetic import make_synthetic_problem
    from tpu_ba.solver.lm import solve

    if args.quick:
        args.problem = "ladybug-49"
        args.max_iters = 20

    t0 = time.time()
    if args.problem == "synthetic":
        problem, gt = make_synthetic_problem(20, 500, dtype=np.float32)
        gt = dict(gt)
        gt.setdefault("n_obs", problem.n_obs)
    else:
        problem, gt = make_bal_like_problem(args.problem, dtype=np.float32,
                                            covis=args.covis)
        if args.covis != "ring":
            # suffixed label: goldens and metric names must not collide
            # with the ring stand-in's
            args.problem = f"{args.problem}-{args.covis}"
    gen_s = time.time() - t0
    n_obs = gt["n_obs"]

    from tpu_ba.residuals.robust import ROBUST_KINDS

    cfg = LMConfig(max_iters=args.max_iters, linear_solver=args.solver,
                   cg_max_iters=args.cg_iters, cg_tol=args.cg_tol,
                   cg_forcing=args.cg_forcing,
                   robust_kind=ROBUST_KINDS[args.robust],
                   robust_scale=args.robust_scale, init_lambda=1e-4,
                   precond=args.precond)

    # first call: host plan build + compile (persistent cache may hit) + run
    t0 = time.time()
    res = jax.block_until_ready(solve(problem, cfg))
    first_call_s = time.time() - t0

    # timed runs (best of 3)
    run_s = float("inf")
    for _trial in range(3):
        t0 = time.time()
        res = jax.block_until_ready(solve(problem, cfg))
        run_s = min(run_s, time.time() - t0)
    iters = int(res.iterations)
    accepted = int(res.accepted)
    iters_per_sec = iters / max(run_s, 1e-9)
    accepted_per_sec = accepted / max(run_s, 1e-9)

    final_cost = float(res.cost)
    hist = np.asarray(res.cost_history, np.float64)
    rmse = math.sqrt(2.0 * final_cost / n_obs)

    # time-to-1%-of-final-cost (BASELINE.json:2): first iteration whose cost
    # is within 1% of the final cost, with the run time split uniformly over
    # the LM iterations (an estimate: λ-retries and CG counts vary)
    target = final_cost * 1.01
    reach = int(np.argmax(hist <= target)) + 1
    frac = reach / max(iters, 1)
    time_to_1pct_run_s = frac * run_s
    time_to_1pct_total_s = first_call_s - run_s * (1 - frac)

    # f64 CPU oracle parity (golden committed by scripts/golden_oracle.py)
    parity = None
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "goldens", f"{args.problem}.json")
    if os.path.exists(golden_path):
        with open(golden_path) as fh:
            golden = json.load(fh)
        parity = {
            "golden_final_cost_f64": golden["final_cost"],
            "golden_config": {k: golden[k] for k in
                              ("max_iters", "cg_max_iters", "cg_tol",
                               "robust", "robust_scale") if k in golden},
            "final_cost_gap_pct": round(
                (final_cost - golden["final_cost"])
                / golden["final_cost"] * 100, 3),
            "rmse_f64_px": golden["final_rmse_px"],
            "rmse_gap_pct": round(
                (rmse - golden["final_rmse_px"])
                / golden["final_rmse_px"] * 100, 3),
        }

    # stage-write the device results BEFORE the CPU baseline: a baseline
    # crash must not lose the measured chip numbers
    detail = {
        "problem": args.problem,
        "solver": args.solver,
        "n_cameras": problem.n_cameras,
        "n_points": problem.n_points,
        "n_obs": n_obs,
        "device": device_record(),
        "dtype": "float32",
        "gen_s": gen_s,
        "first_call_s": first_call_s,
        "run_s": run_s,
        "lm_iters": iters,
        "lm_accepted": accepted,
        "iters_per_sec": iters_per_sec,
        "accepted_per_sec": accepted_per_sec,
        "cg_total": int(np.asarray(res.cg_history).sum()),
        "initial_cost": float(res.initial_cost),
        "final_cost": final_cost,
        "final_rmse_px": rmse,
        "time_to_1pct_run_s": time_to_1pct_run_s,
        "time_to_1pct_incl_first_call_s": time_to_1pct_total_s,
        "f64_parity": parity,
        "peak_bytes_in_use": peak_bytes_in_use(),
        "cost_history": hist.tolist(),
        "baseline": None,
        "vs_baseline_speedup": None,
    }
    with open("bench_detail.json", "w") as fh:
        json.dump(detail, fh, indent=1)

    # CPU baseline, measured directly at the bench problem's scale
    if args.baseline_problem in (None, args.problem):
        bl_problem, bl_scale = problem, 1.0
        bl_name = args.problem
    else:
        bl_problem, bl_gt = make_bal_like_problem(args.baseline_problem,
                                                  dtype=np.float32)
        bl_scale = n_obs / bl_gt["n_obs"]
        bl_name = args.baseline_problem
    bl = solve_cpu_baseline(bl_problem, max_iters=args.baseline_iters,
                            time_budget_s=300.0)
    bl_sec_per_iter = bl["sec_per_iter"] * bl_scale
    vs_baseline = iters_per_sec * bl_sec_per_iter

    detail["baseline"] = {
        "problem": bl_name,
        "method": "scipy Schur + dense Cholesky (MATLAB-class stand-in; "
                  "see SURVEY.md §6 — reference has no published numbers)",
        "iters_run": bl.get("iters", args.baseline_iters),
        "sec_per_iter": bl["sec_per_iter"],
        "sec_per_iter_at_bench_scale": bl_sec_per_iter,
        "obs_scale_factor": bl_scale,
        "final_cost": bl["final_cost"],
    }
    detail["vs_baseline_speedup"] = vs_baseline
    with open("bench_detail.json", "w") as fh:
        json.dump(detail, fh, indent=1)

    print(json.dumps({
        "metric": f"ba_iters_per_sec_{args.problem.replace('-', '_')}_1gpu",
        "value": round(iters_per_sec, 3),
        "unit": "LM iters/s",
        "vs_baseline": round(vs_baseline, 2),
    }))


if __name__ == "__main__":
    main()
