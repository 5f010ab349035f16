#!/usr/bin/env python
"""Compute the f64 CPU oracle ("golden") numbers for the BAL stand-ins.

BASELINE.json:5 demands the f32 solve on the accelerator converge to the
reference final cost within 1%. The reference mount is empty (SURVEY.md §0),
so the binding
oracle is this framework's own LM run in float64 on CPU — same algorithm,
same problem, same iteration budget as the bench — recorded once into
``data/goldens/<problem>.json`` and committed. bench.py reports
``f64_parity_pct`` against these numbers and tests/test_accuracy.py asserts
the 1% bound.

Usage: JAX_PLATFORMS=cpu python scripts/golden_oracle.py [--problem ladybug-49]
       [--max-iters 50] [--cg-iters 50] [--cg-tol 1e-2]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="ladybug-49")
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--cg-iters", type=int, default=50)
    ap.add_argument("--cg-tol", type=float, default=1e-2)
    ap.add_argument("--solver", default="schur_sparse")
    ap.add_argument("--robust", default="none",
                    choices=["none", "huber", "cauchy", "arctan"])
    ap.add_argument("--robust-scale", type=float, default=1.0)
    ap.add_argument("--covis", default="ring", choices=("ring", "community"),
                    help="stand-in covisibility structure; community runs "
                         "write a '-community'-suffixed golden (matches "
                         "bench.py's suffixed problem labels)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from tpu_ba.core import LMConfig
    from tpu_ba.io.bal import make_bal_like_problem
    from tpu_ba.residuals.robust import ROBUST_KINDS
    from tpu_ba.solver.lm import solve

    problem, gt = make_bal_like_problem(args.problem, dtype=np.float64,
                                        covis=args.covis)
    if args.covis != "ring":
        args.problem = f"{args.problem}-{args.covis}"
    cfg = LMConfig(max_iters=args.max_iters, linear_solver=args.solver,
                   cg_max_iters=args.cg_iters, cg_tol=args.cg_tol,
                   robust_kind=ROBUST_KINDS[args.robust],
                   robust_scale=args.robust_scale,
                   init_lambda=1e-4)
    t0 = time.time()
    res = solve(problem, cfg)
    final_cost = float(res.cost)
    wall = time.time() - t0

    out = {
        "problem": args.problem,
        "dtype": "float64",
        "device": "cpu",
        "solver": args.solver,
        "max_iters": args.max_iters,
        "cg_max_iters": args.cg_iters,
        "cg_tol": args.cg_tol,
        "robust": args.robust,
        "robust_scale": args.robust_scale,
        "lm_iters": int(res.iterations),
        "lm_accepted": int(res.accepted),
        "initial_cost": float(res.initial_cost),
        "final_cost": final_cost,
        "final_rmse_px": math.sqrt(2.0 * final_cost / gt["n_obs"]),
        "wall_s": wall,
        "cost_history": np.asarray(res.cost_history, np.float64).tolist(),
    }
    os.makedirs("data/goldens", exist_ok=True)
    path = f"data/goldens/{args.problem}.json"
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "cost_history"},
                     indent=1))
    print("wrote", path)


if __name__ == "__main__":
    main()
