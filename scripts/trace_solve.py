#!/usr/bin/env python
"""Device-trace the production solve and print the top ops by total time.

Captures a jax.profiler trace of one steady-state (pre-compiled) solve and
aggregates the chrome-trace events by name — the ground truth for where a
solve's wall-clock goes.

Usage: python scripts/trace_solve.py [--problem ladybug-1723] [--out x.json]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="ladybug-1723")
    ap.add_argument("--solver", default="schur_sparse")
    ap.add_argument("--max-iters", type=int, default=80)
    ap.add_argument("--cg-tol", type=float, default=1e-4,
                    help="match the bench config to hit the compile cache")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from tpu_ba.utils import enable_compilation_cache

    enable_compilation_cache()

    from tpu_ba.core import LMConfig
    from tpu_ba.io.bal import make_bal_like_problem
    from tpu_ba.solver.lm import solve

    problem, gt = make_bal_like_problem(args.problem, dtype=np.float32)
    cfg = LMConfig(max_iters=args.max_iters, linear_solver=args.solver,
                   cg_max_iters=100, cg_tol=args.cg_tol, init_lambda=1e-4)

    t0 = time.time()
    res = jax.block_until_ready(solve(problem, cfg))
    print(f"warmup (compile) {time.time()-t0:.1f}s")
    t0 = time.time()
    res = jax.block_until_ready(solve(problem, cfg))
    steady = time.time() - t0
    print(f"steady {steady:.2f}s  iters={int(res.iterations)}")

    tdir = tempfile.mkdtemp(prefix="trace_solve_")
    with jax.profiler.trace(tdir):
        res = jax.block_until_ready(solve(problem, cfg))

    files = glob.glob(os.path.join(tdir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not files:
        print("no trace.json.gz produced; files:",
              glob.glob(os.path.join(tdir, "**", "*"), recursive=True)[:10])
        return
    with gzip.open(files[0], "rt") as fh:
        trace = json.load(fh)

    # aggregate complete events by (pid-name, event name)
    pid_names = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev["args"].get("name", str(ev["pid"]))
    agg = defaultdict(float)
    cnt = defaultdict(int)
    total_by_pid = defaultdict(float)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        pname = pid_names.get(ev["pid"], str(ev["pid"]))
        dur = ev.get("dur", 0) / 1e6          # us → s
        key = (pname, ev.get("name", "?"))
        agg[key] += dur
        cnt[key] += 1
        total_by_pid[pname] += dur

    print("\ntrack totals (s):")
    for pname, tot in sorted(total_by_pid.items(), key=lambda kv: -kv[1]):
        print(f"  {tot:8.3f}  {pname}")

    print(f"\ntop {args.top} events by total time:")
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:args.top]
    out_rows = []
    for (pname, name), tot in rows:
        n = cnt[(pname, name)]
        print(f"  {tot:8.3f}s  x{n:<6} {pname[:28]:<28} {name[:80]}")
        out_rows.append({"track": pname, "name": name, "total_s": tot,
                         "count": n})

    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"problem": args.problem, "solver": args.solver,
                       "steady_s": steady, "events": out_rows}, fh, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
