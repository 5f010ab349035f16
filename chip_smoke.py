#!/usr/bin/env python
"""Smoke test of the bundle-adjustment path on NVIDIA GPUs.

Default run (one card):
  (a) the card's name and power limit (nvidia-smi), JAX's device kind and
      the matmul precision in force;
  (b) exit non-zero unless JAX's default backend is a GPU — no CPU fallback;
  (c) ladybug-1723 (1,723 cameras, 156,502 points, 678,718 observations,
      generated from a seed) solved by ``tpu_ba.solver.lm.solve`` at the
      config of its f64 CPU golden (data/goldens/ladybug-1723.json), three
      times; the median final cost must be within 1% of the golden;
  (d) one linearization (U, g_c, W, V, g_p), the compact S blocks for one λ
      and one PCG solve, each in f32 on the card against the same phase in
      f64 on the CPU at ladybug-1723 widths; max error relative to the max
      entry must stay under 1e-3 (f32 with reduction orders that change
      from run to run, against f64, at "highest" matmul precision).

``--multichip`` runs only ``solve_sharded`` (schur_sparse) of ladybug-1723
over all visible cards (four) and the one-card solve it is compared with,
three times each: median sharded cost within 0.1% of the median one-card
cost, both within 1% of the golden.

Why medians: the GPU's segment sums add in an order that changes from run
to run, so each f32 LM trajectory differs. Most runs end within 0.01% of
the golden, but a run whose λ climbs after a few rejected steps spends
~20 of its 80 iterations recovering and ends up to ~1% higher. Every run
is printed; the median of three is checked.

``--phase-times JSON`` runs only the per-phase device times of one LM
iteration at ladybug-1723 (tpu_ba.bench.phases.device_phase_ms, from
profiler traces) and writes them to the file JSON.

Every phase raises on failure. The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Usage: python chip_smoke.py [--multichip | --phase-times JSON]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PROBLEM = "ladybug-1723"
GOLDEN_BOUND = 0.01        # tests/test_accuracy.py's bound
SHARDED_BOUND = 0.001
PHASE_BOUND = 1e-3
SOLVES = 3                 # per solve phase; the median cost is checked


def _golden():
    with open(os.path.join(REPO, "data", "goldens", f"{PROBLEM}.json")) as fh:
        return json.load(fh)


def _config(golden):
    from tpu_ba.core import LMConfig

    return LMConfig(max_iters=golden["max_iters"],
                    cg_max_iters=golden["cg_max_iters"],
                    cg_tol=golden["cg_tol"], linear_solver=golden["solver"],
                    init_lambda=1e-4)


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _solves(tag, fn, golden):
    """SOLVES timed solves, each printed; returns (median cost, seconds)."""
    import numpy as np

    g = golden["final_cost"]
    costs, secs = [], []
    for k in range(SOLVES):
        res, s = _timed(fn)
        costs.append(float(res.cost))
        secs.append(s)
        print(f"[{tag}] run {k}: cost={costs[-1]:.6f} "
              f"gap={(costs[-1] - g) / g * 100:+.4f}% lm_iters="
              f"{int(res.iterations)} accepted={int(res.accepted)} cg_total="
              f"{int(np.asarray(res.cg_history).sum())} wall_s={s:.3f}")
    _check(bool(np.all(np.isfinite(costs))), f"non-finite cost: {costs}")
    return float(np.median(costs)), secs


def _solve_phase(problem, golden):
    """(c): the golden-config solve through the normal plan builder."""
    import jax

    from tpu_ba.bench.device import peak_bytes_in_use
    from tpu_ba.solver.lm import solve

    cfg = _config(golden)
    cost, secs = _solves("solve", lambda: solve(problem, cfg), golden)
    gap = (cost - golden["final_cost"]) / golden["final_cost"]
    print(f"[solve] {PROBLEM} {cfg.linear_solver}: first_call_s={secs[0]:.3f}"
          f" steady_s={min(secs[1:]):.3f} peak_bytes_in_use="
          f"{peak_bytes_in_use(jax.devices()[0])}")
    print(f"[solve] median final_cost={cost:.6f} golden="
          f"{golden['final_cost']:.6f} gap={gap * 100:+.4f}%")
    _check(abs(gap) < GOLDEN_BOUND,
           f"final cost gap {gap:.3e} exceeds {GOLDEN_BOUND}")


def _phase_compare(problem):
    """(d): f32 on the card vs f64 on the CPU, phase by phase."""
    import jax

    from tpu_ba.bench.phases import compare_on_devices
    from tpu_ba.solver.pairs import build_pair_plan

    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            problem.cameras.shape[0], problem.points.shape[0],
                            symmetric=True)
    t0 = time.perf_counter()
    errs = compare_on_devices(problem, pairs, jax.devices()[0],
                              jax.devices("cpu")[0])
    print(f"[phases] gpu f32 vs cpu f64 ({time.perf_counter() - t0:.1f} s), "
          f"max error relative to max entry:")
    worst = 0.0
    for k, v in errs.items():
        print(f"[phases]   {k}: {v}")
        if isinstance(v, float):
            worst = max(worst, v)
    _check(all(errs["cg_ok"]), f"PCG breakdown: {errs['cg_ok']}")
    _check(worst < PHASE_BOUND, f"phase error {worst:.3e} >= {PHASE_BOUND}")


def _multichip(problem, golden):
    import jax

    from tpu_ba.sharding import make_mesh, shard_problem, solve_sharded
    from tpu_ba.solver.lm import solve

    cfg = _config(golden)
    n = len(jax.devices())
    _check(n > 1, f"--multichip needs several cards, found {n}")
    c1, one_s = _solves("one card", lambda: solve(problem, cfg), golden)
    mesh = make_mesh()
    sharded_problem = shard_problem(problem, mesh)
    cn, sh_s = _solves(f"{n} cards",
                       lambda: solve_sharded(sharded_problem, cfg, mesh),
                       golden)
    g = golden["final_cost"]
    print(f"[multichip] one card: median cost={c1:.6f} first_call_s="
          f"{one_s[0]:.3f} steady_s={min(one_s[1:]):.3f} "
          f"gap={(c1 - g) / g * 100:+.4f}%")
    print(f"[multichip] {n} cards: median cost={cn:.6f} first_call_s="
          f"{sh_s[0]:.3f} steady_s={min(sh_s[1:]):.3f} "
          f"gap={(cn - g) / g * 100:+.4f}% vs one card "
          f"{(cn - c1) / c1 * 100:+.4f}%")
    _check(abs(cn - c1) / c1 < SHARDED_BOUND,
           "sharded cost off the one-card cost by more than 0.1%")
    _check(abs(c1 - g) / g < GOLDEN_BOUND and abs(cn - g) / g < GOLDEN_BOUND,
           "cost off the golden by more than 1%")


def _phase_times(problem, path):
    import jax

    from tpu_ba.bench.phases import device_phase_ms
    from tpu_ba.solver.pairs import build_pair_plan

    pairs = build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                            problem.cameras.shape[0], problem.points.shape[0],
                            symmetric=True)
    out = device_phase_ms(problem, pairs)
    for k, v in out["ms"].items():
        print(f"[phase-times] {k}: {v:.4f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"device": jax.devices()[0].device_kind, **out}, fh,
                  indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--multichip", action="store_true",
                      help="sharded solve over all cards vs one card only")
    mode.add_argument("--phase-times", metavar="JSON",
                      help="per-phase device times of one LM iteration only")
    args = ap.parse_args()

    # the f64 reference of phase (d) runs on JAX's CPU backend
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX's default backend is {backend!r}, not a GPU",
              file=sys.stderr)
        return 1

    import numpy as np

    import tpu_ba
    from tpu_ba.bench.device import device_record
    from tpu_ba.io.bal import make_bal_like_problem
    from tpu_ba.utils import enable_compilation_cache

    enable_compilation_cache()
    dev = device_record()
    print(f"nvidia-smi: {dev['nvidia_smi']}")
    print(f"jax {jax.__version__}, tpu_ba {tpu_ba.__version__}: "
          f"{dev['platform']} {dev['kind']} x{dev['count']}; matmul "
          f"precision {jax.config.jax_default_matmul_precision}")

    golden = _golden()
    t0 = time.perf_counter()
    problem, _ = make_bal_like_problem(PROBLEM, dtype=np.float32)
    print(f"[setup] {PROBLEM}: C={problem.n_cameras} P={problem.n_points} "
          f"O={problem.n_obs} generated in {time.perf_counter() - t0:.1f} s")

    if args.multichip:
        _multichip(problem, golden)
    elif args.phase_times:
        _phase_times(problem, args.phase_times)
    else:
        _solve_phase(problem, golden)
        _phase_compare(problem)

    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
