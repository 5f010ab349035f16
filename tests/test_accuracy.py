"""f32 ↔ f64 oracle parity (BASELINE.json:5 "final cost within 1%").

The committed goldens (data/goldens/*.json — scripts/golden_oracle.py) are
f64 CPU runs of this framework's own LM at the bench configuration. CI
asserts the f32 solve lands within 1% of the f64 golden on ladybug-49 (the
scale that fits CI time); the full ladybug-1723 parity is checked on the
GPU by chip_smoke.py and recorded by bench.py (bench_detail.json
"f64_parity").
"""

import json
import os

import numpy as np
import pytest

from tpu_ba.core import LMConfig
from tpu_ba.io.bal import make_bal_like_problem
from tpu_ba.solver.lm import solve

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "goldens",
                      "ladybug-49.json")


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden not committed")
@pytest.mark.parametrize("solver", ["schur_sparse", "schur_pcg"])
def test_f32_final_cost_within_1pct_of_f64_golden(solver):
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    problem, _ = make_bal_like_problem("ladybug-49", dtype=np.float32)
    cfg = LMConfig(max_iters=golden["max_iters"],
                   cg_max_iters=golden["cg_max_iters"],
                   cg_tol=golden["cg_tol"],
                   linear_solver=solver, init_lambda=1e-4)
    res = solve(problem, cfg)
    gap = abs(float(res.cost) - golden["final_cost"]) / golden["final_cost"]
    assert gap < 0.01, (float(res.cost), golden["final_cost"], gap)
