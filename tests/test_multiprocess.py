"""Multi-host code path exercised as 2 local processes (SURVEY.md §4.5):
``jax.distributed.initialize`` + a global mesh spanning both processes.

Invariant: the 2-process × 4-device solve equals the 1-process × 8-device
solve up to cross-process reduction order.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import json, sys
    import jax
    jax.config.update("jax_enable_x64", True)
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize("localhost:" + port, nproc, pid)
    import numpy as np
    sys.path.insert(0, "@REPO@")
    from tpu_ba.core import LMConfig
    from tpu_ba.io.synthetic import make_synthetic_problem
    from tpu_ba.sharding import make_mesh, shard_problem, solve_sharded

    problem, gt = make_synthetic_problem(
        12, 120, obs_per_point=5, pixel_noise=0.5, seed=0,
        dtype=np.float64, pad_multiple=128)
    mesh = make_mesh()
    cfg = LMConfig(max_iters=8, cg_max_iters=200, cg_tol=1e-12)
    res = solve_sharded(shard_problem(problem, mesh), cfg, mesh)
    print("RESULT " + json.dumps({
        "pid": pid, "ndev": len(jax.devices()),
        "local": len(jax.local_devices()), "cost": float(res.cost),
        "iters": int(res.iterations)}), flush=True)
""").replace("@REPO@", REPO)


@pytest.mark.slow
def test_two_process_distributed_solve(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = {**os.environ,
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    port = "12355"
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2", port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=REPO)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        assert p.returncode == 0, out[-3000:]
        outs.append(out)
    results = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                results.append(json.loads(line[7:]))
    assert len(results) == 2, outs
    assert all(r["ndev"] == 8 and r["local"] == 4 for r in results), results
    # both processes agree bit-for-bit (replicated output)
    assert results[0]["cost"] == results[1]["cost"]
    assert results[0]["iters"] == results[1]["iters"]

    # equals the single-process 8-device solve up to reduction order
    single = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(f"""
            import sys
            sys.path.insert(0, {REPO!r})
            import jax
            jax.config.update("jax_enable_x64", True)
            import numpy as np
            from tpu_ba.core import LMConfig
            from tpu_ba.io.synthetic import make_synthetic_problem
            from tpu_ba.sharding import make_mesh, shard_problem, solve_sharded
            problem, gt = make_synthetic_problem(
                12, 120, obs_per_point=5, pixel_noise=0.5, seed=0,
                dtype=np.float64, pad_multiple=128)
            mesh = make_mesh()
            cfg = LMConfig(max_iters=8, cg_max_iters=200, cg_tol=1e-12)
            res = solve_sharded(shard_problem(problem, mesh), cfg, mesh)
            print("COST", float(res.cost))
        """)],
        capture_output=True, text=True, timeout=280, cwd=REPO,
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    assert single.returncode == 0, single.stderr[-2000:]
    cost1 = float([l for l in single.stdout.splitlines()
                   if l.startswith("COST")][0].split()[1])
    np.testing.assert_allclose(results[0]["cost"], cost1, rtol=1e-6)
