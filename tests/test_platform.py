"""What the GPU bring-up changed around the solver: removed solver strings,
the compile-cache location, the checkpoint format, and the chip smoke
script's refusal to run without a GPU. The ``gpu``-marked test runs only
where JAX finds an NVIDIA GPU."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tpu_ba.core import LMConfig
from tpu_ba.io.synthetic import make_synthetic_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("name", ["schur_pcg_pallas", "schur_dense_pallas",
                                  "schur_sparse_pallas"])
def test_removed_pallas_solvers_raise(name):
    from tpu_ba.sharding import solve_sharded
    from tpu_ba.solver.lm import solve

    problem, _ = make_synthetic_problem(4, 20, obs_per_point=3, seed=0,
                                        dtype=np.float64, pad_multiple=8)
    cfg = LMConfig(max_iters=1, linear_solver=name)
    with pytest.raises(ValueError, match="unknown linear_solver"):
        solve(problem, cfg)
    with pytest.raises(ValueError, match="unknown linear_solver"):
        solve_sharded(problem, cfg)


_CACHE_PROBE = textwrap.dedent("""
    import json, os
    import jax
    from tpu_ba.utils import enable_compilation_cache
    path = enable_compilation_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.jit(lambda x: x * 2 + 1)(jax.numpy.arange(3.0)).block_until_ready()
    print(json.dumps({"returned": path,
                      "config": jax.config.jax_compilation_cache_dir}))
""")


def _probe(env):
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_honours_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache lands there and the code
    sets no other directory."""
    d = tmp_path / "xla_cache"
    rec = _probe(_env(JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(d)))
    assert rec["returned"] == str(d) and rec["config"] == str(d)
    assert any(d.iterdir()), "no cache entry written"


def test_compile_cache_defaults_to_checkout(tmp_path):
    """Unset: the fixed, gitignored <checkout>/.jax_cache."""
    from tpu_ba.utils.cache import DEFAULT_CACHE_DIR

    rec = _probe(_env(JAX_PLATFORMS="cpu"))
    assert rec["returned"] == rec["config"] == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_checkpoint_is_atomic_npz(tmp_path):
    from tpu_ba.checkpoint import load_checkpoint, save_checkpoint

    rng = np.random.default_rng(0)
    cams, pts = rng.standard_normal((5, 9)), rng.standard_normal((7, 3))
    ws = rng.standard_normal((5, 9))
    for it in (3, 4):                       # overwrite in place
        save_checkpoint(str(tmp_path), cameras=cams * it, points=pts, lam=0.5,
                        iteration=it, cost=1.25, extra={"warm_dxc": ws,
                                                        "nu": 4.0})
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "state.npz"]
    with np.load(tmp_path / "state.npz", allow_pickle=False) as z:
        assert set(z.files) == {"cameras", "points", "extra.warm_dxc"}
    ck = load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(ck["cameras"], cams * 4)
    np.testing.assert_array_equal(ck["points"], pts)
    np.testing.assert_array_equal(ck["extra_tensors"]["warm_dxc"], ws)
    assert (ck["iteration"], ck["lam"], ck["cost"], ck["extra.nu"]) == \
        (4, 0.5, 1.25, 4.0)


def test_chip_smoke_refuses_cpu():
    """No GPU: non-zero exit and no result line."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                         text=True, timeout=240, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def gpu_env():
    """Environment of a child process that sees the GPU; skips without one.
    Decided here, at run time: the test process itself is pinned to the
    CPU by conftest."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    env = _env()
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=240)
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("JAX finds no GPU")
    return env


@pytest.mark.gpu
def test_gpu_phases_match_cpu_f64(gpu_env):
    """chip_smoke.py's phase check (d) at ladybug-49 size: linearize, S
    blocks and one PCG solve in f32 on the card vs f64 on the CPU."""
    script = textwrap.dedent("""
        import json
        import jax
        import numpy as np
        from tpu_ba.bench.phases import compare_on_devices
        from tpu_ba.io.bal import make_bal_like_problem
        from tpu_ba.solver.pairs import build_pair_plan
        p, _ = make_bal_like_problem("ladybug-49", dtype=np.float32)
        pairs = build_pair_plan(p.cam_idx, p.pt_idx, p.n_obs,
                                p.cameras.shape[0], p.points.shape[0],
                                symmetric=True)
        e = compare_on_devices(p, pairs, jax.devices()[0],
                               jax.devices("cpu")[0])
        print(json.dumps(e))
    """)
    env = dict(gpu_env, JAX_PLATFORMS="cuda,cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    errs = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(errs["cg_ok"])
    assert max(v for v in errs.values() if isinstance(v, float)) < 1e-3
