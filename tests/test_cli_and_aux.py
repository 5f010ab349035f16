"""CLI, checkpoint, metrics, and BAL round-trip tests."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ,
       "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
       "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _run(args):
    out = subprocess.run([sys.executable, "-m", "tpu_ba.cli"] + args,
                         capture_output=True, text=True, cwd=REPO, env=ENV,
                         timeout=500)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_ba_synthetic(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    ckpt = tmp_path / "ckpt"
    rec = _run(["ba", "--problem", "synthetic", "--max-iters", "10",
                "--metrics", str(metrics), "--checkpoint", str(ckpt)])
    assert rec["final_cost"] < rec["initial_cost"]
    lines = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert lines and lines[-1]["event"] == "lm_solve"
    # checkpoint round-trip
    from tpu_ba.checkpoint import load_checkpoint

    state = load_checkpoint(str(ckpt))
    assert state["cameras"].shape == (20, 9)
    assert state["cost"] == rec["final_cost"]


def test_cli_posegraph():
    rec = _run(["posegraph", "--nodes", "12", "--max-iters", "10"])
    assert rec["final_cost"] < rec["initial_cost"]


def test_bal_file_roundtrip(tmp_path):
    from tpu_ba.io.bal import load_bal, save_bal
    from tpu_ba.io.synthetic import make_synthetic_problem

    problem, _ = make_synthetic_problem(5, 40, obs_per_point=3, pad_multiple=8,
                                        dtype=np.float64)
    path = tmp_path / "prob.txt"
    save_bal(str(path), problem)
    loaded = load_bal(str(path), dtype=np.float64, pad_multiple=8)
    np.testing.assert_allclose(np.asarray(loaded.cameras),
                               np.asarray(problem.cameras), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(loaded.points),
                               np.asarray(problem.points), rtol=1e-12)
    n = problem.n_obs
    np.testing.assert_allclose(np.asarray(loaded.obs_2d[:n]),
                               np.asarray(problem.obs_2d[:n]), rtol=1e-12)
    assert np.array_equal(np.asarray(loaded.cam_idx[:n]),
                          np.asarray(problem.cam_idx[:n]))


def test_checkpoint_resume_continuity(tmp_path):
    """Solving 2N iters == solve N, checkpoint, resume, solve N (same path
    modulo the lambda restart)."""
    import dataclasses

    import jax.numpy as jnp

    from tpu_ba.checkpoint import load_checkpoint, save_checkpoint
    from tpu_ba.core import LMConfig
    from tpu_ba.io.synthetic import make_synthetic_problem
    from tpu_ba.solver.lm import solve

    problem, _ = make_synthetic_problem(8, 60, obs_per_point=4,
                                        dtype=np.float64, pad_multiple=32)
    cfg = LMConfig(max_iters=5)
    res1 = solve(problem, cfg)
    save_checkpoint(str(tmp_path / "c"), cameras=res1.cameras,
                    points=res1.points, lam=res1.lam,
                    iteration=int(res1.iterations), cost=float(res1.cost))
    state = load_checkpoint(str(tmp_path / "c"))
    problem2 = dataclasses.replace(
        problem, cameras=jnp.asarray(state["cameras"]),
        points=jnp.asarray(state["points"]))
    cfg2 = dataclasses.replace(cfg, init_lambda=state["lam"])
    res2 = solve(problem2, cfg2)
    assert float(res2.cost) <= float(res1.cost) * (1 + 1e-12)


def test_sequence_readers(tmp_path):
    """TUM and KITTI readers parse the real on-disk formats."""
    from PIL import Image

    from tpu_ba.io.sequences import read_kitti_sequence, read_tum_sequence

    # fabricate a tiny TUM dir
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = ["# comment"]
    for i in range(3):
        img = Image.fromarray((rng.random((32, 40)) * 255).astype(np.uint8))
        img.save(tum / "rgb" / f"{i}.png")
        lines.append(f"{i}.0 rgb/{i}.png")
    (tum / "rgb.txt").write_text("\n".join(lines))
    (tum / "groundtruth.txt").write_text(
        "# gt\n" + "\n".join(f"{i}.0 0 0 0 0 0 0 1" for i in range(3)))
    frames, gt = read_tum_sequence(str(tum))
    assert frames.shape == (3, 32, 40)
    assert gt["trajectory"].shape == (3, 8)

    # fabricate a tiny KITTI dir
    kitti = tmp_path / "kitti"
    (kitti / "image_0").mkdir(parents=True)
    for i in range(2):
        Image.fromarray((rng.random((24, 30)) * 255).astype(np.uint8)).save(
            kitti / "image_0" / f"{i:06d}.png")
    (kitti / "times.txt").write_text("0.0\n0.1\n")
    (kitti / "calib.txt").write_text(
        "P0: 700 0 15 0 0 700 12 0 0 0 1 0\n")
    frames, gt = read_kitti_sequence(str(kitti))
    assert frames.shape == (2, 24, 30)
    assert gt["K"][0] == 700


def test_native_bal_parser_matches_python(tmp_path):
    from tpu_ba.io.bal import load_bal, save_bal
    from tpu_ba.io.native import parse_bal_native
    from tpu_ba.io.synthetic import make_synthetic_problem

    problem, _ = make_synthetic_problem(6, 50, obs_per_point=3, pad_multiple=8,
                                        dtype=np.float64)
    path = str(tmp_path / "prob.txt")
    save_bal(path, problem)
    parsed = parse_bal_native(path)
    if parsed is None:  # no toolchain in this environment
        import pytest

        pytest.skip("native parser unavailable")
    cams, pts, obs, ci, pi = parsed
    ref = load_bal(path, dtype=np.float64, pad_multiple=8, use_native=False)
    np.testing.assert_allclose(cams, np.asarray(ref.cameras), rtol=1e-14)
    np.testing.assert_allclose(pts, np.asarray(ref.points), rtol=1e-14)
    n = ref.n_obs
    # note: ref arrays are camera-sorted; re-sort parsed identically
    order = np.argsort(ci, kind="stable")
    np.testing.assert_allclose(obs[order], np.asarray(ref.obs_2d[:n]), rtol=1e-12)
    assert np.array_equal(ci[order], np.asarray(ref.cam_idx[:n]))
    assert np.array_equal(pi[order], np.asarray(ref.pt_idx[:n]))


def test_inloop_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Kill-and-resume: a run resumed from an in-loop checkpoint lands on
    exactly the same trajectory as the uninterrupted run (SURVEY.md §5;
    VERDICT round 1, weak #8 — λ, ν, and iteration all restored)."""
    import numpy as np

    from tpu_ba.checkpoint import load_checkpoint
    from tpu_ba.core import LMConfig
    from tpu_ba.io.synthetic import make_synthetic_problem
    from tpu_ba.solver.lm import solve

    problem, _ = make_synthetic_problem(8, 120, obs_per_point=4,
                                        pixel_noise=0.5, seed=17,
                                        dtype=np.float64, pad_multiple=64)
    ckdir = str(tmp_path / "ck")
    base = dict(cg_max_iters=200, cg_tol=1e-12, linear_solver="schur_sparse")

    # uninterrupted 12-iteration run
    res_full = solve(problem, LMConfig(max_iters=12, **base))

    # "killed" run: budget cut at 6 iterations, checkpointing every 3
    # accepted iterations — the surviving dump is mid-trajectory
    solve(problem, LMConfig(max_iters=6, checkpoint_every=3,
                            checkpoint_path=ckdir, **base))
    ck = load_checkpoint(ckdir)
    assert 0 < ck["iteration"] <= 6

    # resume from the mid-trajectory state with the SAME total budget
    res_resumed = solve(problem, LMConfig(max_iters=12, **base),
                        resume_from=ckdir)
    assert int(res_resumed.iterations) == int(res_full.iterations)
    np.testing.assert_allclose(float(res_resumed.cost), float(res_full.cost),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(res_resumed.cameras),
                               np.asarray(res_full.cameras), rtol=1e-9,
                               atol=1e-12)


def test_nan_guard_reports(capfd):
    """nan_guard surfaces non-finite steps from inside the jitted loop."""
    import numpy as np

    from tpu_ba.core import LMConfig, make_problem
    from tpu_ba.solver.lm import solve

    # degenerate: all points exactly at camera center ⇒ z≈0 projections
    cams = np.zeros((2, 9)); cams[:, 6] = 100.0
    pts = np.zeros((4, 3))
    ci = np.array([0, 0, 1, 1], np.int32)
    pi = np.array([0, 1, 2, 3], np.int32)
    uv = np.ones((4, 2))
    problem = make_problem(cams, pts, uv, ci, pi, pad_multiple=8,
                           dtype=np.float64)
    cfg = LMConfig(max_iters=3, linear_solver="schur_pcg", nan_guard=True,
                   cg_max_iters=10, cg_tol=1e-3)
    res = solve(problem, cfg)
    assert np.isfinite(float(res.cost))  # guard reports; solver stays finite
