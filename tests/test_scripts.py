"""CLI smoke tests: train/list_envs/demos run end-to-end in subprocesses."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(args, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env=env, timeout=timeout, capture_output=True, text=True
    )


class TestCLIs:
    def test_train_ppo_one_iteration(self):
        r = _run(
            [
                "scripts/train.py",
                "--task", "TacEx-Ball-Rolling-Privileged-v0",
                "--num_envs", "8",
                "--iterations", "2",
                "--rollouts", "4",
            ]
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert '"iter": 1' in r.stdout
        assert "done:" in r.stdout

    def test_train_observability_artifacts(self, tmp_path):
        """Training writes metrics JSONL + periodic png dashboard + tactile
        frame strip under the run dir (reference DirectLiveVisualizer role,
        direct_live_visualizer.py:20-206, rendered headless)."""
        import json

        viz = tmp_path / "viz"
        r = _run(
            [
                "scripts/train.py",
                "--task", "TacEx-Ball-Rolling-Taxim-Fots-v0",
                "--num_envs", "4",
                "--iterations", "2",
                "--rollouts", "2",
                "--viz_dir", str(viz),
                "--viz_interval", "1",
            ],
            timeout=900,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        lines = (viz / "metrics.jsonl").read_text().strip().splitlines()
        assert len(lines) == 2
        rec = json.loads(lines[-1])
        assert rec["iter"] == 1 and "policy_loss" in rec or "loss" in str(rec)
        assert (viz / "metrics.png").exists()
        assert (viz / "tactile_obs_strip.png").exists()

    def test_list_envs(self):
        r = _run(["scripts/list_envs.py"], timeout=180)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "TacEx-Ball-Rolling-Taxim-Fots-v0" in r.stdout
        assert "TacEx-Factory-PegInsert-Direct-v0" in r.stdout

    def test_benchmark_harness_small(self):
        r = _run(
            [
                "scripts/benchmarking/run_ball_rolling_experiment.py",
                "--env", "rigid", "--num_envs", "4", "--steps", "6",
            ]
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert '"frames_per_sec"' in r.stdout
        assert '"in_contact_frames"' in r.stdout

    def test_benchmark_harness_split_fields(self):
        r = _run(
            [
                "scripts/benchmarking/run_ball_rolling_experiment.py",
                "--env", "uipc", "--num_envs", "2", "--steps", "4",
            ],
            timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert '"avg_physics_ms_per_step"' in r.stdout
        assert '"avg_tactile_ms_per_in_contact_step"' in r.stdout

    def test_benchmark_non_rl(self):
        r = _run(
            [
                "scripts/benchmarking/benchmark_non_rl_example.py",
                "--num_envs", "4", "--num_frames", "5",
            ],
            timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert '"per_frame_ms"' in r.stdout

    def test_follow_goal_demo(self):
        r = _run(["scripts/demos/follow_goal.py", "--steps", "40"], timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "tracking error" in r.stdout

    def test_pick_up_rigid_demo(self):
        r = _run(["scripts/demos/pick_up/pick_up_rigid.py", "--steps_per_phase", "120"], timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "ball lifted" in r.stdout

    def test_pick_up_uipc_demo(self):
        """FEM-gel grasp: two soft pads lift the ball (two-way coupling)."""
        r = _run(
            ["scripts/demos/pick_up/pick_up_uipc.py", "--steps_per_phase", "100"],
            timeout=1500,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "ball lifted" in r.stdout

    def test_mani_skill_marker_demo(self):
        r = _run(["scripts/demos/check_mani_skill_marker.py", "--steps", "4"], timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "marker displacement" in r.stdout

    def test_bench_smoke(self):
        """bench.py measures only on a GPU: on the CPU it exits non-zero
        and prints no result line."""
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["BENCH_NUM_ENVS"] = "8"
        env["BENCH_ITERS"] = "3"
        r = subprocess.run(
            [sys.executable, "bench.py"], cwd=REPO, env=env, timeout=420,
            capture_output=True, text=True,
        )
        assert r.returncode != 0
        assert not [l for l in r.stdout.splitlines() if l.startswith("{")]
        assert "no GPU" in r.stderr
