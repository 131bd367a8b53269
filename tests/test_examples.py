"""Smoke tests: every example scene runs end-to-end in a subprocess.

Counterpart of running the reference's examples/ and
examples/libuipc-samples/ scenes (each example asserts its own physics
invariants — landing, draping, friction ordering, motor walking)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

EXAMPLES = [
    "examples/falling_gel_cubes.py",
    "examples/single_uipc_attachment.py",
    "examples/grasp_lift.py",
    "examples/cloth_trampoline.py",
    "examples/libuipc_samples/hello_uipc.py",
    "examples/libuipc_samples/periodically_pressed_tetrahedron.py",
    "examples/libuipc_samples/ramp_sliding.py",
    "examples/libuipc_samples/walking_cube.py",
    "examples/libuipc_samples/wrecking_balls.py",
    "examples/libuipc_samples/bunny_cloth.py",
    "examples/libuipc_samples/floating_cube.py",
    "examples/libuipc_samples/screw_and_nut.py",
]


@pytest.mark.parametrize("script", EXAMPLES, ids=[Path(e).stem for e in EXAMPLES])
def test_example_runs(script):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, timeout=1500,
        capture_output=True, text=True,
    )
    assert r.returncode == 0, f"{script} failed:\n{r.stderr[-3000:]}"
