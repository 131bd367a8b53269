"""chip_smoke.py refuses to report a result without a GPU; its comparison
helpers, on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import jax

REPO = Path(__file__).resolve().parents[1]


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env, timeout=300, capture_output=True, text=True
    )
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
        assert not (isinstance(last, dict) and last.get("ok") is True)
    assert "no GPU" in r.stderr


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_rgb_errors_bounds_rounding_pixels_on_their_own():
    cs = _chip_smoke()
    ref = np.zeros((1, 10, 10, 3))
    determined = np.zeros((1, 10, 10), bool)
    determined[:, :5] = True
    got = ref.copy()
    got[0, 5, :2] = 5.0 / 255  # 2 of 50 rounding-floor pixels off by > 4/255
    assert cs.rgb_errors(got, ref, determined)["ok"]
    got[0, 5:, :] = 5.0 / 255  # all of them
    e = cs.rgb_errors(got, ref, determined)
    assert e["share_over_4_255"] == 0.0
    assert e["share_over_4_255_rounding_px"] == 1.0
    assert not e["ok"]


def test_step_with_height_map_leaves_the_step_unchanged():
    from tacex_tpu import envs

    cs = _chip_smoke()
    env = envs.make(cs.FLAGSHIP, num_envs=2)
    state, _ = env.reset_all(env.init_state(jax.random.PRNGKey(0)))
    action = cs.flagship_actions(2, 1, env.cfg.action_space)[0]
    (_, obs, reward, *_), height_map = jax.jit(lambda s, a: cs.step_with_height_map(env, s, a))(state, action)
    _, obs_ref, reward_ref, *_ = jax.jit(env.step)(state, action)
    assert "update" not in vars(env.sensor)
    w, h = env.cfg.camera_resolution
    assert height_map.shape == (2, h, w)
    np.testing.assert_array_equal(np.asarray(obs["vision_obs"]), np.asarray(obs_ref["vision_obs"]))
    np.testing.assert_array_equal(np.asarray(reward), np.asarray(reward_ref))
