"""Benchmark: flagship env steps per second on one GPU.

Steps the flagship ball-rolling task (TacEx-Ball-Rolling-Taxim-Fots-v0 — the
reference's 4096-env RL config: 32x24 camera, Taxim optical RGB x FOTS
marker composition) at 4096 environments, full env step in the loop (IK +
servo + contact physics + depth render + tactile RGB + markers +
rewards/dones/resets/obs). A frame is one environment-step producing one
tactile observation.

Prints ONE JSON line: {"metric", "value", "unit", "device", "card"}, with
the device as JAX reports it and the card's name and power limit as
nvidia-smi reports them. Exits 2, printing no result, when JAX finds no GPU.

For the sensor-only pipeline at the reference benchmark-harness resolution
(320x240), see scripts/benchmarking/run_ball_rolling_experiment.py.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

NUM_ENVS = int(os.environ.get("BENCH_NUM_ENVS", 4096))
ITERS = int(os.environ.get("BENCH_ITERS", 30))


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX's first device is {dev.platform}); nothing was measured", file=sys.stderr)
        return 2

    from tacex_tpu import envs
    from tacex_tpu.utils.compile_cache import enable_compile_cache
    from tacex_tpu.utils.profiling import gpu_card

    enable_compile_cache()
    env = envs.make("TacEx-Ball-Rolling-Taxim-Fots-v0", num_envs=NUM_ENVS)
    state = env.init_state(jax.random.PRNGKey(0))
    state, _ = env.reset_all(state)
    step = jax.jit(env.step)

    rng = np.random.default_rng(0)
    actions = jnp.asarray(
        rng.uniform(-0.3, 0.3, (ITERS + 1, NUM_ENVS, env.cfg.action_space)).astype(np.float32)
    )
    # keep gentle downward pressure so the tactile path sees real contact
    actions = actions.at[..., 2].add(-0.1)

    state, obs, *_ = step(state, actions[0])
    jax.block_until_ready(obs["vision_obs"])

    t0 = time.perf_counter()
    for i in range(ITERS):
        state, obs, reward, term, trunc, info = step(state, actions[i + 1])
    jax.block_until_ready(obs["vision_obs"])
    dt = time.perf_counter() - t0

    print(
        json.dumps(
            {
                "metric": f"tactile_env_steps_per_sec_rgb_markers_{NUM_ENVS}envs",
                "value": NUM_ENVS * ITERS / dt,
                "unit": "frames/s",
                "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
                "card": gpu_card(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
