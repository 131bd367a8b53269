"""Ablation profile of the coupled FEM+ABD solve (grasp-lift scene).

Question: where does the time of a coupled step go, for a ~150-vertex
system whose per-env cost grows near-linearly with the env count? This
script isolates it by sweeping solver knobs on the real env step:

  newton x cg x line-search give the per-phase split;
  contact-family knobs (self/ee/coupling) isolate candidate-set gathers,
  which re-execute inside every energy/hvp evaluation (~400 per env-step).

Usage: python scripts/benchmarking/profile_coupled.py [--envs 16]
Prints one JSON line per config.
"""

from __future__ import annotations

import argparse

import json
import sys as _sys
import time
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[2]))

import numpy as np

import jax
import jax.numpy as jnp


def time_env(env_id: str, n_envs: int, steps: int, **cfg_over) -> dict:
    from tacex_tpu import envs

    env = envs.make(env_id, num_envs=n_envs, **cfg_over)
    state = env.init_state(jax.random.PRNGKey(0))
    state, _ = env.reset_all(state)
    step = jax.jit(env.step)
    rng = np.random.default_rng(0)
    loc = np.zeros(env.cfg.action_space)
    loc[:2] = [0.6, 0.4]
    actions = jnp.asarray(
        np.clip(rng.normal(loc, 0.2, (steps + 1, n_envs, env.cfg.action_space)), -1, 1).astype(np.float32)
    )
    state = jax.block_until_ready(step(state, actions[0])[0])
    t0 = time.perf_counter()
    for i in range(steps):
        state = step(state, actions[i + 1])[0]
    jax.block_until_ready(state.cube.q)
    dt = time.perf_counter() - t0
    return {"ms_per_step": round(1e3 * dt / steps, 2), **cfg_over}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=15)
    args = ap.parse_args()
    env_id = "TacEx-Grasp-Lift-Uipc-v0"
    configs = [
        dict(),  # baseline: newton 6, cg 24, decimation 2
        dict(newton_iters=1),
        dict(newton_iters=3),
        dict(cg_iters=1),
        dict(cg_iters=8),
        dict(coupling_k=1),
        dict(coupling_k=8),
        dict(decimation=1),
    ]
    for over in configs:
        r = time_env(env_id, args.envs, args.steps, **over)
        print(json.dumps({"envs": args.envs, **r}), flush=True)


if __name__ == "__main__":
    main()
