"""Roll out a (trained or random) policy and dump tactile frames.

Counterpart of the reference's play.py launchers
(reference scripts/reinforcement_learning/skrl/play.py): runs the policy
deterministically and optionally writes tactile observation PNGs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

import jax

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # repo root, so scripts run from anywhere

from tacex_tpu import envs
from tacex_tpu.rl import PPO
from tacex_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="TacEx-Ball-Rolling-Taxim-Fots-v0")
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--save_frames", default=None, help="dir for vision-obs PNGs (env 0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--env_cfg", action="append", default=[], metavar="KEY=VALUE",
        help="env cfg override (same surface as train.py — evaluate at the "
        "training config, e.g. --env_cfg episode_length_s=10.0)",
    )
    args = p.parse_args()

    import ast

    overrides = {}
    for kv in args.env_cfg:
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        overrides[k] = v

    from tacex_tpu.rl.agents import agent_cfg_for

    # staggering first-episode phases is a TRAINING-only behavior (it
    # decorrelates resets across the batch); under evaluation it truncates
    # every env's first episode early and biases returns low (round-4
    # advice) — switch it off where the env cfg has the knob
    try:
        env = envs.make(
            args.task, num_envs=args.num_envs,
            stagger_initial_episodes=False, **overrides,
        )
    except TypeError:
        env = envs.make(args.task, num_envs=args.num_envs, **overrides)
    # the per-task tuned config (same one train.py used) so the policy
    # network matches the checkpoint being restored
    ppo = PPO(env, agent_cfg_for(args.task, "ppo"))
    ts = ppo.init(jax.random.PRNGKey(args.seed))
    params = ts.params
    if args.checkpoint_dir:
        import orbax.checkpoint as ocp

        mgr = ocp.CheckpointManager(Path(args.checkpoint_dir).absolute())
        step = mgr.latest_step()
        restored = mgr.restore(step, args=ocp.args.StandardRestore(jax.device_get({"params": params})))
        params = restored["params"]
        print(f"restored checkpoint step {step}")

    state = ts.env_state
    obs = ts.obs
    step_fn = jax.jit(env.step)
    # jit the policy forward: eager net.apply dispatches every op on its own
    act_fn = jax.jit(lambda p, o: ppo.act(p, o, deterministic=True))
    total_rew = np.zeros(args.num_envs)
    frames_dir = Path(args.save_frames) if args.save_frames else None
    if frames_dir:
        frames_dir.mkdir(parents=True, exist_ok=True)

    metric_sums: dict = {}
    for i in range(args.steps):
        action = act_fn(params, obs)
        state, obs, reward, term, trunc, info = step_fn(state, action)
        total_rew += np.asarray(reward)
        for k, v in info.get("log", {}).items():
            if k.startswith("Metric/"):
                metric_sums[k] = metric_sums.get(k, 0.0) + float(v)
        if frames_dir and "vision_obs" in obs:
            from PIL import Image

            v = np.asarray(obs["vision_obs"][0])
            if v.shape[-1] == 1:
                v = np.repeat(v, 3, -1) / max(v.max(), 1e-6)
            img = (np.kron(np.clip(v, 0, 1), np.ones((8, 8, 1))) * 255).astype(np.uint8)
            Image.fromarray(img).save(frames_dir / f"frame_{i:04d}.png")
    print(f"mean episode return over {args.steps} steps: {total_rew.mean():.2f}")
    for k, s in sorted(metric_sums.items()):
        print(f"{k} (mean over rollout): {s / args.steps:.4f}")


if __name__ == "__main__":
    main()
