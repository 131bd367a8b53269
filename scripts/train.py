"""Train PPO or SAC on a tacex_tpu task environment.

Replaces the reference's per-RL-library launchers
(reference scripts/reinforcement_learning/{skrl,rsl_rl,rl_games}/train.py):
no app bootstrap, no vec-env wrapper — the env and trainer are jitted JAX
programs. Multi-chip data parallelism comes from sharding the env axis
(--shard over all visible devices).

Usage:
  python scripts/train.py --task TacEx-Ball-Rolling-Taxim-Fots-v0 \
      --num_envs 1024 --iterations 200 --checkpoint_dir runs/br
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import jax

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # repo root, so scripts run from anywhere

from tacex_tpu import envs
from tacex_tpu.rl import PPO
from tacex_tpu.utils.compile_cache import enable_compile_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="TacEx-Ball-Rolling-Taxim-Fots-v0")
    p.add_argument("--algorithm", choices=["ppo", "sac"], default="ppo")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument(
        "--rollouts", type=int, default=None,
        help="override the per-task tuned rollout length (rl/agents.py)",
    )
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_interval", type=int, default=50)
    p.add_argument("--shard", action="store_true", help="shard envs over all devices")
    p.add_argument("--log_interval", type=int, default=1)
    p.add_argument("--viz_dir", default=None, help="write metric plots (LiveVisualizer)")
    p.add_argument(
        "--viz_interval", type=int, default=50,
        help="refresh the metrics png + tactile-obs frame strip every N iters",
    )
    p.add_argument(
        "--env_cfg", action="append", default=[], metavar="KEY=VALUE",
        help="env config override, e.g. --env_cfg episode_length_s=6.0 "
        "(repeatable; values parsed as Python literals — the hydra-style "
        "override surface of the reference launchers)",
    )
    p.add_argument(
        "--agent_cfg", action="append", default=[], metavar="KEY=VALUE",
        help="agent config override on top of the per-task tuned values, "
        "e.g. --agent_cfg lr_max=1e-3 (repeatable)",
    )
    return p


def _parse_kv(pairs) -> dict:
    """KEY=VALUE overrides; values parsed as Python literals where they parse."""
    import ast

    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass  # keep as string
        out[k] = v
    return out


def setup(args: argparse.Namespace):
    """Build the env, the agent and its train state as the command line
    asks, the state sharded over all devices under ``--shard``. Returns
    ``(agent_cfg, agent, train_state)``."""
    env = envs.make(args.task, num_envs=args.num_envs, **_parse_kv(args.env_cfg))
    from tacex_tpu.rl.agents import agent_cfg_for

    agent_overrides = _parse_kv(args.agent_cfg)
    if args.algorithm == "sac":
        from tacex_tpu.rl import SAC

        cfg = agent_cfg_for(args.task, "sac", rollout_steps=args.rollouts, **agent_overrides)
        agent = SAC(env, cfg)
    else:
        cfg = agent_cfg_for(args.task, "ppo", rollouts=args.rollouts, **agent_overrides)
        agent = PPO(env, cfg)
    print(f"agent cfg ({args.algorithm}): {cfg}")
    ts = agent.init(jax.random.PRNGKey(args.seed))

    if args.shard and len(jax.devices()) > 1:
        from tacex_tpu.parallel import env_mesh, shard_env_tree

        ts = shard_env_tree(ts, env_mesh(), args.num_envs)
        print(f"sharded over {len(jax.devices())} devices")
    return cfg, agent, ts


def run(args: argparse.Namespace):
    """Train as the command line asks. Returns the final train state and
    ``{"compile_s": ..., "iters": [per-iteration log lines as dicts]}``."""
    env_overrides = _parse_kv(args.env_cfg)
    cfg, ppo, ts = setup(args)

    ckpt_mgr = None
    if args.checkpoint_dir:
        import orbax.checkpoint as ocp

        path = Path(args.checkpoint_dir).absolute()
        ckpt_mgr = ocp.CheckpointManager(path, options=ocp.CheckpointManagerOptions(max_to_keep=3))

    # training observability (reference DirectLiveVisualizer role,
    # direct_live_visualizer.py:20-206, headless): metrics JSONL under the
    # run dir + periodic png dashboard and tactile-obs frame strip
    viz = None
    run_dir = args.viz_dir or args.checkpoint_dir
    metrics_fp = None
    if run_dir:
        Path(run_dir).mkdir(parents=True, exist_ok=True)
        # reproducibility record: the exact launch config of this run
        with open(Path(run_dir) / "config.json", "w") as f:
            json.dump(
                {"argv": vars(args), "env_overrides": env_overrides,
                 "agent_cfg": str(cfg)},
                f, indent=1, default=str,
            )
        metrics_fp = open(Path(run_dir) / "metrics.jsonl", "a")
    if args.viz_dir:
        from tacex_tpu.utils import LiveVisualizer

        viz = LiveVisualizer(args.viz_dir)

    def _grab_tactile_frame(obs) -> None:
        """First env's vision obs -> normalized frame for the strip."""
        import numpy as np

        v = obs.get("vision_obs") if isinstance(obs, dict) else None
        if v is None or viz is None:
            return
        f = np.asarray(jax.device_get(v[0]), dtype=float)  # (h, w, c)
        if f.shape[-1] >= 3:
            f = f[..., :3]
        else:
            f = f[..., :1].repeat(3, -1)
        lo, hi = f.min(), f.max()
        viz.add_frame("tactile_obs", (f - lo) / max(hi - lo, 1e-6))

    step_fn = ppo.jit_train_step()
    t0 = time.time()
    step_fn.lower(ts).compile()  # the jitted calls below reuse this executable
    compile_s = time.time() - t0
    print(json.dumps({"compile_s": round(compile_s, 3)}), flush=True)
    history = []
    t_start = time.time()
    for it in range(args.iterations):
        t0 = time.time()
        ts, metrics = step_fn(ts)
        metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
        dt = time.time() - t0
        if it % args.log_interval == 0:
            sps = args.num_envs * getattr(cfg, 'rollouts', getattr(cfg, 'rollout_steps', 1)) / dt
            line = {
                "iter": it,
                "env_steps": int(ts.steps),
                "steps_per_sec": round(sps, 1),
                "iter_s": dt,
                **{k: round(v, 5) for k, v in metrics.items()},
            }
            history.append(line)
            print(json.dumps(line), flush=True)
            if metrics_fp is not None:
                metrics_fp.write(json.dumps(line) + "\n")
                metrics_fp.flush()
        if viz is not None:
            viz.add_scalars(int(ts.steps), metrics)
            if (it + 1) % args.viz_interval == 0 or it + 1 == args.iterations:
                _grab_tactile_frame(getattr(ts, "obs", None))
                viz.save_plots()
                viz.save_frame_strip("tactile_obs")
        if ckpt_mgr is not None and (it + 1) % args.checkpoint_interval == 0:
            params = ts.params if hasattr(ts, "params") else ts.actor_params
            ckpt_mgr.save(it, args=__import__("orbax.checkpoint", fromlist=["args"]).args.StandardSave(
                jax.device_get({"params": params})
            ))
    if ckpt_mgr is not None:
        ckpt_mgr.wait_until_finished()
    if viz is not None:
        path = viz.save_plots()
        print(f"metric plots -> {path}")
    if metrics_fp is not None:
        metrics_fp.close()
        print(f"metrics jsonl -> {Path(run_dir) / 'metrics.jsonl'}")
    print(f"done: {int(ts.steps)} env steps in {time.time() - t_start:.1f}s")
    return ts, {"compile_s": compile_s, "iters": history}


def main() -> None:
    enable_compile_cache()
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
