"""In-suite coverage of the driver's multi-chip gate.

Runs the exact `__graft_entry__.dryrun_multichip` path — `shard_env_tree` of
the full PPO train state over an 8-device ("env",) mesh, then one jitted
train step — on the 8-virtual-device CPU platform that conftest.py forces,
and asserts the sharded run produces the same metrics as a replicated
single-device run (data-parallel correctness, SURVEY §2.6: psum gradient
reduction must be a pure layout change).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tacex_tpu import envs
from tacex_tpu.parallel import env_mesh, shard_env_tree
from tacex_tpu.rl import PPO, PPOConfig


N_DEV = 8


@pytest.fixture(scope="module")
def _eight_devices():
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"needs {N_DEV} devices, have {len(jax.devices())}")


def _make_ppo(num_envs):
    env = envs.make("TacEx-Ball-Rolling-Taxim-Fots-v0", num_envs=num_envs)
    ppo = PPO(env, PPOConfig(rollouts=2, mini_batches=2, learning_epochs=1, hidden=(16,)))
    return ppo


class TestMultichipPPO:
    def test_dryrun_path_on_8_device_mesh(self, _eight_devices):
        num_envs = 2 * N_DEV
        ppo = _make_ppo(num_envs)
        mesh = env_mesh(N_DEV)
        ts = shard_env_tree(ppo.init(jax.random.PRNGKey(0)), mesh, num_envs)
        new_ts, metrics = jax.jit(ppo.train_step)(ts)
        jax.block_until_ready(metrics)
        assert bool(jnp.isfinite(metrics["loss"]))
        assert int(new_ts.steps) == 2 * num_envs

    def test_sharded_matches_replicated(self, _eight_devices):
        """Same seed, same step: metrics must agree whether the env axis is
        sharded over 8 devices or replicated on one."""
        num_envs = 2 * N_DEV
        mesh = env_mesh(N_DEV)

        ppo = _make_ppo(num_envs)
        ts_sharded = shard_env_tree(ppo.init(jax.random.PRNGKey(0)), mesh, num_envs)
        _, m_sharded = jax.jit(ppo.train_step)(ts_sharded)

        ppo2 = _make_ppo(num_envs)
        ts_rep = ppo2.init(jax.random.PRNGKey(0))
        _, m_rep = jax.jit(ppo2.train_step)(ts_rep)

        # Gradient reduction order differs across layouts (psum tree vs a
        # single-device sum), so allow float-reassociation noise only.
        for k in ("loss", "reward_per_step"):
            np.testing.assert_allclose(
                np.asarray(m_sharded[k]), np.asarray(m_rep[k]), rtol=5e-3, atol=1e-4
            )

    def test_env_state_leaves_actually_sharded(self, _eight_devices):
        num_envs = 2 * N_DEV
        ppo = _make_ppo(num_envs)
        mesh = env_mesh(N_DEV)
        ts = shard_env_tree(ppo.init(jax.random.PRNGKey(0)), mesh, num_envs)
        env_sharding = NamedSharding(mesh, P("env"))
        n_sharded = sum(
            1
            for leaf in jax.tree_util.tree_leaves(ts)
            if hasattr(leaf, "sharding")
            and leaf.ndim >= 1
            and leaf.shape[0] == num_envs
            and leaf.sharding == env_sharding
        )
        assert n_sharded > 0, "no leaf ended up sharded over the env axis"

    def test_train_script_shard_runs_several_iterations(self, _eight_devices):
        """scripts/train.py --shard feeds each iteration the state the last
        one returned, with the shardings GSPMD chose for it."""
        import importlib.util
        from pathlib import Path

        path = Path(__file__).resolve().parents[1] / "scripts" / "train.py"
        spec = importlib.util.spec_from_file_location("tacex_train_script", path)
        train = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(train)
        num_envs = 2 * N_DEV
        args = train.build_parser().parse_args([
            "--num_envs", str(num_envs), "--iterations", "3", "--rollouts", "2", "--shard",
            "--agent_cfg", "mini_batches=2", "--agent_cfg", "learning_epochs=1", "--agent_cfg", "hidden=(16,)",
        ])
        ts, log = train.run(args)
        assert int(ts.steps) == 3 * 2 * num_envs
        assert all(np.isfinite(line["loss"]) for line in log["iters"])
        leaf = jax.tree_util.tree_leaves(ts.env_state)[0]
        assert leaf.shape[0] == num_envs
        assert len({s.device for s in leaf.addressable_shards}) == N_DEV

    def test_graft_entry_dryrun(self, _eight_devices):
        """The literal driver entry point, in-process (platform already CPU)."""
        import __graft_entry__ as g

        g.dryrun_multichip(N_DEV)


class TestMultichipCoupledWorld:
    def test_grasp_lift_sharded_matches_replicated(self, _eight_devices):
        """The round-3/4 headline capability — the coupled FEM+ABD Newton
        solve — stepped with the env axis sharded over an 8-device mesh must
        reproduce the replicated run exactly: each env's solve is local (the
        one-hot gather operators are step constants shared across envs, so
        they replicate), and no cross-env collective may alter the physics.
        This is the multi-chip story for the env family the reference can't
        batch at all (libuipc gelpads are --num_envs=1)."""
        num_envs = N_DEV
        env = envs.make(
            "TacEx-Grasp-Lift-Uipc-v0", num_envs=num_envs, newton_iters=2, cg_iters=8
        )
        mesh = env_mesh(N_DEV)
        actions = jnp.tile(jnp.array([[1.0, 0.2]]), (num_envs, 1))

        def run(shard: bool):
            st = env.init_state(jax.random.PRNGKey(0))
            st, obs = env.reset_all(st)
            if shard:
                st = shard_env_tree(st, mesh, num_envs)
            step = jax.jit(env.step)
            for _ in range(2):
                st, obs, rew, term, trunc, info = step(st, actions)
            return np.asarray(obs["proprio_obs"]), np.asarray(rew)

        obs_r, rew_r = run(shard=False)
        obs_s, rew_s = run(shard=True)
        # the sharded layout re-tiles the one-hot gather matmuls, so f32
        # reassociation noise (~1e-5 abs, measured) walks through the
        # iterative Newton/CG solve — same reason the flagship sharded test
        # above allows 5e-3 on metrics; anything beyond noise (a wrong
        # collective, cross-env mixing) shows up orders of magnitude larger
        np.testing.assert_allclose(obs_s, obs_r, rtol=1e-3, atol=2e-5)
        np.testing.assert_allclose(rew_s, rew_r, rtol=1e-3, atol=2e-5)
        assert np.isfinite(obs_s).all()
