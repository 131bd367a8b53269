"""The policy networks: parameter layout of the committed checkpoints, and
a forward pass against a float64 numpy forward on the same parameters."""

import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tacex_tpu import envs
from tacex_tpu.rl.agents import agent_cfg_for
from tacex_tpu.rl.networks import ActorCritic
from tacex_tpu.rl.sac import GaussianPolicy

LOGS = Path(__file__).resolve().parents[1] / "logs"


def _checkpoint_tree(run: str) -> dict:
    """{key path: shape} of the newest checkpoint of a committed run: the
    paths from its ``_METADATA``, the shapes from orbax's array metadata."""
    import orbax.checkpoint as ocp

    step = max((LOGS / run / "ckpt").iterdir(), key=lambda p: int(p.name))
    meta = json.loads((step / "default" / "_METADATA").read_text())
    paths = {
        tuple(k["key"] for k in entry["key_metadata"]) for entry in meta["tree_metadata"].values()
    }
    arrays = ocp.StandardCheckpointer().metadata(step / "default").item_metadata.tree
    shapes = {
        tuple(k.key for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(arrays)[0]
    }
    assert set(shapes) == paths
    return shapes


def _tree_shapes(tree) -> dict:
    return {
        tuple(k.key for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _obs_spec(task: str, overrides: dict):
    env = envs.make(task, num_envs=2, **overrides)
    obs = jax.eval_shape(lambda k: env.reset_all(env.init_state(k))[1], jax.random.PRNGKey(0))
    return env, obs


@pytest.mark.parametrize(
    "run", ["grasp_lift_ppo_r05", "grasp_lift_tactile_ppo_r05", "factory_uipc_ppo_r05", "sac_privileged_r05"]
)
def test_param_tree_matches_committed_checkpoint(run):
    cfg = json.loads((LOGS / run / "config.json").read_text())
    task, algorithm = cfg["argv"]["task"], cfg["argv"]["algorithm"]
    env, obs = _obs_spec(task, cfg["env_overrides"])
    agent = agent_cfg_for(task, algorithm)
    key = jax.random.PRNGKey(0)
    if algorithm == "sac":
        flat = jax.ShapeDtypeStruct((2, sum(int(np.prod(v.shape[1:])) for v in obs.values())), jnp.float32)
        params = jax.eval_shape(GaussianPolicy(env.cfg.action_space, tuple(agent.hidden)).init, key, flat)
    else:
        net = ActorCritic(action_dim=env.cfg.action_space, hidden=tuple(agent.hidden))
        params = jax.eval_shape(net.init, key, obs)
    assert _tree_shapes({"params": params}) == _checkpoint_tree(run)


def _np_conv(x, kernel, bias, stride):
    kh, kw = kernel.shape[:2]
    ho = (x.shape[1] - kh) // stride + 1
    wo = (x.shape[2] - kw) // stride + 1
    out = np.zeros((x.shape[0], ho, wo, kernel.shape[-1]))
    for i in range(kh):
        for j in range(kw):
            patch = x[:, i : i + stride * ho : stride, j : j + stride * wo : stride, :]
            out += np.einsum("bhwc,co->bhwo", patch, kernel[i, j])
    return out + bias


def _np_actor_critic(p, obs, hidden):
    elu = lambda v: np.where(v > 0, v, np.expm1(np.minimum(v, 0)))
    n = len(hidden)
    towers = []
    for t in range(2):
        enc = p[f"VisionEncoder_{t}"]
        x = np.maximum(_np_conv(obs["vision_obs"], enc["Conv_0"]["kernel"], enc["Conv_0"]["bias"], 2), 0)
        x = np.maximum(_np_conv(x, enc["Conv_1"]["kernel"], enc["Conv_1"]["bias"], 1), 0)
        x = np.concatenate([x.reshape(x.shape[0], -1), obs["proprio_obs"]], -1)
        for i in range(n):
            d = p[f"Dense_{t * n + i}"]
            x = elu(x @ d["kernel"] + d["bias"])
        towers.append(x)
    mean = towers[0] @ p[f"Dense_{2 * n}"]["kernel"] + p[f"Dense_{2 * n}"]["bias"]
    value = towers[1] @ p[f"Dense_{2 * n + 1}"]["kernel"] + p[f"Dense_{2 * n + 1}"]["bias"]
    return mean, value[:, 0]


def test_actor_critic_forward_matches_numpy():
    hidden = (32, 16)
    rng = np.random.default_rng(0)
    obs = {
        "vision_obs": rng.uniform(0, 1, (3, 24, 32, 3)).astype(np.float32),
        "proprio_obs": rng.normal(size=(3, 7)).astype(np.float32),
    }
    net = ActorCritic(action_dim=4, hidden=hidden, initial_log_std=-0.5)
    params = net.init(jax.random.PRNGKey(1), obs)
    # non-zero biases, so their placement is checked too
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape), params
    )
    mean, log_std, value = jax.jit(net.apply)(params, obs)
    p64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)["params"]
    obs64 = {k: v.astype(np.float64) for k, v in obs.items()}
    ref_mean, ref_value = _np_actor_critic(p64, obs64, hidden)
    np.testing.assert_allclose(np.asarray(mean), ref_mean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(value), ref_value, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(log_std), np.broadcast_to(p64["log_std"], (3, 4)), rtol=1e-6)


@pytest.mark.gpu
def test_actor_critic_forward_matches_numpy_on_gpu(gpu):
    """The flagship's network at a PPO minibatch of 4096. The policy runs at
    default precision, TF32 on the card (10 mantissa bits), as RL training
    does; the bound allows that rounding through seven layers."""
    hidden = (256, 128, 64)
    rng = np.random.default_rng(0)
    obs = {
        "vision_obs": rng.uniform(0, 1, (4096, 24, 32, 3)).astype(np.float32),
        "proprio_obs": rng.normal(size=(4096, 11)).astype(np.float32),
    }
    net = ActorCritic(action_dim=6, hidden=hidden)
    params = net.init(jax.random.PRNGKey(1), obs)
    mean, _, value = jax.jit(net.apply)(params, obs)
    p64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)["params"]
    ref_mean, ref_value = _np_actor_critic(p64, {k: v.astype(np.float64) for k, v in obs.items()}, hidden)
    np.testing.assert_allclose(np.asarray(mean), ref_mean, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(np.asarray(value), ref_value, rtol=2e-2, atol=2e-2)
