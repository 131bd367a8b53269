"""Soft Actor-Critic in pure JAX — the off-policy trainer.

Counterpart of the reference's skrl SAC configs
(reference scripts/reinforcement_learning/skrl/train.py --algorithm SAC and
agents/skrl_sac_*.yaml): twin Q critics, tanh-squashed gaussian policy,
automatic entropy temperature, on-device uniform replay buffer. The whole
update (env steps + gradient steps) is one jitted program over the
vectorized env; the replay buffer is a fixed-size device ring buffer.

Designed for the proprio tasks (dict obs are flattened; image obs work but
inflate the buffer — prefer PPO for vision, as the reference does).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from ..core.config import configclass
from .networks import dense, dense_init


@configclass
class SACConfig:
    buffer_size: int = 100_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    init_alpha: float = 0.2
    target_entropy_scale: float = 1.0
    hidden: tuple = (256, 256)
    rollout_steps: int = 4  # env steps per train call
    grad_steps: int = 1
    warmup_steps: int = 1000


@dataclasses.dataclass(frozen=True)
class GaussianPolicy:
    """MLP -> (mean, log_std); layers Dense_0.. in creation order, as the
    checkpoints under ``logs/`` store them."""

    action_dim: int
    hidden: tuple = (256, 256)

    def init(self, key: jax.Array, x: jax.Array) -> dict:
        keys = jax.random.split(key, len(self.hidden) + 2)
        dims = (x.shape[-1],) + tuple(self.hidden)
        params = {f"Dense_{i}": dense_init(keys[i], dims[i], dims[i + 1]) for i in range(len(self.hidden))}
        n = len(self.hidden)
        params[f"Dense_{n}"] = dense_init(keys[n], dims[-1], self.action_dim)
        params[f"Dense_{n + 1}"] = dense_init(keys[n + 1], dims[-1], self.action_dim)
        return {"params": params}

    def apply(self, params: dict, x: jax.Array):
        p = params["params"]
        n = len(self.hidden)
        for i in range(n):
            x = jax.nn.relu(dense(p[f"Dense_{i}"], x))
        mean = dense(p[f"Dense_{n}"], x)
        log_std = jnp.clip(dense(p[f"Dense_{n + 1}"], x), -10.0, 2.0)
        return mean, log_std


@dataclasses.dataclass(frozen=True)
class TwinQ:
    """Two Q MLPs over concat(obs, act); layers Dense_0.. in creation
    order, the first critic's numbered before the second's."""

    hidden: tuple = (256, 256)

    def init(self, key: jax.Array, obs: jax.Array, act: jax.Array) -> dict:
        dims = (obs.shape[-1] + act.shape[-1],) + tuple(self.hidden) + (1,)
        per_q = len(dims) - 1
        keys = jax.random.split(key, 2 * per_q)
        params = {
            f"Dense_{q * per_q + i}": dense_init(keys[q * per_q + i], dims[i], dims[i + 1])
            for q in range(2)
            for i in range(per_q)
        }
        return {"params": params}

    def apply(self, params: dict, obs: jax.Array, act: jax.Array):
        p = params["params"]
        x = jnp.concatenate([obs, act], axis=-1)
        per_q = len(self.hidden) + 1
        qs = []
        for q in range(2):
            h = x
            for i in range(per_q - 1):
                h = jax.nn.relu(dense(p[f"Dense_{q * per_q + i}"], h))
            qs.append(dense(p[f"Dense_{q * per_q + per_q - 1}"], h)[..., 0])
        return qs[0], qs[1]


def _squash(mean, log_std, key):
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mean.shape)
    pre = mean + std * eps
    act = jnp.tanh(pre)
    logp = (-0.5 * (eps**2 + 2 * log_std + jnp.log(2 * jnp.pi))).sum(-1)
    logp = logp - jnp.log(jnp.clip(1 - act**2, 1e-6)).sum(-1)
    return act, logp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    obs: jax.Array
    act: jax.Array
    rew: jax.Array
    next_obs: jax.Array
    done: jax.Array
    ptr: jax.Array
    size: jax.Array

    @staticmethod
    def init(capacity: int, obs_dim: int, act_dim: int) -> "ReplayBuffer":
        return ReplayBuffer(
            obs=jnp.zeros((capacity, obs_dim)),
            act=jnp.zeros((capacity, act_dim)),
            rew=jnp.zeros((capacity,)),
            next_obs=jnp.zeros((capacity, obs_dim)),
            done=jnp.zeros((capacity,)),
            ptr=jnp.zeros((), jnp.int32),
            size=jnp.zeros((), jnp.int32),
        )

    def add_batch(self, obs, act, rew, next_obs, done) -> "ReplayBuffer":
        n = obs.shape[0]
        cap = self.obs.shape[0]
        idx = (self.ptr + jnp.arange(n)) % cap
        return ReplayBuffer(
            obs=self.obs.at[idx].set(obs),
            act=self.act.at[idx].set(act),
            rew=self.rew.at[idx].set(rew),
            next_obs=self.next_obs.at[idx].set(next_obs),
            done=self.done.at[idx].set(done),
            ptr=(self.ptr + n) % cap,
            size=jnp.minimum(self.size + n, cap),
        )

    def sample(self, key, batch_size: int):
        idx = jax.random.randint(key, (batch_size,), 0, jnp.maximum(self.size, 1))
        return (self.obs[idx], self.act[idx], self.rew[idx], self.next_obs[idx], self.done[idx])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SACTrainState:
    actor_params: Any
    critic_params: Any
    target_critic_params: Any
    log_alpha: jax.Array
    actor_opt: Any
    critic_opt: Any
    alpha_opt: Any
    buffer: ReplayBuffer
    env_state: Any
    obs_flat: jax.Array
    key: jax.Array
    steps: jax.Array


def _flatten_obs(obs: dict) -> jax.Array:
    parts = [obs[k].reshape(obs[k].shape[0], -1) for k in sorted(obs)]
    return jnp.concatenate(parts, axis=-1)


class SAC:
    def __init__(self, env, cfg: SACConfig | None = None):
        self.env = env
        self.cfg = cfg or SACConfig()
        self.act_dim = env.cfg.action_space
        self.actor = GaussianPolicy(self.act_dim, tuple(self.cfg.hidden))
        self.critic = TwinQ(tuple(self.cfg.hidden))
        self.actor_tx = optax.adam(self.cfg.actor_lr)
        self.critic_tx = optax.adam(self.cfg.critic_lr)
        self.alpha_tx = optax.adam(self.cfg.alpha_lr)
        self.target_entropy = -self.act_dim * self.cfg.target_entropy_scale

    def init(self, key: jax.Array) -> SACTrainState:
        k_env, k_a, k_c, k_loop = jax.random.split(key, 4)
        env_state = self.env.init_state(k_env)
        env_state, obs = self.env.reset_all(env_state)
        obs_flat = _flatten_obs(obs)
        obs_dim = obs_flat.shape[-1]
        actor_params = self.actor.init(k_a, obs_flat)
        critic_params = self.critic.init(k_c, obs_flat, jnp.zeros((obs_flat.shape[0], self.act_dim)))
        return SACTrainState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_critic_params=critic_params,
            log_alpha=jnp.log(jnp.asarray(self.cfg.init_alpha)),
            actor_opt=self.actor_tx.init(actor_params),
            critic_opt=self.critic_tx.init(critic_params),
            alpha_opt=self.alpha_tx.init(jnp.zeros(())),
            buffer=ReplayBuffer.init(self.cfg.buffer_size, obs_dim, self.act_dim),
            env_state=env_state,
            obs_flat=obs_flat,
            key=k_loop,
            steps=jnp.zeros((), jnp.int32),
        )

    def train_step(self, ts: SACTrainState):
        c = self.cfg
        key = ts.key

        # ---- env interaction
        def env_body(carry, _):
            env_state, obs_flat, buffer, key = carry
            key, k_act = jax.random.split(key)
            mean, log_std = self.actor.apply(ts.actor_params, obs_flat)
            act, _ = _squash(mean, log_std, k_act)
            env_state, next_obs, rew, term, trunc, _ = self.env.step(env_state, act)
            next_flat = _flatten_obs(next_obs)
            done = term.astype(jnp.float32)
            buffer = buffer.add_batch(obs_flat, act, rew, next_flat, done)
            return (env_state, next_flat, buffer, key), rew.mean()

        (env_state, obs_flat, buffer, key), rews = jax.lax.scan(
            env_body, (ts.env_state, ts.obs_flat, ts.buffer, key), None, length=c.rollout_steps
        )

        # ---- gradient updates
        def update(carry, _):
            actor_params, critic_params, target_params, log_alpha, a_opt, c_opt, al_opt, key = carry
            key, k_s, k_n, k_a = jax.random.split(key, 4)
            obs, act, rew, nobs, done = buffer.sample(k_s, c.batch_size)
            alpha = jnp.exp(log_alpha)

            nmean, nlstd = self.actor.apply(actor_params, nobs)
            nact, nlogp = _squash(nmean, nlstd, k_n)
            tq1, tq2 = self.critic.apply(target_params, nobs, nact)
            target_q = rew + c.gamma * (1 - done) * (jnp.minimum(tq1, tq2) - alpha * nlogp)

            def critic_loss(p):
                q1, q2 = self.critic.apply(p, obs, act)
                return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()

            cl, cg = jax.value_and_grad(critic_loss)(critic_params)
            cu, c_opt = self.critic_tx.update(cg, c_opt)
            critic_params = optax.apply_updates(critic_params, cu)

            def actor_loss(p):
                m, ls = self.actor.apply(p, obs)
                a, lp = _squash(m, ls, k_a)
                q1, q2 = self.critic.apply(critic_params, obs, a)
                return (alpha * lp - jnp.minimum(q1, q2)).mean(), lp

            (al, lp), ag = jax.value_and_grad(actor_loss, has_aux=True)(actor_params)
            au, a_opt = self.actor_tx.update(ag, a_opt)
            actor_params = optax.apply_updates(actor_params, au)

            def alpha_loss(la):
                return (-jnp.exp(la) * (jax.lax.stop_gradient(lp) + self.target_entropy)).mean()

            all_, alg = jax.value_and_grad(alpha_loss)(log_alpha)
            alu, al_opt = self.alpha_tx.update(alg, al_opt)
            log_alpha = optax.apply_updates(log_alpha, alu)

            target_params = jax.tree_util.tree_map(
                lambda t, p: (1 - c.tau) * t + c.tau * p, target_params, critic_params
            )
            return (
                actor_params, critic_params, target_params, log_alpha, a_opt, c_opt, al_opt, key,
            ), (cl, al)

        do_update = ts.steps + c.rollout_steps * self.env.cfg.num_envs >= c.warmup_steps
        carry0 = (
            ts.actor_params, ts.critic_params, ts.target_critic_params, ts.log_alpha,
            ts.actor_opt, ts.critic_opt, ts.alpha_opt, key,
        )

        def run_updates(carry):
            carry, losses = jax.lax.scan(update, carry, None, length=c.grad_steps)
            return carry, losses

        def skip_updates(carry):
            return carry, (jnp.zeros((c.grad_steps,)), jnp.zeros((c.grad_steps,)))

        carry, (closs, aloss) = jax.lax.cond(do_update, run_updates, skip_updates, carry0)
        (actor_params, critic_params, target_params, log_alpha, a_opt, c_opt, al_opt, key) = carry

        ts = SACTrainState(
            actor_params=actor_params, critic_params=critic_params,
            target_critic_params=target_params, log_alpha=log_alpha,
            actor_opt=a_opt, critic_opt=c_opt, alpha_opt=al_opt,
            buffer=buffer, env_state=env_state, obs_flat=obs_flat, key=key,
            steps=ts.steps + c.rollout_steps * self.env.cfg.num_envs,
        )
        metrics = {
            "reward_per_step": rews.mean(),
            "critic_loss": closs.mean(),
            "actor_loss": aloss.mean(),
            "alpha": jnp.exp(log_alpha),
        }
        return ts, metrics

    def jit_train_step(self):
        return jax.jit(self.train_step)

    def act(self, actor_params, obs: dict, deterministic: bool = True, key=None):
        flat = _flatten_obs(obs)
        mean, log_std = self.actor.apply(actor_params, flat)
        if deterministic or key is None:
            return jnp.tanh(mean)
        a, _ = _squash(mean, log_std, key)
        return a
