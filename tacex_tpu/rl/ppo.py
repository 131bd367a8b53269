"""PPO in pure JAX (optax): the RL layer of the framework.

Replaces the reference's skrl/rsl_rl/rl_games training stacks (reference
scripts/reinforcement_learning/skrl/train.py) with a single jitted
train-step: scan rollout over the vectorized env -> GAE -> minibatched
clipped-surrogate updates. Hyperparameters default to the reference's
skrl PPO config (agents/skrl_ppo_tactile_rgb_cfg.yaml: rollouts 64, epochs 4,
32 minibatches, gamma .99, lambda .95, lr 1e-4 with KL-adaptive schedule,
ratio/value clip 0.2, grad clip 1.0, running value standardization).

Multi-chip: the whole train step is data-parallel over the env axis — run it
under jit with env-sharded state (parallel/mesh.py) and XLA inserts the psum
for the gradient all-reduce; no explicit collectives needed (SURVEY §2.6).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from ..core.config import configclass
from .networks import ActorCritic, gaussian_entropy, gaussian_log_prob


@configclass
class PPOConfig:
    rollouts: int = 64
    learning_epochs: int = 4
    mini_batches: int = 32
    discount_factor: float = 0.99
    lam: float = 0.95
    learning_rate: float = 1e-4
    kl_threshold: float = 0.008  # KLAdaptiveLR target
    lr_min: float = 1e-6
    lr_max: float = 1e-2
    grad_norm_clip: float = 1.0
    ratio_clip: float = 0.2
    value_clip: float = 0.2
    clip_predicted_values: bool = True
    entropy_loss_scale: float = 0.0
    value_loss_scale: float = 1.0
    value_preprocessor: bool = False
    """Standardize value targets with a running scaler (skrl's
    RunningStandardScaler). Off by default: bootstrapping GAE from unscaled
    network values while the scaler's variance is itself driven by those
    bootstrapped returns forms a positive feedback loop that can run away
    under early done-storms; raw-return critics are stable on the ball-rolling
    task family (rewards O(0.1-1)). Turn it ON for tasks with large returns:
    grasp-lift earns ~13/step over ~200 steps (returns ~1.2k), where the raw
    critic's MSE (~5e4) monopolizes the global-norm-clipped gradient through
    the shared trunk and training collapses/re-converges (measured,
    logs/grasp_lift_ppo_r04 + BASELINE.md) — the scaler keeps it O(1)."""
    hidden: tuple = (256, 128, 64)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RunningScaler:
    """RunningStandardScaler (skrl) for value targets."""

    mean: jax.Array
    var: jax.Array
    count: jax.Array

    @staticmethod
    def init() -> "RunningScaler":
        return RunningScaler(jnp.zeros(()), jnp.ones(()), jnp.full((), 1e-4))

    def update(self, x: jax.Array) -> "RunningScaler":
        bm, bv, bc = x.mean(), x.var(), x.size
        delta = bm - self.mean
        tot = self.count + bc
        new_mean = self.mean + delta * bc / tot
        m_a = self.var * self.count
        m_b = bv * bc
        new_var = (m_a + m_b + delta**2 * self.count * bc / tot) / tot
        return RunningScaler(new_mean, new_var, tot)

    def scale(self, x: jax.Array) -> jax.Array:
        # variance floor: early in training (reward-sparse done storms) the
        # running variance can collapse, exploding scaled targets and the
        # value loss, which drives the KL-adaptive LR to its minimum
        return (x - self.mean) * jax.lax.rsqrt(jnp.maximum(self.var, 1e-4))

    def unscale(self, x: jax.Array) -> jax.Array:
        return x * jnp.sqrt(jnp.maximum(self.var, 1e-4)) + self.mean


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    env_state: Any
    obs: Any  # last observation (carried across rollouts)
    lr: jax.Array
    value_scaler: RunningScaler
    key: jax.Array
    steps: jax.Array  # total env steps


class PPO:
    """PPO trainer bound to a DirectRLEnv."""

    def __init__(self, env, cfg: PPOConfig | None = None):
        self.env = env
        self.cfg = cfg or PPOConfig()
        self.net = ActorCritic(action_dim=env.cfg.action_space, hidden=tuple(self.cfg.hidden))
        # lr is applied manually in the update loop (KL-adaptive); note that
        # optax.scale_by_learning_rate would ALSO negate — composing it with a
        # manual -lr scaling silently turns descent into ascent.
        self.tx = optax.chain(
            optax.clip_by_global_norm(self.cfg.grad_norm_clip),
            optax.scale_by_adam(),
        )

    # ------------------------------------------------------------------ setup
    def init(self, key: jax.Array) -> TrainState:
        k_env, k_net, k_loop = jax.random.split(key, 3)
        env_state = self.env.init_state(k_env)
        env_state, obs = self.env.reset_all(env_state)
        params = self.net.init(k_net, obs)
        return TrainState(
            params=params,
            opt_state=self.tx.init(params),
            env_state=env_state,
            obs=obs,
            lr=jnp.asarray(self.cfg.learning_rate),
            value_scaler=RunningScaler.init(),
            key=k_loop,
            steps=jnp.zeros((), jnp.int32),
        )

    # ---------------------------------------------------------------- rollout
    def _rollout(self, ts: TrainState):
        c = self.cfg

        def body(carry, _):
            env_state, obs, key = carry
            key, k_act = jax.random.split(key)
            mean, log_std, value = self.net.apply(ts.params, obs)
            action = mean + jnp.exp(log_std) * jax.random.normal(k_act, mean.shape)
            logp = gaussian_log_prob(mean, log_std, action)
            env_state, next_obs, reward, term, trunc, info = self.env.step(env_state, action)
            done = (term | trunc).astype(jnp.float32)
            # surface the env's episode metrics (extras["log"], the reference
            # convention, ball_rolling_taxim_fots.py:706-708) — scalars only
            log = info.get("log", {}) if isinstance(info, dict) else {}
            out = (obs, action, logp, value, reward, done, log)
            return (env_state, next_obs, key), out

        key, k0 = jax.random.split(ts.key)
        (env_state, last_obs, _), traj = jax.lax.scan(
            body, (ts.env_state, ts.obs, k0), None, length=c.rollouts
        )
        _, _, last_value = self.net.apply(ts.params, last_obs)
        ts = dataclasses.replace(ts, env_state=env_state, obs=last_obs, key=key)
        return ts, traj, last_value

    # -------------------------------------------------------------------- gae
    def _gae(self, ts: TrainState, values, rewards, dones, last_value):
        c = self.cfg
        sc = ts.value_scaler
        if c.value_preprocessor:
            values_un = sc.unscale(values)
            last_un = sc.unscale(last_value)
        else:
            values_un, last_un = values, last_value

        def body(carry, xs):
            adv_next, v_next = carry
            v, r, d = xs
            nonterm = 1.0 - d
            delta = r + c.discount_factor * v_next * nonterm - v
            adv = delta + c.discount_factor * c.lam * nonterm * adv_next
            return (adv, v), adv

        (_, _), advs = jax.lax.scan(
            body,
            (jnp.zeros_like(last_un), last_un),
            (values_un, rewards, dones),
            reverse=True,
        )
        returns = advs + values_un
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)
        return advs, returns

    # ------------------------------------------------------------------- loss
    def _loss(self, params, obs, action, old_logp, old_value, adv, ret_scaled):
        c = self.cfg
        mean, log_std, value = self.net.apply(params, obs)
        logp = gaussian_log_prob(mean, log_std, action)
        ratio = jnp.exp(logp - old_logp)
        surr = jnp.minimum(
            ratio * adv, jnp.clip(ratio, 1 - c.ratio_clip, 1 + c.ratio_clip) * adv
        )
        policy_loss = -surr.mean()

        if c.clip_predicted_values:
            # PPO2 max-of-clipped/unclipped: plain clipping (skrl-style) kills
            # the value gradient once |target - old| > clip, and with a shared
            # trunk the policy gradient then drifts the value head unboundedly
            v_clipped = old_value + jnp.clip(value - old_value, -c.value_clip, c.value_clip)
            value_loss = c.value_loss_scale * jnp.maximum(
                (ret_scaled - value) ** 2, (ret_scaled - v_clipped) ** 2
            ).mean()
        else:
            value_loss = c.value_loss_scale * ((ret_scaled - value) ** 2).mean()

        entropy = gaussian_entropy(log_std).mean()
        kl = ((logp - old_logp) ** 2).mean() * 0.5  # approx-KL (skrl style)
        loss = policy_loss + value_loss - c.entropy_loss_scale * entropy
        return loss, (policy_loss, value_loss, entropy, kl)

    # ------------------------------------------------------------- train step
    def train_step(self, ts: TrainState):
        """One PPO iteration: rollout + epochs x minibatch updates. Jittable."""
        c = self.cfg
        n = self.env.cfg.num_envs
        ts, traj, last_value = self._rollout(ts)
        obs, action, logp, value, reward, done, env_log = traj  # leaves: (T, N, ...)

        adv, returns = self._gae(ts, value, reward, done, last_value)
        if c.value_preprocessor:
            value_scaler = ts.value_scaler.update(returns)
            ret_scaled = value_scaler.scale(returns)
        else:
            value_scaler = ts.value_scaler
            ret_scaled = returns

        total = c.rollouts * n
        flat = jax.tree_util.tree_map(lambda x: x.reshape((total,) + x.shape[2:]), (obs, action, logp, value, adv, ret_scaled))

        # tiny smoke runs (few envs x short rollouts) can undercut the tuned
        # minibatch count — clamp so every minibatch has at least one sample
        n_mb = min(c.mini_batches, total)
        mb_size = total // n_mb

        def epoch_body(carry, _):
            params, opt_state, lr, key = carry
            key, k_perm = jax.random.split(key)
            perm = jax.random.permutation(k_perm, total)

            def mb_body(carry, mb_idx):
                params, opt_state, lr, kl_sum = carry
                idx = jax.lax.dynamic_slice_in_dim(perm, mb_idx * mb_size, mb_size)
                mb = jax.tree_util.tree_map(lambda x: x[idx], flat)
                (loss, (pl, vl, ent, kl)), grads = jax.value_and_grad(self._loss, has_aux=True)(
                    params, *mb
                )
                updates, opt_state = self.tx.update(grads, opt_state, params)
                updates = jax.tree_util.tree_map(lambda u: -lr * u, updates)
                params = optax.apply_updates(params, updates)
                return (params, opt_state, lr, kl_sum + kl), loss

            (params, opt_state, lr, kl_sum), losses = jax.lax.scan(
                mb_body, (params, opt_state, lr, 0.0), jnp.arange(n_mb)
            )
            # KL-adaptive LR (skrl KLAdaptiveLR)
            mean_kl = kl_sum / n_mb
            lr = jnp.where(mean_kl > c.kl_threshold * 2.0, jnp.maximum(lr / 1.5, c.lr_min), lr)
            lr = jnp.where(mean_kl < c.kl_threshold * 0.5, jnp.minimum(lr * 1.5, c.lr_max), lr)
            return (params, opt_state, lr, key), losses.mean()

        key, k_epochs = jax.random.split(ts.key)
        (params, opt_state, lr, _), epoch_losses = jax.lax.scan(
            epoch_body, (ts.params, ts.opt_state, ts.lr, k_epochs), None, length=c.learning_epochs
        )

        metrics = {
            "loss": epoch_losses.mean(),
            "reward_per_step": reward.mean(),
            "episode_done_frac": done.mean(),
            "lr": lr,
            "value_pred_mean": value.mean(),
            # per-env episode metrics averaged over the rollout window
            **{k: v.mean() for k, v in env_log.items()},
        }
        ts = TrainState(
            params=params,
            opt_state=opt_state,
            env_state=ts.env_state,
            obs=ts.obs,
            lr=lr,
            value_scaler=value_scaler,
            key=key,
            steps=ts.steps + c.rollouts * n,
        )
        return ts, metrics

    # ------------------------------------------------------------------ jit
    def jit_train_step(self):
        return jax.jit(self.train_step)

    def act(self, params, obs, deterministic: bool = True, key: jax.Array | None = None):
        mean, log_std, _ = self.net.apply(params, obs)
        if deterministic or key is None:
            return mean
        return mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape)
