"""Direct-RL-style environment base: pure-functional vectorized envs.

Batched JAX counterpart of Isaac Lab's ``DirectRLEnv`` /
``UipcRLEnv`` (reference source/tacex_uipc/.../direct_uipc_rl_env.py:41-671):
instead of a stateful object mutating torch buffers around a PhysX process,
an env here is (cfg, pure ``reset``/``step`` functions over one state
pytree). The step contract mirrors the reference's vectorized auto-reset
semantics: every call advances physics ``decimation`` times, then computes
dones -> rewards -> resets (masked, in-graph) -> observations
(direct_uipc_rl_env.py:285-382). The whole step jits and shards over the env
axis (SURVEY §2.6).
"""

from __future__ import annotations

from typing import Any, Callable

import jax

from ..core.config import configclass


@configclass
class DirectRLEnvCfg:
    num_envs: int = 1024
    episode_length_s: float = 16.6666
    decimation: int = 1
    sim_dt: float = 1.0 / 60.0
    physics_substeps: int = 4
    action_space: int = 6
    seed: int = 0

    @property
    def max_episode_length(self) -> int:
        return int(self.episode_length_s / (self.sim_dt * self.decimation))


class DirectRLEnv:
    """Protocol every task env implements.

    Subclasses provide:
      * ``init_state(key) -> state``
      * ``reset_all(state) -> (state, obs)`` — full vectorized reset
      * ``step(state, action) -> (state, obs, reward, terminated, truncated, info)``
    All three are pure and jittable; ``self`` holds only static config.
    """

    cfg: DirectRLEnvCfg

    def __init__(self, cfg: DirectRLEnvCfg):
        self.cfg = cfg

    @property
    def num_envs(self) -> int:
        return self.cfg.num_envs

    # --- to override -------------------------------------------------------
    def init_state(self, key: jax.Array):
        raise NotImplementedError

    def reset_all(self, state):
        raise NotImplementedError

    def step(self, state, action):
        raise NotImplementedError

    # --- convenience -------------------------------------------------------
    def jit_step(self) -> Callable:
        return jax.jit(self.step)

    def rollout_fn(self, num_steps: int) -> Callable:
        """scan-based rollout driver: (state, actions (T, N, A)) -> ..."""

        def rollout(state, actions):
            def body(s, a):
                s, obs, rew, term, trunc, info = self.step(s, a)
                return s, (obs, rew, term, trunc)

            return jax.lax.scan(body, state, actions)

        return rollout


_REGISTRY: dict[str, tuple[type, Any]] = {}


def register(env_id: str, env_class: type, default_cfg_factory: Callable[[], DirectRLEnvCfg]) -> None:
    """gym.register equivalent (reference ball_rolling_tactile/__init__.py:19-80)."""
    _REGISTRY[env_id] = (env_class, default_cfg_factory)


def make(env_id: str, cfg: DirectRLEnvCfg | None = None, **overrides) -> DirectRLEnv:
    if env_id not in _REGISTRY:
        raise KeyError(f"Unknown env id '{env_id}'. Registered: {sorted(_REGISTRY)}")
    env_class, cfg_factory = _REGISTRY[env_id]
    cfg = cfg if cfg is not None else cfg_factory()
    if overrides:
        cfg = cfg.replace(**overrides)
    return env_class(cfg)


def registered_envs() -> list[str]:
    return sorted(_REGISTRY)
