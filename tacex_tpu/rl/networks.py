"""Actor-critic networks for dict observations (proprio + tactile vision).

Topology mirrors the reference's skrl model instantiator config
(reference source/tacex_tasks/.../agents/skrl_ppo_tactile_rgb_cfg.yaml):
vision -> conv(16, k4, s2) -> conv(4, k3, s1) -> flatten -> concat(proprio)
-> MLP [256, 128, 64] (elu) -> gaussian policy head / value head. Images
stay NHWC, so no permute is needed (the YAML itself warns torch-only).

The layers are plain ``jax.numpy``/``lax``. Parameters are nested dicts laid
out as the checkpoints under ``logs/`` store them — ``{"params":
{"VisionEncoder_0": {"Conv_0": {"kernel", "bias"}, ...}, "Dense_0":
{"kernel", "bias"}, ..., "log_std"}}``, layers numbered per kind in
creation order, kernels (in, out) and convolutions HWIO — so those
checkpoints restore unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def dense_init(key: jax.Array, fan_in: int, fan_out: int, kernel_init=_lecun_normal) -> dict:
    return {
        "kernel": kernel_init(key, (fan_in, fan_out), jnp.float32),
        "bias": jnp.zeros((fan_out,), jnp.float32),
    }


def dense(p: dict, x: jax.Array) -> jax.Array:
    return x @ p["kernel"] + p["bias"]


def _conv_init(key: jax.Array, k: int, c_in: int, c_out: int) -> dict:
    return {
        "kernel": _lecun_normal(key, (k, k, c_in, c_out), jnp.float32),
        "bias": jnp.zeros((c_out,), jnp.float32),
    }


def _conv(p: dict, x: jax.Array, stride: int) -> jax.Array:
    y = jax.lax.conv_general_dilated(
        x, p["kernel"], (stride, stride), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")
    )
    return y + p["bias"]


# (name, kernel size, stride, output channels) of the vision encoder
_ENCODER = (("Conv_0", 4, 2, 16), ("Conv_1", 3, 1, 4))


def _encoder_init(key: jax.Array, c_in: int) -> dict:
    keys = jax.random.split(key, len(_ENCODER))
    params = {}
    for k_layer, (name, k, _, c_out) in zip(keys, _ENCODER):
        params[name] = _conv_init(k_layer, k, c_in, c_out)
        c_in = c_out
    return params


def _encode(p: dict, x: jax.Array) -> jax.Array:  # (B, H, W, C) -> (B, F)
    for name, _, stride, _ in _ENCODER:
        x = jax.nn.relu(_conv(p[name], x, stride))
    return x.reshape((x.shape[0], -1))


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Gaussian actor + value critic over dict obs.

    The policy and value have separate towers (encoder + MLP each): with a
    shared trunk, policy-loss gradients perturb the features the critic
    reads, which (with KL-adaptive LR raising the step size when the policy
    is stable) can run the critic away from its bootstrapped targets.
    """

    action_dim: int
    hidden: tuple = (256, 128, 64)
    initial_log_std: float = 0.0
    min_log_std: float = -20.0
    max_log_std: float = 2.0

    def _layout(self):
        """((encoder, dense layers) per tower, mean head, value head): layer
        names numbered per kind in creation order (policy tower, value
        tower, mean head, value head), as the checkpoints store them."""
        n = len(self.hidden)
        towers = tuple(
            (f"VisionEncoder_{t}", tuple(f"Dense_{t * n + i}" for i in range(n))) for t in range(2)
        )
        return towers, f"Dense_{2 * n}", f"Dense_{2 * n + 1}"

    def _features(self, p: dict, encoder: str, obs: dict) -> jax.Array:
        feats = []
        if "vision_obs" in obs:
            feats.append(_encode(p[encoder], obs["vision_obs"]))
        feats.append(obs["proprio_obs"])
        return jnp.concatenate(feats, axis=-1)

    def init(self, key: jax.Array, obs: dict) -> dict:
        towers, mean_name, value_name = self._layout()
        keys = iter(jax.random.split(key, 2 * (len(self.hidden) + 1) + 2))
        params = {}
        for encoder, layers in towers:
            if "vision_obs" in obs:
                params[encoder] = _encoder_init(next(keys), obs["vision_obs"].shape[-1])
            feat = jax.eval_shape(lambda p, o: self._features(p, encoder, o), params, obs)
            d = feat.shape[-1]
            for name, h in zip(layers, self.hidden):
                params[name] = dense_init(next(keys), d, h)
                d = h
        orth = jax.nn.initializers.orthogonal
        params[mean_name] = dense_init(next(keys), d, self.action_dim, orth(0.01))
        params[value_name] = dense_init(next(keys), d, 1, orth(1.0))
        params["log_std"] = jnp.full((self.action_dim,), self.initial_log_std, jnp.float32)
        return {"params": params}

    def apply(self, params: dict, obs: dict):
        p = params["params"]
        towers, mean_name, value_name = self._layout()
        outs = []
        for encoder, layers in towers:
            x = self._features(p, encoder, obs)
            for name in layers:
                x = jax.nn.elu(dense(p[name], x))
            outs.append(x)
        pol, val = outs
        mean = dense(p[mean_name], pol)
        log_std = jnp.clip(p["log_std"], self.min_log_std, self.max_log_std)
        value = dense(p[value_name], val)[..., 0]
        return mean, jnp.broadcast_to(log_std, mean.shape), value


def gaussian_log_prob(mean: jax.Array, log_std: jax.Array, action: jax.Array) -> jax.Array:
    var = jnp.exp(2 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2 * log_std + jnp.log(2 * jnp.pi))
    return lp.sum(axis=-1)


def gaussian_entropy(log_std: jax.Array) -> jax.Array:
    return (log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e)).sum(axis=-1)
