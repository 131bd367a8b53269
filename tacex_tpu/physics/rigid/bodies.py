"""Batched 6-DoF rigid body state + semi-implicit Euler integration.

Batched JAX replacement for the PhysX rigid-body layer the reference scenes
use (ball, plate, pole props — reference
source/tacex_tasks/.../ball_rolling_taxim_fots.py:580-633). One pytree of
``(N, B, ...)`` arrays for N envs x B bodies, stepped inside jit; no
per-body Python objects.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ...core import maths


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RigidState:
    """Batched rigid bodies: (N, B, ...)."""

    pos: jax.Array  # (N, B, 3)
    quat: jax.Array  # (N, B, 4) wxyz
    lin_vel: jax.Array  # (N, B, 3)
    ang_vel: jax.Array  # (N, B, 3) world frame

    @staticmethod
    def init(num_envs: int, num_bodies: int) -> "RigidState":
        return RigidState(
            pos=jnp.zeros((num_envs, num_bodies, 3)),
            quat=maths.quat_identity((num_envs, num_bodies)),
            lin_vel=jnp.zeros((num_envs, num_bodies, 3)),
            ang_vel=jnp.zeros((num_envs, num_bodies, 3)),
        )


def integrate(state: RigidState, dt: float, gravity=(0.0, 0.0, -9.81), inv_mass: jax.Array | None = None) -> RigidState:
    """Semi-implicit Euler: v += g dt (dynamic bodies), x += v dt, q += w q dt/2.

    ``inv_mass``: (B,) or (N, B); 0 marks static/kinematic bodies (no gravity).
    """
    g = jnp.asarray(gravity, state.lin_vel.dtype)
    if inv_mass is None:
        dyn = jnp.ones(state.pos.shape[:-1], state.pos.dtype)
    else:
        dyn = (inv_mass > 0).astype(state.pos.dtype)
        dyn = jnp.broadcast_to(dyn, state.pos.shape[:-1])
    lin_vel = state.lin_vel + dyn[..., None] * g * dt
    pos = state.pos + lin_vel * dt
    # quaternion update: q' = q + 0.5 * (0, w) ⊗ q * dt
    w = state.ang_vel
    wq = jnp.concatenate([jnp.zeros_like(w[..., :1]), w], axis=-1)
    quat = state.quat + 0.5 * dt * maths.quat_mul(wq, state.quat)
    quat = maths.quat_normalize(quat)
    return RigidState(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=state.ang_vel)
