"""Franka Panda kinematics: batched FK, geometric Jacobian, differential IK.

Batched JAX replacement for the PhysX articulation + isaaclab
``DifferentialIKController`` pipeline the reference tasks drive
(reference source/tacex_tasks/.../ball_rolling_taxim_fots.py:457-459,
648-658: 6-dim delta-pose command -> damped-least-squares IK from the PhysX
Jacobian -> joint position targets). Joint-space tracking is modeled as a
rate-limited first-order servo — the reference robots run high-PD position
control with gravity compensation (franka_gsmini_single_uipc.py:29-108), for
which this is the standard RL-sim abstraction.

Kinematics use the published Panda modified-DH parameters (Craig
convention); all functions broadcast over leading batch axes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ...core import maths

NUM_JOINTS = 7

# Modified DH rows: (a, d, alpha) for joints 1..7, flange handled separately.
_DH = jnp.array(
    [
        #   a        d       alpha
        [0.0, 0.333, 0.0],
        [0.0, 0.0, -jnp.pi / 2],
        [0.0, 0.316, jnp.pi / 2],
        [0.0825, 0.0, jnp.pi / 2],
        [-0.0825, 0.384, -jnp.pi / 2],
        [0.0, 0.0, jnp.pi / 2],
        [0.088, 0.0, jnp.pi / 2],
    ],
    dtype=jnp.float32,
)
FLANGE_OFFSET = 0.107  # m along the joint-7 z axis

Q_LOWER = jnp.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973], jnp.float32)
Q_UPPER = jnp.array([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973], jnp.float32)
Q_DEFAULT = jnp.array([0.0, -0.569, 0.0, -2.81, 0.0, 3.037, 0.741], jnp.float32)
QD_LIMIT = jnp.array([2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61], jnp.float32)


def _mdh_transform(a: jax.Array, d: jax.Array, alpha: jax.Array, theta: jax.Array):
    """Modified-DH link transform as (rotmat, translation)."""
    ct, st = jnp.cos(theta), jnp.sin(theta)
    ca, sa = jnp.cos(alpha), jnp.sin(alpha)
    rot = jnp.stack(
        [
            jnp.stack([ct, -st, jnp.zeros_like(ct)], -1),
            jnp.stack([st * ca, ct * ca, -sa * jnp.ones_like(ct)], -1),
            jnp.stack([st * sa, ct * sa, ca * jnp.ones_like(ct)], -1),
        ],
        -2,
    )
    trans = jnp.stack([a * jnp.ones_like(ct), -sa * d * jnp.ones_like(ct), ca * d * jnp.ones_like(ct)], -1)
    return rot, trans


def forward_kinematics(
    q: jax.Array,  # (..., 7)
    base_pos: jax.Array | None = None,  # (..., 3)
    base_quat: jax.Array | None = None,  # (..., 4)
    ee_offset_pos: jax.Array | None = None,  # (3,) extra tool offset in flange frame
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """FK to the flange/tool frame.

    Returns (ee_pos (...,3), ee_quat (...,4), joint_origins (...,7,3),
    joint_axes (...,7,3)) — origins/axes feed the geometric Jacobian.
    """
    batch = q.shape[:-1]
    rot = jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), batch + (3, 3))
    pos = jnp.zeros(batch + (3,), q.dtype)
    if base_quat is not None:
        rot = maths.matrix_from_quat(base_quat)
    if base_pos is not None:
        pos = jnp.broadcast_to(base_pos, batch + (3,))

    origins = []
    axes = []
    for i in range(NUM_JOINTS):
        a, d, alpha = _DH[i]
        r_i, t_i = _mdh_transform(a, d, alpha, q[..., i])
        pos = pos + jnp.einsum("...ij,...j->...i", rot, t_i)
        rot = jnp.einsum("...ij,...jk->...ik", rot, r_i)
        origins.append(pos)
        axes.append(rot[..., :, 2])  # joint rotates about local z

    # flange: translate along final z
    ee_pos = pos + FLANGE_OFFSET * rot[..., :, 2]
    if ee_offset_pos is not None:
        ee_pos = ee_pos + jnp.einsum("...ij,j->...i", rot, jnp.asarray(ee_offset_pos, q.dtype))
    ee_quat = maths.quat_from_matrix(rot)
    return ee_pos, ee_quat, jnp.stack(origins, -2), jnp.stack(axes, -2)


def geometric_jacobian(
    ee_pos: jax.Array, joint_origins: jax.Array, joint_axes: jax.Array
) -> jax.Array:
    """(..., 6, 7) spatial Jacobian [linear; angular] at the tool point."""
    r = ee_pos[..., None, :] - joint_origins  # (..., 7, 3)
    lin = jnp.cross(joint_axes, r)  # (..., 7, 3)
    return jnp.concatenate([lin, joint_axes], axis=-1).swapaxes(-1, -2)  # (..., 6, 7)


def dls_ik_step(
    q: jax.Array,  # (..., 7)
    pos_err: jax.Array,  # (..., 3) desired - current, world
    rot_err: jax.Array,  # (..., 3) axis-angle error, world
    jacobian: jax.Array,  # (..., 6, 7)
    damping: float = 0.05,
) -> jax.Array:
    """Damped-least-squares IK update: q + J^T (J J^T + λ²I)^-1 err.

    Mirrors isaaclab's DLS DifferentialIKController (the method the reference
    tasks configure: ik_method="dls").
    """
    err = jnp.concatenate([pos_err, rot_err], axis=-1)[..., None]  # (..., 6, 1)
    jjt = jnp.einsum("...ik,...jk->...ij", jacobian, jacobian)
    lam = (damping**2) * jnp.eye(6, dtype=q.dtype)
    dq = jnp.einsum("...ki,...kj->...ij", jacobian, jnp.linalg.solve(jjt + lam, err))[..., 0]
    return q + dq


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ArmState:
    """Batched arm state: measured joints + servo targets."""

    q: jax.Array  # (N, 7)
    qd: jax.Array  # (N, 7)
    q_target: jax.Array  # (N, 7)

    @staticmethod
    def init(num_envs: int, q0: jax.Array | None = None) -> "ArmState":
        q = jnp.broadcast_to(Q_DEFAULT if q0 is None else q0, (num_envs, NUM_JOINTS)).astype(jnp.float32)
        return ArmState(q=q, qd=jnp.zeros_like(q), q_target=q)


def servo_step(state: ArmState, dt: float, stiffness: float = 40.0) -> ArmState:
    """First-order rate-limited tracking of q_target (high-PD abstraction)."""
    err = state.q_target - state.q
    qd = jnp.clip(stiffness * err, -QD_LIMIT, QD_LIMIT)
    q = jnp.clip(state.q + qd * dt, Q_LOWER, Q_UPPER)
    return ArmState(q=q, qd=qd, q_target=state.q_target)


def apply_delta_pose_ik(
    state: ArmState,
    delta_pos: jax.Array,  # (N, 3) commanded EE translation
    delta_rot: jax.Array,  # (N, 3) commanded EE axis-angle rotation
    base_pos: jax.Array | None = None,
    base_quat: jax.Array | None = None,
    ee_offset_pos: jax.Array | None = None,
    damping: float = 0.05,
) -> ArmState:
    """Set joint targets from a 6-dim delta-pose command (one DLS step),
    replicating the reference action pipeline
    (ball_rolling_taxim_fots.py:637-658)."""
    ee_pos, ee_quat, origins, axes = forward_kinematics(
        state.q, base_pos, base_quat, ee_offset_pos
    )
    jac = geometric_jacobian(ee_pos, origins, axes)
    q_new = dls_ik_step(state.q, delta_pos, delta_rot, jac, damping)
    q_new = jnp.clip(q_new, Q_LOWER, Q_UPPER)
    return ArmState(q=state.q, qd=state.qd, q_target=q_new)
