"""Pole balancing on the tactile sensor.

Batched rebuild of the reference ``TacEx-Pole-Balancing-Base-v0``
(reference source/tacex_tasks/tacex_tasks/pole_balancing/base_env.py): the
Franka holds the GelSight face-up; a pole stands on the gel pad and must be
kept balanced while the end-effector tracks a target height. Observations are
proprio + the sensor camera depth image (32x32x1 in the reference cfg).

Pole physics: a uniform rod with full 6-DoF dynamics; its lower tip contacts
the (moving, compliant) gel pad as a sphere-vs-box impulse with friction,
applied at the tip so the reaction torque tips the rod — the inverted-
pendulum-on-moving-support dynamics the task needs. Rewards, dones and the
action pipeline follow the reference (base_env.py:218-247, 431-560).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

import jax
import jax.numpy as jnp

from ...core import maths
from ...core.config import configclass
from ...physics.rigid import contact, franka
from ...render.depth_camera import SdfScene, render_depth_batch
from ...sensors.gelsight.sensor import GelSightSensor
from ...sensors.gelsight.sensor_cfg import gelsight_mini_cfg
from ..base import DirectRLEnv, DirectRLEnvCfg
from ..ball_rolling.env import CAM_EXTENT, GELPAD_HALF


@configclass
class PoleBalancingEnvCfg(DirectRLEnvCfg):
    num_envs: int = 1024
    episode_length_s: float = 8.3333 / 2
    decimation: int = 1
    sim_dt: float = 1.0 / 120.0
    physics_substeps: int = 2
    action_space: int = 6
    action_scale: float = 0.05
    action_noise: float = 0.001
    obs_noise_std: float = 0.002

    # pole (reference Props/pole.usd: slender rod standing on the gel)
    pole_length: float = 0.2
    pole_radius: float = 0.005
    pole_mass: float = 0.02
    default_joint_pos: tuple = (1.5, -1.76, -1.84, -2.52, 1.25, 1.58, -1.72)
    ee_offset: tuple = (0.0, 0.0, 0.131)

    x_bounds: tuple = (0.0, 0.9)
    y_bounds: tuple = (-0.5, 0.5)
    too_far_away_threshold: float = 0.3
    min_height_threshold: float = 0.05

    camera_resolution: tuple = (32, 32)
    vision_obs_shape: tuple = (32, 32, 1)
    sensor_clipping: tuple = (0.015, 0.029)

    reward_terms: dict = dataclasses.field(
        default_factory=lambda: {
            "at_obj_reward": {"weight": 0.75, "minimal_distance": 0.005},
            "height_reward": {"weight": 0.25, "w": 10.0, "v": 0.3, "alpha": 0.00067, "target_height_cm": 50},
            "orient_reward": {"weight": 0.25},
            "ee_goal_fine_tracking_reward": {"weight": 0.75, "std": 0.0380},
            "staying_alive_rew": {"weight": 1.0},
            "termination_penalty": {"weight": -5.0},
            "action_rate_penalty": {"weight": -1e-4},
            "joint_vel_penalty": {"weight": -1e-4},
        }
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoleBalancingState:
    arm: franka.ArmState
    pole_pos: jax.Array  # (N, 3) rod center of mass
    pole_quat: jax.Array  # (N, 4)
    pole_lin: jax.Array  # (N, 3)
    pole_ang: jax.Array  # (N, 3)
    actions: jax.Array
    prev_actions: jax.Array
    episode_length: jax.Array
    key: jax.Array


class PoleBalancingEnv(DirectRLEnv):
    cfg: PoleBalancingEnvCfg

    def __init__(self, cfg: PoleBalancingEnvCfg | None = None):
        super().__init__(cfg or PoleBalancingEnvCfg())
        c = self.cfg
        res = tuple(c.camera_resolution)
        sensor_cfg = gelsight_mini_cfg(with_markers=False, camera_resolution=res, tactile_img_res=res)
        sensor_cfg.sensor_camera_cfg.clipping_range = tuple(c.sensor_clipping)
        sensor_cfg.data_types = ["height_map", "camera_depth"]
        self.sensor = GelSightSensor(sensor_cfg, num_envs=c.num_envs)
        self._q0 = jnp.asarray(c.default_joint_pos, jnp.float32)
        self._ee_off = jnp.asarray(c.ee_offset, jnp.float32)
        self.tip_params = contact.SphereParams(
            radius=c.pole_radius, mass=c.pole_mass, friction=1.0
        )
        # uniform rod inertia about its center, body z = rod axis
        m, L, r = c.pole_mass, c.pole_length, c.pole_radius
        i_perp = m * (L**2) / 12.0 + 0.25 * m * r * r
        i_axial = 0.5 * m * r * r
        self._inv_inertia_body = jnp.array([1 / i_perp, 1 / i_perp, 1 / i_axial], jnp.float32)

    # ---------------------------------------------------------------- helpers
    def _tool_pose(self, q):
        pos, quat, _, _ = franka.forward_kinematics(q, ee_offset_pos=self._ee_off)
        return pos, quat

    def _tip_pos(self, pole_pos, pole_quat):
        axis = maths.quat_apply(pole_quat, jnp.array([0.0, 0.0, 1.0]))
        return pole_pos - (self.cfg.pole_length / 2) * axis, axis

    # ------------------------------------------------------------------ state
    def init_state(self, key: jax.Array) -> PoleBalancingState:
        n = self.cfg.num_envs
        tool_pos, tool_quat = self._tool_pose(jnp.broadcast_to(self._q0, (n, 7)))
        # pole stands upright on the face-up sensor (world up = tool +z here)
        pole_pos = tool_pos.at[:, 2].add(self.cfg.pole_length / 2 + 1e-4)
        return PoleBalancingState(
            arm=franka.ArmState.init(n, self._q0),
            pole_pos=pole_pos,
            pole_quat=maths.quat_identity((n,)),
            pole_lin=jnp.zeros((n, 3)),
            pole_ang=jnp.zeros((n, 3)),
            actions=jnp.zeros((n, self.cfg.action_space)),
            prev_actions=jnp.zeros((n, self.cfg.action_space)),
            episode_length=jnp.zeros((n,), jnp.int32),
            key=key,
        )

    def _reset_where(self, state: PoleBalancingState, mask: jax.Array) -> PoleBalancingState:
        n = self.cfg.num_envs
        key, k1 = jax.random.split(state.key)
        fresh = self.init_state(k1)
        m1 = mask[:, None]
        return PoleBalancingState(
            arm=franka.ArmState(
                q=jnp.where(m1, fresh.arm.q, state.arm.q),
                qd=jnp.where(m1, 0.0, state.arm.qd),
                q_target=jnp.where(m1, fresh.arm.q_target, state.arm.q_target),
            ),
            pole_pos=jnp.where(m1, fresh.pole_pos, state.pole_pos),
            pole_quat=jnp.where(m1, fresh.pole_quat, state.pole_quat),
            pole_lin=jnp.where(m1, 0.0, state.pole_lin),
            pole_ang=jnp.where(m1, 0.0, state.pole_ang),
            actions=jnp.where(m1, 0.0, state.actions),
            prev_actions=jnp.where(m1, 0.0, state.prev_actions),
            episode_length=jnp.where(mask, 0, state.episode_length),
            key=key,
        )

    def reset_all(self, state):
        state = self._reset_where(state, jnp.ones((self.cfg.num_envs,), bool))
        obs, _ = self._observations(state, None)
        return state, obs

    # ------------------------------------------------------------------- step
    def step(self, state: PoleBalancingState, action: jax.Array):
        c = self.cfg
        n = c.num_envs
        key, k_act, k_obs = jax.random.split(state.key, 3)

        prev_actions = state.actions
        actions = jnp.clip(jnp.nan_to_num(action), -1.0, 1.0)
        actions = actions + jax.random.uniform(k_act, actions.shape, minval=-c.action_noise, maxval=c.action_noise)
        processed = actions * c.action_scale

        arm = franka.apply_delta_pose_ik(
            state.arm, processed[:, :3], processed[:, 3:6], ee_offset_pos=self._ee_off
        )

        pos, quat = state.pole_pos, state.pole_quat
        lin, ang = state.pole_lin, state.pole_ang
        sub_dt = c.sim_dt / c.physics_substeps
        half = jnp.asarray(GELPAD_HALF, jnp.float32)
        tool_pos, _ = self._tool_pose(arm.q)
        for _ in range(c.physics_substeps):
            tool_prev = tool_pos
            arm = franka.servo_step(arm, sub_dt)
            tool_pos, tool_quat = self._tool_pose(arm.q)
            # gel pad box centered half-thickness behind the contact face
            # (tool +z points up out of the face-up sensor)
            pad_pos, pad_quat = tool_pos - half[2] * maths.quat_apply(
                tool_quat, jnp.array([0.0, 0.0, 1.0])
            ), tool_quat
            pad_vel = (tool_pos - tool_prev) / sub_dt

            lin = lin + jnp.array([0.0, 0.0, -9.81]) * sub_dt
            tip, axis = self._tip_pos(pos, quat)
            # contact impulse at the tip (sphere-vs-box), mapped through rod
            # dynamics: dv = J/m; dw = I^-1 (r x J)
            dl, da_s = contact.sphere_box_contact(
                tip, lin + jnp.cross(ang, tip - pos), jnp.zeros_like(ang),
                pad_pos, pad_quat, pad_vel, half, self.tip_params, sub_dt,
                stiffness_scale=0.5,
            )
            imp = dl * self.tip_params.mass  # impulse vector
            lin = lin + imp / c.pole_mass
            r_vec = tip - pos
            ang_imp = jnp.cross(r_vec, imp)
            # world-frame inverse inertia: R diag R^T
            rot = maths.matrix_from_quat(quat)
            inv_i_world = jnp.einsum(
                "nij,j,nkj->nik", rot, self._inv_inertia_body, rot
            )
            ang = ang + jnp.einsum("nij,nj->ni", inv_i_world, ang_imp)

            pos = pos + lin * sub_dt
            wq = jnp.concatenate([jnp.zeros_like(ang[..., :1]), ang], -1)
            quat = maths.quat_normalize(quat + 0.5 * sub_dt * maths.quat_mul(wq, quat))

        # ------------- sensor frame: camera looks along tool +z (up at pole)
        tool_pos, tool_quat = self._tool_pose(arm.q)
        ocfg = self.sensor.cfg.optical_sim_cfg
        dist = ocfg.gelpad_to_camera_min_distance + ocfg.gelpad_height
        zax = maths.quat_apply(tool_quat, jnp.array([0.0, 0.0, 1.0]))
        cam_pos = tool_pos - dist * zax
        tip, _ = self._tip_pos(pos, quat)
        scene = SdfScene(
            spheres=jnp.concatenate([tip, jnp.full((n, 1), c.pole_radius)], -1)[:, None, :],
            boxes=jnp.zeros((n, 1, 10)),
            capsules=jnp.concatenate(
                [tip, pos + (pos - tip), jnp.full((n, 1), c.pole_radius), jnp.ones((n, 1))], -1
            )[:, None, :],
            planes=jnp.zeros((n, 1, 4)),
        )
        depth = render_depth_batch(
            cam_pos, tool_quat, scene, tuple(c.camera_resolution), CAM_EXTENT, far=c.sensor_clipping[1]
        )
        sensor_state, sensor_out = self.sensor.update(self.sensor.init_state(), depth)

        state = PoleBalancingState(
            arm=arm, pole_pos=pos, pole_quat=quat, pole_lin=lin, pole_ang=ang,
            actions=actions, prev_actions=prev_actions,
            episode_length=state.episode_length + 1, key=key,
        )

        # ---------------- dones (base_env.py:431-465)
        oob = (
            (pos[:, 0] < c.x_bounds[0]) | (pos[:, 0] > c.x_bounds[1])
            | (pos[:, 1] < c.y_bounds[0]) | (pos[:, 1] > c.y_bounds[1])
        )
        roll, pitch, _ = maths.euler_xyz_from_quat(quat)
        tipped = (jnp.abs(roll) > math.pi / 4) | (jnp.abs(pitch) > math.pi / 4)
        ee_far = jnp.linalg.norm(pos - tool_pos, axis=-1) > c.too_far_away_threshold
        too_low = (tool_pos[:, 2] < c.min_height_threshold) | (pos[:, 2] < c.min_height_threshold)
        terminated = oob | tipped | ee_far | too_low
        truncated = state.episode_length >= c.max_episode_length - 1

        # ---------------- rewards (base_env.py:467-560)
        r = c.reward_terms
        obj_ee_dist = jnp.linalg.norm(pos - tool_pos, axis=-1)
        at_obj = jnp.where(
            obj_ee_dist <= r["at_obj_reward"]["minimal_distance"] + c.pole_length / 2,
            r["at_obj_reward"]["weight"],
            0.0,
        )
        hd = (r["height_reward"]["target_height_cm"] - tool_pos[:, 2] * 100.0) * 0.1
        height = -jnp.clip(
            r["height_reward"]["w"] * hd**2
            + r["height_reward"]["v"] * jnp.log(hd**2 + r["height_reward"]["alpha"]),
            -1.0,
            1.0,
        )
        height = jnp.where(tool_pos[:, 2] <= c.min_height_threshold, height - 10.0, height)
        height = height * r["height_reward"]["weight"]
        orient = jnp.where(
            (jnp.abs(roll) < math.pi / 8) | (jnp.abs(pitch) < math.pi / 8),
            r["orient_reward"]["weight"],
            0.0,
        )
        goal = jnp.stack(
            [tool_pos[:, 0], tool_pos[:, 1], jnp.full((n,), r["height_reward"]["target_height_cm"] / 100.0)],
            -1,
        )
        ee_goal_dist = jnp.linalg.norm(tool_pos - goal, axis=-1)
        fine = 1.0 - jnp.tanh(ee_goal_dist / r["ee_goal_fine_tracking_reward"]["std"]) ** 2
        fine = fine * r["ee_goal_fine_tracking_reward"]["weight"]
        alive = r["staying_alive_rew"]["weight"] * (1.0 - terminated.astype(jnp.float32))
        term_pen = r["termination_penalty"]["weight"] * terminated.astype(jnp.float32)
        act_rate = r["action_rate_penalty"]["weight"] * jnp.sum(
            jnp.square(actions - prev_actions), axis=-1
        )
        joint_vel = r["joint_vel_penalty"]["weight"] * jnp.sum(jnp.square(arm.qd), axis=-1)
        reward = at_obj + height + orient + fine + alive + term_pen + act_rate + joint_vel

        done = terminated | truncated
        state = self._reset_where(state, done)
        obs, _ = self._observations(state, sensor_out, k_obs)
        info = {"log": {"full_reward": reward.mean()}}
        return state, obs, reward, terminated, truncated, info

    # -------------------------------------------------------------------- obs
    def _observations(self, state, sensor_out, obs_key=None):
        c = self.cfg
        n = c.num_envs
        tool_pos, tool_quat = self._tool_pose(state.arm.q)
        roll, pitch, yaw = maths.euler_xyz_from_quat(tool_quat)
        proprio = jnp.concatenate(
            [
                tool_pos,
                roll[:, None],
                pitch[:, None],
                yaw[:, None],
                state.pole_pos[:, :2],
                state.actions,
            ],
            axis=-1,
        )
        if obs_key is not None:
            proprio = proprio + c.obs_noise_std * jax.random.normal(obs_key, proprio.shape)
        vh, vw, _ = c.vision_obs_shape
        if sensor_out is None:
            vision = jnp.zeros((n, vh, vw, 1))
        else:
            d = sensor_out["camera_depth"]
            if d.shape[1:3] != (vh, vw):
                d = jax.image.resize(d, (n, vh, vw, 1), method="linear")
            vision = d
        return {"proprio_obs": proprio, "vision_obs": vision}, None
