"""Follow-goal demo: Franka + GelSight Mini tracks a moving goal pose.

Counterpart of reference scripts/demos/follow_goal_franka_single_gsmini.py
(there: an Omniverse GUI frame the user drags, a DifferentialIKController
tracking it, and live tactile rendering). Headless version: the goal pose
follows a scripted square-with-press trajectory, the arm tracks it with the
same damped-least-squares IK used by the task envs, and whenever the press
segment brings the gel against the plate-mounted test sphere the tactile
image is recorded. Outputs a PNG strip plus per-waypoint tracking errors.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[2]))  # repo root

from tacex_tpu.core import maths
from tacex_tpu.physics.rigid import franka
from tacex_tpu.render.depth_camera import SdfScene, render_depth_batch
from tacex_tpu.sensors.gelsight.sensor import GelSightSensor
from tacex_tpu.sensors.gelsight.sensor_cfg import gelsight_mini_cfg

EE_OFF = jnp.array([0.0, 0.0, 0.131], jnp.float32)
PLATE_TOP = 0.0026
SPHERE = (0.45, 0.0, PLATE_TOP + 0.008, 0.008)  # center x, y, z, radius
CAM_EXTENT = (0.0295 * 640 / 1000.0, 0.0295 * 480 / 1000.0)


def goal_at(t: float) -> np.ndarray:
    """Square sweep at hover height, with a press dip over the sphere."""
    cx, cy, r = SPHERE[0], SPHERE[1], 0.06
    corners = np.array(
        [[cx - r, cy - r], [cx + r, cy - r], [cx + r, cy + r], [cx - r, cy + r]], np.float32
    )
    seg = t % 5
    if seg < 4:  # edges of the square
        a = corners[int(seg) % 4]
        b = corners[(int(seg) + 1) % 4]
        xy = a + (seg - int(seg)) * (b - a)
        z = 0.05
    else:  # press over the sphere
        xy = np.array([cx, cy], np.float32)
        z = 0.05 - 0.04 * np.sin(np.pi * (seg - 4))  # dip to ~1 cm (press)
    return np.array([xy[0], xy[1], z], np.float32)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--dt", type=float, default=1 / 30)
    p.add_argument("--out", default="/tmp/follow_goal.png")
    args = p.parse_args()

    sensor = GelSightSensor(gelsight_mini_cfg(camera_resolution=(320, 240)), num_envs=1)
    sstate = sensor.init_state()

    q = jnp.asarray([[-1.02, 0.3175, 0.06, -2.60, 0.0, 2.91, -0.12]], jnp.float32)
    down_quat = maths.quat_from_angle_axis(jnp.asarray(np.pi), jnp.array([1.0, 0.0, 0.0]))

    @jax.jit
    def track(q, goal):
        pos, quat, orig, ax = franka.forward_kinematics(q, ee_offset_pos=EE_OFF)
        jac = franka.geometric_jacobian(pos, orig, ax)
        rot_err = maths.axis_angle_from_quat(
            maths.quat_mul(jnp.broadcast_to(down_quat, quat.shape), maths.quat_conjugate(quat))
        )
        q = jnp.clip(franka.dls_ik_step(q, goal - pos, rot_err, jac), franka.Q_LOWER, franka.Q_UPPER)
        return q, pos, quat

    @jax.jit
    def tactile(sstate, pos, quat):
        ocfg = sensor.cfg.optical_sim_cfg
        dist = ocfg.gelpad_to_camera_min_distance + ocfg.gelpad_height
        z_axis = maths.quat_apply(quat, jnp.array([0.0, 0.0, 1.0]))
        cam_pos = pos - dist * z_axis
        scene = SdfScene(
            spheres=jnp.array([[list(SPHERE)]], jnp.float32),
            boxes=jnp.zeros((1, 1, 10)),
            capsules=jnp.zeros((1, 1, 8)),
            planes=jnp.array([[[0.0, 0.0, 1.0, PLATE_TOP]]], jnp.float32),
        )
        depth = render_depth_batch(cam_pos, quat, scene, (320, 240), CAM_EXTENT, far=0.029)
        return sensor.update(sstate, depth)

    frames, errors = [], []
    for i in range(args.steps):
        goal = jnp.asarray(goal_at(i * args.dt * 3))[None]
        for _ in range(4):  # a few IK iterations per control step
            q, pos, quat = track(q, goal)
        err = float(jnp.linalg.norm(goal - pos))
        errors.append(err)
        sstate, out = tactile(sstate, pos, quat)
        if float(out["indentation_depth"][0]) > 0.05 and len(frames) < 8:
            frames.append(np.asarray(out["tactile_rgb"][0]))

    print(f"tracking error: mean {np.mean(errors)*1000:.2f} mm, final {errors[-1]*1000:.2f} mm")
    print(f"in-contact tactile frames recorded: {len(frames)}")
    if frames:
        strip = (np.concatenate(frames, axis=1) * 255).astype(np.uint8)
        try:
            from PIL import Image

            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(strip).save(args.out)
            print(f"saved {args.out}")
        except ImportError:
            np.save(args.out + ".npy", strip)
    assert np.mean(errors[10:]) < 0.02, "IK tracking did not converge"


if __name__ == "__main__":
    main()
