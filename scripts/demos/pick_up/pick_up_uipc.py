"""Pick-up demo (FEM gel pads): grasp a ball with soft gels on both fingers.

Counterpart of reference scripts/demos/pick_up/pick_up_uipc.py (there: a
PhysX Franka whose two GelSight gel pads are libuipc FEM bodies coupled via
UipcIsaacAttachments). Here:

  * the two finger gels are ONE batched SoftBodyModel solve with batch
    axis = fingers (the batched IPC solver does not care
    that the "envs" are two gels of the same robot),
  * each gel is attached (top face) to its finger frame and pressed against
    the ball; the ball feels the action-reaction of both gels' contact
    barriers plus Coulomb friction at the contact (two-way coupling, as in
    the batched UIPC ball-rolling env),
  * tactile depth is taken from each gel's DEFORMED contact face.

Phases: approach -> descend -> close -> lift; asserts the ball rises.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[3]))  # repo root

from tacex_tpu.core import maths
from tacex_tpu.physics.rigid import articulation as art
from tacex_tpu.physics.rigid import contact, franka
from tacex_tpu.physics.soft.ipc import IpcSolverCfg, RigidSdfScene, SoftBodyModel, SoftBodyState
from tacex_tpu.physics.soft.mesh import box_tet_mesh
from tacex_tpu.sensors.gelsight.sensor import GelSightSensor
from tacex_tpu.sensors.gelsight.sensor_cfg import gelsight_mini_cfg

BALL = contact.SphereParams(radius=0.012, mass=0.02, friction=0.9)
BALL_POS0 = np.array([0.45, 0.0, 0.012 + 0.0026], np.float32)
GEL_SIZE = (0.020, 0.005, 0.024)  # x, y (thickness), z in finger frame
DT = 1.0 / 120.0


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--steps_per_phase", type=int, default=100)
    p.add_argument("--out", default="/tmp/pick_up_uipc.png")
    args = p.parse_args()

    sensor = GelSightSensor(
        gelsight_mini_cfg(camera_resolution=(96, 72), with_markers=False), num_envs=2
    )
    sstate = sensor.init_state()

    # gel tet mesh in FINGER-LOCAL frame: contact face at y=0 (facing the
    # ball), mount face at y=thickness (attached to the finger body).
    # Built with thickness along +z, then ROTATED -90deg about x (a proper
    # rotation — swapping axes would mirror the mesh and invert the tets).
    mesh = box_tet_mesh((GEL_SIZE[0], GEL_SIZE[2], GEL_SIZE[1]), (6, 7, 2),
                        center=(0.0, 0.0, GEL_SIZE[1] / 2))
    pts = np.stack([mesh.points[:, 0], mesh.points[:, 2], -mesh.points[:, 1]], -1)
    mount = np.where(pts[:, 1] > GEL_SIZE[1] - 1e-9)[0].astype(np.int32)
    contact_face = np.where(pts[:, 1] < 1e-9)[0].astype(np.int32)

    class _M:  # local-frame view of the mesh with swapped axes
        points = pts
        tets = mesh.tets
        num_vertices = mesh.num_vertices

    _M.surface_tris = mesh.surface_tris
    _M.surface_verts = mesh.surface_verts

    gel = SoftBodyModel(
        _M, youngs_modulus=1.45e5, poisson_ratio=0.45,
        cfg=IpcSolverCfg(dt=DT, newton_max_iter=4, cg_iters=24, d_hat=5e-4, kappa=2e4),
        attachment_verts=mount,
    )
    rest_local = jnp.asarray(pts)  # (V, 3) finger-local
    mount_local = jnp.asarray(pts[mount])
    # contact-face grid for tactile depth (sorted row-major)
    fpts = pts[contact_face]
    order = np.lexsort((fpts[:, 0], fpts[:, 2]))
    grid_ids = contact_face[order].reshape(8, 7)  # (nz+1, nx+1)

    arm = art.GripperArmState.init(1, finger_width=0.06)
    ball_pos = jnp.asarray(BALL_POS0)[None]
    ball_lin = jnp.zeros((1, 3))
    ball_ang = jnp.zeros((1, 3))

    down_quat = maths.quat_from_angle_axis(jnp.asarray(np.pi), jnp.array([1.0, 0.0, 0.0]))
    tcp_off = jnp.array([0.0, 0.0, art.HAND_TCP_OFFSET], jnp.float32)

    def finger_frames(arm_q):
        """Pose of each gel's local frame (origin = pad center, contact face
        at local y=0, mount face at local +y = INTO the finger body)."""
        pads, _, rot = art.finger_positions(arm_q)  # (1,2,3), (1,3,3)
        x, y, z = rot[0, :, 0], rot[0, :, 1], rot[0, :, 2]
        # finger 0 sits at +y of the hand (ball toward -y): mount dir = +y
        r0 = jnp.stack([x, y, z], -1)
        # finger 1: mount dir = -y; flip x too to stay right-handed
        r1 = jnp.stack([-x, -y, z], -1)
        quats = jnp.stack([maths.quat_from_matrix(r0), maths.quat_from_matrix(r1)])
        return pads[0], quats  # (2,3), (2,4)

    @jax.jit
    def ik_target(arm, goal_pos):
        qt = arm.q_target[:, :7]
        for _ in range(6):
            pos, quat, orig, ax = franka.forward_kinematics(qt, ee_offset_pos=tcp_off)
            jac = franka.geometric_jacobian(pos, orig, ax)
            rot_err = maths.axis_angle_from_quat(
                maths.quat_mul(jnp.broadcast_to(down_quat, quat.shape), maths.quat_conjugate(quat))
            )
            qt = jnp.clip(franka.dls_ik_step(qt, goal_pos - pos, rot_err, jac), franka.Q_LOWER, franka.Q_UPPER)
        return qt

    def gel_world_state(arm_q):
        pos, quats = finger_frames(arm_q)
        x = maths.transform_points(rest_local[None], pos, quats)  # (2, V, 3)
        return SoftBodyState(x=x, v=jnp.zeros_like(x))

    @jax.jit
    def physics(arm, gel_state, ball_pos, ball_lin, ball_ang, q_target):
        arm = art.GripperArmState(arm.q, arm.qd, q_target)
        pads_old, _, _ = art.finger_positions(arm.q)
        arm = art.step(arm, DT)
        pos, quats = finger_frames(arm.q)
        pad_vel = (pos - pads_old[0]) / DT  # (2, 3)

        # ---- ball: gravity + gel barrier reaction (both gels) + friction + plate
        sph = jnp.broadcast_to(
            jnp.concatenate([ball_pos[0], jnp.array([BALL.radius])])[None, None], (2, 1, 4)
        )
        zero_scene = RigidSdfScene(
            spheres=sph, boxes=jnp.zeros((2, 1, 10)),
            capsules=jnp.zeros((2, 1, 8)), planes=jnp.zeros((2, 1, 4)),
        )
        f_gel = gel.sphere_contact_force(gel_state, zero_scene)[:, 0]  # (2, 3)
        ball_lin = ball_lin + jnp.array([0.0, 0.0, -9.81]) * DT
        # Both gels resolved SIMULTANEOUSLY against the same incoming ball
        # velocity, impulses summed afterwards — sequential application makes
        # the symmetric squeeze asymmetric and squirts the ball out sideways
        # (same failure mode documented in pick_up_rigid).
        dv_sum = jnp.zeros_like(ball_lin)
        for i in range(2):
            f = f_gel[i][None]  # (1, 3)
            f_mag = jnp.linalg.norm(f, axis=-1)
            dv = f * (DT / BALL.mass)
            dv_n = jnp.linalg.norm(dv, axis=-1, keepdims=True)
            dv_sum = dv_sum + dv * jnp.minimum(1.0, 0.25 / jnp.maximum(dv_n, 1e-9))
            # Coulomb friction vs the (attached, finger-following) gel; the
            # pinch locks ball rotation (see pick_up_rigid), so the slip is
            # purely translational.
            in_c = f_mag > 1e-6
            n_dir = f / jnp.maximum(f_mag, 1e-9)[..., None]
            v_rel = ball_lin - pad_vel[i][None]
            vt = v_rel - jnp.sum(v_rel * n_dir, -1, keepdims=True) * n_dir
            vt_mag = jnp.linalg.norm(vt, axis=-1)
            jt = jnp.minimum(BALL.friction * f_mag * DT, BALL.mass * vt_mag)
            t_dir = vt / jnp.maximum(vt_mag, 1e-9)[..., None]
            dv_sum = dv_sum - jt[..., None] * t_dir * in_c[..., None] / BALL.mass
        ball_lin = ball_lin + dv_sum
        dl, da = contact.sphere_plane_contact(
            ball_pos, ball_lin, ball_ang, (0.0, 0.0, 1.0), 0.0026, BALL, DT
        )
        ball_lin, ball_ang = ball_lin + dl, ball_ang + da
        ball_pos = ball_pos + ball_lin * DT

        # ---- FEM gels deform against the (new) ball
        aim = maths.transform_points(mount_local[None], pos, quats)  # (2, A, 3)
        scene = RigidSdfScene(
            spheres=jnp.broadcast_to(
                jnp.concatenate([ball_pos[0], jnp.array([BALL.radius])])[None, None], (2, 1, 4)
            ),
            boxes=jnp.zeros((2, 1, 10)), capsules=jnp.zeros((2, 1, 8)),
            planes=jnp.zeros((2, 1, 4)),
        )
        gel_state = gel.step(gel_state, scene, aim)
        grip = jnp.linalg.norm(f_gel, axis=-1).sum()
        return arm, gel_state, ball_pos, ball_lin, ball_ang, grip

    @jax.jit
    def finger_tactile(sstate, gel_state, arm):
        pos, quats = finger_frames(arm.q)
        # depth = gel contact face distance from each finger's virtual camera
        # (sitting 0.0285 m behind the contact face along local -y)
        face_world = gel_state.x[:, jnp.asarray(grid_ids.reshape(-1))]  # (2, G, 3)
        face_local = maths.quat_apply_inverse(quats[:, None], face_world - pos[:, None])
        depth_grid = (face_local[..., 1] + 0.0285).reshape(2, *grid_ids.shape)
        depth = jax.image.resize(depth_grid, (2, 72, 96), method="linear")
        return sensor.update(sstate, depth)

    grasp_z = float(BALL_POS0[2])
    # pad centers carry the gel CONTACT FACE (local y=0): width so each face
    # presses 1.5 mm into the ball
    grip_w = 2 * BALL.radius - 0.003
    phases = [
        ("approach", np.array([*BALL_POS0[:2], grasp_z + 0.10]), 0.06),
        ("descend", np.array([*BALL_POS0[:2], grasp_z]), 0.06),
        ("close", np.array([*BALL_POS0[:2], grasp_z]), grip_w),
        ("lift", np.array([*BALL_POS0[:2], grasp_z + 0.06]), grip_w),
    ]
    gel_state = gel_world_state(arm.q)
    frames = []
    prev_goal, prev_width = None, 0.06
    for name, goal, width in phases:
        for k in range(args.steps_per_phase):
            frac = min(1.0, (k + 1) / (0.6 * args.steps_per_phase))
            if prev_goal is not None:
                g = prev_goal + frac * (goal - prev_goal)
            else:
                g = goal
            w = prev_width + frac * (width - prev_width)
            qt_arm = ik_target(arm, jnp.asarray(g)[None])
            q_target = jnp.concatenate([qt_arm, jnp.full((1, 2), w / 2)], -1)
            arm, gel_state, ball_pos, ball_lin, ball_ang, grip = physics(
                arm, gel_state, ball_pos, ball_lin, ball_ang, q_target
            )
        prev_goal, prev_width = goal, width
        sstate, out = finger_tactile(sstate, gel_state, arm)
        frames.append(np.concatenate(list(np.asarray(out["tactile_rgb"])), axis=0))
        pads_dbg, tcp_dbg, _ = art.finger_positions(arm.q)
        print(
            f"{name:9s}: ball z={float(ball_pos[0, 2]):.3f} grip|f|={float(grip):.2f} N "
            f"indent={np.asarray(out['indentation_depth']).round(2)} "
            f"tcp={np.asarray(tcp_dbg[0]).round(4)} ball={np.asarray(ball_pos[0]).round(4)} "
            f"qf={np.asarray(arm.q[0, 7:]).round(4)}"
        )

    lifted = float(ball_pos[0, 2]) - float(BALL_POS0[2])
    print(f"ball lifted {lifted*100:.1f} cm (FEM gels)")
    strip = (np.concatenate(frames, axis=1) * 255).astype(np.uint8)
    try:
        from PIL import Image

        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(strip).save(args.out)
        print(f"saved {args.out}")
    except ImportError:
        np.save(args.out + ".npy", strip)
    assert lifted > 0.02, f"grasp failed: ball only rose {lifted*100:.1f} cm"


if __name__ == "__main__":
    main()
