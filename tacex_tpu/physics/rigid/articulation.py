"""Second-order Franka + gripper dynamics: mass matrix, gravity, torque PD.

Batched JAX replacement for the PhysX articulation the reference Factory
tasks control at torque level (reference
source/tacex_tasks/tacex_tasks/factory/factory_control.py:19-93
``compute_dof_torque``: operational-space task wrench -> joint torques +
gravity handling, on a Franka with an actuated two-finger gripper,
franka_gsmini_single_uipc.py:29-108).

Model: the 7 revolute arm joints plus 2 prismatic finger joints (9 DOF).
  * mass matrix M(q) from per-link CoM Jacobians
        M = sum_i m_i J_v_i^T J_v_i + J_w_i^T (R_i I_i R_i^T) J_w_i
    — all einsums, batched; no Featherstone recursion needed
    at n=9.
  * gravity torque as the EXACT gradient of potential energy via jax.grad
    (guaranteed consistent with the kinematics — no hand-derived RNEA).
  * torque-level PD with gravity compensation + external J^T wrenches,
    semi-implicit Euler integration. Coriolis/centrifugal terms are omitted
    (standard RL-sim abstraction at the low joint speeds of these tasks).

Inertial parameters: identified values published for the Panda (Gaz et al.,
"Dynamic Identification of the Franka Emika Panda Robot...", RA-L 2019; the
same numbers ship in the public franka_description URDF).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ...core import maths
from . import franka

NUM_DOF = 9  # 7 arm + 2 prismatic fingers
GRAVITY = 9.81

# link masses (kg): links 1..7, hand, finger (each)
_MASSES = jnp.array(
    [4.970684, 0.646926, 3.228604, 3.587895, 1.225946, 1.666555, 0.735522],
    jnp.float32,
)
_HAND_MASS = 0.73
_FINGER_MASS = 0.015

# CoM in each link's modified-DH frame (Gaz et al. Table / URDF values)
_COMS = jnp.array(
    [
        [3.875e-03, 2.081e-03, -0.1750],
        [-3.141e-03, -2.872e-02, 3.495e-03],
        [2.7518e-02, 3.9252e-02, -6.6502e-02],
        [-5.317e-02, 1.04419e-01, 2.7454e-02],
        [-1.1953e-02, 4.1065e-02, -3.8437e-02],
        [6.0149e-02, -1.4117e-02, -1.0517e-02],
        [1.0517e-02, -4.252e-03, 6.1597e-02],
    ],
    jnp.float32,
)
_HAND_COM = jnp.array([-0.01, 0.0, 0.03], jnp.float32)  # in the hand frame

# rotational inertia tensors about each link CoM, link frame (kg m^2)
_I_XX_ETC = [
    # (Ixx, Ixy, Ixz, Iyy, Iyz, Izz)
    (7.0337e-01, -1.3900e-04, 6.7720e-03, 7.0661e-01, 1.9169e-02, 9.1170e-03),
    (7.9620e-03, -3.9250e-03, 1.0254e-02, 2.8110e-02, 7.0400e-04, 2.5995e-02),
    (3.7242e-02, -4.7610e-03, -1.1396e-02, 3.6155e-02, -1.2805e-02, 1.0830e-02),
    (2.5853e-02, 7.7960e-03, -1.3320e-03, 1.9552e-02, 8.6410e-03, 2.8323e-02),
    (3.5549e-02, -2.1170e-03, -4.0370e-03, 2.9474e-02, 2.2900e-04, 8.6270e-03),
    (1.9640e-03, 1.0900e-04, -1.1580e-03, 4.3540e-03, 3.4100e-04, 5.4330e-03),
    (1.2516e-02, -4.2800e-04, -1.1960e-03, 1.0027e-02, -7.4100e-04, 4.8150e-03),
]


def _sym(ixx, ixy, ixz, iyy, iyz, izz):
    return jnp.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]], jnp.float32)


_INERTIAS = jnp.stack([_sym(*row) for row in _I_XX_ETC])  # (7, 3, 3)
_HAND_INERTIA = jnp.diag(jnp.array([1e-3, 2.5e-3, 1.7e-3], jnp.float32))

# hand geometry: flange -> grasp frame, finger slide axis = hand y
HAND_TCP_OFFSET = 0.1034  # flange to grasp center along flange z
FINGER_Z_OFFSET = 0.0584  # flange to finger base
FINGER_TRAVEL = (0.0, 0.04)  # prismatic range per finger (m)
FINGER_FORCE_LIMIT = 70.0  # N, per finger

Q_LOWER = jnp.concatenate([franka.Q_LOWER, jnp.array([FINGER_TRAVEL[0]] * 2, jnp.float32)])
Q_UPPER = jnp.concatenate([franka.Q_UPPER, jnp.array([FINGER_TRAVEL[1]] * 2, jnp.float32)])

# default joint PD gains: arm after the reference HIGH_PD configs
# (stiffness 400 / damping 80, franka_gsmini_single_uipc.py), fingers stiff
DEFAULT_KP = jnp.array([400.0] * 4 + [100.0] * 3 + [4000.0] * 2, jnp.float32)
DEFAULT_KD = jnp.array([80.0] * 4 + [20.0] * 3 + [80.0] * 2, jnp.float32)
TAU_LIMIT = jnp.array([87.0] * 4 + [12.0] * 3 + [FINGER_FORCE_LIMIT] * 2, jnp.float32)


def _link_frames(q7: jax.Array):
    """All link frames for one configuration. q7: (7,).

    Returns (origins (7,3), rots (7,3,3), hand_pos (3,), hand_rot (3,3)).
    """
    rot = jnp.eye(3, dtype=q7.dtype)
    pos = jnp.zeros(3, q7.dtype)
    origins, rots = [], []
    for i in range(franka.NUM_JOINTS):
        a, d, alpha = franka._DH[i]
        r_i, t_i = franka._mdh_transform(a, d, alpha, q7[i])
        pos = pos + rot @ t_i
        rot = rot @ r_i
        origins.append(pos)
        rots.append(rot)
    hand_pos = pos + franka.FLANGE_OFFSET * rot[:, 2]
    return jnp.stack(origins), jnp.stack(rots), hand_pos, rot


def finger_positions(q9: jax.Array):
    """World positions of the two finger-pad centers. q9: (..., 9)."""

    def one(q):
        _, _, hand_pos, hand_rot = _link_frames(q[:7])
        base = hand_pos + hand_rot @ jnp.array([0.0, 0.0, HAND_TCP_OFFSET], q.dtype)
        y = hand_rot[:, 1]
        return jnp.stack([base + q[7] * y, base - q[8] * y]), base, hand_rot

    batch = q9.shape[:-1]
    flat = q9.reshape(-1, NUM_DOF)
    f, b, r = jax.vmap(one)(flat)
    return (
        f.reshape(batch + (2, 3)),
        b.reshape(batch + (3,)),
        r.reshape(batch + (3, 3)),
    )


def potential_energy(q9: jax.Array) -> jax.Array:
    """Scalar gravitational potential of all links + hand + fingers. q9: (9,)."""
    origins, rots, hand_pos, hand_rot = _link_frames(q9[:7])
    coms_w = origins + jnp.einsum("lij,lj->li", rots, _COMS)
    u = (_MASSES * coms_w[:, 2]).sum()
    hand_com = hand_pos + hand_rot @ _HAND_COM
    u = u + _HAND_MASS * hand_com[2]
    fbase = hand_pos + hand_rot @ jnp.array([0.0, 0.0, FINGER_Z_OFFSET], q9.dtype)
    y = hand_rot[:, 1]
    u = u + _FINGER_MASS * ((fbase + q9[7] * y)[2] + (fbase - q9[8] * y)[2])
    return GRAVITY * u


# exact gravity torque: dU/dq (consistent with kinematics by construction)
_grav_single = jax.grad(potential_energy)


def gravity_torque(q9: jax.Array) -> jax.Array:
    """(..., 9) joint torques that gravity exerts (add +g_comp to cancel)."""
    batch = q9.shape[:-1]
    return jax.vmap(_grav_single)(q9.reshape(-1, NUM_DOF)).reshape(batch + (NUM_DOF,))


def _mass_matrix_single(q9: jax.Array) -> jax.Array:
    origins, rots, hand_pos, hand_rot = _link_frames(q9[:7])
    axes = rots[:, :, 2]  # (7, 3) revolute axes
    dof_idx = jnp.arange(franka.NUM_JOINTS)

    def body_jacobians(com_w, n_active):
        """6x9 CoM jacobian for a body rigidly attached after arm joint n."""
        active = (dof_idx < n_active)[:, None]
        jv_arm = jnp.where(active, jnp.cross(axes, com_w[None] - origins), 0.0)
        jw_arm = jnp.where(active, axes, 0.0)
        jv = jnp.concatenate([jv_arm, jnp.zeros((2, 3), q9.dtype)])  # (9, 3)
        jw = jnp.concatenate([jw_arm, jnp.zeros((2, 3), q9.dtype)])
        return jv, jw

    M = jnp.zeros((NUM_DOF, NUM_DOF), q9.dtype)
    # arm links
    coms_w = origins + jnp.einsum("lij,lj->li", rots, _COMS)
    for i in range(franka.NUM_JOINTS):
        jv, jw = body_jacobians(coms_w[i], i + 1)
        I_w = rots[i] @ _INERTIAS[i] @ rots[i].T
        M = M + _MASSES[i] * jv @ jv.T + jw @ I_w @ jw.T
    # hand (rigid after joint 7)
    hand_com = hand_pos + hand_rot @ _HAND_COM
    jv, jw = body_jacobians(hand_com, 7)
    I_w = hand_rot @ _HAND_INERTIA @ hand_rot.T
    M = M + _HAND_MASS * jv @ jv.T + jw @ I_w @ jw.T
    # fingers: point masses on their prismatic DOFs
    fbase = hand_pos + hand_rot @ jnp.array([0.0, 0.0, FINGER_Z_OFFSET], q9.dtype)
    y = hand_rot[:, 1]
    for k, sgn in ((7, 1.0), (8, -1.0)):
        com = fbase + sgn * q9[k] * y
        jv, _ = body_jacobians(com, 7)
        jv = jv.at[k].set(sgn * y)
        M = M + _FINGER_MASS * jv @ jv.T
    # rotor/transmission inertia floor keeps M well-conditioned
    return M + jnp.diag(jnp.full((NUM_DOF,), 3e-3, q9.dtype))


def mass_matrix(q9: jax.Array) -> jax.Array:
    """(..., 9, 9) symmetric positive-definite joint-space mass matrix."""
    batch = q9.shape[:-1]
    return jax.vmap(_mass_matrix_single)(q9.reshape(-1, NUM_DOF)).reshape(
        batch + (NUM_DOF, NUM_DOF)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GripperArmState:
    """Batched 9-DOF state (7 arm + 2 finger joints)."""

    q: jax.Array  # (N, 9)
    qd: jax.Array  # (N, 9)
    q_target: jax.Array  # (N, 9)

    @staticmethod
    def init(num_envs: int, q0_arm: jax.Array | None = None, finger_width: float = 0.04):
        qa = jnp.broadcast_to(
            franka.Q_DEFAULT if q0_arm is None else q0_arm, (num_envs, 7)
        ).astype(jnp.float32)
        qf = jnp.full((num_envs, 2), finger_width / 2, jnp.float32)
        q = jnp.concatenate([qa, qf], -1)
        return GripperArmState(q=q, qd=jnp.zeros_like(q), q_target=q)

    @property
    def arm(self) -> franka.ArmState:
        """View as the 7-DOF ArmState API (kinematics helpers reuse)."""
        return franka.ArmState(self.q[:, :7], self.qd[:, :7], self.q_target[:, :7])


def pd_torque(
    state: GripperArmState,
    kp: jax.Array = DEFAULT_KP,
    kd: jax.Array = DEFAULT_KD,
    gravity_comp: bool = True,
) -> jax.Array:
    """Joint PD torque toward q_target with optional gravity compensation
    (the reference robots run PD + disabled gravity; HIGH_PD semantics)."""
    tau = kp * (state.q_target - state.q) - kd * state.qd
    if gravity_comp:
        tau = tau + gravity_torque(state.q)
    return jnp.clip(tau, -TAU_LIMIT, TAU_LIMIT)


def dynamics_step(
    state: GripperArmState,
    tau: jax.Array,  # (N, 9) applied joint torque (incl. any J^T F external)
    dt: float,
    substeps: int = 2,
    gravity: bool = True,
) -> GripperArmState:
    """Semi-implicit Euler: qdd = M(q)^-1 (tau - g(q)); qd += dt qdd; q += dt qd.

    gravity=False models perfect gravity compensation (the reference robots
    run with arm gravity disabled, franka HIGH_PD configs). Adding g(q0) to
    tau instead is NOT equivalent: tau is held over the substeps while g(q)
    moves, and the lag term -dg/dq acts as an undamped anti-spring of tens
    of N m/rad that destabilizes torque control.
    """
    h = dt / substeps
    q, qd = state.q, state.qd
    for _ in range(substeps):
        M = mass_matrix(q)
        rhs = tau - gravity_torque(q) if gravity else tau
        qdd = jnp.linalg.solve(M, rhs[..., None])[..., 0]
        qd = qd + h * qdd
        qd = qd.at[:, :7].set(jnp.clip(qd[:, :7], -franka.QD_LIMIT, franka.QD_LIMIT))
        qd = qd.at[:, 7:].set(jnp.clip(qd[:, 7:], -0.2, 0.2))
        q = jnp.clip(q + h * qd, Q_LOWER, Q_UPPER)
        # joint-limit contact: zero the velocity into an active limit
        at_lo = (q <= Q_LOWER + 1e-9) & (qd < 0)
        at_hi = (q >= Q_UPPER - 1e-9) & (qd > 0)
        qd = jnp.where(at_lo | at_hi, 0.0, qd)
    return GripperArmState(q=q, qd=qd, q_target=state.q_target)


def step(
    state: GripperArmState,
    dt: float,
    kp: jax.Array = DEFAULT_KP,
    kd: jax.Array = DEFAULT_KD,
    tau_ext: jax.Array | None = None,
    gravity_comp: bool = True,
    substeps: int = 2,
) -> GripperArmState:
    """PD-controlled dynamics step with IMPLICIT gain handling.

    The PD terms are evaluated at the end-of-step state:
        (M + h D + h^2 K) qd' = M qd + h (K (q_target - q) + tau_ext [- g])
    which is unconditionally stable for arbitrarily stiff actuator gains
    (the finger drive runs kp=4000 on a 15 g slider — explicit PD at
    h=1/240 s would limit-cycle). Torque limits are enforced by clamping
    the position error the spring may act on.
    """
    h = dt / substeps
    q, qd = state.q, state.qd
    for _ in range(substeps):
        M = mass_matrix(q)
        err = state.q_target - q
        err = jnp.clip(err, -TAU_LIMIT / kp, TAU_LIMIT / kp)
        rhs = kp * err
        if not gravity_comp:
            rhs = rhs - gravity_torque(q)
        if tau_ext is not None:
            rhs = rhs + tau_ext
        A = M + jnp.diag(h * kd + h * h * kp)
        qd = jnp.linalg.solve(A, (jnp.einsum("nij,nj->ni", M, qd) + h * rhs)[..., None])[..., 0]
        qd = qd.at[:, :7].set(jnp.clip(qd[:, :7], -franka.QD_LIMIT, franka.QD_LIMIT))
        qd = qd.at[:, 7:].set(jnp.clip(qd[:, 7:], -0.2, 0.2))
        q = jnp.clip(q + h * qd, Q_LOWER, Q_UPPER)
        at_lo = (q <= Q_LOWER + 1e-9) & (qd < 0)
        at_hi = (q >= Q_UPPER - 1e-9) & (qd > 0)
        qd = jnp.where(at_lo | at_hi, 0.0, qd)
    return GripperArmState(q=q, qd=qd, q_target=state.q_target)


def ee_wrench_to_tau(
    q9: jax.Array, wrench: jax.Array, ee_offset_pos: jax.Array | None = None
) -> jax.Array:
    """Map a (N, 6) [force; torque] wrench at the tool point to (N, 9) joint
    torques via J^T (fingers get zero — the wrench acts on the hand)."""
    ee_pos, _, origins, axes = franka.forward_kinematics(
        q9[:, :7], ee_offset_pos=ee_offset_pos
    )
    jac = franka.geometric_jacobian(ee_pos, origins, axes)  # (N, 6, 7)
    tau_arm = jnp.einsum("nij,ni->nj", jac, wrench)
    return jnp.concatenate([tau_arm, jnp.zeros(q9.shape[:-1] + (2,), q9.dtype)], -1)


def operational_space_tau(
    state: GripperArmState,
    target_pos: jax.Array,  # (N, 3)
    target_quat: jax.Array,  # (N, 4)
    task_kp: jax.Array,  # (6,) task-space gains
    task_kd: jax.Array,  # (6,)
    ee_offset_pos: jax.Array | None = None,
    null_damping: float = 1.5,
) -> jax.Array:
    """Operational-space PD torque (reference factory_control.py:19-93):
    tau = J^T (kp * pose_err - kd * ee_vel) - kd_null * qd + gravity comp.

    The joint-space damping term stabilizes the Jacobian null space — pure
    J^T control leaves internal motions undamped and the elbow/wrist spin up
    to their velocity limits.
    """
    ee_pos, ee_quat, origins, axes = franka.forward_kinematics(
        state.q[:, :7], ee_offset_pos=ee_offset_pos
    )
    jac = franka.geometric_jacobian(ee_pos, origins, axes)
    ee_vel = jnp.einsum("nij,nj->ni", jac, state.qd[:, :7])
    rot_err = maths.axis_angle_from_quat(
        maths.quat_mul(target_quat, maths.quat_conjugate(ee_quat))
    )
    err = jnp.concatenate([target_pos - ee_pos, rot_err], -1)
    wrench = task_kp * err - task_kd * ee_vel
    tau = ee_wrench_to_tau(state.q, wrench, ee_offset_pos)
    tau = tau.at[:, :7].add(-null_damping * state.qd[:, :7])
    # NOTE: no gravity term here — integrate with dynamics_step(gravity=False)
    # (perfect compensation; see dynamics_step docstring for why adding g(q0)
    # to a zero-order-held torque is unstable)
    return tau


def osc_step(
    state: GripperArmState,
    target_pos: jax.Array,  # (N, 3)
    target_quat: jax.Array,  # (N, 4)
    task_kp: jax.Array,  # (6,)
    task_kd: jax.Array,  # (6,)
    dt: float,
    tau_ext: jax.Array | None = None,  # (N, 9) e.g. grasp reaction via J^T
    ee_offset_pos: jax.Array | None = None,
    null_damping: float = 1.5,
    substeps: int = 2,
) -> GripperArmState:
    """Operational-space-controlled dynamics step with IMPLICIT damping.

    The task damping J^T diag(kd) J lands ~10 N m s/rad on the wrist joints
    whose inertia is ~0.01 kg m^2 — explicitly integrated that diverges at
    any practical dt (c/m * h >> 2). Here the damping matrix and the finger
    joint PD are folded into the left-hand side (MuJoCo-implicitfast style):

      (M + h (J^T D J + D_null + D_f) + h^2 K_f) qd' =
            M qd + h (J^T kp err + K_f (qt_f - q_f) + tau_ext)

    Gravity is treated as perfectly compensated (reference HIGH_PD configs
    disable arm gravity).
    """
    h = dt / substeps
    q, qd = state.q, state.qd
    n = q.shape[0]
    kp_f = DEFAULT_KP[7:]
    kd_f = DEFAULT_KD[7:]
    d_joint = jnp.concatenate([jnp.full((7,), null_damping), kd_f])
    k_diag = jnp.concatenate([jnp.zeros((7,)), kp_f])
    for _ in range(substeps):
        ee_pos, ee_quat, origins, axes = franka.forward_kinematics(
            q[:, :7], ee_offset_pos=ee_offset_pos
        )
        jac7 = franka.geometric_jacobian(ee_pos, origins, axes)  # (N, 6, 7)
        jac = jnp.concatenate([jac7, jnp.zeros((n, 6, 2), q.dtype)], -1)  # (N, 6, 9)
        rot_err = maths.axis_angle_from_quat(
            maths.quat_mul(target_quat, maths.quat_conjugate(ee_quat))
        )
        err = jnp.concatenate([target_pos - ee_pos, rot_err], -1)
        tau = jnp.einsum("nij,ni->nj", jac, task_kp * err)
        tau = tau + k_diag * (state.q_target - q)
        if tau_ext is not None:
            tau = tau + tau_ext
        M = mass_matrix(q)
        C = jnp.einsum("nij,i,nik->njk", jac, task_kd, jac)  # J^T D J
        A = M + h * (C + jnp.diag(d_joint)) + (h * h) * jnp.diag(k_diag)
        rhs = jnp.einsum("nij,nj->ni", M, qd) + h * tau
        qd = jnp.linalg.solve(A, rhs[..., None])[..., 0]
        qd = qd.at[:, :7].set(jnp.clip(qd[:, :7], -franka.QD_LIMIT, franka.QD_LIMIT))
        qd = qd.at[:, 7:].set(jnp.clip(qd[:, 7:], -0.2, 0.2))
        q = jnp.clip(q + h * qd, Q_LOWER, Q_UPPER)
        at_lo = (q <= Q_LOWER + 1e-9) & (qd < 0)
        at_hi = (q >= Q_UPPER - 1e-9) & (qd > 0)
        qd = jnp.where(at_lo | at_hi, 0.0, qd)
    return GripperArmState(q=q, qd=qd, q_target=state.q_target)
