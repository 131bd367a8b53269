"""Batched Affine Body Dynamics (ABD) with IPC barrier contact.

Batched counterpart of libuipc's ``AffineBodyConstitution`` +
``RotatingMotor`` / ``SoftTransformConstraint`` (reference scope:
source/tacex_uipc/examples/libuipc-samples/*.py — hello_libuipc, walking
cube, wrecking balls, ramp sliding, screw&nut all run on these; and
uipc_sim.py:23-26 lists AffineBodyConstitution among the supported
constitutions). Design, re-thought for XLA:

  * Each body is 12 generalized DOFs ``q = [t | a1 | a2 | a3]`` (translation
    + rows of the affine matrix A); vertices embed as x_i = A p_i + t.
    A scene of B bodies is a single (B*12,) unknown — the implicit Euler
    incremental potential is minimized with a DENSE Newton solve
    (``jax.hessian`` + ``jnp.linalg.solve``): for B <= ~32 the Hessian is a
    few-hundred-square matrix, and envs are vmapped so the batch dimension
    keeps the device busy. No sparse assembly, no CUDA
    kernel zoo (libuipc's ABD pipeline) — one fused autodiff energy.
  * Orthogonality ("rigidity") energy: kappa * V * ||A^T A - I||_F^2 — the
    standard ABD shape potential; kappa plays the role of the reference's
    per-body stiffness argument (abd.apply_to(mesh, 100 MPa)).
  * Contact: IPC log-barrier on (a) analytic scene SDFs (ground plane etc.)
    for every surface vertex, and (b) body-vs-body vertex-triangle distances
    over a fixed-capacity K-nearest candidate set (same static-shape broad
    phase as the FEM solver's self-contact) — no BVH, no dynamic pair lists.
  * Friction: IPC-style lagged Coulomb against scene SDFs (normal force
    magnitude frozen at the step's start).
  * Constraints: ``SoftTransformConstraint`` is a quadratic pull of q toward
    a target q* weighted by the body mass matrix; ``RotatingMotor`` is the
    same with q* advanced by a rotation each step (see ``rotate_target``).
    Strength 0 disables per body — all static shapes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

import jax
import jax.numpy as jnp

from ...core.config import configclass
from ...ops import sdf as sdf_ops
from .ipc import (
    RigidSdfScene,
    _edge_edge_distance,
    _edge_pair_crossed,
    _point_triangle_closest,
    _point_triangle_distance,
    _segment_crosses_moving_triangle,
    barrier_extended,
    barrier_force_mag,
    edge_edge_mollifier,
    full_f32_solve,
)


@configclass
class AbdSolverCfg:
    dt: float = 0.01
    gravity: tuple = (0.0, 0.0, -9.81)
    newton_max_iter: int = 8
    line_search_iters: int = 10
    velocity_tol: float = 0.01  # m/s — generalized step rate convergence
    d_hat: float = 0.001
    kappa_contact: float = 1e4
    friction_mu: float = 0.5
    eps_velocity: float = 0.01
    contact_k: int = 8  # body-body candidate triangles per surface vertex (0 = off)
    # body-body EDGE-EDGE candidate edges per surface edge (0 = off).
    # Vertex-triangle pairs alone hop thin features that meet edge-on
    # (crossed rods, box edges, thread crests — the round-2 gap); real IPC
    # resolves PT and EE pairs (libuipc's BVH pipeline, SURVEY §2.2 row 1).
    # Barriers use the standard clamped segment-segment distance weighted by
    # the parallel-edge mollifier (ipc.edge_edge_mollifier).
    ee_contact_k: int = 4
    hessian_reg: float = 1e-6  # Tikhonov floor for the dense Newton solve
    # "dense": jax.hessian + jnp.linalg.solve — one batched (12B)^2 LU in
    # place of CG's 32 sequential hvp evaluations at B<=~32 bodies; BOTH
    # paths vmap over envs, so there is no separate "batched RL-scale
    # path". Which one is faster on the GPU is not measured. "cg":
    # matrix-free conjugate gradient on Hessian-vector products with a
    # per-body 12x12 block preconditioner (inertia + orthogonality +
    # constraint, inverted once per step) — kept for body counts where the
    # O((12B)^2) Hessian autodiff would outgrow memory (hundreds of bodies),
    # beyond any shipped scene.
    linear_solver: str = "dense"
    cg_iters: int = 32
    # assemble the Newton Hessian analytically (J^T G J structure, see
    # _assemble_hessian) instead of jax.hessian. Verified identical to 1e-7;
    # off by default: the fused 144-tangent autodiff Hessian is one large
    # program where this path is many small per-pair Hessians. Not measured
    # on the GPU.
    analytic_hessian: bool = False


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AbdState:
    q: jax.Array  # (N, B, 12): [t(3), a1(3), a2(3), a3(3)] per body
    qd: jax.Array  # (N, B, 12)

    @staticmethod
    def identity(num_envs: int, num_bodies: int, offsets: np.ndarray | None = None) -> "AbdState":
        q0 = np.zeros((num_bodies, 12), np.float32)
        q0[:, 3] = q0[:, 7] = q0[:, 11] = 1.0  # A = I
        if offsets is not None:
            q0[:, :3] = offsets
        q = jnp.broadcast_to(jnp.asarray(q0), (num_envs, num_bodies, 12))
        return AbdState(q=q, qd=jnp.zeros_like(q))


def q_to_affine(q: jax.Array) -> tuple[jax.Array, jax.Array]:
    """q (..., 12) -> (A (..., 3, 3), t (..., 3))."""
    t = q[..., :3]
    A = q[..., 3:].reshape(q.shape[:-1] + (3, 3))
    return A, t


def embed_points(q: jax.Array, pts: jax.Array) -> jax.Array:
    """x = A p + t. q: (..., 12); pts: (V, 3) -> (..., V, 3)."""
    A, t = q_to_affine(q)
    return jnp.einsum("...ij,vj->...vi", A, pts) + t[..., None, :]


def rotate_target(q_star: jax.Array, axis: jax.Array, angle: float | jax.Array) -> jax.Array:
    """RotatingMotor semantics: advance a target affine by a rotation about
    ``axis`` through the body's own origin (reference 5_walking_cube:100,
    8_screw_and_nut:81 — motor_rot_vel * dt per step)."""
    axis = axis / jnp.linalg.norm(axis)
    c, s = jnp.cos(angle), jnp.sin(angle)
    K = jnp.array(
        [[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]], [-axis[1], axis[0], 0.0]]
    )
    R = jnp.eye(3) + s * K + (1 - c) * (K @ K)
    A, t = q_to_affine(q_star)
    A_new = R @ A
    return jnp.concatenate([t, A_new.reshape(q_star.shape[:-1] + (9,))], -1)


class AbdModel:
    """Static scene topology: B affine bodies with fixed surface meshes.

    Args:
      points: list of (V_b, 3) rest vertices per body (LOCAL frame).
      triangles: list of (T_b, 3) surface triangle indices per body.
      mass_density: scalar or per-body list (kg/m^3; volume from the surface
        mesh via divergence theorem).
      kappa_ortho: scalar or per-body — the AffineBodyConstitution stiffness
        (Pa-like; reference samples use 1e7..1e8).
    """

    def __init__(
        self,
        points: list[np.ndarray],
        triangles: list[np.ndarray],
        mass_density=1000.0,
        kappa_ortho=1e7,
        cfg: AbdSolverCfg | None = None,
    ):
        self.cfg = cfg or AbdSolverCfg()
        B = len(points)
        self.num_bodies = B
        dens = np.broadcast_to(np.asarray(mass_density, np.float64), (B,))
        kap = np.broadcast_to(np.asarray(kappa_ortho, np.float64), (B,))

        all_pts, all_tris, body_of_vert, body_of_tri = [], [], [], []
        M_blocks, grav_force, volumes = [], [], []
        off = 0
        for b, (P, T) in enumerate(zip(points, triangles)):
            P = np.asarray(P, np.float64)
            T = np.asarray(T, np.int64)
            vol, com, C = _mesh_moments(P, T)
            vol = max(vol, 1e-12)
            m = dens[b] * vol
            volumes.append(vol)
            # vertex-lumped surrogate masses reproducing the exact integral
            # moments is overkill; ABD only needs the 12x12 generalized mass:
            # M = [[ m I,            (m c)^T kron I ],
            #      [ m c kron I,     Sigma kron I   ]]   with Sigma = dens * C
            Sig = dens[b] * C  # second moment ∫ rho p p^T
            mc = m * com
            M = np.zeros((12, 12))
            M[:3, :3] = m * np.eye(3)
            for i in range(3):
                M[:3, 3 + 3 * i : 6 + 3 * i] = np.eye(3) * 0.0
            # rows layout: x = A p + t with q = [t, a1, a2, a3] and
            # x_k = t_k + a_k . p  => J_i = d x / d q: x_k depends on t_k and a_k only
            # => M[t_k, t_k] = m; M[t_k, a_k] = (m c)^T; M[a_k, a_k] = Sigma
            for k in range(3):
                rows = slice(3 + 3 * k, 6 + 3 * k)
                M[k, rows] = mc
                M[rows, k] = mc
                M[rows.start : rows.stop, rows.start : rows.stop] = Sig
            M_blocks.append(M)
            # generalized gravity force: f_q = dV/dq of -m g . x(com)
            # x(com) = A c + t  =>  f_t = m g; f_{a_k} = m g_k c
            g_vec = np.asarray(self.cfg.gravity, np.float64)
            f = np.zeros(12)
            f[:3] = m * g_vec
            for k in range(3):
                f[3 + 3 * k : 6 + 3 * k] = m * g_vec[k] * com
            grav_force.append(f)

            all_pts.append(P)
            all_tris.append(T + off)
            body_of_vert.append(np.full(len(P), b))
            body_of_tri.append(np.full(len(T), b))
            off += len(P)

        self.volumes = jnp.asarray(np.asarray(volumes), jnp.float32)
        self.kappa_ortho = jnp.asarray(kap * np.asarray(volumes), jnp.float32)  # (B,)
        self.mass = jnp.asarray(np.stack(M_blocks), jnp.float32)  # (B, 12, 12)
        self.pts = jnp.asarray(np.concatenate(all_pts), jnp.float32)  # (Vt, 3)
        self.tris = jnp.asarray(np.concatenate(all_tris), jnp.int32)  # (Tt, 3)
        self.vert_body = jnp.asarray(np.concatenate(body_of_vert), jnp.int32)  # (Vt,)
        self.tri_body = jnp.asarray(np.concatenate(body_of_tri), jnp.int32)  # (Tt,)
        self._same_body = self.vert_body[:, None] == self.tri_body[None, :]  # (Vt, Tt)
        tri_pts = np.concatenate(all_pts)[np.concatenate(all_tris)]
        self._tri_radius_max = float(
            np.linalg.norm(tri_pts - tri_pts.mean(1, keepdims=True), axis=-1).max()
        )
        self.gravity_q = jnp.asarray(np.stack(grav_force), jnp.float32)  # (B, 12)
        # mass inverse for the free-flight predictor
        self.mass_inv = jnp.asarray(
            np.linalg.inv(np.stack(M_blocks) + 1e-9 * np.eye(12)), jnp.float32
        )
        # unique surface edges (global vertex ids) for edge-edge pairs
        tris_cat = np.concatenate(all_tris)
        e_all = np.concatenate(
            [tris_cat[:, [0, 1]], tris_cat[:, [1, 2]], tris_cat[:, [2, 0]]]
        )
        e_all.sort(axis=1)
        edges = np.unique(e_all, axis=0)
        self.edges = jnp.asarray(edges, jnp.int32)  # (E, 2)
        pts_cat = np.concatenate(all_pts)
        self.edge_body = jnp.asarray(
            np.concatenate(body_of_vert)[edges[:, 0]], jnp.int32
        )  # (E,)
        elen2 = ((pts_cat[edges[:, 1]] - pts_cat[edges[:, 0]]) ** 2).sum(-1)
        self._edge_len2 = jnp.asarray(elen2, jnp.float32)
        self._edge_halflen = jnp.asarray(0.5 * np.sqrt(elen2), jnp.float32)

    # --------------------------------------------------------------- energies
    def world_points(self, q: jax.Array) -> jax.Array:
        """q (B, 12) -> all surface vertices (Vt, 3)."""
        A, t = q_to_affine(q)  # (B, 3, 3), (B, 3)
        return (
            jnp.einsum("vij,vj->vi", A[self.vert_body], self.pts) + t[self.vert_body]
        )

    def _ortho_energy(self, q: jax.Array) -> jax.Array:
        A, _ = q_to_affine(q)
        R = jnp.einsum("bij,bik->bjk", A, A) - jnp.eye(3)
        return jnp.sum(self.kappa_ortho * jnp.sum(R * R, (-2, -1)))

    def _barrier(self, d: jax.Array) -> jax.Array:
        """Summed log-barrier (shared formulation: ipc.barrier_extended)."""
        return self._barrier_scalar(d).sum()

    def _select_candidates(self, x: jax.Array):
        """K nearest OTHER-body triangles per vertex (static shapes)."""
        k = self.cfg.contact_k
        cent = x[self.tris].mean(-2)  # (Tt, 3)
        d2 = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
        d2 = jnp.where(self._same_body, jnp.inf, d2)
        neg, cand = jax.lax.top_k(-d2, k)
        cut = 3.0 * self.cfg.d_hat + self._tri_radius_max
        valid = (-neg) < cut * cut
        return jax.lax.stop_gradient(cand), jax.lax.stop_gradient(valid)

    # ------------------------------------------------- one-hot gather operators
    def _gather_ops(self, cand, ee_cand):
        """Per-step 0/1 gather matrices for the candidate fetches (same
        rationale as CoupledModel._gather_ops: the candidate indices are step
        constants, while the fetch re-executes in every energy/hvp/
        feasibility eval — and jax.hessian multiplies it by 12B tangents on
        the dense path; a tiny one-hot matmul does the fetch)."""
        Vt = self.vert_body.shape[0]
        opTri = opEE = opTB = None
        if cand is not None:
            ci = cand[0]
            opTri = jax.nn.one_hot(
                self.tris[ci].reshape(-1), Vt, dtype=jnp.float32
            )
            opTB = jax.nn.one_hot(
                self.tri_body[ci].reshape(-1), self.num_bodies, dtype=jnp.float32
            )
        if ee_cand is not None:
            opEE = jax.nn.one_hot(
                self.edges[ee_cand[0]].reshape(-1), Vt, dtype=jnp.float32
            )
        return tuple(
            None if o is None else jax.lax.stop_gradient(o)
            for o in (opTri, opEE, opTB)
        )

    def _tri_rows(self, x, ci, ops):
        """(Vt, K, 3, 3) candidate-triangle corners.

        precision=HIGHEST makes the 0/1 matmul an EXACT gather — default
        precision (TF32 on a GPU) rounds the coordinates, injecting error
        into barrier distances and feasibility floors."""
        if ops is None or ops[0] is None:
            return x[self.tris[ci]]
        return jnp.matmul(
            ops[0], x, precision=jax.lax.Precision.HIGHEST
        ).reshape(ci.shape + (3, 3))

    def _ee_rows(self, x, cand, ops):
        """(E, K, 2, 3) candidate-edge endpoints (exact one-hot gather)."""
        if ops is None or ops[1] is None:
            return x[self.edges[cand]]
        return jnp.matmul(
            ops[1], x, precision=jax.lax.Precision.HIGHEST
        ).reshape(cand.shape + (2, 3))

    def _body_rows(self, M, shape2, ops):
        """(Vt, K, ...) per-candidate body rows of M (B, ...)."""
        if ops is None or ops[2] is None:
            return None  # caller falls back to M[tb]
        return jnp.matmul(
            ops[2], M.reshape(M.shape[0], -1),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(shape2 + M.shape[1:])

    def _pair_distances(self, x: jax.Array, cand: jax.Array, ops=None) -> jax.Array:
        tri = self._tri_rows(x, cand, ops)  # (Vt, K, 3, 3)
        return _point_triangle_distance(
            x[:, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
        )

    # ------------------------------------------------- broad-phase accounting
    def broad_phase_overflow(self, x: jax.Array) -> dict[str, jax.Array]:
        """Within-reach candidates dropped past the top-K sets for one env
        (x = world_points(q), (Vt, 3)). See SoftBodyModel.broad_phase_overflow
        for the semantics; families here are body-body VT and EE."""
        c = self.cfg
        out: dict[str, jax.Array] = {}
        if c.contact_k > 0:
            cent = x[self.tris].mean(-2)
            d2 = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
            d2 = jnp.where(self._same_body, jnp.inf, d2)
            cut = 3.0 * c.d_hat + self._tri_radius_max
            within = (d2 < cut * cut).sum(-1)
            out["vt_body"] = jnp.maximum(within - c.contact_k, 0).sum()
        if c.ee_contact_k > 0 and c.contact_k > 0 and self.num_bodies >= 2:
            k = min(c.ee_contact_k, self.edges.shape[0])
            mid = x[self.edges].mean(-2)
            d2 = ((mid[:, None, :] - mid[None]) ** 2).sum(-1)
            mask = self.edge_body[:, None] >= self.edge_body[None, :]
            d2 = jnp.where(mask, jnp.inf, d2)
            cut = (
                3.0 * c.d_hat
                + self._edge_halflen[:, None]
                + self._edge_halflen[None, :]
            )
            within = (d2 < cut * cut).sum(-1)
            out["ee"] = jnp.maximum(within - k, 0).sum()
        return out

    def _pair_closest(self, x: jax.Array, cand: jax.Array, ops=None):
        """(distances (Vt, K), closest points (Vt, K, 3)) for candidates."""
        tri = self._tri_rows(x, cand, ops)
        qp = _point_triangle_closest(
            x[:, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
        )
        d = jnp.sqrt(((x[:, None, :] - qp) ** 2).sum(-1) + 1e-18)
        return d, qp

    # ----------------------------------------------------------- edge-edge
    def _select_ee_candidates(self, x: jax.Array):
        """K nearest HIGHER-body edges per surface edge (each unordered
        body pair contributes its EE pairs once — candidates are restricted
        to edges of bodies with a larger index, so (i,j) and (j,i) never
        both appear)."""
        k = min(self.cfg.ee_contact_k, self.edges.shape[0])
        mid = x[self.edges].mean(-2)  # (E, 3)
        d2 = ((mid[:, None, :] - mid[None]) ** 2).sum(-1)
        mask = self.edge_body[:, None] >= self.edge_body[None, :]
        d2 = jnp.where(mask, jnp.inf, d2)
        neg, cand = jax.lax.top_k(-d2, k)
        cut = 3.0 * self.cfg.d_hat + self._edge_halflen[:, None] + self._edge_halflen[cand]
        valid = (-neg) < cut * cut
        return jax.lax.stop_gradient(cand), jax.lax.stop_gradient(valid)

    def _ee_distances(self, x: jax.Array, cand: jax.Array, ops=None) -> jax.Array:
        pi = x[self.edges]  # (E, 2, 3)
        pj = self._ee_rows(x, cand, ops)  # (E, K, 2, 3)
        return _edge_edge_distance(
            pi[:, None, 0, :], pi[:, None, 1, :], pj[..., 0, :], pj[..., 1, :]
        )

    def _ee_barrier(self, x: jax.Array, ee_cand, ops=None) -> jax.Array:
        """Mollified edge-edge barrier sum (ipc.edge_edge_mollifier)."""
        cand, valid = ee_cand
        c = self.cfg
        pi = x[self.edges]
        pj = self._ee_rows(x, cand, ops)
        d = _edge_edge_distance(
            pi[:, None, 0, :], pi[:, None, 1, :], pj[..., 0, :], pj[..., 1, :]
        )
        eps_x = 1e-3 * self._edge_len2[:, None] * self._edge_len2[cand]
        m = edge_edge_mollifier(
            pi[:, None, 0, :], pi[:, None, 1, :], pj[..., 0, :], pj[..., 1, :], eps_x
        )
        d = jnp.where(valid, d, 10.0 * c.d_hat)
        return jnp.sum(m * barrier_extended(d, c.kappa_contact, c.d_hat))

    def _energy(
        self, q, q_tilde, scene, aim_q, aim_strength, x_prev, friction_basis, cand,
        pair_friction=None, ee_cand=None, ops=None,
    ):
        c = self.cfg
        dq = q - q_tilde
        inertia = (0.5 / c.dt**2) * jnp.sum(dq * jnp.einsum("bij,bj->bi", self.mass, dq))
        ortho = self._ortho_energy(q)
        x = self.world_points(q)
        contact = self._barrier(scene.sdf(x))
        if cand is not None:
            ci, valid = cand
            d_vt = self._pair_distances(x, ci, ops)
            d_vt = jnp.where(valid, d_vt, 10.0 * c.d_hat)
            contact = contact + self._barrier(d_vt)
        if ee_cand is not None:
            contact = contact + self._ee_barrier(x, ee_cand, ops)
        # soft transform / motor constraints: diagonal mass-scaled quadratic
        # with PER-DOF strengths (B, 12). A RotatingMotor constrains only the
        # rotational DOFs (a-rows) and leaves translation free — that is how
        # a motor-driven screw can advance axially through thread contact
        # (libuipc RotatingMotor semantics, 8_screw_and_nut.py:81). The
        # diagonal form keeps the penalty PSD for any nonuniform weights.
        dqa = q - aim_q
        # weight every DOF by the body MASS (reference convention: constraint
        # strength is a ratio of object mass, uipc_attachments.py:36-66). The
        # second-moment diagonal would under-weight the affine DOFs of small
        # bodies by r^2 (~1e-5 for mm-scale parts) and make motors powerless
        # against contact friction.
        m_body = self.mass[:, 0, 0][:, None]  # (B, 1)
        constr = 0.5 * jnp.sum(aim_strength * m_body * dqa * dqa) / c.dt**2
        friction = 0.0
        if friction_basis is not None:
            lam_n, n_dir = friction_basis
            du = x - x_prev
            du_t = du - jnp.sum(du * n_dir, -1, keepdims=True) * n_dir
            s = jnp.sum(du_t**2, -1)
            eps = c.eps_velocity * c.dt
            # True IPC mollifier (quadratic near 0, |u_t| beyond eps), in
            # s = |du_t|^2 with a clamped sqrt argument: finite value, first
            # AND second derivatives everywhere in f32. It must be used for
            # the Hessian too — an unbounded quadratic surrogate makes the
            # Newton model's stick stiffness grow without limit along slip
            # directions and rigid bodies jam solid against any contact.
            f0 = jnp.where(
                s < eps * eps,
                s / (2 * eps) + eps / 2,
                jnp.sqrt(jnp.maximum(s, eps * eps)),
            )
            friction = c.friction_mu * jnp.sum(lam_n * f0)
        if pair_friction is not None:
            # body-body Coulomb friction, lagged like the scene term: the
            # slip at a contact is the RELATIVE displacement of the vertex
            # and the other body's material point at the (frozen) closest
            # location — evaluated through that body's affine DOFs, so no
            # barycentric bookkeeping is needed.
            lam_p, n_p, q_p0, p_local, tb, valid_p = pair_friction
            A, t = q_to_affine(q)
            x = self.world_points(q)
            disp_v = x - x_prev  # (Vt, 3)
            A_tb = self._body_rows(A, tb.shape, ops)
            t_tb = self._body_rows(t, tb.shape, ops)
            if A_tb is None:
                A_tb, t_tb = A[tb], t[tb]
            q_new = jnp.einsum("vkij,vkj->vki", A_tb, p_local) + t_tb
            rel = disp_v[:, None, :] - (q_new - q_p0)
            rel_t = rel - jnp.sum(rel * n_p, -1, keepdims=True) * n_p
            s_p = jnp.sum(rel_t**2, -1)
            eps = c.eps_velocity * c.dt
            f0p = jnp.where(
                s_p < eps * eps,
                s_p / (2 * eps) + eps / 2,
                jnp.sqrt(jnp.maximum(s_p, eps * eps)),
            )
            friction = friction + c.friction_mu * jnp.sum(
                jnp.where(valid_p, lam_p * f0p, 0.0)
            )
        return inertia + ortho + contact + constr + friction

    def _barrier_scalar(self, d):
        """Per-distance log-barrier (shared formulation: ipc.barrier_extended)."""
        return barrier_extended(d, self.cfg.kappa_contact, self.cfg.d_hat)

    def _point_jacobians(self) -> jax.Array:
        """J_v = dx_v/dq_b (Vt, 3, 12): x = A p + t is linear in q, so the
        Jacobian is a CONSTANT sparse pattern [I | p1 I | p2 I | p3 I]
        (row-of-A layout). Cached on first use."""
        if not hasattr(self, "_J_pts"):
            V = self.pts.shape[0]
            J = np.zeros((V, 3, 12), np.float32)
            p = np.asarray(self.pts)
            for i in range(3):
                J[:, i, i] = 1.0
                J[:, i, 3 + 3 * i : 6 + 3 * i] = p
            self._J_pts = jnp.asarray(J)
        return self._J_pts

    def _assemble_hessian(
        self, q, q_tilde, scene, aim_strength, x_prev, friction_basis, cand, pair_friction
    ) -> jax.Array:
        """Analytic (12B, 12B) Hessian of the incremental potential.

        jax.hessian of the full energy is forward-over-reverse with 12B
        tangents, each replaying the whole energy graph. But x = A p + t is
        LINEAR in q, so every energy term's q-Hessian is J^T G J with a
        constant per-point Jacobian J and a SMALL point-space Hessian G
        (3x3 per vertex term, 12x12 per vertex-triangle pair) — each from
        jax.hessian over a tiny closure with 3..15 tangents. All
        contributions are accumulated SCATTER-FREE: 12x12 blocks
        segment-summed by (row body, col body) into a (B, B, 12, 12) grid
        and reshaped, so no scatter runs in the Newton loop.
        """
        c = self.cfg
        B = self.num_bodies
        J = self._point_jacobians()  # (Vt, 3, 12)
        x = self.world_points(q)

        blocks = []  # list of ((n, 12, 12) contributions, (n,) segment ids rb*B+cb)
        diag_ids = jnp.arange(B) * B + jnp.arange(B)

        # 1. inertia + 3. ortho (block diagonal)
        def ortho_b(a_flat, kap):
            A = a_flat.reshape(3, 3)
            R = A.T @ A - jnp.eye(3)
            return kap * jnp.sum(R * R)

        Ho9 = jax.vmap(jax.hessian(ortho_b))(q[:, 3:].reshape(B, 9), self.kappa_ortho)
        Hd = self.mass / c.dt**2
        Hd = Hd.at[:, 3:, 3:].add(Ho9)
        # 2. constraints (diagonal per DOF)
        m_body = self.mass[:, 0, 0][:, None]
        Hd = Hd + jax.vmap(jnp.diag)(aim_strength * m_body / c.dt**2)

        # 4. scene contact + scene friction: per-vertex 3x3 point Hessians
        def phi_scene(p):
            return self._barrier_scalar(scene.sdf(p[None])[0])

        G_c = jax.vmap(jax.hessian(phi_scene))(x)  # (Vt, 3, 3)
        if friction_basis is not None:
            lam_n, n_dir = friction_basis
            eps = c.eps_velocity * c.dt

            def phi_fric(p, p0, n, lam):
                du = p - p0
                du_t = du - jnp.dot(du, n) * n
                s = jnp.sum(du_t**2)
                f0 = jnp.where(
                    s < eps * eps,
                    s / (2 * eps) + eps / 2,
                    jnp.sqrt(jnp.maximum(s, eps * eps)),
                )
                return c.friction_mu * lam * f0

            G_c = G_c + jax.vmap(jax.hessian(phi_fric))(x, x_prev, n_dir, lam_n)
        Hb_c = jnp.einsum("vai,vab,vbj->vij", J, G_c, J)  # (Vt, 12, 12)
        Hd = Hd + jax.ops.segment_sum(Hb_c, self.vert_body, num_segments=B)
        blocks.append((Hd.reshape(B, 144), diag_ids))

        # 5. pair contact: per-(vertex, candidate) 12-point-coordinate Hessian
        if cand is not None:
            ci, valid = cand
            K = ci.shape[1]
            tri_ids = self.tris[ci]  # (Vt, K, 3)

            def psi(pts4):
                d = _point_triangle_distance(pts4[0], pts4[1], pts4[2], pts4[3])
                return self._barrier_scalar(d)

            pts4 = jnp.concatenate(
                [x[:, None, None, :].repeat(K, 1), x[tri_ids]], axis=2
            )
            G12 = jax.vmap(jax.vmap(jax.hessian(psi)))(pts4)  # (Vt, K, 4, 3, 4, 3)
            G12 = jnp.where(valid[:, :, None, None, None, None], G12, 0.0)
            J4 = jnp.stack(
                [
                    jnp.broadcast_to(J[:, None], (J.shape[0], K, 3, 12)),
                    J[tri_ids[..., 0]],
                    J[tri_ids[..., 1]],
                    J[tri_ids[..., 2]],
                ],
                axis=2,
            )  # (Vt, K, 4, 3, 12)
            bodies4 = jnp.stack(
                [
                    jnp.broadcast_to(self.vert_body[:, None], ci.shape),
                    self.tri_body[ci],
                    self.tri_body[ci],
                    self.tri_body[ci],
                ],
                axis=2,
            )  # (Vt, K, 4)
            Hmn = jnp.einsum("vkmai,vkmanb,vknbj->vkmnij", J4, G12, J4)
            ids = bodies4[..., :, None] * B + bodies4[..., None, :]
            blocks.append((Hmn.reshape(-1, 144), ids.reshape(-1)))

        # 6. pair friction: function of (x_v, q_B) — 15-input Hessian
        if pair_friction is not None:
            lam_p, n_p, q_p0, p_local, tb, valid_p = pair_friction
            eps = c.eps_velocity * c.dt

            def chi(z, pv0, n, lam, pl, qp0):
                pv, qB = z[:3], z[3:]
                A_B = qB[3:].reshape(3, 3)
                moved = A_B @ pl + qB[:3]
                rel = (pv - pv0) - (moved - qp0)
                rel_t = rel - jnp.dot(rel, n) * n
                s = jnp.sum(rel_t**2)
                f0 = jnp.where(
                    s < eps * eps,
                    s / (2 * eps) + eps / 2,
                    jnp.sqrt(jnp.maximum(s, eps * eps)),
                )
                return c.friction_mu * lam * f0

            K = tb.shape[1]
            z_all = jnp.concatenate(
                [jnp.broadcast_to(x[:, None, :], (x.shape[0], K, 3)), q[tb]], axis=-1
            )
            Hp15 = jax.vmap(jax.vmap(jax.hessian(chi)))(
                z_all,
                jnp.broadcast_to(x_prev[:, None, :], (x.shape[0], K, 3)),
                n_p, lam_p, p_local, q_p0,
            )  # (Vt, K, 15, 15)
            Hp15 = jnp.where(valid_p[:, :, None, None], Hp15, 0.0)
            Jv = jnp.broadcast_to(J[:, None], (J.shape[0], K, 3, 12))
            Hvv = jnp.einsum("vkai,vkab,vkbj->vkij", Jv, Hp15[..., :3, :3], Jv)
            Hvq = jnp.einsum("vkai,vkaj->vkij", Jv, Hp15[..., :3, 3:])
            Hqq = Hp15[..., 3:, 3:]
            bv = jnp.broadcast_to(self.vert_body[:, None], tb.shape)
            contrib = jnp.stack(
                [Hvv, Hvq, jnp.swapaxes(Hvq, -1, -2), Hqq], axis=2
            )  # (Vt, K, 4, 12, 12)
            ids = jnp.stack(
                [bv * B + bv, bv * B + tb, tb * B + bv, tb * B + tb], axis=2
            )
            blocks.append((contrib.reshape(-1, 144), ids.reshape(-1)))

        all_contrib = jnp.concatenate([b[0] for b in blocks])
        all_ids = jnp.concatenate([b[1] for b in blocks])
        grid = jax.ops.segment_sum(all_contrib, all_ids, num_segments=B * B)
        H = grid.reshape(B, B, 12, 12).transpose(0, 2, 1, 3).reshape(12 * B, 12 * B)
        return H

    # ------------------------------------------------------------- single env
    def _step_single(self, q, qd, scene, aim_q, aim_strength):
        c = self.cfg
        q_tilde = q + c.dt * qd + c.dt**2 * jnp.einsum("bij,bj->bi", self.mass_inv, self.gravity_q)

        x0 = self.world_points(q)
        sdf_fn = scene.sdf
        dh = c.d_hat
        cand = self._select_candidates(x0) if c.contact_k > 0 else None
        ee_cand = (
            self._select_ee_candidates(x0)
            if (c.ee_contact_k > 0 and c.contact_k > 0 and self.num_bodies >= 2)
            else None
        )
        ops = self._gather_ops(cand, ee_cand)
        A0, t0 = q_to_affine(q)  # step-start pose: friction anchors map here
        B = self.num_bodies

        def friction_lag(qf_k, stop=True):
            """Friction quantities from the CURRENT Newton iterate (see
            ipc.py friction_lag — per-iteration re-lagging is the fixed
            point of fully-implicit friction). Slip anchors (p_local) are
            picked at the iterate but their reference world position is the
            STEP-START pose, so the friction displacement spans the whole
            step like the vertex displacement does."""
            if c.friction_mu <= 0:
                return None, None
            q_k = (jax.lax.stop_gradient(qf_k) if stop else qf_k).reshape(B, 12)
            x_k = self.world_points(q_k)
            d = sdf_fn(x_k)
            n = jax.vmap(jax.grad(lambda p: sdf_fn(p[None])[0]))(x_k)
            n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
            fb = (barrier_force_mag(d, c.kappa_contact, dh), n)
            pf = None
            if cand is not None:
                ci, valid = cand
                d_p, q_p = self._pair_closest(x_k, ci, ops)
                lam_p = jnp.where(valid, barrier_force_mag(d_p, c.kappa_contact, dh), 0.0)
                n_p = (x_k[:, None, :] - q_p) / jnp.maximum(d_p, 1e-9)[..., None]
                A_k, t_k = q_to_affine(q_k)
                A_k_inv = jnp.linalg.inv(A_k)
                tb = self.tri_body[ci]  # (Vt, K)

                def rows(M):
                    r = self._body_rows(M, tb.shape, ops)
                    return M[tb] if r is None else r

                p_local = jnp.einsum(
                    "vkij,vkj->vki", rows(A_k_inv), q_p - rows(t_k)
                )
                q_p0 = jnp.einsum("vkij,vkj->vki", rows(A0), p_local) + rows(t0)
                pf = (lam_p, n_p, q_p0, p_local, tb, valid)
            return fb, pf

        def make_energy(friction_basis, pair_friction):
            return lambda qf: self._energy(
                qf.reshape(B, 12), q_tilde, scene, aim_q, aim_strength, x0,
                friction_basis, cand, pair_friction, ee_cand, ops,
            )

        # no-worsening floor when the step starts penetrated by a moved
        # kinematic collider (see ipc._step_single d_floor rationale)
        d_floor = jnp.minimum(sdf_fn(x0).min(), 0.0)
        if ee_cand is not None:
            eci, eval_ = ee_cand
            ee_floor = jnp.minimum(
                0.999 * jnp.where(eval_, self._ee_distances(x0, eci, ops), 1.0).min(),
                1e-7,
            )

        def feasible(qf, qf_from):
            x = self.world_points(qf.reshape(B, 12))
            ok = sdf_fn(x).min() > d_floor
            if cand is not None:
                ci, valid = cand
                d_vt = self._pair_distances(x, ci, ops)
                ok = ok & (jnp.where(valid, d_vt, 1.0).min() > 1e-7)
                # reject trials whose vertices pierce a candidate triangle
                # (unsigned distances cannot detect tunneling); both bodies
                # move, so test in the triangle's co-moving frame
                x_from = self.world_points(qf_from.reshape(B, 12))
                tri = self._tri_rows(x, ci, ops)
                tri0 = self._tri_rows(x_from, ci, ops)
                crossed = _segment_crosses_moving_triangle(
                    x_from[:, None, :], x[:, None, :],
                    tri0[..., 0, :], tri0[..., 1, :], tri0[..., 2, :],
                    tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
                )
                ok = ok & ~(crossed & valid).any()
            if ee_cand is not None:
                eci2, evalid = ee_cand
                d_ee = self._ee_distances(x, eci2, ops)
                ok = ok & (jnp.where(evalid, d_ee, 1.0).min() > ee_floor)
                # EE crossing CCD: unsigned distances cannot see an edge
                # passing through another edge within one trial
                x_from = self.world_points(qf_from.reshape(B, 12))
                pa = x_from[self.edges]
                pja = self._ee_rows(x_from, eci2, ops)
                pb = x[self.edges]
                pjb = self._ee_rows(x, eci2, ops)
                crossed = _edge_pair_crossed(
                    pa[:, None, 0, :], pa[:, None, 1, :],
                    pja[..., 0, :], pja[..., 1, :],
                    pb[:, None, 0, :], pb[:, None, 1, :],
                    pjb[..., 0, :], pjb[..., 1, :],
                )
                ok = ok & ~(crossed & evalid).any()
            return ok

        # straight-through lag: primal from the iterate, tangent from the
        # step-start lag's smooth input dependence — float leaves only
        # (indices/masks pass through; see ipc.py lag_st rationale)
        lag0 = friction_lag(q.reshape(-1), stop=False)

        def lag_st(qf_k):
            if c.friction_mu <= 0:
                return None, None

            def comb(it, s0):
                if not jnp.issubdtype(it.dtype, jnp.floating):
                    return it
                return s0 + jax.lax.stop_gradient(it - s0)

            return jax.tree_util.tree_map(comb, friction_lag(qf_k), lag0)

        # CG preconditioner: per-body 12x12 smooth-part inverse, once per
        # step (inertia + orthogonality at the step start + constraints)
        if c.linear_solver == "cg":

            def ortho_b(a_flat, kap):
                A = a_flat.reshape(3, 3)
                R = A.T @ A - jnp.eye(3)
                return kap * jnp.sum(R * R)

            Hd = self.mass / c.dt**2
            Hd = Hd.at[:, 3:, 3:].add(
                jax.vmap(jax.hessian(ortho_b))(q[:, 3:].reshape(B, 9), self.kappa_ortho)
            )
            m_body = self.mass[:, 0, 0][:, None]
            Hd = Hd + jax.vmap(jnp.diag)(aim_strength * m_body / c.dt**2)
            Hd_inv = jnp.linalg.inv(Hd + 1e-6 * jnp.eye(12))  # (B, 12, 12)

            def precond(r):
                return jnp.einsum("bij,bj->bi", Hd_inv, r.reshape(B, 12)).reshape(-1)

        def newton_iter(_, carry):
            qf, done = carry
            friction_basis, pair_friction = lag_st(qf)
            energy_flat = make_energy(friction_basis, pair_friction)
            grad = jax.grad(energy_flat)(qf)
            if c.linear_solver == "cg":
                hvp = lambda pv: jax.jvp(jax.grad(energy_flat), (qf,), (pv,))[1]

                def cg_body(_, cgc):
                    p_dir, r, zv, xsol = cgc
                    hp = hvp(p_dir)
                    denom = jnp.sum(p_dir * hp)
                    alpha = jnp.where(
                        jnp.abs(denom) > 1e-20, jnp.sum(r * zv) / denom, 0.0
                    )
                    xsol = xsol + alpha * p_dir
                    r_new = r - alpha * hp
                    z_new = precond(r_new)
                    beta = jnp.where(
                        jnp.sum(r * zv) > 1e-20,
                        jnp.sum(r_new * z_new) / jnp.sum(r * zv),
                        0.0,
                    )
                    return (z_new + beta * p_dir, r_new, z_new, xsol)

                r0 = -grad
                z0 = precond(r0)
                _, _, _, p = jax.lax.fori_loop(
                    0, c.cg_iters, cg_body, (z0, r0, z0, jnp.zeros_like(qf))
                )
                descent = jnp.sum(p * grad) < 0
                p = jnp.where(descent, p, -z0)
            else:
                if c.analytic_hessian and ee_cand is None:
                    # the analytic J^T G J assembly predates EE pairs; with
                    # EE active fall back to the (default, measured-faster
                    # at sample scale anyway) fused autodiff Hessian
                    H = self._assemble_hessian(
                        qf.reshape(B, 12), q_tilde, scene, aim_strength, x0,
                        friction_basis, cand, pair_friction,
                    )
                else:
                    H = jax.hessian(energy_flat)(qf)
                # PSD-ify with a PER-DOF relative Tikhonov shift. A
                # max-diagonal scaled identity (reg * maxdiag * I) looks
                # harmless but is not: when stiff barrier contacts push
                # diagonal entries to ~1e10, a uniform shift of 1e4 swamps
                # the SOFT directions (the coupled rotation+advance subspace
                # of a motor-driven screw is ~1e1) and the Newton step
                # collapses to zero there — the body jams solid against any
                # contact. Shifting each DOF relative to its own curvature
                # preserves the soft subspace.
                diag = jnp.abs(jnp.diagonal(H))
                Hr = H + jnp.diag(c.hessian_reg * (1.0 + diag)) + 1e-9 * jnp.eye(12 * B)
                p = -jnp.linalg.solve(Hr, grad)
                descent = jnp.sum(p * grad) < 0
                p = jnp.where(descent, p, -grad / (1.0 + jnp.linalg.norm(grad)))

            e0 = energy_flat(qf)

            def ls_body(_, ls):
                alpha, accepted = ls
                q_try = qf + alpha * p
                ok = (energy_flat(q_try) < e0) & feasible(q_try, qf)
                return (jnp.where(ok | accepted, alpha, alpha * 0.5), ok | accepted)

            alpha, accepted = jax.lax.fori_loop(0, c.line_search_iters, ls_body, (1.0, False))
            alpha = jnp.where(accepted, alpha, 0.0)
            step = alpha * p
            qf_new = jnp.where(done, qf, qf + step)
            done = done | (jnp.abs(step).max() / c.dt < c.velocity_tol)
            return (qf_new, done)

        qf0 = q.reshape(-1)
        qf_new, _ = jax.lax.fori_loop(0, c.newton_max_iter, newton_iter, (qf0, False))
        q_new = qf_new.reshape(B, 12)
        qd_new = (q_new - q) / c.dt
        return q_new, qd_new

    # ----------------------------------------------------------------- public
    @full_f32_solve
    def step(
        self,
        state: AbdState,
        scene: RigidSdfScene,
        aim_q: jax.Array | None = None,  # (N, B, 12) constraint targets
        aim_strength: jax.Array | None = None,  # (N, B) or (N, B, 12); 0 = free
    ) -> AbdState:
        n, B = state.q.shape[:2]
        if aim_q is None:
            aim_q = state.q
        if aim_strength is None:
            aim_strength = jnp.zeros((n, B, 12))
        elif aim_strength.ndim == 2:
            aim_strength = jnp.broadcast_to(aim_strength[..., None], (n, B, 12))

        q, qd = jax.vmap(self._step_single)(
            state.q, state.qd, scene, aim_q, aim_strength
        )
        return AbdState(q=q, qd=qd)

    def body_positions(self, state: AbdState) -> jax.Array:
        """Body origins (N, B, 3)."""
        return state.q[..., :3]

    def all_vertices(self, state: AbdState) -> jax.Array:
        """(N, Vt, 3) world vertices of every body."""
        return jax.vmap(self.world_points)(state.q)


def _mesh_moments(P: np.ndarray, T: np.ndarray):
    """Volume, centroid and second moment of a closed triangle mesh
    (divergence theorem over the surface; signed — triangles must be
    consistently outward-oriented)."""
    a, b, c = P[T[:, 0]], P[T[:, 1]], P[T[:, 2]]
    det = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 * signed tet volume
    vol = det.sum() / 6.0
    if vol < 0:
        vol, det = -vol, -det
    # centroid of tet (0,a,b,c) is (a+b+c)/4; weight = det/6
    com = ((a + b + c) / 4.0 * (det[:, None] / 6.0)).sum(0) / max(vol, 1e-12)
    # second moment ∫ p p^T dV: for tet (0,a,b,c):
    # = vol_t/20 * (a a^T + b b^T + c c^T + a b^T + ... sym) — use the
    # standard formula Sigma_t = vol_t/20 * (M + m m^T*?) ; do it exactly:
    Sig = np.zeros((3, 3))
    for i in range(len(T)):
        V = np.stack([a[i], b[i], c[i]])
        vt = det[i] / 6.0
        S = V.T @ (np.ones((3, 3)) + np.eye(3)) @ V / 20.0
        Sig += vt * S
    return float(vol), com, Sig
