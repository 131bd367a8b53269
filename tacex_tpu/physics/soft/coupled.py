"""Unified contact world: FEM soft bodies + dynamic affine bodies (ABD)
in ONE Newton solve.

The batched counterpart of libuipc's single contact world over its
``GlobalVertexManager / FiniteElementMethod / AffineBodyDynamics``
subsystems (reference source/tacex_uipc/tacex_uipc/sim/uipc_sim.py:204-208:
one ``world.advance()`` resolves every pair type). Round 2 of this rebuild
split the two systems — dynamic ABD bodies and FEM gels only met through
analytic scene SDFs — which ruled out the core GelSight-manipulation
scenario: two FEM gel pads grasping and lifting a free rigid object by
friction. This module closes that gap.

Design (XLA-first, no translation):

  * One unknown vector ``z = [x (3V) | q (12B)]`` — all FEM vertices plus
    all ABD generalized DOFs — minimizing the joint incremental potential
      E(x, q) = E_fem(x) + E_abd(q) + E_cross(x, q)
    with Newton. E_fem / E_abd are the EXACT energies of the individual
    solvers (reused, not reimplemented); E_cross adds two fixed-capacity
    vertex-triangle barrier families:
      A. FEM surface vertex  vs  ABD surface triangle
      B. ABD vertex          vs  FEM surface triangle
    Both are functions of (x, q) jointly, so action-reaction is exact by
    construction (one scalar energy, one gradient).
  * Newton direction from matrix-free CG on the joint Hessian-vector
    product, block-preconditioned: FEM rows by lumped mass / dt^2, ABD rows
    by the inverse of each body's 12x12 (inertia + orthogonality +
    constraint) diagonal block — the same matrix the standalone ABD solver
    inverts densely, here used as a preconditioner so the coupled system
    stays matrix-free.
  * Friction on cross pairs is the shared lagged-Coulomb scheme
    (straight-through per-iteration re-lag, see ipc.py friction_lag):
    family A anchors the ABD material point (frozen body-local coordinates,
    like abd.py pair friction); family B anchors the FEM material point
    (frozen barycentric coordinates on the triangle).
  * Line search feasibility = the union of every subsystem's checks plus
    cross-pair distance floors and Möller–Trumbore crossing rejection in
    both directions (the unsigned-distance CCD of the individual solvers).

Batched over envs with ``jax.vmap`` like every other solver here — N
grasping scenes solve in one compiled program (the reference's libuipc is
single-scene).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from .abd import AbdModel, AbdState, q_to_affine
from .ipc import (
    RigidSdfScene,
    SoftBodyModel,
    SoftBodyState,
    _edge_pair_crossed,
    _point_triangle_closest,
    _point_triangle_distance,
    _segment_crosses_moving_triangle,
    _segment_crosses_triangle,
    barrier_extended,
    barrier_force_mag,
    full_f32_solve,
)


def _triangle_barycentric(q, a, b, c):
    """Barycentric coordinates of point q (assumed on/near tri plane) wrt
    (a, b, c), broadcast over leading dims; clamped to the simplex."""
    e1, e2, ep = b - a, c - a, q - a
    d11 = (e1 * e1).sum(-1)
    d12 = (e1 * e2).sum(-1)
    d22 = (e2 * e2).sum(-1)
    p1 = (ep * e1).sum(-1)
    p2 = (ep * e2).sum(-1)
    det = jnp.maximum(d11 * d22 - d12 * d12, 1e-30)
    v = jnp.clip((d22 * p1 - d12 * p2) / det, 0.0, 1.0)
    w = jnp.clip((d11 * p2 - d12 * p1) / det, 0.0, 1.0)
    s = jnp.maximum(v + w, 1.0)
    v, w = v / s, w / s
    return jnp.stack([1.0 - v - w, v, w], axis=-1)


class CoupledModel:
    """One contact world over one FEM union model + one ABD batch.

    Args:
      fem: the (union) FEM soft-body model — all FEM objects of the scene.
      abd: the ABD model — all affine bodies of the scene (kinematic ones
        included; their strong soft-transform constraints hold them).
      cross_k: candidate triangles per vertex for each cross family
        (A: fem-vert -> abd-tris, B: abd-vert -> fem-surface-tris).
    """

    def __init__(self, fem: SoftBodyModel, abd: AbdModel, cross_k: int = 4):
        self.fem = fem
        self.abd = abd
        self.cross_k = int(cross_k)
        c, a = fem.cfg, abd.cfg
        # the two configs come from one UipcSimCfg; the contact terms must
        # agree for the shared barrier to mean one thing
        assert abs(c.d_hat - a.d_hat) < 1e-12 and abs(c.kappa - a.kappa_contact) < 1e-9
        assert abs(c.dt - a.dt) < 1e-12

    # ------------------------------------------------------------ candidates
    def _cross_candidates(self, xs, y):
        """Step-start K-nearest candidates for both families.

        xs: (Vs, 3) FEM surface verts; y: (Va, 3) ABD world verts.
        Returns (candA (Vs,K) abd-tri ids, validA, candB (Va,K) fem-surface-
        tri ids, validB)."""
        k = self.cross_k
        c = self.fem.cfg
        # A: fem surface vertex vs abd triangles
        centA = y[self.abd.tris].mean(-2)  # (Ta, 3)
        d2A = ((xs[:, None, :] - centA[None]) ** 2).sum(-1)
        negA, candA = jax.lax.top_k(-d2A, min(k, centA.shape[0]))
        cutA = 3.0 * c.d_hat + self.abd._tri_radius_max
        validA = (-negA) < cutA * cutA
        return (
            jax.lax.stop_gradient(candA),
            jax.lax.stop_gradient(validA),
        )

    def _cross_candidates_b(self, x, y):
        k = self.cross_k
        c = self.fem.cfg
        centB = x[self.fem.surface_tris].mean(-2)  # (Ts, 3)
        d2B = ((y[:, None, :] - centB[None]) ** 2).sum(-1)
        negB, candB = jax.lax.top_k(-d2B, min(k, centB.shape[0]))
        cutB = 3.0 * c.d_hat + self.fem._tri_radius_max
        validB = (-negB) < cutB * cutB
        return jax.lax.stop_gradient(candB), jax.lax.stop_gradient(validB)

    # ------------------------------------------------- broad-phase accounting
    def broad_phase_overflow(self, x: jax.Array, q: jax.Array) -> dict[str, jax.Array]:
        """Within-reach candidates dropped past the top-K sets, for one env
        (x: (V, 3) FEM vertices, q: (B, 12)). Includes both cross families
        plus the member models' own families (abd keys prefixed). See
        SoftBodyModel.broad_phase_overflow for semantics."""
        c = self.fem.cfg
        k = self.cross_k
        xs = x[self.fem.surface_verts]
        y = self.abd.world_points(q)
        out: dict[str, jax.Array] = {}
        centA = y[self.abd.tris].mean(-2)
        d2A = ((xs[:, None, :] - centA[None]) ** 2).sum(-1)
        cutA = 3.0 * c.d_hat + self.abd._tri_radius_max
        withinA = (d2A < cutA * cutA).sum(-1)
        out["vt_cross_a"] = jnp.maximum(withinA - min(k, centA.shape[0]), 0).sum()
        centB = x[self.fem.surface_tris].mean(-2)
        d2B = ((y[:, None, :] - centB[None]) ** 2).sum(-1)
        cutB = 3.0 * c.d_hat + self.fem._tri_radius_max
        withinB = (d2B < cutB * cutB).sum(-1)
        out["vt_cross_b"] = jnp.maximum(withinB - min(k, centB.shape[0]), 0).sum()
        out.update(self.fem.broad_phase_overflow(x))
        out.update(
            {f"abd_{key}": v for key, v in self.abd.broad_phase_overflow(y).items()}
        )
        return out

    def missed_barriers(
        self, x: jax.Array, q: jax.Array, reach_frac: float = 0.5
    ) -> jax.Array:
        """Cross-family pairs INSIDE actual barrier reach (exact
        vertex-triangle distance < reach_frac·d_hat) in excess of the top-K
        candidate capacity, for one env — the actionable variant of
        ``broad_phase_overflow`` for default-on env telemetry.

        The conservative candidate-cut counters (3·d_hat + support radius)
        chronically read nonzero in tight grasp scenes — e.g. every
        inner-face gel vertex "reaches" all 12 cube triangles — which
        trains users to ignore the alarm. This counter is zero whenever at
        most K pairs per vertex carry MEANINGFUL barrier force: the
        log-barrier fades to exactly 0 at d_hat, so the default counts
        pairs inside d_hat/2, where dropping one loses real contact force
        (a vertex near a cube corner sits just under d_hat of all 6
        adjacent triangles — those extra near-zero-energy pairs are
        harmless to drop). libuipc's complete BVH broad phase never misses
        a pair (reference uipc_sim.py:121). Exact distances over (Vs, Ta)
        are trivially cheap at scene scale (~150 x 12)."""
        d_hat = reach_frac * self.fem.cfg.d_hat
        k = self.cross_k
        xs = x[self.fem.surface_verts]
        y = self.abd.world_points(q)
        triA = y[self.abd.tris]  # (Ta, 3, 3)
        dA = _point_triangle_distance(
            xs[:, None, :],
            triA[None, :, 0, :], triA[None, :, 1, :], triA[None, :, 2, :],
        )  # (Vs, Ta)
        withinA = (dA < d_hat).sum(-1)
        missed = jnp.maximum(withinA - min(k, triA.shape[0]), 0).sum()
        triB = x[self.fem.surface_tris]  # (Ts, 3, 3)
        dB = _point_triangle_distance(
            y[:, None, :],
            triB[None, :, 0, :], triB[None, :, 1, :], triB[None, :, 2, :],
        )  # (Va, Ts)
        withinB = (dB < d_hat).sum(-1)
        missed += jnp.maximum(withinB - min(k, triB.shape[0]), 0).sum()
        return missed

    # ------------------------------------------------- one-hot gather operators
    def _gather_ops(self, candA, candB):
        """Per-step 0/1 gather matrices for the cross-family triangle
        fetches.

        A per-env dynamic-index gather RE-EXECUTES inside every energy /
        hvp / feasibility evaluation of the Newton solve (~400 per
        env-step). The candidate indices are step constants, so the same
        fetch is a small one-hot matmul, built once per step: opA (Vs*K*3, Va) rows
        select ABD triangle corners, opB (Va*K*3, V) rows select FEM
        surface-triangle corners, opT (Vs*K, B) selects per-candidate body
        rows. All three are tiny (the tables have 8-216 rows)."""
        idxA = self.abd.tris[candA].reshape(-1)
        opA = jax.nn.one_hot(idxA, self.abd.vert_body.shape[0], dtype=jnp.float32)
        idxB = self.fem.surface_tris[candB].reshape(-1)
        opB = jax.nn.one_hot(idxB, self.fem.mesh.num_vertices, dtype=jnp.float32)
        tbA = self.abd.tri_body[candA]
        opT = jax.nn.one_hot(tbA.reshape(-1), self.abd.num_bodies, dtype=jnp.float32)
        return (
            jax.lax.stop_gradient(opA),
            jax.lax.stop_gradient(opB),
            jax.lax.stop_gradient(opT),
        )

    def _triA(self, y, candA, ops):
        """(Vs, K, 3, 3) ABD triangle corners per FEM-vertex candidate.

        precision=HIGHEST on all three one-hot matmuls: full-f32 makes the
        0/1 product an EXACT gather; default precision (TF32 on a GPU) would
        round coordinates before they feed barrier distances and
        feasibility floors."""
        if ops is None:
            return y[self.abd.tris[candA]]
        shp = candA.shape + (3, 3)
        return jnp.matmul(ops[0], y, precision=jax.lax.Precision.HIGHEST).reshape(shp)

    def _triB(self, x, candB, ops):
        """(Va, K, 3, 3) FEM surface-triangle corners per ABD-vertex cand."""
        if ops is None:
            return x[self.fem.surface_tris[candB]]
        shp = candB.shape + (3, 3)
        return jnp.matmul(ops[1], x, precision=jax.lax.Precision.HIGHEST).reshape(shp)

    def _bodyrows(self, M, candA, ops):
        """(Vs, K, ...) per-candidate body rows of M (B, ...)."""
        if ops is None:
            return M[self.abd.tri_body[candA]]
        shp = candA.shape + M.shape[1:]
        return jnp.matmul(
            ops[2], M.reshape(M.shape[0], -1),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(shp)

    # --------------------------------------------------------------- energies
    def _cross_distances(self, x, q, candA, candB, ops=None):
        """Vertex-triangle distances of both families at (x, q)."""
        xs = x[self.fem.surface_verts]
        y = self.abd.world_points(q)
        triA = self._triA(y, candA, ops)  # (Vs, K, 3, 3)
        dA = _point_triangle_distance(
            xs[:, None, :], triA[..., 0, :], triA[..., 1, :], triA[..., 2, :]
        )
        triB = self._triB(x, candB, ops)  # (Va, K, 3, 3)
        dB = _point_triangle_distance(
            y[:, None, :], triB[..., 0, :], triB[..., 1, :], triB[..., 2, :]
        )
        return dA, dB

    def _cross_energy(self, x, q, cand, lag, x0, y0, ops=None):
        """Barrier + lagged friction energy of both cross families."""
        c = self.fem.cfg
        candA, validA, candB, validB = cand
        dA, dB = self._cross_distances(x, q, candA, candB, ops)
        dA = jnp.where(validA, dA, 10.0 * c.d_hat)
        dB = jnp.where(validB, dB, 10.0 * c.d_hat)
        e = barrier_extended(dA, c.kappa, c.d_hat).sum()
        e = e + barrier_extended(dB, c.kappa, c.d_hat).sum()
        if lag is None:
            return e
        lagA, lagB = lag
        xs = x[self.fem.surface_verts]
        y = self.abd.world_points(q)
        A, t = q_to_affine(q)
        eps = c.eps_velocity * c.dt
        mu = c.friction_mu

        def mollify(s):
            return jnp.where(
                s < eps * eps,
                s / (2 * eps) + eps / 2,
                jnp.sqrt(jnp.maximum(s, eps * eps)),
            )

        # family A: fem vertex vs frozen ABD material point
        lamA, nA, pA_local, pA0, tbA = lagA
        A_rows = self._bodyrows(A, candA, ops)
        t_rows = self._bodyrows(t, candA, ops)
        movedA = jnp.einsum("vkij,vkj->vki", A_rows, pA_local) + t_rows
        relA = (xs - x0[self.fem.surface_verts])[:, None, :] - (movedA - pA0)
        relA_t = relA - jnp.sum(relA * nA, -1, keepdims=True) * nA
        sA = jnp.sum(relA_t**2, -1)
        e = e + mu * jnp.sum(jnp.where(validA, lamA * mollify(sA), 0.0))
        # family B: abd vertex vs frozen FEM barycentric material point
        lamB, nB, wB, triB_ids = lagB
        matB = jnp.einsum("vkc,vkcd->vkd", wB, self._triB(x, candB, ops))  # (Va, K, 3)
        matB0 = jnp.einsum("vkc,vkcd->vkd", wB, self._triB(x0, candB, ops))
        relB = (y - y0)[:, None, :] - (matB - matB0)
        relB_t = relB - jnp.sum(relB * nB, -1, keepdims=True) * nB
        sB = jnp.sum(relB_t**2, -1)
        e = e + mu * jnp.sum(jnp.where(validB, lamB * mollify(sB), 0.0))
        return e

    def _cross_lag(self, x_k, q_k, cand, q0, ops=None):
        """Lagged friction quantities for both families at an iterate."""
        c = self.fem.cfg
        if c.friction_mu <= 0:
            return None
        candA, validA, candB, validB = cand
        xs = x_k[self.fem.surface_verts]
        y = self.abd.world_points(q_k)
        A_k, t_k = q_to_affine(q_k)
        A0, t0 = q_to_affine(q0)
        # family A
        triA = self._triA(y, candA, ops)
        qpA = _point_triangle_closest(
            xs[:, None, :], triA[..., 0, :], triA[..., 1, :], triA[..., 2, :]
        )
        dA = jnp.sqrt(((xs[:, None, :] - qpA) ** 2).sum(-1) + 1e-18)
        lamA = jnp.where(validA, barrier_force_mag(dA, c.kappa, c.d_hat), 0.0)
        nA = (xs[:, None, :] - qpA) / jnp.maximum(dA, 1e-9)[..., None]
        tbA = self.abd.tri_body[candA]  # (Vs, K)
        A_inv = jnp.linalg.inv(A_k)
        pA_local = jnp.einsum(
            "vkij,vkj->vki",
            self._bodyrows(A_inv, candA, ops),
            qpA - self._bodyrows(t_k, candA, ops),
        )
        pA0 = jnp.einsum(
            "vkij,vkj->vki", self._bodyrows(A0, candA, ops), pA_local
        ) + self._bodyrows(t0, candA, ops)
        # family B
        triB_ids = self.fem.surface_tris[candB]  # (Va, K, 3)
        triB = self._triB(x_k, candB, ops)
        qpB = _point_triangle_closest(
            y[:, None, :], triB[..., 0, :], triB[..., 1, :], triB[..., 2, :]
        )
        dB = jnp.sqrt(((y[:, None, :] - qpB) ** 2).sum(-1) + 1e-18)
        lamB = jnp.where(validB, barrier_force_mag(dB, c.kappa, c.d_hat), 0.0)
        nB = (y[:, None, :] - qpB) / jnp.maximum(dB, 1e-9)[..., None]
        wB = _triangle_barycentric(
            qpB, triB[..., 0, :], triB[..., 1, :], triB[..., 2, :]
        )  # (Va, K, 3)
        return (
            (lamA, nA, pA_local, pA0, tbA),
            (lamB, nB, wB, triB_ids),
        )

    # ------------------------------------------------------------- single env
    def _step_single(self, x, v, q, qd, scene, aim_pos, aim_q, aim_strength):
        fem, abd = self.fem, self.abd
        c = fem.cfg
        ca = abd.cfg
        B = abd.num_bodies
        V = x.shape[0]

        g = jnp.asarray(c.gravity, jnp.float32)
        x_tilde = x + c.dt * v + c.dt * c.dt * g
        q_tilde = q + ca.dt * qd + ca.dt**2 * jnp.einsum(
            "bij,bj->bi", abd.mass_inv, abd.gravity_q
        )

        xs0 = x[fem.surface_verts]
        y0 = abd.world_points(q)
        x0 = x

        # ---- step-start candidate sets (all families)
        self_cand = fem._select_candidates(x) if c.self_contact_k > 0 else None
        static_cand = (
            fem._static_candidates(xs0) if fem.static_tris is not None else None
        )
        ee_cand = fem._select_ee_candidates(x) if fem.edges is not None else None
        abd_cand = abd._select_candidates(y0) if ca.contact_k > 0 else None
        candA, validA = self._cross_candidates(xs0, y0)
        candB, validB = self._cross_candidates_b(x, y0)
        cross_cand = (candA, validA, candB, validB)
        # one-hot gather operators for the cross families (step constants;
        # turn every in-solve candidate fetch into a tiny matmul — see
        # _gather_ops), plus the FEM model's own families and the
        # x-independent static-triangle prefetch
        ops = self._gather_ops(candA, candB)
        fem_ops = fem._gather_ops(self_cand, ee_cand)
        if static_cand is not None:
            static_cand = fem.static_tris[static_cand]  # prefetched corners

        # ---- friction lags (straight-through: see ipc.py lag_st rationale)
        def fem_lag(x_k, stop=True):
            if c.friction_mu <= 0:
                return None
            xsk = (jax.lax.stop_gradient(x_k) if stop else x_k)[fem.surface_verts]
            d = scene.sdf(xsk)
            n = jax.vmap(jax.grad(lambda p: scene.sdf(p[None])[0]))(xsk)
            n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
            return (barrier_force_mag(d, c.kappa, c.d_hat), n)

        fem_lag0 = fem_lag(x, stop=False)
        abd_lag0 = None
        cross_lag0 = None
        if ca.friction_mu > 0:
            # step-start ABD scene lag without stop_gradient (tangent anchor)
            y0_d = abd.world_points(q)
            d0 = scene.sdf(y0_d)
            n0 = jax.vmap(jax.grad(lambda p: scene.sdf(p[None])[0]))(y0_d)
            n0 = n0 / jnp.maximum(jnp.linalg.norm(n0, axis=-1, keepdims=True), 1e-9)
            abd_lag0 = (barrier_force_mag(d0, ca.kappa_contact, ca.d_hat), n0)
            cross_lag0 = self._cross_lag(x, q, cross_cand, q, ops)

        def st(it, s0):
            return jax.tree_util.tree_map(
                lambda a, b: (
                    a
                    if not jnp.issubdtype(a.dtype, jnp.floating)
                    else b + jax.lax.stop_gradient(a - b)
                ),
                it,
                s0,
            )

        def lags_at(x_k, q_k):
            if c.friction_mu <= 0:
                return None, None, None
            xs_s = jax.lax.stop_gradient(x_k)
            qs = jax.lax.stop_gradient(q_k)
            fl = st(fem_lag(xs_s), fem_lag0)
            ys = abd.world_points(qs)
            d = scene.sdf(ys)
            n = jax.vmap(jax.grad(lambda p: scene.sdf(p[None])[0]))(ys)
            n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
            al = st((barrier_force_mag(d, ca.kappa_contact, ca.d_hat), n), abd_lag0)
            cl = st(self._cross_lag(xs_s, qs, cross_cand, q, ops), cross_lag0)
            return fl, al, cl

        # ---- joint energy over the packed unknown z = [x | q]
        def unpack(z):
            return z[: 3 * V].reshape(V, 3), z[3 * V :].reshape(B, 12)

        def energy_of(z, fl, al, cl):
            xx, qq = unpack(z)
            e = fem._energy(
                xx, x_tilde, scene, aim_pos, x0, fl, self_cand, static_cand,
                ee_cand, None, fem_ops,
            )
            e = e + abd._energy(
                qq, q_tilde, scene, aim_q, aim_strength, y0, al, abd_cand, None
            )
            e = e + self._cross_energy(xx, qq, cross_cand, cl, x0, y0, ops)
            return e

        # ---- ABD block preconditioner: per-body 12x12 smooth-part inverse
        def ortho_b(a_flat, kap):
            A = a_flat.reshape(3, 3)
            R = A.T @ A - jnp.eye(3)
            return kap * jnp.sum(R * R)

        Ho9 = jax.vmap(jax.hessian(ortho_b))(q[:, 3:].reshape(B, 9), abd.kappa_ortho)
        Hd = abd.mass / ca.dt**2
        Hd = Hd.at[:, 3:, 3:].add(Ho9)
        m_body = abd.mass[:, 0, 0][:, None]
        Hd = Hd + jax.vmap(jnp.diag)(aim_strength * m_body / ca.dt**2)
        Hd = Hd + 1e-6 * jnp.eye(12)
        Hd_inv = jnp.linalg.inv(Hd)  # (B, 12, 12)
        fem_pre = 1.0 / (fem.masses[:, None] / c.dt**2)  # (V, 1)

        def precond(r):
            rx, rq = unpack(r)
            px = fem_pre * rx
            pq = jnp.einsum("bij,bj->bi", Hd_inv, rq)
            return jnp.concatenate([px.reshape(-1), pq.reshape(-1)])

        # ---- feasibility: union of every family's checks
        d_floor = jnp.minimum(scene.sdf(xs0).min(), 0.0)
        d_floor_abd = jnp.minimum(scene.sdf(y0).min(), 0.0)
        dA0, dB0 = self._cross_distances(x, q, candA, candB, ops)
        crossA_floor = jnp.minimum(
            0.999 * jnp.where(validA, dA0, 1.0).min(), 1e-7
        )
        crossB_floor = jnp.minimum(
            0.999 * jnp.where(validB, dB0, 1.0).min(), 1e-7
        )
        if static_cand is not None:
            s_floor = jnp.minimum(
                0.999 * fem._static_distance(xs0, static_cand).min(), 1e-7
            )
        if ee_cand is not None:
            eci0, eval0 = ee_cand
            ee_floor = jnp.minimum(
                0.999 * jnp.where(eval0, fem._ee_distances(x, eci0), 1.0).min(),
                1e-7,
            )

        def feasible(z_try, z_from):
            xx, qq = unpack(z_try)
            xf, qf = unpack(z_from)
            xs_t = xx[fem.surface_verts]
            y_t = abd.world_points(qq)
            ok = scene.sdf(xs_t).min() > d_floor
            ok = ok & (scene.sdf(y_t).min() > d_floor_abd)
            # fem self contact (moving triangles: co-moving-frame test)
            if self_cand is not None:
                cnd, vld = self_cand
                d_vt = fem._pair_distances(xx, cnd, fem_ops)
                ok = ok & (jnp.where(vld, d_vt, 1.0).min() > 1e-6)
                tri = fem._tri_rows(xx, cnd, fem_ops)
                tri0 = fem._tri_rows(xf, cnd, fem_ops)
                crossed = _segment_crosses_moving_triangle(
                    xf[fem.surface_verts][:, None, :],
                    xs_t[:, None, :],
                    tri0[..., 0, :], tri0[..., 1, :], tri0[..., 2, :],
                    tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
                )
                ok = ok & ~(crossed & vld).any()
            if static_cand is not None:
                ok = ok & (fem._static_distance(xs_t, static_cand).min() > s_floor)
                tri = static_cand  # prefetched (Vs, K, 3, 3) corners
                crossed = _segment_crosses_triangle(
                    xf[fem.surface_verts][:, None, :],
                    xs_t[:, None, :],
                    tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
                )
                ok = ok & ~crossed.any()
            if ee_cand is not None:
                eci, evalid = ee_cand
                d_ee = fem._ee_distances(xx, eci, fem_ops)
                ok = ok & (jnp.where(evalid, d_ee, 1.0).min() > ee_floor)
                pa = xf[fem.edges]
                pja = fem._ee_rows(xf, eci, fem_ops)
                pb = xx[fem.edges]
                pjb = fem._ee_rows(xx, eci, fem_ops)
                crossed = _edge_pair_crossed(
                    pa[:, None, 0, :], pa[:, None, 1, :],
                    pja[..., 0, :], pja[..., 1, :],
                    pb[:, None, 0, :], pb[:, None, 1, :],
                    pjb[..., 0, :], pjb[..., 1, :],
                )
                ok = ok & ~(crossed & evalid).any()
            # abd body-body
            y_f = abd.world_points(qf)
            if abd_cand is not None:
                ci, vld = abd_cand
                d_bb = abd._pair_distances(y_t, ci)
                ok = ok & (jnp.where(vld, d_bb, 1.0).min() > 1e-7)
                tri = y_t[abd.tris[ci]]
                tri0 = y_f[abd.tris[ci]]
                crossed = _segment_crosses_moving_triangle(
                    y_f[:, None, :], y_t[:, None, :],
                    tri0[..., 0, :], tri0[..., 1, :], tri0[..., 2, :],
                    tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
                )
                ok = ok & ~(crossed & vld).any()
            # cross families: floors + crossing CCD both ways — both sides
            # of each family move, so the co-moving-frame test is essential
            # (the end-frame test misses the barrier's push-apart kinematics;
            # measured tunneling in the cloth-catches-falling-body scene)
            dA, dB = self._cross_distances(xx, qq, candA, candB, ops)
            ok = ok & (jnp.where(validA, dA, 1.0).min() > crossA_floor)
            ok = ok & (jnp.where(validB, dB, 1.0).min() > crossB_floor)
            triA = y_t[self.abd.tris[candA]]
            triA0 = y_f[self.abd.tris[candA]]
            crossedA = _segment_crosses_moving_triangle(
                xf[fem.surface_verts][:, None, :],
                xs_t[:, None, :],
                triA0[..., 0, :], triA0[..., 1, :], triA0[..., 2, :],
                triA[..., 0, :], triA[..., 1, :], triA[..., 2, :],
            )
            ok = ok & ~(crossedA & validA).any()
            triB = xx[self.fem.surface_tris[candB]]
            triB0 = xf[self.fem.surface_tris[candB]]
            crossedB = _segment_crosses_moving_triangle(
                y_f[:, None, :], y_t[:, None, :],
                triB0[..., 0, :], triB0[..., 1, :], triB0[..., 2, :],
                triB[..., 0, :], triB[..., 1, :], triB[..., 2, :],
            )
            ok = ok & ~(crossedB & validB).any()
            return ok

        # ---- Newton loop (shared structure with ipc.py)
        def newton_iter(_, carry):
            z_k, done = carry
            x_k, q_k = unpack(z_k)
            fl, al, cl = lags_at(x_k, q_k)
            energy = lambda zz: energy_of(zz, fl, al, cl)
            grad = jax.grad(energy)(z_k)
            hvp = lambda p: jax.jvp(jax.grad(energy), (z_k,), (p,))[1]

            def cg_body(_, cg):
                p_dir, r, zv, xsol = cg
                hp = hvp(p_dir)
                denom = jnp.sum(p_dir * hp)
                alpha = jnp.where(jnp.abs(denom) > 1e-20, jnp.sum(r * zv) / denom, 0.0)
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
                0, c.cg_iters, cg_body, (z0, r0, z0, jnp.zeros_like(z_k))
            )
            descent = jnp.sum(p * grad) < 0
            p = jnp.where(descent, p, -z0)

            e0 = energy(z_k)

            def ls_body(_, ls):
                alpha, accepted = ls
                z_try = z_k + alpha * p
                ok = (energy(z_try) < e0) & feasible(z_try, z_k)
                return (jnp.where(ok | accepted, alpha, alpha * 0.5), ok | accepted)

            alpha, accepted = jax.lax.fori_loop(
                0, c.line_search_iters, ls_body, (1.0, False)
            )
            alpha = jnp.where(accepted, alpha, 0.0)
            step_vec = alpha * p
            z_new = jnp.where(done, z_k, z_k + step_vec)
            done = done | (jnp.abs(step_vec).max() / c.dt < c.velocity_tol)
            return (z_new, done)

        z_init = jnp.concatenate([x.reshape(-1), q.reshape(-1)])
        z_new, _ = jax.lax.fori_loop(0, c.newton_max_iter, newton_iter, (z_init, False))
        x_new, q_new = unpack(z_new)
        v_new = (x_new - x) / c.dt * (1.0 - c.damping)
        qd_new = (q_new - q) / ca.dt
        return x_new, v_new, q_new, qd_new

    # ----------------------------------------------------------------- public
    @full_f32_solve
    def step(
        self,
        fem_state: SoftBodyState,
        abd_state: AbdState,
        scene: RigidSdfScene,
        aim_pos: jax.Array | None = None,  # (N, Va, 3) FEM attachment targets
        aim_q: jax.Array | None = None,  # (N, B, 12) ABD constraint targets
        aim_strength: jax.Array | None = None,  # (N, B) or (N, B, 12)
    ) -> tuple[SoftBodyState, AbdState]:
        n = fem_state.x.shape[0]
        B = self.abd.num_bodies
        if aim_pos is None:
            aim_pos = jnp.zeros(
                (n, max(int(self.fem.attachment_verts.shape[0]), 1), 3)
            )
        if aim_q is None:
            aim_q = abd_state.q
        if aim_strength is None:
            aim_strength = jnp.zeros((n, B, 12))
        elif aim_strength.ndim == 2:
            aim_strength = jnp.broadcast_to(aim_strength[..., None], (n, B, 12))

        x, v, q, qd = jax.vmap(self._step_single)(
            fem_state.x, fem_state.v, abd_state.q, abd_state.qd,
            scene, aim_pos, aim_q, aim_strength,
        )
        return SoftBodyState(x=x, v=v), AbdState(q=q, qd=qd)
