"""Batched implicit shell (cloth) solver with IPC barrier contact.

Batched counterpart of libuipc's shell constitutions
(``NeoHookeanShell`` + ``DiscreteShellBending``; reference scope:
uipc_sim.py:23-26 constitution list and the bunny-cloth sample
examples/libuipc-samples/11_bunny_cloth.py:72-79 — 10 kPa membrane,
1 mm thickness, density 200, bending E=10, dropped on a fixed body).

Design mirrors :class:`ipc.SoftBodyModel` (same incremental potential /
matrix-free-CG Newton / feasibility line search / lagged friction — one
vmapped solve over all envs), with shell-specific energies:

  * Membrane: constant-strain-triangle 2D Neo-Hookean. Per triangle the
    3x2 deformation gradient F maps rest tangent coordinates to world;
    psi = mu/2 (tr C - 2) - mu ln J + lam/2 (ln J)^2 with C = F^T F and
    J = sqrt(det C), integrated over rest area x thickness.
  * Bending: discrete-shells hinge energy kb * (theta - theta0)^2 *
    |e|/h_bar per interior edge (Grinspun et al.), theta from an
    atan2(sin, cos) dihedral — autodiff-stable away from degenerate
    triangles, which the membrane term already forbids.
  * Contact: IPC log-barrier (with the C^2 penetration extension shared
    with the FEM solver) against (a) analytic scene SDFs and (b) an
    optional STATIC triangle-soup collider (the fixed ABD bunny of the
    sample) via fixed-capacity K-nearest candidate triangles per vertex.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from ...core.config import configclass
from ...ops import sdf as sdf_ops
from .codim import (
    ShellElementsJax,
    bending_energy,
    build_shell_elements,
    membrane_energy,
)
from .ipc import (
    RigidSdfScene,
    SoftBodyState,
    _point_triangle_distance,
    _segment_crosses_triangle,
    barrier_extended,
    barrier_force_mag,
)


@configclass
class ShellSolverCfg:
    dt: float = 0.01
    gravity: tuple = (0.0, 0.0, -9.81)
    newton_max_iter: int = 8
    velocity_tol: float = 0.05
    cg_iters: int = 24
    line_search_iters: int = 8
    d_hat: float = 0.002
    kappa: float = 1e4
    friction_mu: float = 0.5
    eps_velocity: float = 0.01
    damping: float = 0.0
    static_contact_k: int = 4  # candidate static triangles per cloth vertex


class ShellModel:
    """Static topology + vmapped step for one cloth shared by all envs.

    Args:
      points: (V, 3) rest vertex positions.
      triangles: (T, 3) triangle indices.
      youngs_modulus / poisson_ratio / thickness / mass_density: membrane
        parameters (NeoHookeanShell.apply_to signature).
      bending_stiffness: DiscreteShellBending ``E``.
      static_tris: optional (Ts, 3, 3) world-frame triangle soup the cloth
        collides against (fixed bodies).
      attachment_verts: pinned/aimed vertices (SoftPositionConstraint).
    """

    def __init__(
        self,
        points: np.ndarray,
        triangles: np.ndarray,
        youngs_modulus: float = 1e4,
        poisson_ratio: float = 0.3,
        thickness: float = 0.001,
        mass_density: float = 200.0,
        bending_stiffness: float = 10.0,
        cfg: ShellSolverCfg | None = None,
        static_tris: np.ndarray | None = None,
        attachment_verts: np.ndarray | None = None,
        attachment_strength_ratio: float = 100.0,
    ):
        self.cfg = cfg or ShellSolverCfg()
        P = np.asarray(points, np.float64)
        T = np.asarray(triangles, np.int64)
        self.num_vertices = len(P)
        self.tris = jnp.asarray(T, jnp.int32)

        # rest-state precompute shared with the union/coupled path
        # (codim.build_shell_elements — libuipc's NeoHookeanShell +
        # DiscreteShellBending apply_to quantities; bending uses the
        # plate modulus k_b = E_bend t^3/12 times the discrete-shells
        # |e|/h_bar hinge weight, cloth-soft at the sample's E=10, 1 mm)
        elems = build_shell_elements(
            P, T,
            youngs_modulus=youngs_modulus,
            poisson_ratio=poisson_ratio,
            thickness=thickness,
            mass_density=mass_density,
            bending_stiffness=bending_stiffness,
        )
        self.elems = ShellElementsJax(elems)
        self.masses = jnp.asarray(elems.masses, jnp.float32)
        self.hinges = self.elems.hinges
        masses = elems.masses

        # ---- static collider
        if static_tris is not None and len(static_tris) > 0:
            self.static_tris = jnp.asarray(static_tris, jnp.float32)  # (Ts, 3, 3)
            self.static_cent = self.static_tris.mean(axis=1)
        else:
            self.static_tris = None
            self.static_cent = None

        if attachment_verts is not None and len(attachment_verts) > 0:
            self.attachment_verts = jnp.asarray(attachment_verts, jnp.int32)
            k = np.broadcast_to(
                np.asarray(attachment_strength_ratio, np.float64),
                (len(attachment_verts),),
            )
            self.attachment_k = jnp.asarray(
                k * np.maximum(masses[np.asarray(attachment_verts)], 1e-9) / self.cfg.dt**2,
                jnp.float32,
            )
        else:
            self.attachment_verts = jnp.zeros((0,), jnp.int32)
            self.attachment_k = jnp.zeros((0,), jnp.float32)

        self.surface_verts = jnp.arange(self.num_vertices, dtype=jnp.int32)

    # -------------------------------------------------------------- energies
    def _membrane(self, x: jax.Array) -> jax.Array:
        return membrane_energy(x, self.elems)

    def _bending(self, x: jax.Array) -> jax.Array:
        return bending_energy(x, self.elems)

    def _barrier(self, d: jax.Array) -> jax.Array:
        """Summed log-barrier (shared formulation: ipc.barrier_extended)."""
        return barrier_extended(d, self.cfg.kappa, self.cfg.d_hat).sum()

    def _static_candidates(self, x: jax.Array):
        """K nearest static-collider triangles per vertex (stop-gradient)."""
        k = min(self.cfg.static_contact_k, self.static_cent.shape[0])
        d2 = ((x[:, None, :] - self.static_cent[None]) ** 2).sum(-1)
        neg, cand = jax.lax.top_k(-d2, k)
        return jax.lax.stop_gradient(cand)

    def _static_distance(self, x: jax.Array, cand: jax.Array) -> jax.Array:
        tri = self.static_tris[cand]  # (V, K, 3, 3)
        return _point_triangle_distance(
            x[:, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
        )

    def _energy(self, x, x_tilde, scene, aim_pos, x_prev, friction_basis, static_cand):
        c = self.cfg
        dx = x - x_tilde
        inertia = (0.5 / c.dt**2) * jnp.sum(self.masses[:, None] * dx * dx)
        elastic = self._membrane(x) + self._bending(x)
        contact = self._barrier(scene.sdf(x))
        if static_cand is not None:
            contact = contact + self._barrier(self._static_distance(x, static_cand))
        attach = 0.0
        if self.attachment_verts.shape[0] > 0:
            attach = 0.5 * jnp.sum(
                self.attachment_k[:, None] * (x[self.attachment_verts] - aim_pos) ** 2
            )
        friction = 0.0
        if friction_basis is not None:
            lam_n, n_dir = friction_basis
            du = x - x_prev
            du_t = du - jnp.sum(du * n_dir, -1, keepdims=True) * n_dir
            ut2 = jnp.sum(du_t**2, -1)
            eps = c.eps_velocity * c.dt
            f0 = jnp.where(
                ut2 < eps * eps,
                ut2 / (2 * eps) + eps / 2,
                jnp.sqrt(jnp.maximum(ut2, eps * eps)),
            )
            friction = c.friction_mu * jnp.sum(lam_n * f0)
        return inertia + elastic + contact + attach + friction

    # ------------------------------------------------------------ single env
    def _step_single(self, x, v, scene, aim_pos):
        c = self.cfg
        g = jnp.asarray(c.gravity, jnp.float32)
        x_tilde = x + c.dt * v + c.dt**2 * g

        sdf_fn = scene.sdf
        static_cand = self._static_candidates(x) if self.static_tris is not None else None

        def friction_lag(x_k, stop=True):
            # re-lagged every Newton iteration -> fully-implicit friction
            # fixed point (see ipc.py friction_lag rationale)
            if c.friction_mu <= 0:
                return None
            xs = jax.lax.stop_gradient(x_k) if stop else x_k
            d = sdf_fn(xs)
            n = jax.vmap(jax.grad(lambda p: sdf_fn(p[None])[0]))(xs)
            n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
            return (barrier_force_mag(d, c.kappa, c.d_hat), n)

        # straight-through lag: primal from the iterate, tangent from the
        # step-start lag (see ipc.py lag_st rationale)
        lag0 = friction_lag(x, stop=False)

        def lag_st(x_k):
            if lag0 is None:
                return None
            return jax.tree_util.tree_map(
                lambda it, s0: s0 + jax.lax.stop_gradient(it - s0),
                friction_lag(x_k), lag0,
            )

        def make_energy(friction_basis):
            return lambda xx: self._energy(
                xx, x_tilde, scene, aim_pos, x, friction_basis, static_cand
            )

        d_floor = jnp.minimum(sdf_fn(x).min(), 0.0)
        # no-worsening floor for static trimesh colliders (see ipc.py)
        if static_cand is not None:
            s_floor = jnp.minimum(
                0.999 * self._static_distance(x, static_cand).min(), 1e-7
            )

        def feasible(xx, x_from):
            ok = sdf_fn(xx).min() > d_floor
            if static_cand is not None:
                ok = ok & (self._static_distance(xx, static_cand).min() > s_floor)
                tri = self.static_tris[static_cand]  # (V, K, 3, 3)
                crossed = _segment_crosses_triangle(
                    x_from[:, None, :], xx[:, None, :],
                    tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
                )
                ok = ok & ~crossed.any()
            return ok

        precond = 1.0 / (self.masses[:, None] / c.dt**2)

        def newton_iter(_, carry):
            x_k, done = carry
            energy = make_energy(lag_st(x_k))
            grad = jax.grad(energy)(x_k)
            hvp = lambda p: jax.jvp(jax.grad(energy), (x_k,), (p,))[1]

            def cg_body(_, cg):
                p_dir, r, z, xsol = cg
                hp = hvp(p_dir)
                denom = jnp.sum(p_dir * hp)
                alpha = jnp.where(jnp.abs(denom) > 1e-20, jnp.sum(r * z) / denom, 0.0)
                xsol = xsol + alpha * p_dir
                r_new = r - alpha * hp
                z_new = precond * r_new
                beta = jnp.where(
                    jnp.sum(r * z) > 1e-20, jnp.sum(r_new * z_new) / jnp.sum(r * z), 0.0
                )
                return (z_new + beta * p_dir, r_new, z_new, xsol)

            r0 = -grad
            z0 = precond * r0
            _, _, _, p = jax.lax.fori_loop(
                0, c.cg_iters, cg_body, (z0, r0, z0, jnp.zeros_like(x_k))
            )
            descent = jnp.sum(p * grad) < 0
            p = jnp.where(descent, p, -z0)

            e0 = energy(x_k)

            def ls_body(_, ls):
                alpha, accepted = ls
                x_try = x_k + alpha * p
                ok = (energy(x_try) < e0) & feasible(x_try, x_k)
                return (jnp.where(ok | accepted, alpha, alpha * 0.5), ok | accepted)

            alpha, accepted = jax.lax.fori_loop(
                0, c.line_search_iters, ls_body, (1.0, False)
            )
            alpha = jnp.where(accepted, alpha, 0.0)
            step_vec = alpha * p
            x_new = jnp.where(done, x_k, x_k + step_vec)
            done = done | (jnp.abs(step_vec).max() / c.dt < c.velocity_tol)
            return (x_new, done)

        x_new, _ = jax.lax.fori_loop(0, c.newton_max_iter, newton_iter, (x, False))
        v_new = (x_new - x) / c.dt * (1.0 - c.damping)
        return x_new, v_new

    # ----------------------------------------------------------------- public
    def step(
        self,
        state: SoftBodyState,
        scene: RigidSdfScene,
        aim_pos: jax.Array | None = None,
    ) -> SoftBodyState:
        n = state.x.shape[0]
        if aim_pos is None:
            aim_pos = jnp.zeros((n, self.attachment_verts.shape[0], 3))

        x, v = jax.vmap(self._step_single)(state.x, state.v, scene, aim_pos)
        return SoftBodyState(x=x, v=v)

    def surface_positions(self, state: SoftBodyState) -> jax.Array:
        return state.x


def grid_cloth(nx: int = 20, ny: int = 20, size: float = 2.0, z: float = 1.0):
    """(points, triangles) of an nx-by-ny cloth grid (the sample's
    grid20x20.obj scaled by 2, 11_bunny_cloth.py:69-71)."""
    xs = np.linspace(-size / 2, size / 2, nx)
    ys = np.linspace(-size / 2, size / 2, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    P = np.stack([gx, gy, np.full_like(gx, z)], -1).reshape(-1, 3).astype(np.float32)
    T = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            v00 = i * ny + j
            v01 = v00 + 1
            v10 = v00 + ny
            v11 = v10 + 1
            T.append([v00, v10, v11])
            T.append([v00, v11, v01])
    return P, np.asarray(T, np.int32)
