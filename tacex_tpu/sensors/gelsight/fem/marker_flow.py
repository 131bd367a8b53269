"""FEM-surface marker flow (ManiSkill-ViTac protocol) — batched.

Reimplements the reference's ``VisionTactileSensorUIPC`` marker tracking
(reference source/tacex/.../fem_based/sim/tactile_sensor_sapienipc_modified.py:
42-458): a randomized marker grid on the gel contact surface, bound to
surface triangles with barycentric weights, projected into the sensor camera
with pinhole intrinsics, with lose-tracking dropout, pixel noise, and a
fixed-size (2, num_markers, 2) flow output.

Re-architecture vs the reference (which was single-env, CPU numpy + sklearn
kNN + Delaunay per frame):
  * the binding (grid generation + triangle search + barycentric weights) is
    computed ONCE on the host at construction — static topology means the
    binding never changes (SURVEY §7.1.5);
  * the per-step path is pure JAX over all envs: gather surface vertices ->
    barycentric combine -> pinhole projection -> masked dropout/noise ->
    static-shape sampling to ``marker_flow_size`` — one fused program, no
    host round trips;
  * random subsampling of valid markers uses masked random ranking instead
    of data-dependent np.random.choice (static shapes).
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from ....core.config import configclass


@configclass
class ManiSkillSimulatorCfg:
    """Field names mirror the reference ManiSkillSimulatorCfg
    (fem_based/mani_skill_sim_cfg.py:10-70)."""

    marker_interval_range: tuple = (2.0625, 2.0625)  # mm
    marker_rotation_range: float = 0.0  # rad
    marker_translation_range: tuple = (0.0, 0.0)  # mm
    marker_pos_shift_range: tuple = (0.0, 0.0)  # mm
    marker_random_noise: float = 0.0  # px
    marker_lose_tracking_probability: float = 0.0
    normalize: bool = False
    marker_flow_size: int = 128
    camera_params: tuple = (340.0, 325.0, 160.0, 125.0, 0.0)  # fx, fy, cx, cy, distortion
    tactile_img_res: tuple = (320, 240)


def _generate_marker_grid(cfg: ManiSkillSimulatorCfg, rng: np.random.Generator) -> np.ndarray:
    """Randomized marker grid in the gel plane, meters (reference :189-247)."""
    lo, hi = cfg.marker_interval_range
    interval = rng.random() * (hi - lo) + lo
    rot = 2 * cfg.marker_rotation_range * rng.random() - cfg.marker_rotation_range
    tx = 2 * cfg.marker_translation_range[0] * rng.random() - cfg.marker_translation_range[0]
    ty = 2 * cfg.marker_translation_range[1] * rng.random() - cfg.marker_translation_range[1]

    x_start = -math.ceil((8 + tx) / interval) * interval + tx
    x_end = math.ceil((16.5 - tx) / interval) * interval + tx
    y_start = -math.ceil((6 + ty) / interval) * interval + ty
    y_end = math.ceil((6 - ty) / interval) * interval + ty
    xs = np.linspace(x_start, x_end, round((x_end - x_start) / interval) + 1, True)
    ys = np.linspace(y_start, y_end, round((y_end - y_start) / interval) + 1, True)
    xy = np.array(np.meshgrid(xs, ys)).reshape(2, -1).T
    xy[:, 0] += rng.random(len(xy)) * cfg.marker_pos_shift_range[0] * 2 - cfg.marker_pos_shift_range[0]
    xy[:, 1] += rng.random(len(xy)) * cfg.marker_pos_shift_range[1] * 2 - cfg.marker_pos_shift_range[1]
    rot_mat = np.array([[math.cos(rot), -math.sin(rot)], [math.sin(rot), math.cos(rot)]])
    return (xy @ rot_mat.T) / 1000.0  # mm -> m


def _bind_barycentric(
    marker_xy: np.ndarray,  # (M0, 2) meters, gel plane (camera-frame xy)
    surface_pts: np.ndarray,  # (Vs, 3) rest surface vertices, camera frame
    surface_tris: np.ndarray,  # (S, 3) indices into surface_pts
) -> tuple[np.ndarray, np.ndarray]:
    """Find containing triangle (xy projection) + barycentric weights.

    Brute-force point-in-triangle over the contact-face triangles (those
    whose vertices lie on the far z plane) — runs once at construction, so no
    kNN/Delaunay machinery is needed (reference :249-329 used sklearn).
    Returns (tri_vert_ids (M, 3), weights (M, 3)); markers without a
    containing triangle are dropped.
    """
    z_far = surface_pts[:, 2].max()
    on_face = np.abs(surface_pts[:, 2] - z_far) < 1e-6
    face_tris = surface_tris[on_face[surface_tris].all(axis=1)]

    p0 = surface_pts[face_tris[:, 0], :2]  # (S, 2)
    e1 = surface_pts[face_tris[:, 1], :2] - p0
    e2 = surface_pts[face_tris[:, 2], :2] - p0
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]  # (S,)
    valid_tri = np.abs(det) > 1e-18

    d = marker_xy[:, None, :] - p0[None, :, :]  # (M0, S, 2)
    w1 = (d[..., 0] * e2[None, :, 1] - d[..., 1] * e2[None, :, 0]) / det[None, :]
    w2 = (e1[None, :, 0] * d[..., 1] - e1[None, :, 1] * d[..., 0]) / det[None, :]
    inside = (w1 >= -1e-9) & (w2 >= -1e-9) & (w1 + w2 <= 1 + 1e-9) & valid_tri[None, :]

    has_tri = inside.any(axis=1)
    tri_idx = inside.argmax(axis=1)
    ids = face_tris[tri_idx]
    w1s = w1[np.arange(len(marker_xy)), tri_idx]
    w2s = w2[np.arange(len(marker_xy)), tri_idx]
    weights = np.stack([1 - w1s - w2s, w1s, w2s], axis=-1)
    return ids[has_tri].astype(np.int32), weights[has_tri].astype(np.float32)


class FemMarkerFlow:
    """Per-topology marker-flow generator over batched FEM surface states."""

    def __init__(
        self,
        cfg: ManiSkillSimulatorCfg,
        rest_surface_camera: np.ndarray,  # (Vs, 3) rest surface verts, camera frame
        surface_tris: np.ndarray,  # (S, 3) indices into the surface array
        seed: int = 0,
    ):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        grid = _generate_marker_grid(cfg, rng)
        # recenter the nominal grid onto the gel footprint
        cx = rest_surface_camera[:, 0].mean()
        cy = rest_surface_camera[:, 1].mean()
        grid = grid - grid.mean(axis=0) + np.array([cx, cy])
        ids, w = _bind_barycentric(grid, rest_surface_camera, surface_tris)
        self.tri_ids = jnp.asarray(ids)  # (M, 3)
        self.weights = jnp.asarray(w)  # (M, 3)
        self.num_bound = len(ids)
        rest = jnp.asarray(rest_surface_camera)
        self.init_pts = (rest[self.tri_ids] * self.weights[..., None]).sum(axis=1)  # (M, 3)

    def _project(self, pts: jax.Array) -> jax.Array:
        """Pinhole projection (..., M, 3) -> (..., M, 2) pixel uv
        (reference gen_marker_uv: u = fx x/z + cx, v = fy y/z + cy)."""
        fx, fy, cx, cy, _ = self.cfg.camera_params
        z = jnp.maximum(pts[..., 2], 1e-6)
        u = fx * pts[..., 0] / z + cx
        v = fy * pts[..., 1] / z + cy
        return jnp.stack([u, v], axis=-1)

    def flow(self, surface_camera: jax.Array, key: jax.Array) -> jax.Array:
        """Marker flow for a batch of surface states.

        Args:
          surface_camera: (N, Vs, 3) current surface vertices in camera frame.
          key: PRNG key (noise / dropout / sampling).
        Returns: (N, 2, marker_flow_size, 2) [init_uv, curr_uv].
        Reference: gen_marker_flow (:354-413).
        """
        cfg = self.cfg
        n = surface_camera.shape[0]
        w_img, h_img = cfg.tactile_img_res

        curr_pts = (surface_camera[:, self.tri_ids] * self.weights[None, ..., None]).sum(axis=2)
        init_uv = jnp.broadcast_to(self._project(self.init_pts), (n, self.num_bound, 2))
        curr_uv = self._project(curr_pts)  # (N, M, 2)

        # in-bounds mask on the initial uv (reference convention :383-388)
        in_bounds = (
            (init_uv[..., 0] > 5)
            & (init_uv[..., 0] < w_img)
            & (init_uv[..., 1] > 5)
            & (init_uv[..., 1] < h_img)
        )

        k_drop, k_noise, k_sample = jax.random.split(key, 3)
        keep = jax.random.uniform(k_drop, (n, self.num_bound)) > cfg.marker_lose_tracking_probability
        valid = in_bounds & keep

        flow = jnp.stack([init_uv, curr_uv], axis=1)  # (N, 2, M, 2)
        flow = flow + cfg.marker_random_noise * jax.random.normal(k_noise, flow.shape)

        # static-shape random subsample of valid markers to marker_flow_size:
        # rank by random score with invalid markers pushed to the end, then
        # take the first K (equivalent in distribution to choice-without-
        # replacement among valid markers).
        score = jax.random.uniform(k_sample, (n, self.num_bound)) + (~valid) * 10.0
        order = jnp.argsort(score, axis=-1)  # (N, M)
        k = cfg.marker_flow_size
        take = order[:, :k] if self.num_bound >= k else jnp.pad(
            order, ((0, 0), (0, k - self.num_bound)), mode="edge"
        )
        picked = jnp.take_along_axis(flow, take[:, None, :, None].repeat(2, 1).repeat(2, -1), axis=2)
        # pad: if fewer than k valid, repeat the last valid marker
        n_valid = valid.sum(axis=-1)  # (N,)
        pos = jnp.arange(k)[None, :]
        last_valid = jnp.clip(n_valid - 1, 0, k - 1)
        src = jnp.minimum(pos, last_valid[:, None])  # (N, k)
        picked = jnp.take_along_axis(picked, src[:, None, :, None].repeat(2, 1).repeat(2, -1), axis=2)

        if cfg.normalize:
            picked = picked / (w_img / 2.0) - 1.0
        return picked


def surface_to_camera_frame(
    surface_world: jax.Array,  # (N, Vs, 3)
    cam_pos: jax.Array,  # (N, 3)
    cam_quat: jax.Array,  # (N, 4) +z forward
) -> jax.Array:
    """World -> camera frame for batched surface vertices."""
    from ....core import maths

    return maths.quat_apply_inverse(cam_quat[:, None, :], surface_world - cam_pos[:, None, :])
