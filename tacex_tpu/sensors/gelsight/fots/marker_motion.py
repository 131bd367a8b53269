"""FOTS marker-motion simulation, fully vectorized.

Implements the FOTS analytic marker displacement model (Zhao et al., RA-L
2024): three closed-form Gaussian-damped displacement fields — normal-load
dilation, shear, and twist — composed over a regular marker grid.

Reference behavior spec: reference source/tacex/.../fots/sim/
marker_motion.py:22-219 and fots/fots_marker_sim.py:26-446. The reference
implementation loops per env in Python over CPU numpy and keeps an unbounded
per-env trajectory list; only ``traj[0]`` and ``traj[-1]`` are ever read
(marker_motion.py:177-207), so this version carries a fixed-size
``(traj_start, traj_curr)`` state and evaluates everything batched:
``(num_envs, rows*cols)`` markers in one fused program — no host round trips.

Displacement fields (image coords, x = column/width, y = row/height):
  dilation: sum over contact markers i of  h_i * (p - c_i) * exp(-λ0 |p-c_i|²)
  shear:    clip(Δs, ±10 px) * exp(-λ1 |p - c_shear|²)
  twist:    R'(θ)(p - c_twist) * exp(-λ2 |p - c_twist|²), θ clipped to ±60°
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ....core.config import configclass


@configclass
class FOTSMarkerCfg:
    """Marker-field configuration (defaults = reference
    fots/fots_marker_sim_cfg.py:15-76: 11x9 grid, λ=[1.25e-3, 2.1e-4, 3.8e-4],
    mm_to_pixel=19.58, image 320x240)."""

    lamb: list = dataclasses.field(default_factory=lambda: [0.00125, 0.00021, 0.00038])
    num_markers_row: int = 11
    num_markers_col: int = 9
    x0: float = 15.0
    y0: float = 26.0
    tactile_img_width: int = 320
    tactile_img_height: int = 240
    mm_to_pixel: float = 19.58
    shear_max_px: float = 10.0
    twist_max_deg: float = 60.0
    marker_dot_radius_px: float = 2.0

    @property
    def num_markers(self) -> int:
        return self.num_markers_row * self.num_markers_col


def init_marker_grid(cfg: FOTSMarkerCfg) -> jax.Array:
    """Initial marker positions (num_markers, 2) as (x, y) pixel coords.

    Grid spans [x0, W-x0] x [y0, H-y0] (reference marker_motion.py:58-66,
    int-truncated linspace).
    """
    xs = jnp.floor(jnp.linspace(cfg.x0, cfg.tactile_img_width - cfg.x0, cfg.num_markers_col))
    ys = jnp.floor(jnp.linspace(cfg.y0, cfg.tactile_img_height - cfg.y0, cfg.num_markers_row))
    xx, yy = jnp.meshgrid(xs, ys, indexing="xy")  # (rows, cols)
    return jnp.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1).astype(jnp.float32)


def _dilate_field(
    markers: jax.Array,  # (M, 2) x,y
    contact_pos: jax.Array,  # (M, 2) marker positions treated as contact pts
    contact_height: jax.Array,  # (M,) normalized depth at each contact marker
    contact_valid: jax.Array,  # (M,) bool
    lamb: float,
) -> jax.Array:
    """Normal-load dilation: each contact marker pushes its neighbors radially
    outward (reference marker_motion.py:111-120). (M, 2) displacement."""
    diff = markers[:, None, :] - contact_pos[None, :, :]  # (M, M, 2)
    r2 = (diff**2).sum(-1)
    g = jnp.exp(-lamb * r2)
    w = jnp.where(contact_valid[None, :], contact_height[None, :] * g, 0.0)
    return (w[..., None] * diff).sum(axis=1)


def _shear_field(markers: jax.Array, center: jax.Array, shear_px: jax.Array, lamb: float, shear_max: float) -> jax.Array:
    """(M,2) shear displacement (reference marker_motion.py:78-88)."""
    r2 = ((markers - center[None, :]) ** 2).sum(-1)
    g = jnp.exp(-lamb * r2)
    s = jnp.clip(shear_px, -shear_max, shear_max)
    return s[None, :] * g[:, None]


def _twist_field(markers: jax.Array, center: jax.Array, theta: jax.Array, lamb: float, theta_max: float) -> jax.Array:
    """(M,2) twist displacement (reference marker_motion.py:90-109).

    Note the reference's rotation residual uses ``cos(theta - 1)`` (sic) —
    kept verbatim for output parity with FOTS.
    """
    th = jnp.clip(theta, -theta_max, theta_max)
    off = markers - center[None, :]
    r2 = (off**2).sum(-1)
    g = jnp.exp(-lamb * r2)
    ox, oy = off[:, 0], off[:, 1]
    rotx = ox * jnp.cos(th - 1.0) - oy * jnp.sin(th)
    roty = ox * jnp.sin(th) + oy * jnp.cos(th - 1.0)
    return jnp.stack([rotx * g, roty * g], axis=-1)


def marker_motion(
    cfg: FOTSMarkerCfg,
    depth_map: jax.Array,  # (N, h, w) gel deformation depth (mm, >= 0 inward)
    contact_mask: jax.Array,  # (N, h, w) bool
    traj_start: jax.Array,  # (N, 3) [x_mm, y_mm, theta_rad] at contact start
    traj_curr: jax.Array,  # (N, 3) current relative pose
    traj_valid: jax.Array,  # (N,) bool — has a trajectory (>= 2 samples seen)
    init_markers: jax.Array,  # (M, 2)
    sample_scale: tuple[float, float] = (1.0, 1.0),
) -> jax.Array:
    """Compute current marker positions for a batch of sensors.

    Returns (N, M, 2) marker (x, y) pixel positions. With no contact the
    markers stay at their initial grid (reference marker_motion.py:168-170).
    ``sample_scale`` maps marker coordinates onto the depth-map grid when the
    two live at different resolutions (depth_x = marker_x * sample_scale[0]).
    """
    n = depth_map.shape[0]
    h, w = depth_map.shape[-2:]
    m = init_markers.shape[0]

    # Depth normalization: reference divides the min-subtracted depth by 10
    # (cm conversion; marker_motion.py:144-149).
    d = depth_map - depth_map.min(axis=(-2, -1), keepdims=True)
    d = d / 10.0

    # Sample contact mask / depth at (integer) marker positions.
    mx = jnp.clip((init_markers[:, 0] * sample_scale[0]).astype(jnp.int32), 0, w - 1)
    my = jnp.clip((init_markers[:, 1] * sample_scale[1]).astype(jnp.int32), 0, h - 1)
    contact_at_m = contact_mask[:, my, mx]  # (N, M)
    height_at_m = d[:, my, mx]  # (N, M)
    any_contact = contact_at_m.any(axis=-1)  # (N,)

    markers = jnp.broadcast_to(init_markers, (n, m, 2))

    lamb = cfg.lamb
    dil = jax.vmap(lambda mk, cv, ch: _dilate_field(mk, mk, ch, cv, lamb[0]))(
        markers, contact_at_m, height_at_m
    )

    # Shear: center at traj start (image coords), magnitude = displacement.
    img_c = jnp.array([cfg.tactile_img_width / 2.0, cfg.tactile_img_height / 2.0], jnp.float32)
    shear_center = jnp.floor(traj_start[:, :2] * cfg.mm_to_pixel + img_c)  # (N, 2)
    shear_px = jnp.trunc((traj_curr[:, :2] - traj_start[:, :2]) * cfg.mm_to_pixel)  # (N, 2)
    shear = jax.vmap(lambda mk, c, s: _shear_field(mk, c, s, lamb[1], cfg.shear_max_px))(
        markers, shear_center, shear_px
    )

    twist_center = jnp.floor(traj_curr[:, :2] * cfg.mm_to_pixel + img_c)
    theta = traj_curr[:, 2] - traj_start[:, 2]
    theta_max = cfg.twist_max_deg / 180.0 * math.pi
    twist = jax.vmap(lambda mk, c, t: _twist_field(mk, c, t, lamb[2], theta_max))(
        markers, twist_center, theta
    )

    moved = markers + dil + jnp.where(traj_valid[:, None, None], shear + twist, 0.0)
    return jnp.where(any_contact[:, None, None], moved, markers)


def draw_marker_image(
    cfg: FOTSMarkerCfg,
    markers: jax.Array,  # (N, M, 2) x,y pixel positions
    hw: tuple[int, int] | None = None,
) -> jax.Array:
    """Rasterize markers as anti-aliased dark dots, (N, h, w) in [0, 1].

    Batched replacement for the reference's per-marker patch blitting
    (fots_marker_sim.py:346-446): a smooth disk splat evaluated as a soft
    min-distance field over all markers — one fused elementwise program.
    """
    h, w = hw if hw is not None else (cfg.tactile_img_height, cfg.tactile_img_width)
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32), indexing="ij")
    px = jnp.stack([xx, yy], axis=-1)  # (h, w, 2)
    d2 = ((px[None, :, :, None, :] - markers[:, None, None, :, :]) ** 2).sum(-1)  # (N, h, w, M)
    r = cfg.marker_dot_radius_px
    # quadratic bump instead of a gaussian: visually equivalent anti-aliased
    # dots without N*h*w*M transcendentals
    support = 2.5 * r * r
    intensity = (jnp.maximum(1.0 - d2 / support, 0.0) ** 2).max(axis=-1)  # (N, h, w)
    return 1.0 - intensity


def marker_flow(init_markers: jax.Array, markers: jax.Array) -> jax.Array:
    """Stack (initial, current) marker positions: (N, 2, M, 2) — the sensor
    output contract of the reference (gelsight_sensor_cfg.py:44-47)."""
    n, m = markers.shape[0], markers.shape[1]
    init = jnp.broadcast_to(init_markers, (n, m, 2))
    return jnp.stack([init, markers], axis=1)
