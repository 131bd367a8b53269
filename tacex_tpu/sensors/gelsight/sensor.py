"""GelSightSensor: batched, functional tactile sensor facade.

The batched rebuild of the reference's ``GelSightSensor`` (reference
source/tacex/tacex/gelsight_sensor.py:31-631). Where the reference is an
Isaac-Lab ``SensorBase`` driving a TiledCamera and mutating torch buffers,
this version is a pure function of its inputs: the environment's depth
renderer produces a camera depth image, and ``update`` maps
``(state, depth) -> (state, outputs)`` entirely inside jit. All outputs carry
a leading ``num_envs`` axis and follow the reference's output contract
(gelsight_sensor_cfg.py:39-50):

  height_map     (N, h, w)        mm, camera resolution
  camera_depth   (N, h, w, 1)     m
  tactile_rgb    (N, H, W, 3)     float in [0, 1], tactile resolution
  marker_motion  (N, 2, M, 2)     initial/current marker (x, y) pixel coords

Efficiency note: the reference computes the gel-pad deformation twice per
frame (once inside Taxim's render, once in the FOTS wrapper —
fots_marker_sim.py:128-130). Here the deformation is computed once and shared
by the optical and marker paths.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .fots import marker_motion as fots
from .sensor_cfg import GelSightSensorCfg
from .taxim import calib as taxim_calib
from .taxim import optical as taxim_optical


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GelSightSensorState:
    """Per-env sensor state carried across steps (FOTS trajectory tracking).

    The reference keeps an unbounded python trajectory list per env
    (fots_marker_sim.py:101-104); only the first and last samples are ever
    used, so we carry exactly those (SURVEY.md §7.3).
    """

    traj_start: jax.Array  # (N, 3): [x_mm, y_mm, theta] at first contact
    traj_curr: jax.Array  # (N, 3): latest sample
    traj_count: jax.Array  # (N,) int32: consecutive in-contact frames

    @staticmethod
    def init(num_envs: int) -> "GelSightSensorState":
        z = jnp.zeros((num_envs, 3), jnp.float32)
        return GelSightSensorState(z, z, jnp.zeros((num_envs,), jnp.int32))


class GelSightSensor:
    """Holds static config + calibration; exposes pure update/reset."""

    def __init__(self, cfg: GelSightSensorCfg, num_envs: int):
        self.cfg = cfg
        self.num_envs = num_envs

        self.camera_res = tuple(cfg.sensor_camera_cfg.resolution)  # (w, h)
        ocfg = cfg.optical_sim_cfg
        self._optical_enabled = ocfg is not None and "tactile_rgb" in cfg.data_types
        self._markers_enabled = cfg.marker_motion_sim_cfg is not None and "marker_motion" in cfg.data_types

        if ocfg is not None:
            folder = ocfg.calib_folder_path or None
            self.tactile_res = tuple(ocfg.tactile_img_res)  # (w, h)
            self.calib = taxim_calib.load_calib(folder).at_resolution(
                (self.tactile_res[1], self.tactile_res[0])
            )
        else:
            self.tactile_res = self.camera_res
            self.calib = None

        if cfg.marker_motion_sim_cfg is not None:
            self.marker_cfg = cfg.marker_motion_sim_cfg.to_marker_cfg()
            self.init_markers = fots.init_marker_grid(self.marker_cfg)
        else:
            self.marker_cfg = None
            self.init_markers = None

    # ------------------------------------------------------------------ state
    def init_state(self) -> GelSightSensorState:
        return GelSightSensorState.init(self.num_envs)

    def reset(self, state: GelSightSensorState, env_mask: jax.Array) -> GelSightSensorState:
        """Clear trajectory state for envs where ``env_mask`` is True."""
        m = env_mask[:, None]
        return GelSightSensorState(
            traj_start=jnp.where(m, 0.0, state.traj_start),
            traj_curr=jnp.where(m, 0.0, state.traj_curr),
            traj_count=jnp.where(env_mask, 0, state.traj_count),
        )

    # ------------------------------------------------------------- main update
    def height_map_from_depth(self, camera_depth_m: jax.Array) -> jax.Array:
        """Depth (m) -> height map (mm), non-finite values clipped to the far
        plane (reference gelsight_sensor.py:581-598)."""
        far = self.cfg.sensor_camera_cfg.clipping_range[1]
        hm = jnp.where(jnp.isfinite(camera_depth_m), camera_depth_m, far)
        hm = jnp.clip(hm, 0.0, far)
        return hm * 1000.0

    def compute_indentation_depth(self, height_map_mm: jax.Array) -> jax.Array:
        """(N,) indentation depth in mm (reference taxim_sim.py:115-131)."""
        ocfg = self.cfg.optical_sim_cfg
        hm_m = height_map_mm / 1000.0
        min_dist = hm_m.min(axis=(-2, -1))
        dist = jnp.maximum(min_dist - ocfg.gelpad_to_camera_min_distance, 0.0)
        return jnp.where(dist <= ocfg.gelpad_height, (ocfg.gelpad_height - dist) * 1000.0, 0.0)

    def gel_surface(self, height_map_mm: jax.Array, indent: jax.Array):
        """The pressed gel at tactile resolution: (deformed height (N, h, w)
        mm, contact mask, surface-gradient magnitude, gradient direction).
        ``height_map_mm`` is at camera resolution, ``indent`` (N,) mm."""
        n = height_map_mm.shape[0]
        th, tw = self.tactile_res[1], self.tactile_res[0]
        if height_map_mm.shape[-2:] != (th, tw):
            height_map_mm = jax.image.resize(height_map_mm, (n, th, tw), method="linear")
        shifted = taxim_optical.shift_height_map(height_map_mm, indent)
        deformed, contact_mask = taxim_optical.compute_gel_deformation(self.calib, shifted)
        grad_mag, grad_dir = taxim_optical.generate_normals(
            self.calib, -deformed / self.calib.sensor_params.pixmm
        )
        return deformed, contact_mask, grad_mag, grad_dir

    def update(
        self,
        state: GelSightSensorState,
        camera_depth_m: jax.Array,  # (N, h, w) meters
        obj_yaw: jax.Array | None = None,  # (N,) object yaw relative to sensor
        obj_pos_mm: jax.Array | None = None,  # (N, 2) object xy in sensor frame (mm)
    ) -> tuple[GelSightSensorState, dict[str, jax.Array]]:
        """One sensor frame. Pure; call under jit.

        ``obj_pos_mm`` selects the FrameTransformer FOTS variant (reference
        FOTSMarkerFrameTransformerSimulator, fots_marker_sim_frame_
        transformer.py:26-441): the marker-trajectory contact center comes
        from the TRACKED OBJECT's pose in the sensor frame instead of the
        contact-mask centroid — pose-driven shear/twist even when the mask
        is ambiguous (flat or multi-lobed contacts)."""
        n = camera_depth_m.shape[0]
        out: dict[str, jax.Array] = {}

        height_map = self.height_map_from_depth(camera_depth_m)
        if "camera_depth" in self.cfg.data_types:
            out["camera_depth"] = camera_depth_m[..., None]
        if "height_map" in self.cfg.data_types:
            out["height_map"] = height_map

        if self.cfg.optical_sim_cfg is not None:
            indent = self.compute_indentation_depth(height_map)
            out["indentation_depth"] = indent

        if not (self._optical_enabled or self._markers_enabled):
            return state, out

        th, tw = self.tactile_res[1], self.tactile_res[0]
        deformed, contact_mask, grad_mag, grad_dir = self.gel_surface(height_map, indent)

        if self._optical_enabled:
            deformed_px = deformed / self.calib.sensor_params.pixmm
            raw = taxim_optical.shade(self.calib, grad_mag, grad_dir)
            if self.cfg.optical_sim_cfg.with_shadow:
                raw = taxim_optical._shadow_pass_compact(
                    self.calib, raw, deformed_px, contact_mask, grad_dir
                )
                raw = taxim_optical.gaussian_blur(raw, self.calib.sim_params.shadow_blur_sigma((th, tw)))
                img = raw + self.calib.background
                img = taxim_optical.gaussian_blur(img, self.calib.sim_params.deform_final_sigma((th, tw)))
            else:
                img = raw + self.calib.background
            out["tactile_rgb"] = jnp.clip(img, 0.0, 1.0)

        if self._markers_enabled:
            in_contact = indent > 0.0
            # Contact center (mm, sensor frame) from the contact mask
            # (reference fots_marker_sim.py:132-144). The marker simulation
            # may run at a different nominal resolution than the optical path
            # (the reference's task cfg pairs 32x24 optics with 320x240 FOTS
            # coords); positions here are converted into marker-res pixels.
            mcfg = self.marker_cfg
            sx = mcfg.tactile_img_width / tw
            sy = mcfg.tactile_img_height / th
            if obj_pos_mm is not None:
                cx_mm = obj_pos_mm[:, 0]
                cy_mm = obj_pos_mm[:, 1]
            else:
                cnt = contact_mask.sum(axis=(-2, -1))
                yy, xx = jnp.meshgrid(
                    jnp.arange(th, dtype=jnp.float32), jnp.arange(tw, dtype=jnp.float32), indexing="ij"
                )
                denom = jnp.maximum(cnt, 1)
                cy = (contact_mask * yy).sum(axis=(-2, -1)) / denom * sy
                cx = (contact_mask * xx).sum(axis=(-2, -1)) / denom * sx
                cx_mm = (cx - mcfg.tactile_img_width / 2.0) / mcfg.mm_to_pixel
                cy_mm = (cy - mcfg.tactile_img_height / 2.0) / mcfg.mm_to_pixel
            theta = obj_yaw if obj_yaw is not None else jnp.zeros((n,), jnp.float32)
            sample = jnp.stack([cx_mm, cy_mm, theta], axis=-1)

            first_contact = in_contact & (state.traj_count == 0)
            traj_start = jnp.where(first_contact[:, None], sample, state.traj_start)
            traj_curr = jnp.where(in_contact[:, None], sample, state.traj_curr)
            traj_count = jnp.where(in_contact, state.traj_count + 1, 0)
            traj_valid = traj_count >= 2

            # Depth fed to FOTS: inverted deformation (fots_marker_sim.py:130).
            depth_for_markers = deformed.max(axis=(-2, -1), keepdims=True) - deformed
            markers = fots.marker_motion(
                mcfg,
                depth_for_markers,
                contact_mask,
                traj_start,
                traj_curr,
                traj_valid,
                self.init_markers,
                sample_scale=(1.0 / sx, 1.0 / sy),
            )
            out["marker_motion"] = fots.marker_flow(self.init_markers, markers)
            state = GelSightSensorState(traj_start, traj_curr, traj_count)

        return state, out
