"""Taxim calibration data loading.

Loads the GelSight calibration artifacts shipped with the reference
(reference source/tacex_assets/.../calibs/640x480/: ``polycalib.npz``,
``gelmap.npy``, ``shadowTable.npz``, ``params.json``, optionally
``dataPack.npz``) into a single jit-friendly pytree, :class:`TaximCalib`.

Processing mirrors the reference loader semantics
(source/tacex/.../gpu_taxim/sim/taxim_jax.py:38-97):
  * the polynomial gradient LUT's ``grad_b``/``grad_r`` are swapped on disk
    and are stacked back in RGB order, scaled to [0, 1];
  * the gel rest height map is blurred, scaled by pixmm, and normalized to a
    maximum of zero (its former max becomes ``gel_map_shift``);
  * the ragged per-(direction, height) shadow attenuation lists are padded
    with +inf into a dense ``(num_dirs, num_heights+1, max_len, 3)`` table
    (the extra height row is all-inf — the out-of-range sentinel), and each
    direction is fanned into ``num_fan_rays`` ray angles;
  * the background frame ``f0`` comes from ``dataPack.npz`` when present.
    The public calibration snapshot ships that file only as a git-lfs pointer,
    so when it is unavailable we synthesize a smooth tri-chromatic background
    (three LEDs lighting the gel from three sides) — the polynomial LUT
    encodes *deltas* over the background, so any smooth plausible f0 yields
    well-formed tactile images.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ....ops.blur import gaussian_blur
from .params import SensorParams, SimParams, load_params

# Default calibration folder: the reference's GelSight Mini 640x480 data.
REFERENCE_CALIB_GELSIGHT_MINI = (
    Path("/root/reference/source/tacex_assets/tacex_assets/data/Sensors/GelSight_Mini/calibs/640x480")
)
# Repo-local copy (preferred; created by tools/import_calib.py).
LOCAL_CALIB_GELSIGHT_MINI = Path(__file__).resolve().parents[3] / "assets" / "gelsight_mini" / "calibs" / "640x480"

SHADOW_DEPTH_0 = 0.4  # mm; shadow table depth origin (taxim_jax.py:63)
SHADOW_HEIGHT_IDX_OFFSET = 6  # taxim_jax.py:230


def default_calib_folder() -> Path:
    if LOCAL_CALIB_GELSIGHT_MINI.exists():
        return LOCAL_CALIB_GELSIGHT_MINI
    return REFERENCE_CALIB_GELSIGHT_MINI


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TaximCalib:
    """Calibration pytree at a fixed working resolution ``(h, w)``."""

    poly_lut: jax.Array  # (num_bins*num_bins, 6, 3) float32, RGB
    poly_lut_padded: jax.Array  # (num_bins*num_bins, 32): the 18 coefficients
    # of a row padded to 32, the table shade() gathers from
    gel_map: jax.Array  # (h, w) float32, mm, max-normalized to 0
    background: jax.Array  # (h, w, 3) float32 in [0, 1]
    shadow_fan_angles: jax.Array  # (num_dirs, num_fan_rays) float32, radians
    shadow_table: jax.Array  # (num_dirs, num_heights+1, max_len, 3) float32
    gel_map_shift: float = dataclasses.field(metadata=dict(static=True))
    sim_params: SimParams = dataclasses.field(metadata=dict(static=True))
    sensor_params: SensorParams = dataclasses.field(metadata=dict(static=True))

    @property
    def resolution(self) -> tuple[int, int]:
        return tuple(self.gel_map.shape)  # (h, w)

    def at_resolution(self, hw: tuple[int, int]) -> "TaximCalib":
        """Return a calib with gel map / background resized to ``(h, w)``.

        Resizing once here (instead of inside every render call, as the
        reference does at taxim_jax.py:99-103) keeps the hot path gather-free.
        """
        h, w = int(hw[0]), int(hw[1])
        if (h, w) == self.resolution:
            return self
        gel = jax.image.resize(self.gel_map, (h, w), method="linear")
        bg = jax.image.resize(self.background, (h, w, 3), method="linear")
        return dataclasses.replace(self, gel_map=gel, background=bg)


def _synthesize_background(h: int, w: int) -> np.ndarray:
    """Plausible GelSight Mini resting frame: three LEDs (R, G, B) from three
    sides over a gray gel, with gentle vignetting."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = 0.42
    r = base + 0.10 * (1.0 - xx) - 0.03 * yy
    g = base + 0.10 * xx - 0.03 * yy
    b = base + 0.10 * yy
    img = np.stack([r, g, b], axis=-1)
    # radial vignette
    cy, cx = 0.5, 0.5
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    img *= (1.0 - 0.25 * d2 / d2.max())[..., None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _process_initial_frame(f0: jax.Array, sim_params: SimParams) -> jax.Array:
    """Mix f0 with its blur where they differ little (denoise keep-features).

    Cleaned-up version of the reference's initial-frame processing
    (taxim_jax.py:376-392): blur, then blend the blur in (by
    ``frame_mixing_percentage``) wherever the blur-vs-original difference is
    below ``diff_threshold`` (threshold is in 0-255 units on disk).
    """
    sigma = sim_params.initial_frame_sigma(f0.shape[:2])
    f0_blur = gaussian_blur(f0, sigma)
    diff = jnp.abs(f0_blur - f0).mean(axis=-1, keepdims=True)
    fmp = sim_params.frame_mixing_percentage
    mixed = fmp * f0_blur + (1.0 - fmp) * f0
    return jnp.where(diff < sim_params.diff_threshold / 255.0, mixed, f0)


def load_calib(
    calib_folder: Path | str | None = None,
    param_overrides: dict[str, dict[str, Any]] | None = None,
    dtype=jnp.float32,
) -> TaximCalib:
    """Load a calibration folder into a :class:`TaximCalib` pytree."""
    folder = Path(calib_folder) if calib_folder is not None else default_calib_folder()
    sim_params, sensor_params = load_params(folder, param_overrides)

    # --- polynomial LUT (grad_b / grad_r swapped on disk: taxim_jax.py:41-42)
    data = np.load(folder / "polycalib.npz")
    poly = np.stack([data["grad_b"], data["grad_g"], data["grad_r"]], axis=-1) / 255.0
    nb = sensor_params.num_bins
    assert poly.shape == (nb, nb, 6, 3), poly.shape
    poly_flat = poly.reshape(nb * nb, 18)
    poly_lut = jnp.asarray(poly.reshape(nb * nb, 6, 3), dtype)
    poly_lut_padded = jnp.asarray(np.pad(poly_flat, ((0, 0), (0, 14))), dtype)

    # --- gel rest height map: blur, scale to mm, normalize max -> 0
    gel = np.load(folder / "gelmap.npy").astype(np.float32)
    gel_j = gaussian_blur(jnp.asarray(gel), sim_params.deform_final_sigma(gel.shape)) * sensor_params.pixmm
    gel_map_shift = float(jnp.max(gel_j))
    gel_map = (gel_j - gel_map_shift).astype(dtype)

    # --- background frame
    h, w = gel.shape
    data_pack = folder / "dataPack.npz"
    f0 = None
    if data_pack.exists():
        try:
            pack = np.load(data_pack, allow_pickle=True)
            f0_raw = np.asarray(pack["f0"], dtype=np.float32) / 255.0
            if f0_raw.ndim == 3 and f0_raw.shape[0] == 3:  # CHW BGR on disk
                f0_raw = np.moveaxis(f0_raw, 0, -1)
            f0 = jnp.asarray(f0_raw[..., ::-1].copy())  # BGR -> RGB
        except (ValueError, OSError, KeyError):  # git-lfs pointer / bad file
            f0 = None
    if f0 is None:
        f0 = jnp.asarray(_synthesize_background(h, w))
    background = _process_initial_frame(f0, sim_params).astype(dtype)

    # --- shadow tables
    shadow = np.load(folder / "shadowTable.npz", allow_pickle=True)
    directions = np.asarray(shadow["shadowDirections"], np.float32)  # (num_dirs,)
    fan_angle = sim_params.fan_angle
    num_fan_rays = int(fan_angle * 2 / sim_params.fan_precision)
    fan = directions[:, None] + np.linspace(-fan_angle, fan_angle, num_fan_rays, dtype=np.float32)

    table = shadow["shadowTable"]  # (3, num_dirs, num_heights) of ragged lists
    table = np.flip(table, axis=0)  # BGR -> RGB along channel axis
    n_ch, n_dir, n_h = table.shape
    max_len = max((len(e) for e in table.reshape(-1)), default=1)
    max_len = max(max_len, 1)
    dense = np.full((n_ch, n_dir, n_h + 1, max_len), np.inf, dtype=np.float32)
    for c in range(n_ch):
        for d in range(n_dir):
            for hh in range(n_h):
                e = table[c, d, hh]
                if len(e):
                    dense[c, d, hh, : len(e)] = np.asarray(e, np.float32)
    dense /= 255.0
    shadow_table = jnp.asarray(np.moveaxis(dense, 0, -1), dtype)  # (dirs, heights+1, len, 3)

    return TaximCalib(
        poly_lut=poly_lut,
        poly_lut_padded=poly_lut_padded,
        gel_map=gel_map,
        background=background,
        shadow_fan_angles=jnp.asarray(fan, dtype),
        shadow_table=shadow_table,
        gel_map_shift=gel_map_shift,
        sim_params=sim_params,
        sensor_params=sensor_params,
    )
