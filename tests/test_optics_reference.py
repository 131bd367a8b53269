"""Taxim shading and gel deformation against plain float64 numpy references
written from the algorithm (reference taxim_jax.py:176-199 and 405-437).

The CPU cases run at 60x80. The ``gpu`` cases repeat them at the sensor's
320x240 on the card, where float32 matmuls default to TF32.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tacex_tpu.sensors.gelsight.taxim import optical
from tacex_tpu.sensors.gelsight.taxim.calib import load_calib


def _sphere_press(n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w) mm height maps, 0 = gel top, of spheres pressed 0.5-1.5 mm."""
    rng = np.random.default_rng(0)
    mm_per_px = 19.0 / w
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for _ in range(n):
        cy, cx = h / 2 + rng.uniform(-h / 8, h / 8), w / 2 + rng.uniform(-w / 8, w / 8)
        radius, press = rng.uniform(3.0, 5.0), rng.uniform(0.5, 1.5)
        r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) * mm_per_px**2
        z = np.where(r2 < radius**2, radius - np.sqrt(np.maximum(radius**2 - r2, 0.0)), radius)
        out.append(z - press)
    return np.stack(out).astype(np.float32)


def _np_blur(img: np.ndarray, sigma_xy) -> np.ndarray:
    """Separable Gaussian, reflect padding, taps until the outermost weight
    falls below 1e-5 (odd size), along H with sigma_y then W with sigma_x."""
    out = img.astype(np.float64)
    for axis, sigma in ((1, sigma_xy[1]), (2, sigma_xy[0])):
        arg = -2.0 * math.log(1e-5 * math.sqrt(2.0 * math.pi) * sigma)
        k = int(round(math.sqrt(arg) * sigma)) // 2 * 2 + 1 if sigma > 0 and arg > 0 else 1
        if k == 1:
            continue
        x = np.arange(k) - (k - 1) / 2
        taps = np.exp(-0.5 * (x / sigma) ** 2)
        taps /= taps.sum()
        pad = [(0, 0)] * out.ndim
        pad[axis] = ((k - 1) // 2, (k - 1) // 2)
        padded = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        out = sum(taps[t] * np.take(padded, np.arange(t, t + n), axis=axis) for t in range(k))
    return out


def _np_deformation(calib, hm: np.ndarray):
    sim = calib.sim_params
    gel = np.asarray(calib.gel_map, np.float64)
    hm = hm.astype(np.float64)
    pressing = -hm.min(axis=(-2, -1), keepdims=True)
    joined = np.minimum(hm, gel)
    mask = ((joined - gel) < -pressing * sim.contact_scale) & (hm < 0)
    blurred = joined
    for sigma in sim.deform_pyramid_sigma(hm.shape[-2:]):
        blurred = np.where(mask, joined, _np_blur(blurred, sigma))
    return _np_blur(blurred, sim.deform_final_sigma(hm.shape[-2:])), mask


def _np_shade(calib, grad_mag: np.ndarray, grad_dir: np.ndarray) -> np.ndarray:
    nb = calib.sensor_params.num_bins
    lut = np.asarray(calib.poly_lut, np.float64).reshape(nb * nb, 6, 3)
    i_mag = np.clip(np.floor(grad_mag / (0.5 * np.pi / (nb - 1))), 0, nb - 1).astype(int)
    i_dir = np.clip(np.floor((grad_dir + np.pi) / (2.0 * np.pi / (nb - 1))), 0, nb - 1).astype(int)
    h, w = grad_mag.shape[-2:]
    yy, xx = np.meshgrid(
        np.arange(h) * (calib.sensor_params.height / h),
        np.arange(w) * (calib.sensor_params.width / w),
        indexing="ij",
    )
    feats = np.stack([xx * xx, yy * yy, xx * yy, xx, yy, np.ones_like(xx)], -1)  # (h, w, 6)
    return np.einsum("hwk,nhwkc->nhwc", feats, lut[i_mag * nb + i_dir])


def _check_deformation(hw, n):
    calib = load_calib().at_resolution(hw)
    hm = _sphere_press(n, *hw)
    deformed, mask = jax.jit(optical.compute_gel_deformation)(calib, jnp.asarray(hm))
    ref, ref_mask = _np_deformation(calib, hm)
    np.testing.assert_array_equal(np.asarray(mask), ref_mask)
    # mm; the map spans ~5 mm, so 1e-4 mm is float32 rounding through eight blurs
    np.testing.assert_allclose(np.asarray(deformed), ref, atol=1e-4)


def _check_shade(hw, n):
    calib = load_calib().at_resolution(hw)
    deformed, _ = optical.compute_gel_deformation(calib, jnp.asarray(_sphere_press(n, *hw)))
    grad_mag, grad_dir = optical.generate_normals(calib, -deformed / calib.sensor_params.pixmm)
    got = np.asarray(jax.jit(optical.shade)(calib, grad_mag, grad_dir))
    ref = _np_shade(calib, np.asarray(grad_mag, np.float64), np.asarray(grad_dir, np.float64))
    err = np.abs(got - ref).max(axis=-1)
    # binning floor()s float32 gradients: a value within rounding of a bin
    # edge may land in the neighbouring row, so allow a few such pixels
    assert (err > 1e-4).mean() < 2e-3, (err > 1e-4).mean()
    assert np.median(err) < 1e-5


def test_deformation_matches_numpy():
    _check_deformation((60, 80), 3)


def test_shade_nearest_matches_numpy():
    _check_shade((60, 80), 3)


@pytest.mark.gpu
def test_deformation_matches_numpy_on_gpu(gpu):
    _check_deformation((240, 320), 8)


@pytest.mark.gpu
def test_shade_nearest_matches_numpy_on_gpu(gpu):
    _check_shade((240, 320), 8)
