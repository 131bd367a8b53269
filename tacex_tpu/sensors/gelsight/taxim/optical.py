"""Taxim optical simulation: height map -> tactile RGB, batched.

Re-implements the GelSight optical model of the reference's Taxim port
(algorithm spec: reference source/tacex/.../gpu_taxim/sim/taxim_jax.py:159-467
and taxim_torch.py:432-503) as pure batched JAX functions:

  1. gel-pad deformation: clamp object height map against the gel rest
     surface, then a masked Gaussian-pyramid relaxation approximating
     soft-body deformation;
  2. surface normals by central differences -> gradient (magnitude, direction);
  3. per-pixel shading: discretize gradients into a (num_bins x num_bins) bin
     grid, look up 6 polynomial coefficients per RGB channel, evaluate the
     quadratic [x^2, y^2, xy, x, y, 1] model in full-resolution pixel
     coordinates;
  4. optional shadow pass: ray-march attenuation values from contact-boundary
     pixels along calibrated light directions, composited with scatter-min;
  5. add background frame, clip to [0, 1].

Differences from the reference implementation (deliberate):
  * natively batched over a leading env axis — no python-side vmap per image;
    all reductions/blurs/gathers carry the batch dim and compile into one
    program;
  * separable 1-D convolutions instead of FFT 2-D convolutions for all blurs;
  * the shadow pass compacts the contact-boundary sources to a fixed capacity
    with one top_k and composites all (source, ray, step) attenuation pairs
    with one scatter-min per channel (``_shadow_pass_compact``; the
    reference's "fast" path uses a data-dependent while_loop over extracted
    contact pixels — dynamic shapes, hostile to XLA. A dense static-shape
    oracle is kept for tests).
    The compact pass is BIT-IDENTICAL to the dense oracle (tested); the
    residual ours-vs-reference shadow-image error (mean 3.1e-3 / max 0.054)
    is fully attributed to out-of-contact DIRECTION-bin noise shared with the
    no-shadow path: 84% of out-of-contact pixels sit in magnitude bin 0 with
    |grad| ~ 1e-7, where grad_dir = arctan2(blur noise) — FFT (reference) vs
    separable (ours) convolutions seed different noise and the LUT's bin-0
    rows vary ~0.05 across direction bins. The reference reproduces those
    pixels no better against ITSELF (max 0.057 under a 1e-6 mm input
    perturbation — test_shadow_residual_at_reference_noise_floor);
  * no NaN-sentinel + lax.cond for optional press depth: optionality is
    resolved statically at trace time.

Shading is a plain per-pixel ``jnp.take`` from the (num_bins^2, 18) LUT,
as the reference's own GPU Taxim does.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ....ops.blur import box_dilate, gaussian_blur
from .calib import SHADOW_DEPTH_0, SHADOW_HEIGHT_IDX_OFFSET, TaximCalib


def shift_height_map(height_map: jax.Array, press_depth_mm: jax.Array) -> jax.Array:
    """Place the object so its closest point is ``press_depth_mm`` below the
    gel top (reference taxim_jax.py:394-403). ``press_depth_mm``: (...,)."""
    hm_min = height_map.min(axis=(-2, -1), keepdims=True)
    return height_map - hm_min - press_depth_mm[..., None, None]


def compute_gel_deformation(calib: TaximCalib, height_map: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Deform the gel pad under the object height map.

    Args:
      height_map: (..., h, w) mm; 0 = gel top plane, negative = penetration.
    Returns:
      (deformed_gel (..., h, w) mm, contact_mask (..., h, w) bool).
    Reference semantics: taxim_jax.py:405-437.
    """
    shape = height_map.shape[-2:]
    sim = calib.sim_params
    pressing_depth = -height_map.min(axis=(-2, -1), keepdims=True)
    contact_mask = height_map < 0

    gel_map = calib.gel_map  # (h, w), max 0
    joined = jnp.minimum(height_map, gel_map)

    # Slightly shrunken contact mask: pixels pressed deeper than
    # contact_scale * press_depth stay pinned to the object surface.
    mask = ((joined - gel_map) < -pressing_depth * sim.contact_scale) & contact_mask

    blurred = joined
    for sigma in sim.deform_pyramid_sigma(shape):
        blurred = gaussian_blur(blurred, sigma)
        blurred = jnp.where(mask, joined, blurred)
    blurred = gaussian_blur(blurred, sim.deform_final_sigma(shape))
    return blurred, mask


def generate_normals(calib: TaximCalib, height_map_px: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Gradient magnitude/direction maps by central differences.

    ``height_map_px``: (..., h, w) in *pixel* height units (mm / pixmm),
    negated so that bumps point up (reference taxim_jax.py:439-467).
    Gradients are rescaled into full-calibration-resolution pixel units so
    binning is resolution independent.
    """
    h, w = height_map_px.shape[-2:]
    full_h, full_w = calib.sensor_params.height, calib.sensor_params.width
    top = height_map_px[..., 0 : h - 2, 1 : w - 1]
    bot = height_map_px[..., 2:h, 1 : w - 1]
    left = height_map_px[..., 1 : h - 1, 0 : w - 2]
    right = height_map_px[..., 1 : h - 1, 2:w]
    dzdx = (bot - top) * (0.5 * h / full_h)
    dzdy = (right - left) * (0.5 * w / full_w)

    # NaN-safe formulation (double-where): sqrt'(0) and atan2's partials at
    # (0, 0) are NaN, and reverse-mode would propagate them even through the
    # unselected branch of a single where.
    mag2 = dzdx * dzdx + dzdy * dzdy
    nz = mag2 > 0
    mag_tan = jnp.sqrt(jnp.where(nz, mag2, 1.0))
    mag_tan = jnp.where(nz, mag_tan, 0.0)
    grad_mag = jnp.arctan(mag_tan)
    sx = jnp.where(nz, dzdx, 1.0)
    sy = jnp.where(nz, dzdy, 1.0)
    grad_dir = jnp.where(nz, jnp.arctan2(sx, sy), 0.0)

    pad = [(0, 0)] * (height_map_px.ndim - 2) + [(1, 1), (1, 1)]
    return jnp.pad(grad_mag, pad, mode="edge"), jnp.pad(grad_dir, pad, mode="edge")


def _features(calib: TaximCalib, shape: tuple[int, int]) -> jax.Array:
    """Quadratic pixel-coordinate features (h, w, 6) in full-res units.

    Static per resolution — constant-folded under jit.
    """
    h, w = shape
    full_h, full_w = calib.sensor_params.height, calib.sensor_params.width
    yy, xx = np.meshgrid(
        np.linspace(0, full_h, h, endpoint=False, dtype=np.float32),
        np.linspace(0, full_w, w, endpoint=False, dtype=np.float32),
        indexing="ij",
    )
    feats = np.stack([xx * xx, yy * yy, xx * yy, xx, yy, np.ones_like(xx)], axis=-1)
    return jnp.asarray(feats)


def shade(
    calib: TaximCalib,
    grad_mag: jax.Array,
    grad_dir: jax.Array,
    interp: str = "nearest",
    lut_dtype=None,
) -> jax.Array:
    """Polynomial-LUT shading: gradients -> RGB delta over background.

    (..., h, w) -> (..., h, w, 3). Reference: taxim_jax.py:176-199.

    ``interp='nearest'`` reproduces the reference's floor-binned lookup
    (piecewise-constant in the gradients — zero gradient flow).
    ``interp='bilinear'`` interpolates the LUT over (magnitude, direction)
    bins — an extension beyond the reference that makes the optical model
    differentiable w.r.t. the height map (direction axis wraps periodically).
    ``lut_dtype=jnp.bfloat16`` gathers narrower LUT rows, at a max output
    error of 0.0099 (~2.5/255 image counts). The LUT itself cannot be
    replaced by any dense smooth fit: a Chebyshev-x-Fourier least-squares
    over (mag, dir) plateaus at 0.09 worst-case coefficient error for ANY
    basis size (measured 2.4k..130k params) — the per-bin calibration fits
    carry irreducible bin-level noise.
    """
    nb = calib.sensor_params.num_bins
    x_binr = 0.5 * jnp.pi / (nb - 1)
    y_binr = 2.0 * jnp.pi / (nb - 1)
    lut = calib.poly_lut.reshape(nb * nb, 18)
    feats = _features(calib, grad_mag.shape[-2:])  # (h, w, 6)

    if interp == "nearest":
        idx_mag = jnp.clip(jnp.floor(grad_mag / x_binr).astype(jnp.int32), 0, nb - 1)
        idx_dir = jnp.clip(jnp.floor((grad_dir + jnp.pi) / y_binr).astype(jnp.int32), 0, nb - 1)
        table = calib.poly_lut_padded
        if lut_dtype is not None:
            table = table.astype(lut_dtype)
        coeffs = jnp.take(table, idx_mag * nb + idx_dir, axis=0)[..., :18].astype(jnp.float32)
        coeffs = coeffs.reshape(coeffs.shape[:-1] + (6, 3))
        return jnp.einsum("hwk,...hwkc->...hwc", feats, coeffs)

    assert interp == "bilinear", interp
    t_mag = jnp.clip(grad_mag / x_binr, 0.0, nb - 1 - 1e-6)
    t_dir = (grad_dir + jnp.pi) / y_binr  # periodic
    m0 = jnp.floor(t_mag).astype(jnp.int32)
    d0 = jnp.floor(t_dir).astype(jnp.int32)
    fm = (t_mag - m0)[..., None]
    fd = (t_dir - d0)[..., None]
    m1 = jnp.minimum(m0 + 1, nb - 1)
    d0w = jnp.mod(d0, nb)
    d1w = jnp.mod(d0 + 1, nb)

    def g(mi, di):
        c = jnp.take(lut, mi * nb + di, axis=0)
        return c

    c00, c01 = g(m0, d0w), g(m0, d1w)
    c10, c11 = g(m1, d0w), g(m1, d1w)
    c = (
        c00 * (1 - fm) * (1 - fd)
        + c01 * (1 - fm) * fd
        + c10 * fm * (1 - fd)
        + c11 * fm * fd
    )
    c = c.reshape(c.shape[:-1] + (6, 3))
    return jnp.einsum("hwk,...hwkc->...hwc", feats, c)


def _shadow_geometry(
    calib: TaximCalib,
    deformed_gel_px: jax.Array,  # (..., h, w)
    contact_mask: jax.Array,  # (..., h, w) bool
    grad_dir: jax.Array,  # (..., h, w)
):
    """Shared shadow precomputation: boundary ring + per-pixel table row.

    Returns (boundary mask, flat row index into the shadow table, fan-angle
    row index) — all shaped like the inputs.
    """
    h, w = deformed_gel_px.shape[-2:]
    sim = calib.sim_params

    # Grow the contact mask by the attachment kernel; the boundary ring is
    # where shadows attach.
    ks_w, ks_h = sim.shadow_attachment_kernel_size((h, w))
    total = (int(round(ks_h * 2)), int(round(ks_w * 2)))
    first = (total[0] // 2, total[1] // 2)
    second = (total[0] - first[0], total[1] - first[1])
    enlarged = box_dilate(box_dilate(contact_mask, first), second)
    boundary = enlarged & ~contact_mask

    # Per-pixel shadow-table row selection.
    norm_idx = jnp.floor((grad_dir + jnp.pi) / sim.discretize_precision).astype(jnp.int32)
    norm_idx = jnp.clip(norm_idx, 0, calib.shadow_table.shape[0] - 1)

    contact_height = calib.gel_map - deformed_gel_px * calib.sensor_params.pixmm
    height_idx = jnp.floor((contact_height - SHADOW_DEPTH_0) / sim.height_precision).astype(jnp.int32)
    height_idx = height_idx + SHADOW_HEIGHT_IDX_OFFSET
    max_h_idx = calib.shadow_table.shape[1] - 1
    height_idx = jnp.where((height_idx < 0) | (height_idx >= max_h_idx), max_h_idx, height_idx)

    n_heights = calib.shadow_table.shape[1]
    flat_idx = norm_idx * n_heights + height_idx
    return boundary, flat_idx, norm_idx


def _shadow_pass_dense(
    calib: TaximCalib,
    sim_img: jax.Array,  # (h, w, 3) raw shaded (no background)
    deformed_gel_px: jax.Array,  # (h, w)
    contact_mask: jax.Array,  # (h, w) bool
    grad_dir: jax.Array,  # (h, w)
) -> jax.Array:
    """Cast shadows from contact-boundary pixels (single image, dense).

    Reference-shaped oracle: loops over the ray-march step count with a
    full-image scatter-min per step (every pixel is treated as a potential
    source each step). O(h*w * steps * rays) scatter elements. Kept as the
    semantic oracle for ``_shadow_pass_compact`` (the production path) and
    for tiny images.
    Reference: taxim_jax.py:206-304.
    """
    h, w = deformed_gel_px.shape
    sim = calib.sim_params
    boundary, flat_idx, norm_idx = _shadow_geometry(calib, deformed_gel_px, contact_mask, grad_dir)
    # The per-step column is gathered inside the march loop — materializing
    # the full (h, w, L, 3) selection up front (as the reference does,
    # taxim_jax.py:238) costs L x more memory and OOMs at batch.
    table_flat = calib.shadow_table.reshape(-1, calib.shadow_table.shape[2], 3)
    thetas = calib.shadow_fan_angles[norm_idx]  # (h, w, R)
    num_steps = calib.shadow_table.shape[2]

    step_w, step_h = sim.shadow_step((h, w))
    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    num_rays = calib.shadow_fan_angles.shape[1]
    # Rays are unrolled in python (typically 4), keeping every array at
    # (h, w[, 3]).
    cos_rays = [jnp.cos(thetas[..., r]) for r in range(num_rays)]
    sin_rays = [jnp.sin(thetas[..., r]) for r in range(num_rays)]

    def step_body(s, imgs):
        # RGB channels are carried as three separate (h*w,) images.
        dist = (s + 1).astype(jnp.float32)
        col = jax.lax.dynamic_slice_in_dim(table_flat, s, 1, axis=1)[:, 0, :]  # (rows, 3)
        step_vals = [jnp.take(col[:, ch], flat_idx, axis=0) for ch in range(3)]  # 3 x (h, w)
        for r in range(num_rays):
            tx = (xx + step_w * dist * cos_rays[r]).astype(jnp.int32)  # (h, w)
            ty = (yy + step_h * dist * sin_rays[r]).astype(jnp.int32)
            in_bounds = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            txc = jnp.clip(tx, 0, w - 1)
            tyc = jnp.clip(ty, 0, h - 1)
            # Shadow only falls on pixels higher (closer to camera) than source.
            higher = deformed_gel_px < deformed_gel_px[tyc, txc]
            valid = in_bounds & boundary & higher  # (h, w)
            flat = (tyc * w + txc).reshape(-1)
            imgs = tuple(
                imgs[ch].at[flat].min(jnp.where(valid, step_vals[ch], jnp.inf).reshape(-1))
                for ch in range(3)
            )
        return imgs

    imgs0 = tuple(sim_img[..., ch].reshape(-1) for ch in range(3))
    imgs = jax.lax.fori_loop(0, num_steps, step_body, imgs0)
    return jnp.stack(imgs, axis=-1).reshape(h, w, 3)


def _shadow_pass_compact(
    calib: TaximCalib,
    sim_img: jax.Array,  # (n, h, w, 3) raw shaded (no background)
    deformed_gel_px: jax.Array,  # (n, h, w)
    contact_mask: jax.Array,  # (n, h, w) bool
    grad_dir: jax.Array,  # (n, h, w)
    capacity: int = 1024,
) -> jax.Array:
    """Batched shadow pass via boundary compaction + one scatter-min.

    Same math as ``_shadow_pass_dense`` (the reference semantics,
    taxim_jax.py:206-304) restructured for a static-shape batch: shadows
    emanate only from contact-boundary pixels, so instead of scatter-minning
    the full image once per march step (h*w*steps*rays scatter elements), we

      1. compact the boundary pixels to a fixed ``capacity`` per image with
         one ``top_k`` over ``boundary * 2^18 + pixel_id``,
      2. build the full (capacity, rays, steps) pair set of march targets and
         shadow-table attenuation values with plain broadcasting,
      3. apply the reference's admission test (target in bounds, target
         pixel higher than the source) with ONE dest-height gather, and
      4. composite with ONE scatter-min per channel.

    Exact vs the dense oracle whenever the boundary ring has at most
    ``capacity`` pixels (tested); beyond that the highest-index boundary
    pixels are dropped. A 3 mm-ball contact at 320x240 has a ~400 px ring;
    the default capacity covers typical contacts with >2x margin, and the
    cost (one gathered dest height + three scatter-min elements per
    source-ray-step pair) scales linearly in it.
    """
    n, h, w = deformed_gel_px.shape
    sim = calib.sim_params
    boundary, flat_idx, norm_idx = _shadow_geometry(calib, deformed_gel_px, contact_mask, grad_dir)

    hw = h * w
    cap = min(capacity, hw)
    # Compaction: boundary pixels first (any order), then filler pixels whose
    # pairs get masked out via ``is_src``.
    pix_id = jax.lax.broadcasted_iota(jnp.int32, (n, hw), 1)
    score = jnp.where(boundary.reshape(n, hw), pix_id + hw, pix_id)
    top = jax.lax.top_k(score, cap)[0]  # (n, cap)
    is_src = top >= hw
    pos = jnp.where(is_src, top - hw, top)
    sy = (pos // w).astype(jnp.float32)
    sx = (pos % w).astype(jnp.float32)

    take = lambda img: jnp.take_along_axis(img.reshape(n, hw), pos, axis=1)
    flat_src = take(flat_idx)  # (n, cap)
    norm_src = take(norm_idx)
    h_src = take(deformed_gel_px)  # (n, cap) px units

    num_steps = calib.shadow_table.shape[2]
    table_flat = calib.shadow_table.reshape(-1, num_steps, 3)
    vals = jnp.take(table_flat, flat_src, axis=0)  # (n, cap, L, 3)
    thetas = calib.shadow_fan_angles[norm_src]  # (n, cap, R)
    num_rays = thetas.shape[-1]

    # All pair arrays are laid out (n, R, L, cap), the big ``cap`` axis last.
    thetas_t = thetas.transpose(0, 2, 1)[:, :, None, :]  # (n, R, 1, cap)
    step_w, step_h = sim.shadow_step((h, w))
    dist = jnp.arange(1, num_steps + 1, dtype=jnp.float32)[:, None]  # (L, 1)
    tx = (sx[:, None, None, :] + step_w * dist * jnp.cos(thetas_t)).astype(jnp.int32)
    ty = (sy[:, None, None, :] + step_h * dist * jnp.sin(thetas_t)).astype(jnp.int32)
    in_bounds = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    txc = jnp.clip(tx, 0, w - 1)
    tyc = jnp.clip(ty, 0, h - 1)
    tgt = (tyc * w + txc).reshape(n, -1)  # (n, R*L*cap)

    # Admission: shadow falls only on pixels higher than the source
    # (reference taxim_jax.py:275). One gather of dest heights per pair.
    h_dst = jnp.take_along_axis(deformed_gel_px.reshape(n, hw), tgt, axis=1)
    h_dst = h_dst.reshape(n, num_rays, num_steps, cap)
    valid = in_bounds & is_src[:, None, None, :] & (h_src[:, None, None, :] < h_dst)

    # Channels are scatter-minned separately as flat (n, pairs) scalars.
    vals_t = vals.transpose(0, 2, 1, 3)  # (n, L, cap, 3)
    rows = jnp.arange(n)[:, None]
    outs = []
    for ch in range(3):
        v = jnp.broadcast_to(vals_t[:, None, :, :, ch], (n, num_rays, num_steps, cap))
        v = jnp.where(valid, v, jnp.inf).reshape(n, -1)
        outs.append(sim_img[..., ch].reshape(n, hw).at[rows, tgt].min(v))
    return jnp.stack(outs, axis=-1).reshape(n, h, w, 3)


def render(
    calib: TaximCalib,
    height_map: jax.Array,
    press_depth: jax.Array | None = None,
    with_shadow: bool = False,
    orig_hm_fmt: bool = False,
    interp: str = "nearest",
    lut_dtype=None,
) -> jax.Array:
    """Render tactile RGB images from height maps.

    Args:
      calib: calibration at the working resolution (``calib.at_resolution``).
      height_map: (..., h, w) mm. 0 = top of the gel, negative = pressed in
        (the "processed" format of reference taxim_impl.py:124-141).
      press_depth: optional (...,) mm — if given, each height map is shifted
        so its minimum sits ``press_depth`` below the gel top.
      with_shadow: enable the shadow pass.
      orig_hm_fmt: input uses original-Taxim format (inverted, shifted by the
        gel map max).

    Returns: (..., h, w, 3) float32 RGB in [0, 1].
    """
    lead = height_map.shape[:-2]
    h, w = height_map.shape[-2:]
    assert (h, w) == calib.resolution, (
        f"height map {h, w} != calib resolution {calib.resolution}; use calib.at_resolution()"
    )
    hm = height_map.reshape((-1, h, w)).astype(jnp.float32)

    if orig_hm_fmt:
        hm = calib.gel_map_shift - hm
    if press_depth is not None:
        pd = jnp.broadcast_to(jnp.asarray(press_depth, jnp.float32), lead).reshape(-1)
        hm = shift_height_map(hm, pd)

    deformed, contact_mask = compute_gel_deformation(calib, hm)
    deformed_px = deformed / calib.sensor_params.pixmm
    grad_mag, grad_dir = generate_normals(calib, -deformed_px)
    raw = shade(calib, grad_mag, grad_dir, interp=interp, lut_dtype=lut_dtype)  # (N, h, w, 3)

    if not with_shadow:
        img = jnp.clip(raw + calib.background, 0.0, 1.0)
        return img.reshape(lead + (h, w, 3))

    shadowed = _shadow_pass_compact(calib, raw, deformed_px, contact_mask, grad_dir)
    shadowed = gaussian_blur(shadowed, calib.sim_params.shadow_blur_sigma((h, w)))
    img = shadowed + calib.background
    img = gaussian_blur(img, calib.sim_params.deform_final_sigma((h, w)))
    return jnp.clip(img, 0.0, 1.0).reshape(lead + (h, w, 3))
