"""Batched orthographic triangle-mesh depth rasterizer (matmul formulation).

The reference renders arbitrary USD triangle meshes with RTX ray tracing
(reference source/tacex/tacex/gelsight_sensor.py:203-319, TiledCamera).
Instead of per-ray Möller–Trumbore we exploit the tactile camera being
*orthographic*
(parallel rays along camera +Z, the geometry Taxim's calibration assumes):

In the camera frame a triangle's coverage and depth are AFFINE functions of
the pixel coordinates (px, py):

  edge_i(p) = a_i*px + b_i*py + c_i     (>= 0 for all i  <=>  p inside)
  z(p)      = alpha*px + beta*py + gamma (plane through the 3 vertices)

so rasterizing P pixels against T triangles is ONE matmul
``(P, 3) @ (3, 4T)`` followed by a masked min over T. Depth = nearest front-facing-or-back-facing hit with
z > near, i.e. exactly first-hit ray casting, no BVH, no winding rules.

Memory is bounded by scanning triangle chunks with a running (P,) min, so
T can be large without materializing (P, 4T).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import maths

BIG = 1e9
_EPS_AREA = 1e-12


def triangle_affine_coeffs(verts_cam: jax.Array) -> jax.Array:
    """Per-triangle affine coefficient matrix for the rasterizing matmul.

    verts_cam: (T, 3, 3) triangle vertices in CAMERA frame (x right, y down,
    z forward). Returns (T, 3, 4): for each triangle, columns are the three
    orientation-normalized edge functions and the z-plane, each expressed as
    coefficients against the pixel vector [px, py, 1].

    Degenerate (zero projected area — silhouette slivers and zero padding)
    triangles get a constant -BIG edge so no pixel is ever inside.
    """
    p0, p1, p2 = verts_cam[:, 0], verts_cam[:, 1], verts_cam[:, 2]
    x0, y0, z0 = p0[:, 0], p0[:, 1], p0[:, 2]
    x1, y1, z1 = p1[:, 0], p1[:, 1], p1[:, 2]
    x2, y2, z2 = p2[:, 0], p2[:, 1], p2[:, 2]

    # twice the signed projected area
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = jnp.abs(area2) > _EPS_AREA
    s = jnp.where(area2 >= 0, 1.0, -1.0)
    inv_area2 = jnp.where(valid, 1.0 / jnp.where(valid, area2, 1.0), 0.0)

    def edge(xa, ya, xb, yb):
        # e(p) = cross2(pb - pa, p - pa) = a*px + b*py + c
        a = -(yb - ya)
        b = xb - xa
        c = (yb - ya) * xa - (xb - xa) * ya
        return a, b, c

    a0, b0, c0 = edge(x0, y0, x1, y1)  # zero on edge p0->p1 (vertex 2's bary)
    a1, b1, c1 = edge(x1, y1, x2, y2)  # (vertex 0's bary)
    a2, b2, c2 = edge(x2, y2, x0, y0)  # (vertex 1's bary)

    # z(p) = (e1*z0 + e2*z1 + e0*z2) / area2  (barycentric interpolation)
    za = (a1 * z0 + a2 * z1 + a0 * z2) * inv_area2
    zb = (b1 * z0 + b2 * z1 + b0 * z2) * inv_area2
    zc = (c1 * z0 + c2 * z1 + c0 * z2) * inv_area2

    # orientation-normalize edges; poison degenerate triangles
    c0 = jnp.where(valid, s * c0, -BIG)
    coeffs = jnp.stack(
        [
            jnp.stack([s * a0, s * b0, c0], -1),
            jnp.stack([s * a1, s * b1, s * c1], -1),
            jnp.stack([s * a2, s * b2, s * c2], -1),
            jnp.stack([za, zb, zc], -1),
        ],
        axis=-1,
    )  # (T, 3, 4)
    return coeffs


def raster_depth(
    verts_cam: jax.Array,  # (T, 3, 3) camera-frame triangles
    pix: jax.Array,  # (P, 2) camera-frame pixel (x, y)
    near: float = 0.0,
    chunk: int = 1024,
) -> jax.Array:
    """Nearest triangle depth per pixel -> (P,), BIG where no hit."""
    T = verts_cam.shape[0]
    if T == 0:
        return jnp.full((pix.shape[0],), BIG, dtype=jnp.float32)
    coeffs = triangle_affine_coeffs(verts_cam)  # (T, 3, 4)
    pvec = jnp.concatenate([pix, jnp.ones_like(pix[:, :1])], -1)  # (P, 3)

    if T <= chunk:
        out = jnp.einsum("pk,tkj->ptj", pvec, coeffs)  # (P, T, 4)
        inside = (out[..., 0] >= 0) & (out[..., 1] >= 0) & (out[..., 2] >= 0)
        z = out[..., 3]
        return jnp.where(inside & (z > near), z, BIG).min(-1)

    pad = (-T) % chunk
    coeffs = jnp.pad(coeffs, ((0, pad), (0, 0), (0, 0)))
    # padding is all-zero -> c0 == 0 and z == 0; poison the first edge
    if pad:
        poison = jnp.arange(coeffs.shape[0]) >= T
        coeffs = coeffs.at[:, 2, 0].set(jnp.where(poison, -BIG, coeffs[:, 2, 0]))
    coeffs = coeffs.reshape(-1, chunk, 3, 4)

    def body(depth_min, cf):
        out = jnp.einsum("pk,tkj->ptj", pvec, cf)
        inside = (out[..., 0] >= 0) & (out[..., 1] >= 0) & (out[..., 2] >= 0)
        z = out[..., 3]
        d = jnp.where(inside & (z > near), z, BIG).min(-1)
        return jnp.minimum(depth_min, d), None

    depth, _ = jax.lax.scan(body, jnp.full((pvec.shape[0],), BIG), coeffs)
    return depth


def raster_attributes(
    verts_cam: jax.Array,  # (T, 3, 3) camera-frame triangles
    attrs: jax.Array,  # (T, 3, A) per-vertex attributes (e.g. UV)
    pix: jax.Array,  # (P, 2) camera-frame pixel (x, y)
    near: float = 0.0,
    chunk: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """First-hit depth + barycentrically interpolated attributes per pixel.

    The textured-filming primitive (reference: the camera films the
    ``primvars:st``-textured gelpad, ui_extension.py:248-281): attributes
    are affine in pixel coordinates exactly like z, so they ride the same
    rasterizing matmul as extra columns. Returns (depth (P,), attr (P, A));
    depth BIG / attr 0 where no hit.
    """
    T, A = verts_cam.shape[0], attrs.shape[-1]
    P = pix.shape[0]
    if T == 0:
        return jnp.full((P,), BIG, jnp.float32), jnp.zeros((P, A), jnp.float32)
    coeffs = triangle_affine_coeffs(verts_cam)  # (T, 3, 4)
    # attribute planes: same barycentric combination as the z plane
    p0, p1, p2 = verts_cam[:, 0], verts_cam[:, 1], verts_cam[:, 2]
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = jnp.abs(area2) > _EPS_AREA
    inv_area2 = jnp.where(valid, 1.0 / jnp.where(valid, area2, 1.0), 0.0)

    def edge(xa, ya, xb, yb):
        return -(yb - ya), xb - xa, (yb - ya) * xa - (xb - xa) * ya

    a0, b0, c0 = edge(x0, y0, x1, y1)
    a1, b1, c1 = edge(x1, y1, x2, y2)
    a2, b2, c2 = edge(x2, y2, x0, y0)
    v0, v1, v2 = attrs[:, 0], attrs[:, 1], attrs[:, 2]  # (T, A)
    aa = (a1[:, None] * v0 + a2[:, None] * v1 + a0[:, None] * v2) * inv_area2[:, None]
    ab = (b1[:, None] * v0 + b2[:, None] * v1 + b0[:, None] * v2) * inv_area2[:, None]
    ac = (c1[:, None] * v0 + c2[:, None] * v1 + c0[:, None] * v2) * inv_area2[:, None]
    attr_coeffs = jnp.stack([aa, ab, ac], axis=1)  # (T, 3, A)
    coeffs = jnp.concatenate([coeffs, attr_coeffs], axis=-1)  # (T, 3, 4+A)
    pvec = jnp.concatenate([pix, jnp.ones_like(pix[:, :1])], -1)

    pad = (-T) % chunk
    if pad:
        coeffs = jnp.pad(coeffs, ((0, pad), (0, 0), (0, 0)))
        poison = jnp.arange(coeffs.shape[0]) >= T
        coeffs = coeffs.at[:, 2, 0].set(jnp.where(poison, -BIG, coeffs[:, 2, 0]))
    coeffs = coeffs.reshape(-1, min(chunk, coeffs.shape[0]), 3, 4 + A)

    def body(carry, cf):
        z_min, attr_min = carry
        out = jnp.einsum("pk,tkj->ptj", pvec, cf)  # (P, t, 4+A)
        inside = (out[..., 0] >= 0) & (out[..., 1] >= 0) & (out[..., 2] >= 0)
        z = jnp.where(inside & (out[..., 3] > near), out[..., 3], BIG)
        idx = jnp.argmin(z, axis=-1)  # (P,)
        z_best = jnp.take_along_axis(z, idx[:, None], axis=1)[:, 0]
        a_best = jnp.take_along_axis(
            out[..., 4:], idx[:, None, None], axis=1
        )[:, 0]  # (P, A)
        better = z_best < z_min
        return (
            jnp.where(better, z_best, z_min),
            jnp.where(better[:, None], a_best, attr_min),
        ), None

    (depth, attr), _ = jax.lax.scan(
        body,
        (jnp.full((P,), BIG), jnp.zeros((P, A), jnp.float32)),
        coeffs,
    )
    return depth, attr


def sample_texture_bilinear(tex: jax.Array, uv: jax.Array) -> jax.Array:
    """Bilinear texture fetch. tex: (th, tw, C); uv: (..., 2) in [0, 1]
    (u along width, v along height). Out-of-range UVs clamp to the edge."""
    th, tw = tex.shape[0], tex.shape[1]
    u = jnp.clip(uv[..., 0], 0.0, 1.0) * (tw - 1)
    v = jnp.clip(uv[..., 1], 0.0, 1.0) * (th - 1)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    u1 = jnp.minimum(u0 + 1, tw - 1)
    v1 = jnp.minimum(v0 + 1, th - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    flat = tex.reshape(-1, tex.shape[-1])
    t00 = flat[v0 * tw + u0]
    t01 = flat[v0 * tw + u1]
    t10 = flat[v1 * tw + u0]
    t11 = flat[v1 * tw + u1]
    return (
        t00 * (1 - fu) * (1 - fv)
        + t01 * fu * (1 - fv)
        + t10 * (1 - fu) * fv
        + t11 * fu * fv
    )


def world_tris_to_cam(cam_pos: jax.Array, cam_quat: jax.Array, tris_w: jax.Array) -> jax.Array:
    """(T, 3, 3) world triangles -> camera frame (+Z forward, wxyz quat)."""
    flat = tris_w.reshape(-1, 3)
    loc = maths.quat_apply_inverse(
        jnp.broadcast_to(cam_quat, (flat.shape[0], 4)), flat - cam_pos[None, :]
    )
    return loc.reshape(tris_w.shape)


def transform_tris(pos: jax.Array, quat: jax.Array, tris: jax.Array, scale=1.0) -> jax.Array:
    """Rigidly place (T, 3, 3) local-frame triangles into the world."""
    flat = tris.reshape(-1, 3) * scale
    out = maths.quat_apply(jnp.broadcast_to(quat, (flat.shape[0], 4)), flat) + pos[None, :]
    return out.reshape(tris.shape)
