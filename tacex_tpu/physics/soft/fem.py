"""FEM elasticity: stable Neo-Hookean tets (batched, autodiff-ready).

The constitutive model of the reference's soft gelpads
(libuipc ``StableNeoHookean``, configured by youngs_modulus / poisson_rate —
reference source/tacex_uipc/tacex_uipc/objects/uipc_object.py:442-470) is the
inversion-safe Neo-Hookean of Smith et al. 2018:

    Psi(F) = mu/2 (I_C - 3) + lambda/2 (J - alpha)^2,  alpha = 1 + mu/lambda

No logs or square roots of J — well-defined for inverted elements, so a
Newton solver with plain backtracking stays NaN-free. Gradients and
Hessian-vector products come from autodiff: the energy is a dense
fused gather + 3x3 algebra over all tets; there is no sparse assembly at all
(SURVEY §7.1.3 — this is XLA territory, not CUDA-style SpMV).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def lame_params(youngs_modulus: float, poisson_ratio: float) -> tuple[float, float]:
    e, nu = youngs_modulus, poisson_ratio
    mu = e / (2.0 * (1.0 + nu))
    lam = e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def precompute_rest(points: np.ndarray, tets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(Dm_inv (T, 3, 3), rest_volume (T,)) for the rest configuration."""
    p = points[tets]  # (T, 4, 3)
    dm = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=-1)  # (T,3,3)
    vol = np.abs(np.linalg.det(dm)) / 6.0
    return np.linalg.inv(dm).astype(np.float32), vol.astype(np.float32)


def deformation_gradients(x: jax.Array, tets: jax.Array, dm_inv: jax.Array) -> jax.Array:
    """F (T, 3, 3) for vertex positions x (V, 3)."""
    p = x[tets]  # (T, 4, 3)
    ds = jnp.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=-1)
    return jnp.einsum("tij,tjk->tik", ds, dm_inv)


def stable_neo_hookean_energy(
    x: jax.Array,  # (V, 3)
    tets: jax.Array,  # (T, 4)
    dm_inv: jax.Array,  # (T, 3, 3)
    rest_vol: jax.Array,  # (T,)
    mu: float,
    lam: float,
) -> jax.Array:
    """Total elastic energy (scalar)."""
    f = deformation_gradients(x, tets, dm_inv)
    ic = jnp.einsum("tij,tij->t", f, f)
    j = jnp.linalg.det(f)
    alpha = 1.0 + mu / lam
    psi = 0.5 * mu * (ic - 3.0) + 0.5 * lam * (j - alpha) ** 2
    return jnp.sum(rest_vol * psi)


def lumped_masses(points: np.ndarray, tets: np.ndarray, density: float) -> np.ndarray:
    """(V,) lumped vertex masses (quarter of each incident tet)."""
    _, vol = precompute_rest(points, tets)
    m = np.zeros(len(points), np.float32)
    for c in range(4):
        np.add.at(m, tets[:, c], density * vol / 4.0)
    return m
