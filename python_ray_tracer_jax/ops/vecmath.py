"""Small vector helpers over packed (..., 3) arrays.

The reference's ``NumpyVector3D`` (``base.py:28-79``) is a
struct-of-arrays wrapper whose x/y/z may each be full ndarrays.  Here the
component axis is packed last — (N, 3) — so one array holds a whole ray
batch and XLA fuses the per-component arithmetic.

Floating-point contracts kept from the reference:

* ``dot`` expands to ``x*x + y*y + z*z`` in that association order
  (``base.py:34-35``) — ``jnp.sum`` over the last axis may associate
  differently, so we index components explicitly.
* ``normalize`` multiplies by a guarded reciprocal magnitude rather than
  dividing (``base.py:61-64``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Component-order-exact dot product over the trailing axis of size 3."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm2(a: jax.Array) -> jax.Array:
    """Squared magnitude — the reference's ``__abs__`` (``base.py:37-38``)."""
    return dot(a, a)


def normalize(a: jax.Array) -> jax.Array:
    """Unit vector with the reference's zero guard (``base.py:61-64``)."""
    mag = jnp.sqrt(dot(a, a))
    inv = 1.0 / jnp.where(mag == 0, jnp.ones_like(mag), mag)
    return a * inv[..., None]


def reflect(direction: jax.Array, normal: jax.Array) -> jax.Array:
    """Mirror direction, normalized — ref ``shader.py:151``."""
    return normalize(direction - normal * (2.0 * dot(direction, normal))[..., None])


def orthonormal_basis(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Branchless tangent frame around unit normals (Duff/Frisvad)."""
    s = jnp.where(n[..., 2] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = jnp.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], axis=-1)
    t2 = jnp.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t1, t2


def ggx_perturb_reflect(
    direction: jax.Array,  # (N, 3) incoming unit dirs
    normal: jax.Array,  # (N, 3) unit normals
    roughness: jax.Array,  # (N,)
    xi: jax.Array,  # (N, 2) uniforms in [0, 1)
) -> jax.Array:
    """Reflect about a GGX-sampled microfacet half-vector.

    Classic NDF sampling: ``tan^2(theta_h) = alpha^2 * xi1 / (1 - xi1)``
    with ``alpha = roughness^2`` (the reference's alpha convention,
    ``shader.py:294``).  ``roughness = 0`` degenerates to the exact mirror;
    samples that would send the ray below the surface fall back to the
    mirror direction (keeps energy bounded, no black fringes).
    """
    alpha = (roughness**2)[..., None]
    xi1 = xi[..., 0:1]
    xi2 = xi[..., 1:2]
    tan2 = (alpha**2) * xi1 / jnp.maximum(1.0 - xi1, 1e-8)
    cos_t = 1.0 / jnp.sqrt(1.0 + tan2)
    # Double-where the sqrt: at tiny roughness cos_t collapses to 1.0 in
    # f32 and sqrt'(0) = inf would poison the gradient (0*inf = NaN); the
    # sample is then the exact mirror, whose derivative the mirror branch
    # already carries, so a zero slope here is the correct limit.
    sin2 = jnp.maximum(0.0, 1.0 - cos_t**2)
    sin_pos = sin2 > 0
    sin_t = jnp.where(sin_pos, jnp.sqrt(jnp.where(sin_pos, sin2, 1.0)), 0.0)
    phi = (2.0 * jnp.pi) * xi2
    t1, t2 = orthonormal_basis(normal)
    h = normalize(t1 * (sin_t * jnp.cos(phi)) + t2 * (sin_t * jnp.sin(phi)) + normal * cos_t)
    r = reflect(direction, h)
    mirror = reflect(direction, normal)
    above = dot(r, normal) > 0
    return jnp.where(above[..., None], r, mirror)
