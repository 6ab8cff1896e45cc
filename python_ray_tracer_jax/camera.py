"""Camera ray generation.

Replicates the reference's screen geometry exactly
(``/root/reference/ray_tracer/infrastructure/numpy/base.py:123-141``):

* aspect ratio ``W/H``; screen rectangle ``x ∈ [-1, 1]``,
  ``y ∈ [1/aspect + 0.25, -1/aspect + 0.25]`` (note the +0.25 vertical lift),
* the image plane sits at ``z = 0`` and rays point from ``camera.position``
  through each grid point,
* normalization multiplies by the reciprocal magnitude
  (``base.py:61-64``: ``self * (1.0 / where(mag == 0, 1, mag))``) — kept
  bit-identical because divide-vs-multiply differ in floating point.

The static pixel grid is built with ``np.linspace`` on the host (float64,
then cast) so it is bit-identical to the reference regardless of how
``jnp.linspace`` rounds; only the camera-dependent part stays in the traced
graph so gradients flow to ``camera.position``.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .ops.vecmath import normalize
from .scene import Camera


def pixel_grid(width: int, height: int, dtype: Any) -> jax.Array:
    """Flattened (H*W, 3) grid of image-plane points at z=0 (row-major).

    Mirrors the tile/repeat construction at ``base.py:130-139``.
    """
    aspect_ratio = float(width) / float(height)
    screen = (-1.0, 1.0 / aspect_ratio + 0.25, 1.0, -1.0 / aspect_ratio + 0.25)
    x = np.tile(np.linspace(screen[0], screen[2], width), height)
    y = np.repeat(np.linspace(screen[1], screen[3], height), width)
    z = np.zeros_like(x)
    return jnp.asarray(np.stack([x, y, z], axis=-1), dtype=dtype)


def pixel_pitch(width: int, height: int) -> tuple[float, float]:
    """Screen-space (dx, dy) between adjacent pixel centers."""
    aspect_ratio = float(width) / float(height)
    dx = 2.0 / (width - 1) if width > 1 else 0.0
    dy = (2.0 / aspect_ratio) / (height - 1) if height > 1 else 0.0
    return dx, dy


def ray_directions(camera: Camera, dtype: Any, jitter: jax.Array | None = None) -> jax.Array:
    """(H*W, 3) unit ray directions from the camera through the pixel grid.

    Ref ``base.py:141``: ``(NumpyVector3D(x, y, 0) - camera.position).norm()``.
    ``jitter`` is an optional (H*W, 2) subpixel offset in [-0.5, 0.5)
    pixel units (supersampling); None keeps the reference's center rays.
    """
    grid = pixel_grid(camera.width, camera.height, dtype)
    if jitter is not None:
        dx, dy = pixel_pitch(camera.width, camera.height)
        pitch = jnp.asarray([dx, -dy, 0.0], dtype)  # y decreases downward
        offs = jnp.concatenate([jitter, jnp.zeros_like(jitter[:, :1])], axis=1)
        grid = grid + offs * pitch[None, :]
    return normalize(grid - jnp.asarray(camera.position, dtype=dtype)[None, :])
