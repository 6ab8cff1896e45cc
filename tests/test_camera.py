"""Camera ray generation parity with the reference (base.py:123-141)."""

import jax.numpy as jnp
import numpy as np

from python_ray_tracer_jax.camera import pixel_grid, ray_directions
from python_ray_tracer_jax.models.scenes import reference_scene


def test_pixel_grid_matches_reference_formula():
    w, h = 64, 36
    grid = np.asarray(pixel_grid(w, h, jnp.float64))
    aspect = w / h
    x = np.tile(np.linspace(-1, 1, w), h)
    y = np.repeat(np.linspace(1 / aspect + 0.25, -1 / aspect + 0.25, h), w)
    np.testing.assert_array_equal(grid[:, 0], x)
    np.testing.assert_array_equal(grid[:, 1], y)
    np.testing.assert_array_equal(grid[:, 2], np.zeros_like(x))


def test_ray_directions_match_oracle(reference_modules):
    w, h = 96, 54
    scene = reference_scene(w, h, dtype=jnp.float64)
    ours = np.asarray(ray_directions(scene.camera, jnp.float64))

    base = reference_modules["base"]
    domain = reference_modules["domain"]
    cam = domain.Camera(base.NumpyVector3D(0, 0.2, -2), w, h)
    ref = base.NumpyRenderer().get_ray_directions(cam)
    ref_arr = np.stack([np.asarray(c) for c in ref.components()], axis=-1)
    np.testing.assert_array_equal(ours, ref_arr)


def test_directions_are_unit():
    scene = reference_scene(32, 18, dtype=jnp.float32)
    d = np.asarray(ray_directions(scene.camera, jnp.float32))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
