"""Ray-chunked rendering parity + determinism/nan invariants (SURVEY §5.2)."""

import jax
import jax.numpy as jnp
import numpy as np

from python_ray_tracer_jax import RenderConfig, render
from python_ray_tracer_jax.models.scenes import random_spheres_scene, reference_scene


def test_ray_chunked_matches_whole_frame():
    scene = reference_scene(97, 53, dtype=jnp.float32)  # 5141 rays: ragged chunks
    cfg0 = RenderConfig(max_depth=3, dtype=jnp.float32)
    cfg1 = RenderConfig(max_depth=3, dtype=jnp.float32, ray_chunk=1024)
    a = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg0))
    b = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg1))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_chunked_many_spheres_smooth():
    scene = random_spheres_scene(n_spheres=64, width=64, height=36)
    cfg0 = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    cfg1 = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth", ray_chunk=512)
    a = np.asarray(render(scene, cfg0))
    b = np.asarray(render(scene, cfg1))
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_render_is_deterministic_and_finite():
    """Deterministic replay: two runs produce bitwise-identical, finite
    images (the reproducibility assertion SURVEY §5.2 asks CI to carry)."""
    scene = reference_scene(96, 54, dtype=jnp.float32)
    for cfg in (
        RenderConfig(max_depth=4, dtype=jnp.float32),
        RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth"),
    ):
        a = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
        b = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def test_grads_finite_with_debug_nans():
    """Backward pass stays NaN-free under jax_debug_nans (the masked-lane
    double-where contract in the sweep/shading)."""
    from python_ray_tracer_jax.optim import make_loss_fn, scene_to_params

    scene = reference_scene(48, 27, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    target = jnp.clip(render(scene, RenderConfig(max_depth=2, dtype=jnp.float32)), 0.0, 1.0)
    params = scene_to_params(scene)
    with jax.debug_nans(True):
        grads = jax.grad(make_loss_fn(scene, target, cfg))(params)
    for key, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), key
