"""Multi-chip sharding equivalence on the 8-device virtual CPU mesh.

SURVEY §4 test plan: shard-vs-single-device equivalence assertions, run via
``xla_force_host_platform_device_count=8`` (set in conftest before jax
import) — the standard way to exercise shard_map/psum without pod hardware.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from python_ray_tracer_jax import RenderConfig, render
from python_ray_tracer_jax.models.scenes import inverse_task_scene, reference_scene
from python_ray_tracer_jax.parallel import make_mesh, pad_spheres, render_sharded


@pytest.fixture(scope="module")
def single_image():
    scene = reference_scene(192, 108, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=3, dtype=jnp.float32)
    return scene, cfg, np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))


def test_ray_sharded_matches_single(single_image):
    """Pure ray/tile sharding (8x1 mesh) is bitwise-identical per lane."""
    scene, cfg, expected = single_image
    mesh = make_mesh(8, 1)
    got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)


def test_sphere_sharded_matches_single(single_image):
    """2D (rays x spheres) mesh with collective nearest-hit/shadow reductions."""
    scene, cfg, expected = single_image
    mesh = make_mesh(4, 2)
    got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)


def test_sphere_sharded_smooth_matches_single():
    """Smooth (differentiable) visibility under sphere sharding."""
    scene = reference_scene(96, 54, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    expected = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
    mesh = make_mesh(2, 4)
    got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


def test_many_sphere_scene_sharded():
    """64-sphere inverse-task scene across a 2x4 mesh (needs padding 64->64)."""
    scene = inverse_task_scene(n_spheres=64, width=64, height=36)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32)
    expected = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
    mesh = make_mesh(2, 4)
    got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)


def test_pad_spheres_never_hit():
    """Padding rows are provably unhittable: padded render == unpadded."""
    scene = reference_scene(96, 54, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=3, dtype=jnp.float32)
    expected = np.asarray(render(scene, cfg))

    import dataclasses

    padded = dataclasses.replace(scene, spheres=pad_spheres(scene.spheres, 5))
    assert padded.spheres.count == 5
    got = np.asarray(render(padded, cfg))
    np.testing.assert_allclose(got, expected, rtol=0, atol=0)

    # Smooth mode too: the far-away placement keeps sigmoids at exactly 0.
    cfg_s = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    np.testing.assert_allclose(
        np.asarray(render(padded, cfg_s)), np.asarray(render(scene, cfg_s)), rtol=0, atol=1e-7
    )


def test_nonmultiple_rays_padding():
    """Ray count not divisible by the shard count round-trips via padding."""
    scene = reference_scene(97, 53, dtype=jnp.float32)  # 5141 rays, not / 8
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32)
    expected = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
    mesh = make_mesh(8, 1)
    got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)


def test_supersampling_sharded_matches_single():
    """spp > 1 composes with ray sharding: the jitter is drawn at global
    scope with render()'s exact seed schedule, so the sharded supersampled
    image matches the single-chip one (VERDICT r2 item 5)."""
    scene = reference_scene(96, 54, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, samples_per_pixel=3, rng_seed=11)
    expected = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
    mesh = make_mesh(8, 1)
    got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)


def test_stochastic_sharded_matches_single():
    """Stochastic glossy roughness under sharding: each shard draws its
    GGX samples at its GLOBAL ray offsets, so the sharded render uses the
    same sample sequence as the single-chip one — including with sphere
    sharding.  Isolated lanes may still flip the below-surface fallback
    gate (shard_map changes XLA fusion, hence rounding), same tolerance
    family as the other stochastic parity tests."""
    scene = reference_scene(96, 54, dtype=jnp.float32)
    cfg = RenderConfig(
        max_depth=2, dtype=jnp.float32, stochastic_roughness=True,
        samples_per_pixel=2, rng_seed=7,
    )
    expected = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
    for shape in ((8, 1), (4, 2)):
        mesh = make_mesh(*shape)
        got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
        diff = np.abs(got - expected)
        assert np.quantile(diff, 0.999) < 2e-4, shape
        assert (diff > 1e-2).mean() < 1e-3, shape


def test_tie_sum_sharded_matches_single():
    """tie_mode='sum' (double shading + BOTH winners' mirror continuations,
    a nested trace inside the bounce scan) composes with the mesh."""
    from python_ray_tracer_jax.scene import build_lights, build_spheres, make_scene, make_sphere_row

    rows = [
        make_sphere_row((0.0, 0.0, 3.0), 1.0, specular_gain=0.5, specular_roughness=0.2,
                        diffuse_gain=0.4, diffuse_color=(0.3, 0.2, 0.1)),
        make_sphere_row((0.0, 0.0, 3.0), 1.0, specular_gain=0.5, specular_roughness=0.2,
                        diffuse_gain=0.3, diffuse_color=(0.1, 0.3, 0.2)),
        make_sphere_row((0.0, 0.0, -50.0), 40.0, specular_roughness=0.5,
                        diffuse_gain=0.9, diffuse_color=(0.9, 0.8, 0.2)),
    ]
    scene = make_scene(
        build_spheres(rows, dtype=jnp.float32),
        build_lights((-2.0, 1.0, 2.0), domes=[(0.1, (1.0, 1.0, 1.0))], dtype=jnp.float32),
        (0.0, 0.2, -2.0), 64, 36, dtype=jnp.float32,
    )
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, tie_mode="sum")
    expected = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
    for shape in ((8, 1), (4, 2)):
        mesh = make_mesh(*shape)
        got = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh))
        np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5, err_msg=str(shape))
