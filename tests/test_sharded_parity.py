"""Sharded rendering and training against one device, on the 8 virtual CPU
devices: ray sharding, (rays x spheres) meshes, gradients, remat, smooth
visibility, stochastic sampling and big sphere tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from python_ray_tracer_jax import RenderConfig, render
from python_ray_tracer_jax.models.scenes import inverse_task_scene, random_spheres_scene, reference_scene
from python_ray_tracer_jax.optim import make_loss_fn, scene_to_params
from python_ray_tracer_jax.parallel import make_mesh, render_sharded

_render = jax.jit(render, static_argnums=1)
_render_sharded = jax.jit(render_sharded, static_argnums=(1, 2))


def _assert_grads_close(g_ref, g, rtol=5e-3, atol_frac=2e-3):
    for key in g_ref:
        a, b = np.asarray(g_ref[key]), np.asarray(g[key])
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol_frac * scale, err_msg=key)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_hard_render_matches_single(shape):
    scene = reference_scene(96, 54, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=3, dtype=jnp.float32)
    exp = np.asarray(_render(scene, cfg))
    got = np.asarray(_render_sharded(scene, cfg, make_mesh(*shape)))
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)


def test_hard_2d_mesh_gradients():
    """Gradients through the sphere-sharded hard sweep (pmin selectors +
    psum'd winner values) == single-device gradients."""
    scene = reference_scene(48, 27, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32)
    target = jnp.clip(jnp.asarray(_render(scene, cfg)), 0.0, 1.0) * 0.9
    params = scene_to_params(scene, sphere_fields=("center", "radius"), light_fields=(), camera=False)
    g_x = jax.jit(jax.grad(make_loss_fn(scene, target, cfg)))(params)
    g_m = jax.jit(jax.grad(make_loss_fn(scene, target, cfg, make_mesh(2, 2))))(params)
    _assert_grads_close(g_x, g_m)


def test_remat_forward_and_grads_match():
    scene = reference_scene(64, 36, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=3, dtype=jnp.float32, visibility="smooth")
    cfg_r = RenderConfig(max_depth=3, dtype=jnp.float32, visibility="smooth", remat=True)
    a = np.asarray(render(scene, cfg))
    b = np.asarray(render(scene, cfg_r))
    np.testing.assert_array_equal(a, b)

    target = jnp.clip(jnp.asarray(a), 0.0, 1.0)
    params = scene_to_params(scene)
    g1 = jax.jit(jax.grad(make_loss_fn(scene, target, cfg)))(params)
    g2 = jax.jit(jax.grad(make_loss_fn(scene, target, cfg_r)))(params)
    for key in g1:
        np.testing.assert_allclose(np.asarray(g2[key]), np.asarray(g1[key]), rtol=1e-4, atol=1e-6, err_msg=key)


def test_smooth_ray_sharding_forward_and_grads():
    """Smooth visibility under 8-way ray sharding: forward and every
    gradient leaf against one device (target perturbed off the optimum so
    gradients have real magnitude)."""
    scene = reference_scene(64, 36, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth",
                       edge_sharpness=20.0, shadow_sharpness=20.0)
    exp = np.asarray(_render(scene, cfg))
    mesh = make_mesh(8, 1)
    got = np.asarray(_render_sharded(scene, cfg, mesh))
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4)

    target = jnp.clip(jnp.asarray(exp), 0.0, 1.0) * 0.85
    params = scene_to_params(scene)
    g1 = jax.jit(jax.grad(make_loss_fn(scene, target, cfg)))(params)
    g2 = jax.jit(jax.grad(make_loss_fn(scene, target, cfg, mesh)))(params)
    _assert_grads_close(g1, g2)


def _collectives(jaxpr, in_loop=False, out=None):
    """``(primitive name, inside a scan/while body)`` of every collective."""
    out = [] if out is None else out
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name.startswith(("psum", "pmin", "pmax", "all_gather")):
            out.append((name, in_loop))
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    _collectives(sub, in_loop or name in ("scan", "while"), out)
    return out


def test_ray_sharded_gradient_sums_after_the_bounce_loop():
    """Ray sharding alone: the replicated scene is made varying once at the
    shard_map boundary, so the gradient all-reduces come after the backward
    bounce loop, not once per parameter use inside it."""
    scene = inverse_task_scene(n_spheres=8, width=32, height=16)
    cfg = RenderConfig(max_depth=3, dtype=jnp.float32, visibility="smooth")
    target = jnp.zeros((16, 32, 3), jnp.float32)
    loss = make_loss_fn(scene, target, cfg, make_mesh(4, 1))
    found = _collectives(jax.make_jaxpr(jax.value_and_grad(loss))(scene_to_params(scene)).jaxpr)
    assert found and not [c for c in found if c[1]], found


def test_big_table_ray_sharding():
    """A table above the GPU kernel threshold under 2-way ray sharding (the
    sharded trace keeps the XLA sweep) == one device."""
    scene = random_spheres_scene(n_spheres=256, width=128, height=72)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32)
    exp = np.asarray(_render(scene, cfg))
    got = np.asarray(_render_sharded(scene, cfg, make_mesh(2, 1)))
    diff = np.abs(got - exp)
    assert np.quantile(diff, 0.999) < 2e-3
    assert (diff > 1e-2).mean() < 1e-3


@pytest.mark.parametrize("stochastic", [False, True])
def test_smooth_sphere_sharding(stochastic):
    """Smooth visibility under sphere sharding (all_gather'd shadow
    products, psum'd coverage) == one device, deterministic and stochastic,
    on two mesh shapes; gradients on (2, 4)."""
    scene = inverse_task_scene(n_spheres=24, width=48, height=27)
    extra = {"stochastic_roughness": True, "rng_seed": 6} if stochastic else {}
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth", **extra)
    exp = np.asarray(_render(scene, cfg))
    for shape in ((1, 2), (2, 4)):
        got = np.asarray(_render_sharded(scene, cfg, make_mesh(*shape)))
        diff = np.abs(got - exp)
        assert np.quantile(diff, 0.999) < 2e-4, shape
        assert (diff > 1e-2).mean() < 1e-3, shape

    target = jnp.clip(jnp.asarray(exp), 0.0, 1.0) * 0.9
    params = scene_to_params(scene)
    g_x = jax.jit(jax.grad(make_loss_fn(scene, target, cfg)))(params)
    g_m = jax.jit(jax.grad(make_loss_fn(scene, target, cfg, make_mesh(2, 4))))(params)
    _assert_grads_close(g_x, g_m)
