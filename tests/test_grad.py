"""Differentiability: gradient existence, finite-difference checks, training.

BASELINE.json config 3: gradients of an L2 pixel loss w.r.t. sphere
centers/radii/colors and light params, finite-difference verified.  The
reference is forward-only (SURVEY §2 row 18) so there is no upstream
behavior to match — these tests define the new capability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from python_ray_tracer_jax import RenderConfig, render
from python_ray_tracer_jax.models.scenes import reference_scene
from python_ray_tracer_jax.optim import combine, make_loss_fn, scene_to_params
from python_ray_tracer_jax.optim.train import fit, init_state, make_train_step

W, H = 64, 36


@pytest.fixture(scope="module")
def setup():
    scene = reference_scene(W, H, dtype=jnp.float64)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float64, visibility="smooth", edge_sharpness=20.0, shadow_sharpness=20.0)
    # Target: the same scene rendered in hard mode (a realistic target image).
    target = np.asarray(render(scene, RenderConfig(max_depth=2, dtype=jnp.float64)))
    return scene, cfg, jnp.clip(jnp.asarray(target), 0.0, 1.0)


def test_grads_exist_and_finite(setup):
    scene, cfg, target = setup
    params = scene_to_params(scene)
    loss_fn = make_loss_fn(scene, target, cfg)
    val, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(val))
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in flat)
    # Geometry and appearance must actually receive signal.  (diffuse_color
    # is legitimately zero-grad in the reference scene: the only sphere with
    # diffuse_gain > 0 is the checker-textured ground, shader.py:130-141.)
    assert float(jnp.abs(grads["spheres.center"]).max()) > 0
    assert float(jnp.abs(grads["spheres.diffuse_gain"]).max()) > 0
    assert float(jnp.abs(grads["lights.point_position"]).max()) > 0


def _fd_check(scene, cfg, target, key, idx, rel):
    params = scene_to_params(scene)
    loss_fn = jax.jit(make_loss_fn(scene, target, cfg))
    grad = jax.jit(jax.grad(make_loss_fn(scene, target, cfg)))(params)
    g_ad = float(grad[key][idx])

    eps = 1e-5
    p_plus = dict(params)
    p_plus[key] = params[key].at[idx].add(eps)
    p_minus = dict(params)
    p_minus[key] = params[key].at[idx].add(-eps)
    g_fd = (float(loss_fn(p_plus)) - float(loss_fn(p_minus))) / (2 * eps)

    assert g_ad == pytest.approx(g_fd, rel=rel, abs=1e-9), f"{key}{idx}: ad={g_ad} fd={g_fd}"


@pytest.mark.parametrize(
    "key,idx",
    [
        ("spheres.specular_gain", (1,)),
        ("spheres.diffuse_gain", (2,)),
        ("spheres.specular_roughness", (1,)),
        ("spheres.iridescence_gain", (0,)),
        ("lights.dome_intensity", (0,)),
    ],
)
def test_finite_difference_shading(setup, key, idx):
    """Shading-linear params move no visibility boundary: FD matches tightly."""
    scene, cfg, target = setup
    _fd_check(scene, cfg, target, key, idx, rel=1e-5)


@pytest.mark.parametrize(
    "key,idx,rel",
    [
        ("spheres.center", (1, 0), 3e-2),  # red sphere x
        # Radius directly dilates the silhouette: the strongest boundary
        # (edge-sampling) term, which the sigmoid coverage only
        # approximates — loosest check.
        ("spheres.radius", (1,), 1e-1),
        ("lights.point_position", (1,), 3e-2),
        ("camera.position", (2,), 3e-2),
    ],
)
def test_finite_difference_geometry(setup, key, idx, rel):
    """Geometry params move silhouettes/shadows/texture cells; the FD stencil
    crosses residual hard discontinuities (checker cells, argmin winner
    flips) the relaxation does not smooth, so the check is looser."""
    scene, cfg, target = setup
    _fd_check(scene, cfg, target, key, idx, rel=rel)


def test_adam_recovers_sphere_color():
    """End-to-end inverse rendering: perturb the ground color, recover it."""
    import dataclasses

    scene = reference_scene(48, 27, dtype=jnp.float32)
    # Constant-texture ground so diffuse_color carries gradient.
    scene = dataclasses.replace(
        scene,
        spheres=dataclasses.replace(scene.spheres, texture_kind=jnp.zeros_like(scene.spheres.texture_kind)),
    )
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    # Smooth-mode target: the unperturbed params reach loss 0 exactly (no
    # relaxation floor), so descent is cleanly measurable.
    target = jnp.clip(render(scene, cfg), 0.0, 1.0)

    params = scene_to_params(scene, sphere_fields=("diffuse_color",), light_fields=(), camera=False)
    true_color = np.asarray(params["spheres.diffuse_color"])
    params["spheres.diffuse_color"] = params["spheres.diffuse_color"].at[2].set(
        jnp.asarray([0.3, 0.6, 0.2], jnp.float32)
    )

    final, history = fit(scene, target, cfg, params, steps=60, learning_rate=0.05)
    assert history[-1] < history[0] * 0.1, f"loss did not drop: {history[0]} -> {history[-1]}"
    got = np.asarray(final["spheres.diffuse_color"])[2]
    np.testing.assert_allclose(got, true_color[2], atol=0.15)


def test_train_step_jits_and_descends():
    # Gentle sharpness: at the default (200) silhouette gradients oscillate
    # at subpixel scale (aliasing) and plain descent stalls — the sharpness
    # knob trades forward fidelity for optimization landscape smoothness.
    cfg32 = RenderConfig(
        max_depth=2, dtype=jnp.float32, visibility="smooth", edge_sharpness=20.0, shadow_sharpness=20.0
    )
    scene32 = reference_scene(W, H, dtype=jnp.float32)
    target = jnp.clip(render(scene32, cfg32), 0.0, 1.0)
    # Shading-linear parameter: smooth convex-ish landscape, no geometry
    # drift from co-optimized leaves (center moves of the giant ground
    # sphere shift the checker pattern and confound the descent signal).
    params = scene_to_params(scene32, sphere_fields=("specular_gain",), light_fields=(), camera=False)
    params["spheres.specular_gain"] = params["spheres.specular_gain"].at[1].add(0.3)
    optimizer = optax.adam(2e-2)
    loss_fn = make_loss_fn(scene32, target, cfg32)
    step = make_train_step(loss_fn, optimizer)
    state = init_state(params, optimizer)
    losses = []
    for _ in range(25):
        state, loss = step(state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, f"{losses[0]} -> {losses[-1]}"


def test_config3_loss_vs_reference_target():
    """BASELINE config 3 verbatim: L2 pixel loss against the checked-in
    ``ref_spec_noRoughness_domelight.png`` at its native 563x527, gradients
    w.r.t. sphere centers/radii/colors and light params, spot finite-diff
    check on a shading-linear param."""
    import pathlib

    import jax.numpy as jnp

    from python_ray_tracer_jax.utils.image import load_png

    path = pathlib.Path("/root/reference/ref_spec_noRoughness_domelight.png")
    if not path.exists():
        pytest.skip("reference target image not mounted")
    target_u8 = load_png(path)
    h, w = target_u8.shape[:2]
    target = jnp.asarray(target_u8, jnp.float32) / 255.0

    scene = reference_scene(w, h, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    params = scene_to_params(scene)
    loss_fn = jax.jit(make_loss_fn(scene, target, cfg))
    val, grads = jax.jit(jax.value_and_grad(make_loss_fn(scene, target, cfg)))(params)
    assert np.isfinite(float(val))
    for key in ("spheres.center", "spheres.radius", "spheres.diffuse_color", "lights.point_position"):
        assert np.isfinite(np.asarray(grads[key])).all(), key
    assert float(jnp.abs(grads["spheres.center"]).max()) > 0

    # FD spot check (f32, so tolerance is loose but directional).
    key, idx, eps = "spheres.specular_gain", (1,), 1e-3
    p_plus = dict(params)
    p_plus[key] = params[key].at[idx].add(eps)
    p_minus = dict(params)
    p_minus[key] = params[key].at[idx].add(-eps)
    g_fd = (float(loss_fn(p_plus)) - float(loss_fn(p_minus))) / (2 * eps)
    g_ad = float(grads[key][idx])
    assert g_ad == pytest.approx(g_fd, rel=5e-2, abs=1e-6)


def test_texture_atlas_finite_difference():
    """Atlas texels are trainable: ``scene_to_params(atlas=True)`` exposes
    ``textures.atlas`` and its gradient (a scatter-add through the
    nearest-texel gathers of the sampler in ``ops/shading.py``) matches
    finite differences tightly — the image-diffuse
    term is LINEAR in the sampled texel."""
    from python_ray_tracer_jax.models.scenes import texture_task_scene

    rng = np.random.default_rng(3)
    tex = rng.uniform(0.2, 0.8, (8, 8, 3))
    scene = texture_task_scene(tex, 48, 27, dtype=jnp.float64)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float64, visibility="smooth")
    target = jnp.clip(render(scene, RenderConfig(max_depth=2, dtype=jnp.float64)) * 0.9, 0.0, 1.0)

    params = scene_to_params(scene, atlas=True)
    assert "textures.atlas" in params
    loss_fn = jax.jit(make_loss_fn(scene, target, cfg))
    grads = jax.jit(jax.grad(make_loss_fn(scene, target, cfg)))(params)
    g_atlas = np.asarray(grads["textures.atlas"])
    assert np.isfinite(g_atlas).all()
    assert (np.abs(g_atlas) > 0).sum() > 10, "no texel received gradient"

    # FD-check the strongest texel and one mid-magnitude texel.
    flat = np.abs(g_atlas).ravel()
    order = np.argsort(flat)
    for pick in (order[-1], order[len(order) // 2 + np.count_nonzero(flat == 0) // 2]):
        idx = np.unravel_index(pick, g_atlas.shape)
        if flat[pick] == 0:
            continue
        eps = 1e-5
        p_plus = dict(params)
        p_plus["textures.atlas"] = params["textures.atlas"].at[idx].add(eps)
        p_minus = dict(params)
        p_minus["textures.atlas"] = params["textures.atlas"].at[idx].add(-eps)
        g_fd = (float(loss_fn(p_plus)) - float(loss_fn(p_minus))) / (2 * eps)
        assert float(g_atlas[idx]) == pytest.approx(g_fd, rel=1e-5, abs=1e-12), idx


def test_texture_atlas_recovery_descends():
    """Inverse texture rendering end-to-end: perturb the atlas, Adam on the
    texels alone recovers toward the rendered target."""
    from python_ray_tracer_jax.models.scenes import texture_task_scene

    rng = np.random.default_rng(5)
    tex = rng.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
    scene = texture_task_scene(tex, 48, 27, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    target = jnp.clip(render(scene, cfg), 0.0, 1.0)

    params = scene_to_params(scene, sphere_fields=(), light_fields=(), camera=False, atlas=True)
    params["textures.atlas"] = jnp.full_like(params["textures.atlas"], 0.5)
    final, history = fit(scene, target, cfg, params, steps=40, learning_rate=0.05)
    assert history[-1] < history[0] * 0.15, f"loss did not drop: {history[0]} -> {history[-1]}"


def test_sharded_grads_match_single():
    """Gradients through shard_map == single-device gradients."""
    from python_ray_tracer_jax.parallel import make_mesh

    scene = reference_scene(48, 27, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
    target = jnp.clip(render(scene, RenderConfig(max_depth=2, dtype=jnp.float32)), 0.0, 1.0)
    params = scene_to_params(scene)

    g1 = jax.jit(jax.grad(make_loss_fn(scene, target, cfg)))(params)
    mesh = make_mesh(4, 2)
    g2 = jax.jit(jax.grad(make_loss_fn(scene, target, cfg, mesh)))(params)
    for key in g1:
        np.testing.assert_allclose(
            np.asarray(g2[key]), np.asarray(g1[key]), rtol=1e-3, atol=1e-5, err_msg=key
        )


def test_masked_updates_freezes_parameters():
    """Element-wise update masks: frozen rows stay bitwise unchanged while
    the unmasked row trains (the knob the inverse-rendering demo uses to
    keep the ground sphere still)."""
    import optax

    from python_ray_tracer_jax.optim import masked_updates
    from python_ray_tracer_jax.optim.train import init_state, make_train_step

    scene = reference_scene(48, 27, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth",
                       edge_sharpness=20.0, shadow_sharpness=20.0)
    target = jnp.clip(render(scene, cfg), 0.0, 1.0)
    params = scene_to_params(scene, sphere_fields=("center",), light_fields=(), camera=False)
    params["spheres.center"] = params["spheres.center"].at[1, 0].add(0.1)

    row = jnp.zeros((3,)).at[1].set(1.0)
    optimizer = optax.chain(optax.adam(5e-3), masked_updates({"spheres.center": row[:, None]}))
    step = make_train_step(make_loss_fn(scene, target, cfg), optimizer)
    state = init_state(params, optimizer)
    before = np.asarray(params["spheres.center"])
    for _ in range(5):
        state, loss = step(state)
    after = np.asarray(state.params["spheres.center"])
    np.testing.assert_array_equal(after[0], before[0])  # frozen
    np.testing.assert_array_equal(after[2], before[2])  # frozen
    assert np.abs(after[1] - before[1]).max() > 0  # trained
