"""The GPU sweep kernel (ops/sweep_gpu.py): interpret-mode parity with the
XLA sweep, its custom VJP, its padding plan and its route.

On the CPU the kernels run in the Pallas interpreter (``interpret=True``),
which executes the same kernel body — tiles, chunk loop, tier split,
padding masks — as ordinary JAX ops.  The compiled kernel is checked on
the card by the ``gpu``-marked test at the end and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from python_ray_tracer_jax import RenderConfig, render
from python_ray_tracer_jax.config import faraway
from python_ray_tracer_jax.models.scenes import random_spheres_scene, reference_scene
from python_ray_tracer_jax.ops import sweep_gpu
from python_ray_tracer_jax.ops.intersect import intersect_two_tier, nearest_hit

FAR = faraway(jnp.float32)
# XLA's CPU backend compiles the dense sweep and the interpreted kernel's
# loop body into different fused code, which rounds float32 multiply-adds
# differently in the last bits (relative to t, with a floor of a
# millionth of a scene unit for hits at t ~ 0); winners must still agree
# exactly.
T_RTOL, T_ATOL = 2e-5, 1e-6


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, jnp.asarray(d, jnp.float32)


def _random_spheres(s, n_exact=0, seed=1):
    """``s`` spheres; the last ``n_exact`` are giant ground-like spheres that
    need the compensated tier (r = 99999, center 1e5 below), their tops 3
    units apart so none is a near-tie of another."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (s, 3))
    r = rng.uniform(0.2, 1.5, (s,))
    for k in range(n_exact):
        c[s - 1 - k] = (0.3 * k, -1.0e5 - 1.5 - 3.0 * k, 0.2 * k)
        r[s - 1 - k] = 99999.0
    return jnp.asarray(c, jnp.float32), jnp.asarray(r, jnp.float32)


def _xla_nearest(o, d, c, r, n_exact):
    return nearest_hit(intersect_two_tier(o, d, c, r, FAR, n_exact).t, FAR)


def _xla_lit(o, d, c, r, idx, n_exact):
    t = np.asarray(intersect_two_tier(o, d, c, r, FAR, n_exact).t)
    rows = np.arange(t.shape[0])
    t_self = t[rows, np.asarray(idx)]
    t_others = t.copy()
    t_others[rows, np.asarray(idx)] = np.inf
    return (t_self <= t_others.min(axis=1)).astype(np.float32)


# (rays, spheres, exact-tier rows): ray counts off the 128-ray block, sphere
# counts off the 2-row chunk, empty and full exact tiers.
SHAPES = [
    (100, 7, 0),
    (128, 16, 0),
    (130, 37, 1),
    (257, 64, 3),
    (300, 33, 33),
    (129, 1, 0),
    (1000, 100, 2),
    (64, 5, 5),
]


@pytest.mark.parametrize("n,s,n_exact", SHAPES)
def test_nearest_matches_xla(n, s, n_exact):
    o, d = _random_rays(n, seed=n)
    c, r = _random_spheres(s, n_exact, seed=s)
    ref = _xla_nearest(o, d, c, r, n_exact)
    got = sweep_gpu.nearest_hit(o, d, c, r, FAR, n_exact, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=T_RTOL, atol=T_ATOL)


@pytest.mark.parametrize("n,s,n_exact", SHAPES[:5])
def test_shadow_matches_xla(n, s, n_exact):
    o, d = _random_rays(n, seed=n + 1)
    c, r = _random_spheres(s, n_exact, seed=s + 1)
    # Own sphere = nearest along the ray (lit), or a random other sphere.
    near = _xla_nearest(o, d, c, r, n_exact)
    other = jnp.asarray(np.random.default_rng(n).integers(0, s, n), jnp.int32)
    for idx in (near.idx, other):
        got = sweep_gpu.shadow_hard(o, d, c, r, idx, FAR, n_exact, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), _xla_lit(o, d, c, r, idx, n_exact))


def test_giant_sphere_stability():
    """The reference ground sphere (r = 99999) from the camera: the float32
    cancellation case the exact tier exists for."""
    from python_ray_tracer_jax.camera import ray_directions

    scene = reference_scene(64, 36, dtype=jnp.float32)
    d = ray_directions(scene.camera, jnp.float32)
    o = jnp.broadcast_to(scene.camera.position, d.shape)
    c, r, ne = scene.spheres.center, scene.spheres.radius, scene.spheres.n_exact
    assert ne == 1
    ref = _xla_nearest(o, d, c, r, ne)
    got = sweep_gpu.nearest_hit(o, d, c, r, FAR, ne, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=T_RTOL, atol=T_ATOL)
    assert np.asarray(got.hit).mean() > 0.3  # the floor is hit


def test_rays_inside_spheres():
    """Origins inside spheres take the positive far root (shape.py:44-48)."""
    rng = np.random.default_rng(11)
    c, r = _random_spheres(9, seed=12)
    o = jnp.asarray(np.asarray(c)[rng.integers(0, 9, 300)] + rng.normal(0, 0.05, (300, 3)), jnp.float32)
    d = rng.normal(size=(300, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    ref = _xla_nearest(o, d, c, r, 0)
    got = sweep_gpu.nearest_hit(o, d, c, r, FAR, 0, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=T_RTOL, atol=T_ATOL)
    assert np.asarray(got.hit).all()


def test_exact_ties_take_lowest_index():
    """Two identical spheres: the lower index wins, as argmin does."""
    o, d = _random_rays(200, seed=5)
    c, r = _random_spheres(20, seed=6)
    c = c.at[17].set(c[3])
    r = r.at[17].set(r[3])
    ref = _xla_nearest(o, d, c, r, 0)
    got = sweep_gpu.nearest_hit(o, d, c, r, FAR, 0, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    assert not (np.asarray(got.idx) == 17).any()


@pytest.mark.parametrize("n_exact", [0, 2])
def test_nearest_vjp_matches_xla_grad(n_exact):
    """The custom VJP (winner recomputation) == AD through the XLA sweep."""
    o, d = _random_rays(256, seed=7)
    c, r = _random_spheres(9, n_exact, seed=8)

    def loss_kernel(c, r, o, d):
        near = sweep_gpu.nearest_hit(o, d, c, r, FAR, n_exact, interpret=True)
        return jnp.sum(jnp.sin(jnp.where(near.hit, near.t, 0.0)))

    def loss_xla(c, r, o, d):
        near = _xla_nearest(o, d, c, r, n_exact)
        return jnp.sum(jnp.sin(jnp.where(near.hit, near.t, 0.0)))

    gk = jax.grad(loss_kernel, argnums=(0, 1, 2, 3))(c, r, o, d)
    gx = jax.grad(loss_xla, argnums=(0, 1, 2, 3))(c, r, o, d)
    for a, b, name in zip(gk, gx, ("center", "radius", "origin", "dir")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


def test_winner_t_matches_sweep():
    o, d = _random_rays(300, seed=9)
    c, r = _random_spheres(40, 2, seed=10)
    near = _xla_nearest(o, d, c, r, 2)
    t = sweep_gpu.winner_t(o, d, c, r, near.idx, 2, FAR)
    np.testing.assert_array_equal(np.asarray(t)[np.asarray(near.hit)], np.asarray(near.t)[np.asarray(near.hit)])


@pytest.mark.parametrize(
    "s,n_exact,expected",
    [
        (3, 1, ((0, 2, 2, False), (2, 1, 1, True))),
        (1024, 1, ((0, 1023, 2, False), (1023, 1, 1, True))),
        (40, 0, ((0, 40, 2, False),)),
        (5, 5, ((0, 5, 2, True),)),
        (5, 9, ((0, 5, 2, True),)),
        (1, 0, ((0, 1, 1, False),)),
    ],
)
def test_tier_plan(s, n_exact, expected):
    """Static (first row, rows, chunk, exact) per tier: chunks are powers of
    two no larger than CHUNK (2); empty tiers are dropped."""
    assert sweep_gpu._tiers(s, n_exact) == expected


def test_tier_tables_pad_to_chunks():
    c, r = _random_spheres(36, 3)
    tiers = sweep_gpu._tiers(36, 3)
    tables = sweep_gpu._tier_tables(c, r, tiers)
    assert [x.shape[0] for x in tables] == [34] * 4 + [4] * 4
    np.testing.assert_array_equal(np.asarray(tables[3][33:]), 0.0)  # padded radii
    np.testing.assert_array_equal(np.asarray(tables[7][3:]), 0.0)
    np.testing.assert_array_equal(np.asarray(tables[4][:3]), np.asarray(c[33:, 0]))


@pytest.mark.parametrize(
    "platform,n_spheres,route",
    [
        ("cpu", 3, "xla"),
        ("cpu", 100_000, "xla"),
        ("rocm", 100_000, "xla"),
        ("cuda", 3, "xla"),
        ("cuda", sweep_gpu.SWEEP_KERNEL_MIN_SPHERES - 1, "xla"),
        ("cuda", sweep_gpu.SWEEP_KERNEL_MIN_SPHERES, "kernel"),
        ("cuda", 1024, "kernel"),
    ],
)
def test_sweep_route(platform, n_spheres, route):
    assert sweep_gpu.sweep_route(platform, n_spheres) == route


def test_routed_below_threshold_is_plain_xla():
    """Below the threshold no platform branch is staged at all."""
    calls = []
    out = sweep_gpu.routed(lambda x: calls.append("k") or x, lambda x: x + 1, 3, jnp.ones(2))
    assert calls == [] and float(out[0]) == 2.0
    jaxpr = jax.make_jaxpr(lambda x: sweep_gpu.routed(lambda y: y * 2, lambda y: y + 1, 3, x))(jnp.ones(2))
    assert "cond" not in str(jaxpr)


def test_routed_above_threshold_runs_xla_on_cpu():
    """Above the threshold the kernel is staged as the CUDA branch of a
    platform switch; lowering for the CPU keeps only the XLA branch."""
    n = sweep_gpu.SWEEP_KERNEL_MIN_SPHERES
    f = jax.jit(lambda x: sweep_gpu.routed(lambda y: y * 2, lambda y: y + 1, n, x))
    assert "cond" in str(jax.make_jaxpr(f)(jnp.ones(2)))
    np.testing.assert_array_equal(np.asarray(f(jnp.ones(2))), [2.0, 2.0])
    assert "platform_index" not in f.lower(jnp.ones(2)).as_text()


def test_routed_with_xla_route_stages_no_kernel():
    """A route that never picks the kernel stages no platform switch, at
    any table size: how the XLA form is run on the card for comparison."""
    n = 10 * sweep_gpu.SWEEP_KERNEL_MIN_SPHERES
    jaxpr = jax.make_jaxpr(
        lambda x: sweep_gpu.routed(lambda y: y * 2, lambda y: y + 1, n, x, route=lambda p, k: "xla")
    )(jnp.ones(2))
    assert "cond" not in str(jaxpr)


@pytest.mark.parametrize("visibility", ["hard", "smooth"])
def test_render_and_grad_above_threshold_on_cpu(visibility):
    """A scene above the kernel threshold renders and differentiates on the
    CPU (the staged CUDA branch is never lowered) and equals the same
    render on the XLA route."""
    from python_ray_tracer_jax.optim import combine, l2_image_loss, scene_to_params

    n = sweep_gpu.SWEEP_KERNEL_MIN_SPHERES
    scene = random_spheres_scene(n_spheres=n, width=24, height=16)
    cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility=visibility)
    params = scene_to_params(scene, sphere_fields=("center", "radius"), light_fields=(), camera=False)

    target = jnp.clip(jax.jit(render, static_argnums=1)(scene, cfg), 0.0, 1.0) * 0.9

    def run(route):
        img = jax.jit(lambda s: render(s, cfg, route=route))(scene)
        loss = lambda p: l2_image_loss(render(combine(p, scene), cfg, route=route), target)  # noqa: E731
        return np.asarray(img), jax.jit(jax.grad(loss))(params)

    img, g = run(sweep_gpu.sweep_route)
    img2, g2 = run(lambda platform, n_spheres: "xla")
    np.testing.assert_allclose(img, img2, rtol=1e-6, atol=1e-7)
    for k in g:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(g2[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_hard_trace_through_kernel_matches_xla():
    """trace()'s hard bounce with the interpreted kernels in place of the
    routed sweeps == the XLA render (nearest, shadow and the VJP wiring)."""
    import python_ray_tracer_jax.ops.sweep_gpu as sg

    scene = random_spheres_scene(n_spheres=24, width=32, height=18)
    cfg = RenderConfig(max_depth=3, dtype=jnp.float32)
    exp = np.asarray(render(scene, cfg))
    orig = (sg.routed, sg.nearest_hit, sg.shadow_hard)
    try:
        sg.nearest_hit = lambda *a, **k: orig[1](*a, **k, interpret=True)
        sg.shadow_hard = lambda *a, **k: orig[2](*a, **k, interpret=True)
        sg.routed = lambda kernel_fn, xla_fn, n, *args, route: kernel_fn(*args)
        got = np.asarray(render(scene, cfg))
    finally:
        sg.routed, sg.nearest_hit, sg.shadow_hard = orig
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel (no interpreter) == the XLA sweep."""
    o, d = _random_rays(5000, seed=3)
    c, r = _random_spheres(300, 1, seed=4)
    ref = _xla_nearest(o, d, c, r, 1)
    got = jax.jit(lambda o, d, c, r: sweep_gpu.nearest_hit(o, d, c, r, FAR, 1))(o, d, c, r)
    assert (np.asarray(got.idx) == np.asarray(ref.idx)).mean() >= 0.9999
    lit = jax.jit(lambda o, d, c, r, i: sweep_gpu.shadow_hard(o, d, c, r, i, FAR, 1))(o, d, c, r, ref.idx)
    assert np.asarray(lit).mean() > 0.99
