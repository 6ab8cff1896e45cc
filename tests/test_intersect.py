"""Intersection sweep: property tests vs a quadratic oracle + f32 robustness."""

import jax.numpy as jnp
import numpy as np

from python_ray_tracer_jax.config import faraway
from python_ray_tracer_jax.ops.intersect import (
    intersect_all,
    intersect_all_stable,
    nearest_hit,
)

F64 = faraway(jnp.float64)


def numpy_oracle(origin, direction, center, radius):
    """The reference's exact quadratic (shape.py:28-51), vectorized in NumPy
    with the reference's component-order dot products (base.py:34-35)."""
    o = origin[:, None, :]
    d = direction[:, None, :]
    c = center[None, :, :]

    def dot3(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    oc = o - c
    b = 2 * dot3(d, oc)
    c_term = dot3(c, c) + dot3(o, o) - 2 * dot3(c, o) - radius[None, :] * radius[None, :]
    disc = b**2 - 4 * c_term
    sq = np.sqrt(np.maximum(0, disc))
    t0 = (-b - sq) / 2
    t1 = (-b + sq) / 2
    sol = np.where((t0 > 0) & (t0 < t1), t0, t1)
    return np.where((disc > 0) & (sol > 0), sol, F64)


def random_case(seed, n=512, s=17):
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-3, 3, (n, 3))
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    center = rng.uniform(-4, 4, (s, 3))
    radius = rng.uniform(0.1, 1.5, (s,))
    return origin, direction, center, radius


def test_reference_form_matches_oracle_f64():
    o, d, c, r = random_case(0)
    ours = np.asarray(intersect_all(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(r), F64).t)
    np.testing.assert_array_equal(ours, numpy_oracle(o, d, c, r))


def test_stable_form_agrees_with_reference_form_f64():
    o, d, c, r = random_case(1)
    t_ref = np.asarray(intersect_all(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(r), F64).t)
    t_st = np.asarray(intersect_all_stable(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(r), F64).t)
    hit = t_ref < F64
    assert (hit == (t_st < F64)).mean() > 0.9999
    both = hit & (t_st < F64)
    np.testing.assert_allclose(t_st[both], t_ref[both], rtol=1e-9)


def test_stable_f32_handles_giant_sphere():
    """The golden scene's r=99999 ground sphere destroys the naive f32 form;
    the compensated form must stay within ~1e-5 of the f64 truth."""
    rng = np.random.default_rng(2)
    n = 256
    origin = np.tile(np.array([0.0, 0.2, -2.0]), (n, 1))
    direction = rng.normal(size=(n, 3))
    direction[:, 1] = -np.abs(direction[:, 1]) - 0.1  # aim downward at the ground
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    center = np.array([[0.0, -99999.5, 0.0]])
    radius = np.array([99999.0])

    t_true = numpy_oracle(origin, direction, center, radius)[:, 0]
    f32 = faraway(jnp.float32)
    t_f32 = np.asarray(
        intersect_all_stable(
            jnp.asarray(origin, jnp.float32),
            jnp.asarray(direction, jnp.float32),
            jnp.asarray(center, jnp.float32),
            jnp.asarray(radius, jnp.float32),
            f32,
        ).t
    )[:, 0]
    hit = t_true < F64
    assert hit.any()
    np.testing.assert_allclose(t_f32[hit], t_true[hit], rtol=2e-5)


def test_grazing_hits_are_misses():
    """disc == 0 exactly (tangent ray) must be a miss — strict > (shape.py:50)."""
    o = jnp.asarray([[0.0, 1.0, -5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    c = jnp.asarray([[0.0, 0.0, 0.0]])
    r = jnp.asarray([1.0])
    res = intersect_all(o, d, c, r, F64)
    assert float(res.t[0, 0]) == F64


def test_nearest_hit_reduction():
    o, d, c, r = random_case(3)
    t = intersect_all(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(r), F64).t
    near = nearest_hit(t, F64)
    t_np = np.asarray(t)
    np.testing.assert_array_equal(np.asarray(near.t), t_np.min(axis=1))
    np.testing.assert_array_equal(np.asarray(near.idx), t_np.argmin(axis=1))
    np.testing.assert_array_equal(np.asarray(near.hit), t_np.min(axis=1) < F64)


def test_oracle_matches_upstream_intersect(reference_modules):
    """Our NumPy oracle is itself validated against the live upstream code."""
    base, shape = reference_modules["base"], reference_modules["shape"]
    o, d, c, r = random_case(4, n=128, s=1)
    sphere = shape.NumpySphere(base.NumpyVector3D(*c[0]), float(r[0]), None)
    ov = base.NumpyVector3D(o[:, 0], o[:, 1], o[:, 2])
    dv = base.NumpyVector3D(d[:, 0], d[:, 1], d[:, 2])
    upstream = np.asarray(sphere.intersect(ov, dv))
    np.testing.assert_array_equal(numpy_oracle(o, d, c, r)[:, 0], upstream)
