"""Unit tests for the stateless hash RNG (`ops/rng.py`).

The reference used a global `np.random` seed for any stochastic sampling
(SURVEY §4); the rebuild replaces it with a stateless counter-based hash
because threefry-in-scan can lower very slowly
(PERF.md, "the threefry trap").  These tests pin the statistical and
structural contracts the renderer relies on: determinism, stream
independence, uniformity, and scan-position invariance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from python_ray_tracer_jax.ops import rng


def test_deterministic_replay():
    s = rng.seed_root(1234)
    a = rng.uniform01(s, 4096)
    b = rng.uniform01(s, 4096)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_range_and_dtype():
    u = np.asarray(rng.uniform01(rng.seed_root(7), 1 << 16))
    assert u.dtype == np.float32
    assert u.min() >= 0.0 and u.max() < 1.0


def test_uniformity_chi2():
    # 64 bins over 2^18 draws: chi-square should be ~63 +- a few sigma.
    u = np.asarray(rng.uniform01(rng.seed_root(42), 1 << 18))
    counts, _ = np.histogram(u, bins=64, range=(0.0, 1.0))
    expected = u.size / 64
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # dof = 63, sigma = sqrt(2*63) ~ 11.2; allow 5 sigma.
    assert chi2 < 63 + 5 * np.sqrt(2 * 63), chi2


def test_streams_decorrelated():
    s = rng.seed_root(99)
    u = np.asarray(rng.uniform2(s, 1 << 16), np.float64)
    u1, u2 = u[:, 0], u[:, 1]
    corr = np.corrcoef(u1, u2)[0, 1]
    assert abs(corr) < 0.01, corr
    # Lane-to-lane serial correlation within one stream must also vanish.
    serial = np.corrcoef(u1[:-1], u1[1:])[0, 1]
    assert abs(serial) < 0.01, serial


def test_fold_seed_differs_and_vectorizes():
    s = rng.seed_root(5)
    children = [int(rng.fold_seed(s, i)) for i in range(8)]
    assert len(set(children)) == 8
    vec = np.asarray(rng.fold_seed(s, jnp.arange(8)))
    np.testing.assert_array_equal(vec, np.asarray(children, np.uint32))


def test_seed_sensitivity():
    # Adjacent seeds must produce unrelated sequences (avalanche).
    a = np.asarray(rng.uniform01(rng.fold_seed(rng.seed_root(0), 1), 1 << 14), np.float64)
    b = np.asarray(rng.uniform01(rng.fold_seed(rng.seed_root(0), 2), 1 << 14), np.float64)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.02
    assert not np.any(a == b) or np.mean(a == b) < 1e-3


def test_scan_position_invariant():
    """A draw inside a lax.scan equals the same draw outside it.

    This is the property that makes replay bit-exact across sharded and
    single-device paths and across chunked vs unchunked rendering.
    """
    s = rng.seed_root(77)

    def body(carry, i):
        return carry, rng.uniform01(rng.fold_seed(s, i), 128)

    _, scanned = jax.lax.scan(body, 0, jnp.arange(4))
    direct = jnp.stack([rng.uniform01(rng.fold_seed(s, i), 128) for i in range(4)])
    np.testing.assert_array_equal(np.asarray(scanned), np.asarray(direct))
