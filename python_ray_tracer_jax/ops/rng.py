"""Stateless per-ray RNG for the stochastic/supersampling paths.

A keyed counter-based hash (the lowbias32 finalizer) replaces
``jax.random``'s threefry cipher on the hot path: a threefry draw
*inside a ``lax.scan`` with a per-iteration key* can lower very slowly
(PERF.md, "the threefry trap"), while this hash is ~10 vector u32 ops in
any position.  Rendering
needs decorrelated, replayable samples, not cryptographic strength —
stateless per-ray hashing is the standard renderer design (the reference
era used ``np.random`` with a global seed; SURVEY §4 restored spec).

Seeds are uint32 **scalars** threaded through scan carries; every helper
is a pure function of (seed, lane index, stream salt), so replay is
bit-exact given ``RenderConfig.rng_seed`` and every path shares one
schedule by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Plain Python ints, NOT jnp constants: this module is imported lazily
# from inside jit traces (render.py), and module-level traced arrays
# would escape their trace (UnexpectedTracerError).
_M1 = 0x21F0AAAD  # lowbias32 multipliers (Wellons' search)
_M2 = 0x735A2D97
_GOLD = 0x9E3779B9  # Weyl increment for seed folding


def _mix(x: jax.Array) -> jax.Array:
    """lowbias32: a well-mixed u32 -> u32 finalizer (vector ops only)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(_M1)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(_M2)
    x = x ^ (x >> 15)
    return x


def seed_root(rng_seed: int) -> jax.Array:
    """The framework-level root seed: uint32 scalar from the config int."""
    return jnp.uint32(rng_seed & 0xFFFFFFFF)


def fold_seed(seed: jax.Array, salt) -> jax.Array:
    """Derive a child seed — the stateless analog of ``jax.random.fold_in``
    / ``split``.  ``salt`` may be a Python int, a traced scalar, or an
    array (vectorized derivation, e.g. per ray-chunk seeds)."""
    return _mix(jnp.asarray(seed, jnp.uint32) + jnp.uint32(_GOLD) * jnp.asarray(salt, jnp.uint32))


def uniform01(seed: jax.Array, n: int, dtype=jnp.float32, offset=0) -> jax.Array:
    """(n,) floats in [0, 1): hash of (lane index, seed), 24-bit mantissa.

    ``offset`` shifts the lane indices — a ray shard passes its global
    ray offset so the sharded draw matches the single-device draw lane for
    lane (bitwise replay across mesh shapes).
    """
    idx = jax.lax.iota(jnp.uint32, n) + jnp.asarray(offset, jnp.uint32)
    bits = _mix(idx + jnp.asarray(seed, jnp.uint32))
    return (bits >> jnp.uint32(8)).astype(dtype) * dtype(1.0 / (1 << 24))


def uniform2(seed: jax.Array, n: int, dtype=jnp.float32, offset=0) -> jax.Array:
    """(n, 2) independent uniforms in [0, 1) — two salted streams."""
    u1 = uniform01(fold_seed(seed, 1), n, dtype, offset)
    u2 = uniform01(fold_seed(seed, 2), n, dtype, offset)
    return jnp.stack([u1, u2], axis=1)
