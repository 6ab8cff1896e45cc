"""Batched ray–sphere intersection and nearest-hit selection (XLA path).

This is the hot loop of the whole framework: the reference calls its
per-shape quadratic ``NumpySphere.intersect``
(``/root/reference/ray_tracer/infrastructure/numpy/shape.py:28-51``) from a
Python loop over shapes — once for primary rays (``base.py:97``), once per
shadow batch (``shader.py:126``) and once per reflection bounce —
4.8 M ray–sphere tests per 960×540 frame.  Here the sweep is a single dense
(N rays × S spheres) computation followed by a nearest-hit reduction; the
GPU kernel in :mod:`.sweep_gpu` computes the same reductions with the same
formulas, tile by tile, without materializing (N, S) tables.

Floating-point contract (bit-match with the reference in float64):

* ``b = 2 * (d.x*(o.x-c.x) + d.y*(o.y-c.y) + d.z*(o.z-c.z))`` — the dot is
  taken against the *difference*, not expanded into two dots
  (``shape.py:34``).
* ``c_term = ((|c|^2 + |o|^2) - 2*(c·o)) - r*r`` (``shape.py:35-37``).
* ``disc = b^2 - 4*c_term``; ``sq = sqrt(max(0, disc))`` (``shape.py:38-39``)
  — implemented with a double-``where`` so the sqrt has no NaN cotangent on
  miss lanes while the forward value is unchanged.
* roots ``(-b ± sq) / 2``; pick ``t0`` iff ``t0 > 0 and t0 < t1``
  (``shape.py:41-48``); valid iff ``disc > 0 and t > 0`` — *strict*, so
  grazing hits are misses (``shape.py:50-51``); invalid → FARAWAY.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class IntersectResult(NamedTuple):
    """Per (ray, sphere) sweep output.

    t: (N, S) hit distance, FARAWAY on miss.
    sol: (N, S) raw quadratic root before validity masking (smooth mode uses
        it as the signed "how far along the ray the surface sits" signal).
    disc: (N, S) quadratic discriminant (smooth mode's edge signal).
    """

    t: jax.Array
    sol: jax.Array
    disc: jax.Array


class NearestHit(NamedTuple):
    """Nearest-hit reduction over the sphere axis.

    t: (N,) distance to the nearest surface (FARAWAY on miss).
    idx: (N,) int32 index of the nearest sphere (0 on miss).
    hit: (N,) bool, True where anything was hit.
    """

    t: jax.Array
    idx: jax.Array
    hit: jax.Array


def intersect_all(
    origin: jax.Array,  # (N, 3) or (3,)
    direction: jax.Array,  # (N, 3)
    center: jax.Array,  # (S, 3)
    radius: jax.Array,  # (S,)
    faraway: float,
) -> IntersectResult:
    """Quadratic sweep of every ray against every sphere."""
    o = jnp.broadcast_to(origin, direction.shape)[:, None, :]  # (N, 1, 3)
    d = direction[:, None, :]  # (N, 1, 3)
    c = center[None, :, :]  # (1, S, 3)

    oc = o - c  # (N, S, 3)
    b = 2.0 * (d[..., 0] * oc[..., 0] + d[..., 1] * oc[..., 1] + d[..., 2] * oc[..., 2])

    def sq3(v: jax.Array) -> jax.Array:
        return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]

    c_dot_o = c[..., 0] * o[..., 0] + c[..., 1] * o[..., 1] + c[..., 2] * o[..., 2]
    c_term = sq3(c) + sq3(o) - 2.0 * c_dot_o - radius[None, :] * radius[None, :]

    disc = b * b - 4.0 * c_term
    pos = disc > 0
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)

    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    sol = jnp.where((t0 > 0) & (t0 < t1), t0, t1)

    t = jnp.where(pos & (sol > 0), sol, jnp.asarray(faraway, dtype=sol.dtype))
    return IntersectResult(t=t, sol=sol, disc=disc)


def nearest_hit(t: jax.Array, faraway: float) -> NearestHit:
    """Reduce the (N, S) distance table to the nearest sphere per ray.

    The reference reduces with sequential ``np.minimum``
    (``base.py:97-98``) then re-derives the winner by equality
    (``base.py:103``); an exact tie between two spheres is shaded twice and
    summed there.  We take the argmin (first winner) instead — identical
    except on measure-zero ties, which :mod:`tests.test_golden` verifies do
    not occur in the golden scene.
    """
    tmin = jnp.min(t, axis=1)
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    hit = tmin != jnp.asarray(faraway, dtype=t.dtype)
    return NearestHit(t=tmin, idx=idx, hit=hit)


def intersect_nearest(
    origin: jax.Array,
    direction: jax.Array,
    center: jax.Array,
    radius: jax.Array,
    faraway: float,
) -> tuple[NearestHit, IntersectResult]:
    res = intersect_all(origin, direction, center, radius, faraway)
    return nearest_hit(res.t, faraway), res


# ---------------------------------------------------------------------------
# Numerically hardened float32 path.
#
# The reference's coefficient form (shape.py:35-37) computes
# ``|c|^2 + |o|^2 - 2 c·o - r^2`` — for the giant ground sphere
# (r = 99999, main.py:39-43) that is a ~1e10 - 1e10 cancellation, which
# float64 absorbs but float32 destroys (absolute error ~600 on a ~1e5
# result → shadow acne and checker swimming).  Rendering runs in float32,
# so this path rebuilds the two cancellation-critical quantities with
# error-free transformations (Knuth twoSum + Dekker twoProd, written without
# FMA) and picks the quadratic's small root as c/q from the stable large
# root q instead of by subtraction:
#
#   c_term = |o - c|^2 - r^2       via compensated products/sums
#   q      = -(b + sign(b) * sq) / 2          (magnitude-largest root)
#   other  = c_term / q                       (magnitude-smallest root)
#
# Forward semantics (strict disc > 0 & t > 0, root preference, FARAWAY)
# are unchanged; only rounding improves.  float64 rendering keeps the
# bit-exact reference form above.
# ---------------------------------------------------------------------------


def _two_sum(a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Knuth twoSum: a + b = s + e exactly (e is the rounding error)."""
    s = a + b
    bv = s - a
    e = (a - (s - bv)) + (b - bv)
    return s, e


def _split(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Dekker split: a = hi + lo with hi/lo each half-width."""
    # 2^12 + 1 for float32 (24-bit mantissa), 2^27 + 1 for float64.
    factor = 4097.0 if a.dtype == jnp.float32 else 134217729.0
    c = a * factor
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Dekker twoProd: a * b = p + e exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _roots(b: jax.Array, c_term: jax.Array, faraway: float) -> IntersectResult:
    """Strict-inequality root selection (``shape.py:41-51``), stable q-form:
    the magnitude-largest root by addition, the other one as ``c / q``."""
    disc = b * b - 4.0 * c_term
    pos = disc > 0
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    qroot = -0.5 * (b + jnp.where(b < 0, -sq, sq))
    safe_q = jnp.where(qroot == 0, jnp.ones_like(qroot), qroot)
    other = jnp.where(qroot == 0, jnp.zeros_like(qroot), c_term / safe_q)
    t0 = jnp.minimum(qroot, other)
    t1 = jnp.maximum(qroot, other)
    sol = jnp.where((t0 > 0) & (t0 < t1), t0, t1)
    t = jnp.where(pos & (sol > 0), sol, jnp.asarray(faraway, dtype=sol.dtype))
    return IntersectResult(t=t, sol=sol, disc=disc)


# The two cores below take rays and spheres as (x, y, z) component tuples of
# mutually broadcastable arrays, so the same formulas serve the (N, S) XLA
# sweep, per-lane winner recomputation, and the GPU sweep kernel's tiles.


def quadratic_plain(o, d, c, r, faraway: float) -> IntersectResult:
    """Well-conditioned plain quadratic: ``c_term = |o-c|^2 - r^2`` directly.

    ~4x fewer ops than :func:`quadratic_stable`; accurate for ordinary
    radii/centers (the cheap tier of ``Spheres.n_exact``).  NOT safe for
    huge spheres — the reference ground plane's 1e10-scale cancellation
    needs the compensated form.
    """
    oc = tuple(o[i] - c[i] for i in range(3))
    b = 2.0 * (d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2])
    c_term = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r * r
    return _roots(b, c_term, faraway)


def quadratic_stable(o, d, c, r, faraway: float) -> IntersectResult:
    """float32-robust quadratic (same hit semantics as the reference)."""
    # Exact (hi, lo) pair for each component of o - c.
    h = []
    low = []
    for i in range(3):
        hi, lo = _two_sum(o[i], -c[i])
        h.append(hi)
        low.append(lo)

    # b = 2 * d · (o - c), with the lo parts folded in.
    b = 2.0 * (
        (d[0] * h[0] + d[1] * h[1] + d[2] * h[2])
        + (d[0] * low[0] + d[1] * low[1] + d[2] * low[2])
    )

    # c_term = |o - c|^2 - r^2 with compensated products and summation.
    p0, e0 = _two_prod(h[0], h[0])
    p1, e1 = _two_prod(h[1], h[1])
    p2, e2 = _two_prod(h[2], h[2])
    pr, er = _two_prod(r, r)
    s1, t1 = _two_sum(p0, p1)
    s2, t2 = _two_sum(s1, p2)
    s3, t3 = _two_sum(s2, -pr)
    corr = (
        (t1 + t2 + t3)
        + (e0 + e1 + e2 - er)
        + 2.0 * (h[0] * low[0] + h[1] * low[1] + h[2] * low[2])
        + (low[0] * low[0] + low[1] * low[1] + low[2] * low[2])
    )
    return _roots(b, s3 + corr, faraway)


def _all_pairs(origin, direction, center, radius):
    """(N, S)-broadcast component tuples of rays x spheres."""
    o = jnp.broadcast_to(origin, direction.shape)
    return (
        tuple(o[:, None, i] for i in range(3)),
        tuple(direction[:, None, i] for i in range(3)),
        tuple(center[None, :, i] for i in range(3)),
        radius[None, :],
    )


def intersect_all_plain(
    origin: jax.Array,  # (N, 3) or (3,)
    direction: jax.Array,  # (N, 3)
    center: jax.Array,  # (S, 3)
    radius: jax.Array,  # (S,)
    faraway: float,
) -> IntersectResult:
    """(N, S) sweep with :func:`quadratic_plain`."""
    return quadratic_plain(*_all_pairs(origin, direction, center, radius), faraway)


def intersect_all_stable(
    origin: jax.Array,  # (N, 3) or (3,)
    direction: jax.Array,  # (N, 3)
    center: jax.Array,  # (S, 3)
    radius: jax.Array,  # (S,)
    faraway: float,
) -> IntersectResult:
    """(N, S) sweep with :func:`quadratic_stable`."""
    return quadratic_stable(*_all_pairs(origin, direction, center, radius), faraway)


def intersect_two_tier(
    origin: jax.Array,
    direction: jax.Array,
    center: jax.Array,  # (S, 3) — cheap rows first, exact rows last
    radius: jax.Array,
    faraway: float,
    n_exact: int,
) -> IntersectResult:
    """Tiered sweep: plain math on the cheap prefix, compensated on the
    exact suffix (the split ``scene.py`` records as ``n_exact``)."""
    s = center.shape[0]
    n_exact = min(n_exact, s)
    if n_exact == 0:
        return intersect_all_plain(origin, direction, center, radius, faraway)
    if n_exact == s:
        return intersect_all_stable(origin, direction, center, radius, faraway)
    s_cheap = s - n_exact
    a = intersect_all_plain(origin, direction, center[:s_cheap], radius[:s_cheap], faraway)
    b = intersect_all_stable(origin, direction, center[s_cheap:], radius[s_cheap:], faraway)
    return IntersectResult(
        t=jnp.concatenate([a.t, b.t], axis=1),
        sol=jnp.concatenate([a.sol, b.sol], axis=1),
        disc=jnp.concatenate([a.disc, b.disc], axis=1),
    )
