"""The renderer: pure function ``(scene, cfg) -> image``.

Array-programming redesign of the reference's render path:

* the unbounded mutual recursion ``raytrace_scene -> Shader.create ->
  _calculate_reflection -> raytrace_scene``
  (``/root/reference/ray_tracer/infrastructure/numpy/base.py:91-121`` /
  ``shader.py:143-161``, measured depth 56) becomes a fixed-depth
  ``lax.scan`` carrying ``(origin, direction, throughput, alive, accum)``,
* extract/place stream compaction (``base.py:15-25,66-79,106-119``) becomes
  masked lanes: every lane computes every bounce, dead lanes are multiplied
  away (SURVEY §3.7) — static shapes, fully fusable by XLA,
* the per-shape Python loops (``base.py:97,102``; ``shader.py:126``) become
  dense (N rays × S spheres) sweeps with a nearest-hit reduction
  (:mod:`.ops.intersect`); hard-visibility sweeps of big sphere tables run
  as one GPU kernel per sweep where :mod:`.ops.sweep_gpu` routes them.

Visibility modes:

* ``hard`` replicates the reference's step functions exactly (strict
  ``disc > 0 & t > 0`` hits, shadow = "this sphere is the nearest hit along
  the light ray", ``shader.py:114-128``),
* ``smooth`` relaxes hit coverage and shadow occlusion with sigmoids so
  silhouette and shadow edges carry gradients (the differentiable-rendering
  upgrade BASELINE.json config 3 mandates; the reference is forward-only).

Multi-device: every reduction over the sphere axis goes through a small set
of helpers that take an optional ``sphere_axis`` mesh-axis name.  When set
(by :mod:`.parallel.sharded`, inside ``shard_map``), each device sweeps only
its shard of the sphere table and the nearest-hit / shadow / coverage
reductions finish with ``lax.pmin``/``psum`` collectives — the
ring-reduction structure SURVEY §5.7 calls for.  With ``sphere_axis=None``
the same code paths reduce locally, so the single-device and sharded
renderers share one bounce loop.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from .camera import ray_directions
from .config import RenderConfig, VISIBILITY_SMOOTH
from .ops.intersect import IntersectResult, NearestHit, intersect_all, intersect_all_stable
from .ops import sweep_gpu
from .ops.shading import NUDGE, LaneMaterial, gather_material, shade
from .ops.vecmath import normalize, reflect
from .scene import Scene


def auto_max_depth(
    scene: Scene,
    quantum: float = 1.0 / 510.0,
    color_bound: float = 2.0,
    cap: int = 64,
) -> int:
    """Depth at which truncating the reference's unbounded recursion is
    invisible at uint8 precision.

    The reference recurses until every reflected ray misses
    (``shader.py:143-156`` -> ``base.py:105``, measured depth 56 on the
    README scene); each bounce attenuates by ``0.5 * specular_gain *
    in_light`` (``shader.py:106``).  With ``g = 0.5 * max(specular_gain)``,
    everything from depth D onward contributes at most
    ``color_bound * g^D / (1 - g)`` per channel — choose the smallest D
    putting that under half a uint8 quantum.  ``color_bound`` bounds one
    bounce's local shaded color (images are clipped to [0,1]; 2.0 adds
    headroom for unclipped HDR contributions).  Host-side (reads concrete
    scene values) — resolve BEFORE jit and pass the result as
    ``RenderConfig.max_depth``.
    """
    import math

    import numpy as np

    g = 0.5 * float(np.max(np.asarray(scene.spheres.specular_gain)))
    if g <= 0.0:
        return 1  # reflections carry zero weight (shader.py:106)
    if g >= 1.0:
        return cap  # non-dissipating mirror hall: cap (beyond ~56 the
        # reference's own float energy dies; cap matches its measured max)
    # color_bound * g^D / (1 - g) < quantum / 2
    d = math.log(0.5 * quantum * (1.0 - g) / color_bound, g)
    return max(1, min(cap, math.ceil(d)))


def _sweep(
    origin: jax.Array,
    direction: jax.Array,
    center: jax.Array,
    radius: jax.Array,
    cfg: RenderConfig,
    *,
    n_exact: int | None = None,
    pin: bool = False,
    exact_mask: jax.Array | None = None,
) -> IntersectResult:
    """All-spheres (N, S) intersection sweep in XLA.

    ``n_exact`` enables the two-tier float32 path (plain math on the
    cheap sphere prefix, compensated on the exact suffix); None keeps
    everything on the compensated path.

    ``exact_mask`` (sphere-sharded mode only): per-LOCAL-row boolean of
    "this row is in the GLOBAL exact suffix".  The static ``n_exact``
    count cannot express the tier split of an arbitrary shard (SPMD runs
    one program on every shard, but the global suffix covers different
    local rows per shard), and applying the global count per shard
    upgrades globally-cheap rows to compensated math — differently
    rounded, which breaks the bitwise sharded==single-device equality the
    tie detection and owner-equality combines rely on.  With a mask both
    tiers are computed and selected per row: each row gets the exact
    same formula it gets on a single device.

    ``pin=True`` wraps the result in an optimization_barrier so every
    consumer reads ONE canonical computation.  Needed only where a
    collective-combined value is compared against a local recomputation
    (the sphere-sharded path): without it XLA may duplicate the sweep into
    differently-fused — differently-rounded — subgraphs and flip the
    owner-equality decision.  Off the sharded path the barrier just blocks
    fusion (measured: the bounce shatters into hundreds of extra
    materialized intermediates), so it stays off.
    """
    if not cfg.stable_intersect:
        res = intersect_all(origin, direction, center, radius, cfg.faraway)
    elif exact_mask is not None:
        from .ops.intersect import intersect_all_plain

        a = intersect_all_plain(origin, direction, center, radius, cfg.faraway)
        b = intersect_all_stable(origin, direction, center, radius, cfg.faraway)
        m = exact_mask[None, :]
        res = IntersectResult(
            t=jnp.where(m, b.t, a.t),
            sol=jnp.where(m, b.sol, a.sol),
            disc=jnp.where(m, b.disc, a.disc),
        )
    elif n_exact is None:
        res = intersect_all_stable(origin, direction, center, radius, cfg.faraway)
    else:
        from .ops.intersect import intersect_two_tier

        res = intersect_two_tier(origin, direction, center, radius, cfg.faraway, n_exact)
    if pin:
        res = IntersectResult(*jax.lax.optimization_barrier(tuple(res)))
    return res


def _soft_cover(sol: jax.Array, disc: jax.Array, sharpness: float) -> jax.Array:
    """Soft "this quadratic has a positive root" in [0, 1].

    ``sigmoid(k*disc) * sigmoid(k*sol)`` → the hard ``disc > 0 & sol > 0``
    as ``k → ∞`` (the strict inequalities of ``shape.py:50``).
    """
    return jax.nn.sigmoid(sharpness * disc) * jax.nn.sigmoid(sharpness * sol)


# ---------------------------------------------------------------------------
# Sphere-axis reductions (local, or collective when sphere_axis is a mesh
# axis name inside shard_map).
#
# AD discipline for the collective branch: pmin/pmax have no differentiation
# rule in JAX, so every *selector* (argmin winner, owner shard) is computed
# on stop_gradient'd values — constants need no JVP rule — while the
# *values* the selector picks flow through differentiable collectives
# (psum / all_gather, whose transposes XLA overlaps with backward compute).
# ---------------------------------------------------------------------------


def _invariant(x: jax.Array, sphere_axis: str | None) -> jax.Array:
    """Make a value already identical on every shard VMA-invariant.

    ``psum`` of (shard-0 copy, zeros elsewhere): bitwise exact (a sum with
    zeros), differentiable (psum transposes), and marks the result reduced
    over the axis for the VMA checker.
    """
    if sphere_axis is None:
        return x
    k = jax.lax.axis_index(sphere_axis)
    return jax.lax.psum(jnp.where(k == 0, x, jnp.zeros_like(x)), sphere_axis)


def _combine_nearest(
    t_table: jax.Array,  # (N, S_local)
    faraway: float,
    sphere_axis: str | None,
    sphere_offset: jax.Array | int,
) -> NearestHit:
    """Nearest-hit reduction over (possibly sharded) sphere axis.

    The reference reduces with sequential ``np.minimum`` (``base.py:97-98``)
    then re-derives the winner by equality (``base.py:103``); an exact tie
    between two spheres is shaded twice and summed there.  We take the
    argmin (lowest global index wins) instead — identical except on
    measure-zero ties, which :mod:`tests.test_golden` verifies do not occur
    in the golden scene.
    """
    if sphere_axis is None:
        tmin = jnp.min(t_table, axis=1)
        idx = jnp.argmin(t_table, axis=1).astype(jnp.int32) + sphere_offset
        hit = tmin != jnp.asarray(faraway, dtype=t_table.dtype)
        return NearestHit(t=tmin, idx=idx, hit=hit)

    # Selector path (no gradients): find the winning global index.  pmin
    # selects (bitwise) one of the shard minima, so the owner shard
    # recognises itself by exact equality — valid only if its tmin_l is
    # computed ONCE.  The barrier stops XLA from duplicating tmin_l into
    # differently-fused (differently-rounded) subgraphs for the two uses.
    t_sg = jax.lax.stop_gradient(t_table)
    tmin_l = jax.lax.optimization_barrier(jnp.min(t_sg, axis=1))
    idx_l = jnp.argmin(t_sg, axis=1).astype(jnp.int32) + sphere_offset
    tmin_sel = jax.lax.pmin(tmin_l, sphere_axis)
    cand = jnp.where(tmin_l == tmin_sel, idx_l, jnp.iinfo(jnp.int32).max)
    idx = jax.lax.pmin(cand, sphere_axis)

    # Value path (differentiable): re-gather the winner's t from the live
    # table; only the owner contributes, psum'd to every shard.  Bitwise
    # equal to the owner's value (a sum with zeros) and its gradient flows
    # to exactly the winning sphere — the same subgradient jnp.min takes.
    t_val, _ = _self_lookup(t_table, idx, sphere_offset, 0.0)
    tmin = jax.lax.psum(t_val, sphere_axis)
    hit = tmin != jnp.asarray(faraway, dtype=t_table.dtype)
    return NearestHit(t=tmin, idx=idx, hit=hit)


def _self_lookup(
    table: jax.Array,  # (N, S_local) per-sphere values
    idx: jax.Array,  # (N,) global sphere index
    sphere_offset: jax.Array | int,
    fill: float,
) -> tuple[jax.Array, jax.Array]:
    """Each lane's value for its *own* sphere; ``fill`` where not owned.

    Returns ``(value, owns)`` — in sharded mode only the owning shard holds
    the real value, others hold ``fill`` (combined by the caller with
    pmin/psum as appropriate).

    Implemented as a one-hot masked sum, not a row gather: the sum's
    transpose is a broadcast multiply, while a gather transposes to an
    N-lane scatter-add.
    """
    s_local = table.shape[1]
    gidx = jnp.arange(s_local, dtype=jnp.int32)[None, :] + sphere_offset
    onehot = gidx == idx[:, None]  # (N, S_local); all-False when not owned
    val = jnp.sum(jnp.where(onehot, table, jnp.zeros_like(table)), axis=1)
    owns = jnp.any(onehot, axis=1)
    val = jnp.where(owns, val, jnp.asarray(fill, table.dtype))
    return val, owns


def _shadow_hard(
    res: IntersectResult,
    idx: jax.Array,
    sphere_axis: str | None,
    sphere_offset: jax.Array | int,
    dtype: Any,
) -> jax.Array:
    """Hard shadow test, ref ``shader.py:114-128``.

    The reference computes "lit iff the lane's own sphere is the nearest hit
    along the shadow ray" as ``t_self == reduce(min, all)`` (the self-hit
    sits at FARAWAY when the path is clear, so equality holds on a clear
    path).  We evaluate the equivalent ``t_self <= min(others)`` instead:
    identical on every input, but not a bitwise float equality — robust to
    XLA recomputing the two sides in differently-fused subgraphs.
    """
    s_local = res.t.shape[1]
    gidx = jnp.arange(s_local, dtype=jnp.int32)[None, :] + sphere_offset
    is_self = gidx == idx[:, None]
    t_others = jnp.where(is_self, jnp.asarray(jnp.inf, res.t.dtype), res.t)
    tmin_others = jnp.min(t_others, axis=1)
    t_self, _ = _self_lookup(res.t, idx, sphere_offset, jnp.inf)
    if sphere_axis is not None:
        # Visibility is a step function — no useful gradient — so the
        # non-differentiable pmin runs on stop_gradient'd values.
        tmin_others = jax.lax.pmin(jax.lax.stop_gradient(tmin_others), sphere_axis)
        t_self = jax.lax.pmin(jax.lax.stop_gradient(t_self), sphere_axis)
    return (t_self <= tmin_others).astype(dtype)


def _shadow_smooth(
    res: IntersectResult,
    idx: jax.Array,
    cfg: RenderConfig,
    sphere_axis: str | None,
    sphere_offset: jax.Array | int,
    dtype: Any,
) -> jax.Array:
    """Smooth shadow: product over *other* spheres of (1 - soft occlusion)."""
    occl = _soft_cover(res.sol, res.disc, cfg.shadow_sharpness)  # (N, S_local)
    gidx = jnp.arange(res.t.shape[1], dtype=jnp.int32)[None, :] + sphere_offset
    not_self = gidx != idx[:, None]
    clear = jnp.prod(jnp.where(not_self, 1.0 - occl, jnp.ones_like(occl)), axis=1)
    if sphere_axis is not None:
        # all_gather + prod is differentiable; the result is identical on
        # every shard, so _invariant re-establishes axis invariance exactly.
        clear = jnp.prod(jax.lax.all_gather(clear, sphere_axis), axis=0)
        clear = _invariant(clear, sphere_axis)
    return clear.astype(dtype)


def _smooth_winner_idx(
    res: IntersectResult,
    near: NearestHit,
    sphere_axis: str | None,
    sphere_offset: jax.Array | int,
) -> jax.Array:
    """Winning sphere per lane for smooth coverage.

    Hit lanes keep the nearest sphere; miss lanes attribute coverage (and
    its gradient) to the sphere whose discriminant came closest to zero.
    """
    disc_sg = jax.lax.stop_gradient(res.disc)  # selector only — no gradient
    dmax_l = jnp.max(disc_sg, axis=1)
    fidx_l = jnp.argmax(disc_sg, axis=1).astype(jnp.int32) + sphere_offset
    if sphere_axis is None:
        fidx = fidx_l
    else:
        dmax_l = jax.lax.optimization_barrier(dmax_l)  # see _combine_nearest
        dmax = jax.lax.pmax(dmax_l, sphere_axis)
        cand = jnp.where(dmax_l == dmax, fidx_l, jnp.iinfo(jnp.int32).max)
        fidx = jax.lax.pmin(cand, sphere_axis)
    return jnp.where(near.hit, near.idx, fidx)


def _coverage_at(
    res: IntersectResult,
    idx: jax.Array,
    sharpness: float,
    sphere_axis: str | None,
    sphere_offset: jax.Array | int,
) -> jax.Array:
    """Soft coverage of each lane's winning sphere."""
    cover_all = _soft_cover(res.sol, res.disc, sharpness)
    cover, _ = _self_lookup(cover_all, idx, sphere_offset, 0.0)
    if sphere_axis is not None:
        cover = jax.lax.psum(cover, sphere_axis)
    return cover


def trace(
    origin: jax.Array,  # (N, 3) or (3,)
    direction: jax.Array,  # (N, 3) unit
    scene: Scene,
    cfg: RenderConfig,
    *,
    sweep_center: jax.Array | None = None,  # (S_local, 3) geometry shard
    sweep_radius: jax.Array | None = None,  # (S_local,)
    sphere_axis: str | None = None,  # mesh axis the sweep is sharded over
    sphere_offset: jax.Array | int = 0,  # global index of sweep row 0
    ray_axis: str | None = None,  # mesh axis the ray lanes are sharded over
    ray_offset: jax.Array | int = 0,  # global ray index of lane 0 (RNG parity)
    key: jax.Array | None = None,  # PRNG key for stochastic roughness
    route: Callable[[str, int], str] = sweep_gpu.sweep_route,  # hard-sweep form
) -> jax.Array:
    """Trace N rays to ``cfg.max_depth`` bounces; returns (N, 3) color.

    Misses contribute black (ref ``base.py:100``: color starts at (0,0,0)
    and only hit lanes are placed back).

    ``sweep_center``/``sweep_radius`` default to the scene's full sphere
    table; :mod:`.parallel.sharded` passes a per-device shard plus the mesh
    axis name so the reductions above finish with collectives.  Material
    gather always reads the (replicated, tiny) full table.

    ``route(platform, n_spheres)`` picks the form of unsharded hard float32
    sweeps, ``"kernel"`` or ``"xla"`` (:func:`.ops.sweep_gpu.routed`).
    """
    dtype = cfg.dtype
    direction = jnp.asarray(direction, dtype)
    n = direction.shape[0]
    origin = jnp.broadcast_to(jnp.asarray(origin, dtype), direction.shape)
    cam_pos = jnp.asarray(scene.camera.position, dtype)
    light_pos = jnp.asarray(scene.lights.point_position, dtype)
    if sweep_center is None:
        sweep_center = scene.spheres.center
    if sweep_radius is None:
        sweep_radius = scene.spheres.radius
    smooth = cfg.visibility == VISIBILITY_SMOOTH
    stochastic = cfg.stochastic_roughness and key is not None
    # Double-shade exact nearest-hit ties (ref base.py:103,119 semantics).
    tie_sum = cfg.tie_mode == "sum" and not smooth
    # Unsharded hard float32 sweeps reduce without (N, S) tables: through
    # the GPU sweep kernel where ops/sweep_gpu.py routes them, otherwise
    # through the same XLA sweep as every other mode.
    sweep_reduced = (
        not smooth
        and not tie_sum
        and sphere_axis is None
        and ray_axis is None
        and cfg.stable_intersect
        and jnp.dtype(dtype) == jnp.dtype(jnp.float32)
    )
    n_exact = scene.spheres.n_exact
    n_sweep = sweep_center.shape[0]

    def nearest_xla(o, d, c, r):
        res = _sweep(o, d, c, r, cfg, n_exact=n_exact)
        return _combine_nearest(res.t, cfg.faraway, None, 0)

    def nearest_kernel(o, d, c, r):
        return sweep_gpu.nearest_hit(o, d, c, r, cfg.faraway, n_exact)

    def shadow_xla(o, d, c, r, idx):
        res = _sweep(o, d, c, r, cfg, n_exact=n_exact)
        return _shadow_hard(res, idx, None, 0, dtype)

    def shadow_kernel(o, d, c, r, idx):
        return sweep_gpu.shadow_hard(o, d, c, r, idx, cfg.faraway, n_exact)

    # Sphere-sharded two-tier split: the global exact suffix covers
    # different LOCAL rows on each shard, which the static per-shard
    # n_exact count cannot express (see _sweep).  Build the global-index
    # tier mask; only needed when the split cuts strictly inside the
    # table (0 < E < S — the all-plain/all-stable ends are shard-uniform).
    exact_mask = None
    if sphere_axis is not None and cfg.stable_intersect:
        n_ex, s_glob = scene.spheres.n_exact, scene.spheres.count
        if 0 < n_ex < s_glob:
            s_loc = sweep_center.shape[0]
            exact_mask = (
                jnp.arange(s_loc, dtype=jnp.int32) + sphere_offset >= s_glob - n_ex
            )

    def bounce(carry, _):
        if stochastic:
            from .ops.rng import fold_seed

            o, d, throughput, alive, accum, k = carry
            k, k_bounce = fold_seed(k, 1), fold_seed(k, 2)
        else:
            o, d, throughput, alive, accum = carry

        if sweep_reduced:
            res = None
            near = sweep_gpu.routed(
                nearest_kernel, nearest_xla, n_sweep, o, d, sweep_center, sweep_radius, route=route
            )
        else:
            res = _sweep(
                o, d, sweep_center, sweep_radius, cfg,
                n_exact=n_exact,
                pin=sphere_axis is not None or tie_sum,
                exact_mask=exact_mask,
            )
            near = _combine_nearest(res.t, cfg.faraway, sphere_axis, sphere_offset)

        if smooth:
            idx = _smooth_winner_idx(res, near, sphere_axis, sphere_offset)
            coverage = _coverage_at(res, idx, cfg.edge_sharpness, sphere_axis, sphere_offset) * alive
        else:
            idx = near.idx
            coverage = near.hit.astype(dtype) * alive

        # Sanitize t so dead lanes stay finite (masked-lane contract).
        t_safe = jnp.where(near.hit, near.t, jnp.ones_like(near.t))
        mat: LaneMaterial = gather_material(scene.spheres, idx)

        p = o + d * t_safe[:, None]  # shader.py:73
        normal = (p - mat.center) * (1.0 / mat.radius)[:, None]  # shader.py:74
        to_light = normalize(light_pos[None, :] - p)  # shader.py:75
        to_camera = normalize(cam_pos[None, :] - p)  # shader.py:76 — ORIGINAL camera, every bounce
        p_nudged = p + normal * NUDGE  # shader.py:77

        if sweep_reduced:
            # Visibility is a step function: constant under AD, exactly
            # like the XLA hard path's comparison (zero tangent).
            sg = jax.lax.stop_gradient
            in_light = sweep_gpu.routed(
                shadow_kernel, shadow_xla, n_sweep,
                sg(p_nudged), sg(to_light), sg(sweep_center), sg(sweep_radius), idx,
                route=route,
            ).astype(dtype)
        else:
            shadow_res = _sweep(
                p_nudged, to_light, sweep_center, sweep_radius, cfg,
                n_exact=n_exact, pin=sphere_axis is not None,
                exact_mask=exact_mask,
            )
            if smooth:
                in_light = _shadow_smooth(shadow_res, idx, cfg, sphere_axis, sphere_offset, dtype)
            else:
                in_light = _shadow_hard(shadow_res, idx, sphere_axis, sphere_offset, dtype)
        local = shade(p, normal, to_light, to_camera, in_light, mat, scene)

        accum = accum + local.color * (throughput * coverage)[:, None]
        if tie_sum:
            # Second tied winner: HIGHEST index whose t equals the winning
            # t bitwise (the sweep result is pinned by a barrier, so both
            # sides read one canonical computation).  Shade it too and add
            # — the reference shades every sphere at the minimum distance
            # and sums (base.py:103,119).  2-way ties only; the mirror
            # continuation stays with the lowest-index winner.
            gidx = jnp.arange(res.t.shape[1], dtype=jnp.int32)[None, :] + sphere_offset
            tied = res.t == near.t[:, None]
            idx2_l = jnp.max(jnp.where(tied, gidx, -1), axis=1)
            idx2 = jax.lax.pmax(idx2_l, sphere_axis) if sphere_axis is not None else idx2_l
            has2 = near.hit & (idx2 != idx)
            idx2 = jnp.where(has2, idx2, idx)
            mat2: LaneMaterial = gather_material(scene.spheres, idx2)
            normal2 = (p - mat2.center) * (1.0 / mat2.radius)[:, None]
            p_nudged2 = p + normal2 * NUDGE
            shadow_res2 = _sweep(
                p_nudged2, to_light, sweep_center, sweep_radius, cfg,
                n_exact=n_exact, pin=sphere_axis is not None,
                exact_mask=exact_mask,
            )
            in_light2 = _shadow_hard(shadow_res2, idx2, sphere_axis, sphere_offset, dtype)
            local2 = shade(p, normal2, to_light, to_camera, in_light2, mat2, scene)
            w2 = throughput * coverage * has2.astype(dtype)
            accum = accum + local2.color * w2[:, None]
            if cfg.max_depth > 1:
                # Both tied winners spawn mirror recursion upstream: each
                # shaded batch calls _calculate_reflection (base.py:110 ->
                # shader.py:96,152), so the second winner's bounce tree
                # contributes too.  The continuation is linear in its
                # entry weight, so it runs as a NESTED fixed-depth trace
                # scaled by w2 * refl_coeff2.  Ties inside that
                # continuation follow lowest-index (ties-of-ties are
                # measure-zero squared); cost is O(depth^2) bounces —
                # tie_mode="sum" is the exactness mode, not the fast path.
                import dataclasses

                sub_cfg = dataclasses.replace(cfg, max_depth=cfg.max_depth - 1, tie_mode="first")
                cont2 = trace(
                    p_nudged2, reflect(d, normal2), scene, sub_cfg,
                    sweep_center=sweep_center, sweep_radius=sweep_radius,
                    sphere_axis=sphere_axis, sphere_offset=sphere_offset,
                    ray_axis=ray_axis, route=route,
                )
                accum = accum + cont2 * (w2 * local2.refl_coeff)[:, None]
        throughput = throughput * coverage * local.refl_coeff
        alive = coverage if smooth else (alive * near.hit.astype(dtype))

        o_next = p_nudged
        if stochastic:
            # Glossy reflection: jitter the mirror by a GGX-sampled
            # microfacet (the old engine's stochastic roughness, SURVEY §4).
            from .ops.rng import uniform2
            from .ops.vecmath import ggx_perturb_reflect

            xi = uniform2(k_bounce, n, dtype, offset=ray_offset)
            d_next = ggx_perturb_reflect(d, normal, mat.specular_roughness, xi)
            return (o_next, d_next, throughput, alive, accum, k), None
        d_next = reflect(d, normal)  # shader.py:151
        return (o_next, d_next, throughput, alive, accum), None

    init = (
        origin,
        direction,
        jnp.ones((n,), dtype),
        jnp.ones((n,), dtype),
        jnp.zeros((n, 3), dtype),
    )
    if stochastic:
        init = init + (key,)
    if ray_axis is not None:
        # Inside shard_map the scan carry becomes varying over the ray axis
        # on the first iteration; mark the init likewise so the carry types
        # are invariant (required by the varying-manual-axes checker).
        def to_varying(x: jax.Array) -> jax.Array:
            if ray_axis in getattr(jax.typeof(x), "vma", frozenset()):
                return x
            return jax.lax.pcast(x, (ray_axis,), to="varying")

        init = jax.tree_util.tree_map(to_varying, init)
    step = jax.checkpoint(bounce) if cfg.remat else bounce
    final, _ = jax.lax.scan(step, init, None, length=cfg.max_depth)
    return final[4]


def _render_sample(
    scene: Scene,
    cfg: RenderConfig,
    jitter: jax.Array | None,
    key: jax.Array | None,
    route: Callable[[str, int], str],
) -> jax.Array:
    """One (optionally jittered) sample per pixel → flat (H*W, 3) colors.

    With ``cfg.ray_chunk > 0`` the trace runs as a sequential ``lax.map``
    over ray tiles, bounding the XLA sweep's (N, S) working set at
    O(chunk * spheres) — how huge frames x huge sphere tables fit on one
    device.
    """
    dirs = ray_directions(scene.camera, cfg.dtype, jitter)
    n = dirs.shape[0]
    if cfg.ray_chunk and n > cfg.ray_chunk:
        chunk = cfg.ray_chunk
        n_pad = -(-n // chunk) * chunk
        if n_pad != n:
            dirs = jnp.concatenate([dirs, jnp.broadcast_to(dirs[:1], (n_pad - n, 3))], axis=0)
        tiles = dirs.reshape(n_pad // chunk, chunk, 3)
        if key is None:
            color = jax.lax.map(lambda d: trace(scene.camera.position, d, scene, cfg, route=route), tiles)
        else:
            from .ops.rng import fold_seed

            keys = fold_seed(key, jnp.arange(tiles.shape[0], dtype=jnp.uint32))
            color = jax.lax.map(
                lambda dk: trace(scene.camera.position, dk[0], scene, cfg, key=dk[1], route=route),
                (tiles, keys),
            )
        color = color.reshape(n_pad, 3)[:n]
    else:
        color = trace(scene.camera.position, dirs, scene, cfg, key=key, route=route)
    return color


def render(
    scene: Scene,
    cfg: RenderConfig,
    *,
    route: Callable[[str, int], str] = sweep_gpu.sweep_route,
) -> jax.Array:
    """Render the scene to an (H, W, 3) float image (unclipped).

    The full pipeline of ``application.py:43-52``: camera ray generation →
    trace → (quantization lives in :mod:`.utils.image`).

    ``cfg.samples_per_pixel > 1`` averages jittered subpixel samples (a
    sequential scan — memory stays at one frame);
    ``cfg.stochastic_roughness`` draws glossy reflection directions.  Both
    are deterministic functions of ``cfg.rng_seed``.

    ``route`` picks the hard sweeps' form (see :func:`trace`); the default
    is the measured :func:`.ops.sweep_gpu.sweep_route`.
    """
    h, w = scene.camera.height, scene.camera.width
    spp = cfg.samples_per_pixel
    if spp == 1 and not cfg.stochastic_roughness:
        color = _render_sample(scene, cfg, None, None, route)
        return color.reshape(h, w, 3)

    from .ops.rng import fold_seed, seed_root, uniform2

    base = seed_root(cfg.rng_seed)
    n = h * w

    def sample(acc, i):
        k = fold_seed(base, i)
        k_jit, k_trace = fold_seed(k, 3), fold_seed(k, 4)
        jitter = uniform2(k_jit, n, cfg.dtype) - 0.5 if spp > 1 else None
        color = _render_sample(scene, cfg, jitter, k_trace if cfg.stochastic_roughness else None, route)
        return acc + color, None

    acc, _ = jax.lax.scan(sample, jnp.zeros((n, 3), cfg.dtype), jnp.arange(spp))
    return (acc / spp).reshape(h, w, 3)


_render_jit = jax.jit(render, static_argnums=1)


def render_jit(scene: Scene, cfg: RenderConfig) -> jax.Array:
    """Jitted :func:`render` (the config is a static argument)."""
    return _render_jit(scene, cfg)
