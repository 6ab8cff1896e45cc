"""Multi-device rendering via ``shard_map`` over a ``(rays, spheres)`` mesh.

The parallelism the reference lacks entirely (it is one Python thread;
SURVEY §2 rows 14-17):

* the flattened ray/pixel axis is sharded across the ``rays`` mesh axis —
  pure data/tile parallelism, zero communication in the forward sweep,
* the sphere axis may additionally be sharded across the ``spheres`` mesh
  axis (context-parallel analog, SURVEY §5.7): each device intersects every
  one of its rays against only its sphere shard, and the nearest-hit /
  shadow / coverage reductions finish with ``lax.pmin`` / ``psum`` /
  ``all_gather`` collectives,
* the (tiny) material table, lights and camera are replicated, so material
  gather after the reduction is device-local,
* gradients of a sharded loss are all-reduced by the transpose of the
  sharding — XLA inserts and overlaps the ``psum`` with backward compute.

Padding: rays are padded to a multiple of the ray-shard count (the padded
lanes render the first pixel again and are sliced off), spheres to a
multiple of the sphere-shard count with never-hitting zero-radius spheres
placed far below the scene (a zero-radius sphere has ``disc <= 0`` for
every ray — Cauchy-Schwarz — so the strict ``disc > 0`` hit test of
``shape.py:50`` can never fire, and the far placement keeps the smooth-mode
sigmoids at exactly 0).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..camera import ray_directions
from ..config import RenderConfig
from ..render import trace
from ..scene import Scene, Spheres
from .mesh import RAY_AXIS, SPHERE_AXIS, round_up

_PAD_CENTER = (0.0, -1.0e7, 0.0)


def pad_spheres(spheres: Spheres, multiple: int) -> Spheres:
    """Pad the sphere table to a multiple of the shard count.

    Padding rows are zero-radius spheres far below the scene: provably
    unhittable under the strict ``disc > 0`` test and invisible to the
    smooth relaxation (their discriminant is ~-1e14).
    """
    s = spheres.count
    target = round_up(s, multiple)
    if target == s:
        return spheres
    pad = target - s

    # Padding is built with concatenate, NOT pad + at[].set: a
    # dynamic-update-slice straddling the shard boundary of a subsequently
    # sphere-sharded array mis-partitions under jit (observed: padded rows
    # materialize on the wrong shard and real spheres vanish from the
    # sweep).  Concatenation partitions correctly.
    def pad_leaf(x: jax.Array, fill) -> jax.Array:
        block = jnp.broadcast_to(jnp.asarray(fill, x.dtype), (pad,) + x.shape[1:])
        return jnp.concatenate([x, block], axis=0)

    import dataclasses

    kw = {
        f.name: pad_leaf(getattr(spheres, f.name), 0)
        for f in dataclasses.fields(Spheres)
        if f.name != "n_exact"
    }
    # radius stays 0; all material columns stay 0 (padding rows never win
    # the nearest-hit reduction, so their materials are never gathered).
    kw["center"] = pad_leaf(spheres.center, jnp.asarray(_PAD_CENTER))
    # Padding rows land after the exact tier; fold them INTO the exact
    # suffix so real rows keep their tier (exact-tier math on an
    # unhittable pad row is merely conservative).
    return Spheres(**kw, n_exact=spheres.n_exact + pad)


def trace_sharded(
    dirs: jax.Array,  # (N, 3) — N divisible by the ray-shard count
    scene: Scene,  # sphere count divisible by the sphere-shard count
    cfg: RenderConfig,
    mesh: Mesh,
    key: jax.Array | None = None,  # PRNG seed -> stochastic glossy bounces
) -> jax.Array:
    """Trace rays across the mesh; returns (N, 3) colors.

    ``dirs`` is sharded over the ``rays`` axis; the sphere *geometry* is
    sharded over the ``spheres`` axis while the full scene (material table,
    lights, camera) is replicated.  With ``key``, each shard draws its
    stochastic GGX samples at its GLOBAL ray offsets (``ops/rng.py`` is a
    pure hash of (seed, global lane index)), so the sharded render uses
    the single-device sample sequence for the same seed (images agree up
    to fusion-order rounding on gate-flip lanes).
    """
    n_sphere_shards = mesh.shape[SPHERE_AXIS]
    n_ray_shards = mesh.shape[RAY_AXIS]
    s_local = scene.spheres.count // n_sphere_shards
    n_local = dirs.shape[0] // n_ray_shards
    # With a single sphere shard the geometry is replicated instead of
    # sharded: no collectives in the bounce loop (pure tile parallelism).
    sphere_sharded = n_sphere_shards > 1

    def shard_fn(dirs_shard: jax.Array, center_shard: jax.Array, radius_shard: jax.Array, scene_rep: Scene):
        # Mark the ray-replicated inputs varying over the ray axis once, here.
        # Otherwise every use inside the bounce scan casts them implicitly,
        # and the transposes of those casts put one gradient all-reduce per
        # parameter use inside the backward loop; cast here, the backward
        # sums each parameter's cotangent once, after the loop.
        center_shard, radius_shard, scene_rep = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (RAY_AXIS,), to="varying"),
            (center_shard, radius_shard, scene_rep),
        )
        offset = jax.lax.axis_index(SPHERE_AXIS) * s_local if sphere_sharded else 0
        return trace(
            scene_rep.camera.position,
            dirs_shard,
            scene_rep,
            cfg,
            sweep_center=center_shard,
            sweep_radius=radius_shard,
            sphere_axis=SPHERE_AXIS if sphere_sharded else None,
            sphere_offset=offset,
            ray_axis=RAY_AXIS,
            ray_offset=jax.lax.axis_index(RAY_AXIS) * n_local,
            key=key,
        )

    geom_spec = P(SPHERE_AXIS) if sphere_sharded else P()
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(RAY_AXIS), geom_spec, geom_spec, P()),
        out_specs=P(RAY_AXIS),
    )(dirs, scene.spheres.center, scene.spheres.radius, scene)


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> jax.Array:
    """Sharded :func:`..render.render`: (H, W, 3) image over the mesh.

    Pads rays/spheres to shard multiples, shards, traces, unpads.  Pure
    function of the scene pytree — jit/grad it like the single-device path.

    ``cfg.samples_per_pixel > 1`` and ``cfg.stochastic_roughness`` compose
    with sharding: the jitter is drawn at global scope with the EXACT seed
    schedule of :func:`..render.render` (fold per sample, streams 3/4) and
    sharded with the rays, so a sharded supersampled render uses the
    single-device sample sequence for the same ``cfg.rng_seed``.
    """
    n_ray_shards = mesh.shape[RAY_AXIS]
    n_sphere_shards = mesh.shape[SPHERE_AXIS]
    h, w = scene.camera.height, scene.camera.width
    n = h * w

    scene = _with_padded_spheres(scene, n_sphere_shards)
    n_pad = round_up(n, n_ray_shards)

    def dirs_for(jitter: jax.Array | None) -> jax.Array:
        dirs = ray_directions(scene.camera, cfg.dtype, jitter)
        if n_pad != n:
            dirs = jnp.concatenate([dirs, jnp.broadcast_to(dirs[:1], (n_pad - n, 3))], axis=0)
        return dirs

    spp = cfg.samples_per_pixel
    if spp == 1 and not cfg.stochastic_roughness:
        color = trace_sharded(dirs_for(None), scene, cfg, mesh)
        return color[:n].reshape(h, w, 3)

    from ..ops.rng import fold_seed, seed_root, uniform2

    base = seed_root(cfg.rng_seed)

    def sample(acc, i):
        k = fold_seed(base, i)
        k_jit, k_trace = fold_seed(k, 3), fold_seed(k, 4)
        jitter = uniform2(k_jit, n, cfg.dtype) - 0.5 if spp > 1 else None
        color = trace_sharded(
            dirs_for(jitter), scene, cfg, mesh,
            key=k_trace if cfg.stochastic_roughness else None,
        )
        return acc + color, None

    acc, _ = jax.lax.scan(sample, jnp.zeros((n_pad, 3), cfg.dtype), jnp.arange(spp))
    return (acc / spp)[:n].reshape(h, w, 3)


def _with_padded_spheres(scene: Scene, multiple: int) -> Scene:
    import dataclasses

    padded = pad_spheres(scene.spheres, multiple)
    if padded is scene.spheres:
        return scene
    return dataclasses.replace(scene, spheres=padded)


def render_sharded_jit(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> jax.Array:
    return _render_sharded_jit(scene, cfg, mesh)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _render_sharded_jit(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> jax.Array:
    return render_sharded(scene, cfg, mesh)
