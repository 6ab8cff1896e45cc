"""Scene description as structure-of-arrays JAX pytrees.

The reference (``/root/reference/ray_tracer/domain.py:1-59`` and
``main.py:13-51``) describes a scene as a Python object graph: a list of
``NumpySphere`` instances each owning a ``NumpyShader``, a list of
``PointLight``/``DomeLight`` objects, and a ``Camera``.  That AoS layout is
hostile to XLA (dynamic Python loops over shapes, per-object dispatch), so
this module re-designs it as dense arrays:

* every per-sphere quantity lives in one dense array over the sphere axis
  ``S`` (``centers (S,3)``, ``radii (S,)``, one column per material knob),
* lights are split by kind into dense arrays,
* the whole scene is a single pytree that can be passed through ``jax.jit``,
  ``jax.grad`` and ``shard_map`` and sharded/replicated with
  ``NamedSharding``.

Material semantics mirror ``NumpyShader.__init__``
(``ray_tracer/infrastructure/numpy/shader.py:36-54``): per-sphere gains plus
the constants the reference hardcodes (``specular_ior=1.5``,
``thin_film_weight=0.1``, ``thin_film_thickness=0.3``, ``thin_film_ior=1.4``)
are promoted to per-sphere arrays so they are optimizable, with defaults
equal to the reference's hardcoded values.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# Texture kinds (shader.py:13-32): constant color or procedural checker,
# plus the equirectangular image texture spec'd by NumpyTexturedSphere
# (shape.py:57-90).
TEXTURE_CONST = 0
TEXTURE_CHECKER = 1
TEXTURE_IMAGE = 2

# Reference-hardcoded material constants (shader.py:51-54).
DEFAULT_SPECULAR_IOR = 1.5
DEFAULT_THIN_FILM_WEIGHT = 0.1
DEFAULT_THIN_FILM_THICKNESS = 0.3
DEFAULT_THIN_FILM_IOR = 1.4


def _register(cls: type, *, meta: tuple[str, ...] = ()) -> type:
    """Register a dataclass as a JAX pytree with the given static fields."""
    fields = [f.name for f in dataclasses.fields(cls)]
    data = tuple(f for f in fields if f not in meta)
    return jax.tree_util.register_dataclass(cls, data_fields=list(data), meta_fields=list(meta))


@dataclasses.dataclass
class Camera:
    """Pinhole camera, ref ``domain.py:14-23``.

    ``width``/``height`` are static (they fix array shapes under jit);
    ``position`` is a differentiable leaf.
    """

    position: jax.Array  # (3,)
    width: int
    height: int


Camera = _register(Camera, meta=("width", "height"))


@dataclasses.dataclass
class Lights:
    """All lights, split by kind.

    The reference stores a heterogeneous list (``domain.py:53-59``) but only
    ever uses ``lights[0]`` as the point light (``shader.py:75``) and
    iterates dome lights by isinstance (``shader.py:239-242``).  We keep one
    point light position plus dense dome arrays.  Per ``shader.py:239-242``,
    when several dome lights exist their intensities accumulate but only the
    *last* dome light's color is used — replicated here.
    """

    point_position: jax.Array  # (3,) — lights[0] in the reference
    dome_intensity: jax.Array  # (D,)
    dome_color: jax.Array  # (D, 3)


Lights = _register(Lights)


@dataclasses.dataclass
class Spheres:
    """Dense sphere + material table over the sphere axis ``S``.

    Geometry per ``NumpySphere`` (``shape.py:16-26``), material per
    ``NumpyShader`` (``shader.py:36-54``).  ``reflection_gain`` is stored for
    parity but — exactly like the reference (``shader.py:45`` is never read;
    the live reflection scale is ``0.5 * specular_gain``, ``shader.py:106``)
    — it does not affect rendering.

    ``n_exact`` (static): number of TRAILING rows that need the
    compensated-arithmetic intersection path in float32 (huge radius or
    far-off center, e.g. the reference's r=99999 ground plane,
    ``main.py:39-43``).  :func:`build_spheres` orders such spheres last and
    sets the split; the sweeps run ~4x cheaper plain-f32 math on the
    leading rows.  0 is always safe (means "treat all rows as cheap"
    when the table is known benign, or callers may pass the full count).
    """

    center: jax.Array  # (S, 3)
    radius: jax.Array  # (S,)
    reflection_gain: jax.Array  # (S,)  vestigial, parity with shader.py:45
    specular_gain: jax.Array  # (S,)
    specular_roughness: jax.Array  # (S,)
    iridescence_gain: jax.Array  # (S,)
    diffuse_gain: jax.Array  # (S,)
    diffuse_color: jax.Array  # (S, 3)
    specular_ior: jax.Array  # (S,)
    thin_film_weight: jax.Array  # (S,)
    thin_film_thickness: jax.Array  # (S,)
    thin_film_ior: jax.Array  # (S,)
    texture_kind: jax.Array  # (S,) int32 — TEXTURE_CONST/CHECKER/IMAGE
    texture_id: jax.Array  # (S,) int32 — row into the scene texture atlas
    n_exact: int = 0  # static — trailing rows needing compensated math

    @property
    def count(self) -> int:
        return self.center.shape[0]


Spheres = _register(Spheres, meta=("n_exact",))

# Host-side partition thresholds: beyond these, |o-c|^2 - r^2 cancels
# catastrophically in float32 and the sphere goes to the exact tier.
EXACT_TIER_RADIUS = 100.0
EXACT_TIER_CENTER = 1000.0


@dataclasses.dataclass
class Scene:
    """Complete scene pytree: spheres + lights + camera + optional textures.

    ``texture_atlas`` is ``(T, Ht, Wt, 3)`` equirectangular images in [0, 1]
    (the feature spec'd by ``NumpyTexturedSphere``, ``shape.py:57-90``); pass
    a (1, 1, 1, 3) dummy when no image textures are used.  Differently-sized
    textures are zero-padded to the common (Ht, Wt) — ``texture_hw`` keeps
    each texture's native (h, w) so UV maps over the texture's own extent,
    never the padding (ADVICE r1: two differently-sized textures would
    otherwise render squashed/black).
    """

    spheres: Spheres
    lights: Lights
    camera: Camera
    texture_atlas: jax.Array  # (T, Ht, Wt, 3)
    texture_hw: jax.Array  # (T, 2) int32 — native (h, w) per texture


Scene = _register(Scene)


def make_sphere_row(
    center: Any,
    radius: float,
    *,
    reflection_gain: float = 0.0,
    specular_gain: float = 0.0,
    specular_roughness: float = 0.0,
    iridescence_gain: float = 0.0,
    diffuse_gain: float = 0.0,
    diffuse_color: Any = (1.0, 1.0, 1.0),
    specular_ior: float = DEFAULT_SPECULAR_IOR,
    thin_film_weight: float = DEFAULT_THIN_FILM_WEIGHT,
    thin_film_thickness: float = DEFAULT_THIN_FILM_THICKNESS,
    thin_film_ior: float = DEFAULT_THIN_FILM_IOR,
    texture_kind: int = TEXTURE_CONST,
    texture_id: int = 0,
) -> dict[str, Any]:
    """One sphere's row as a plain dict (stacked later by :func:`build_spheres`)."""
    return dict(
        center=np.asarray(center, dtype=np.float64),
        radius=float(radius),
        reflection_gain=float(reflection_gain),
        specular_gain=float(specular_gain),
        specular_roughness=float(specular_roughness),
        iridescence_gain=float(iridescence_gain),
        diffuse_gain=float(diffuse_gain),
        diffuse_color=np.asarray(diffuse_color, dtype=np.float64),
        specular_ior=float(specular_ior),
        thin_film_weight=float(thin_film_weight),
        thin_film_thickness=float(thin_film_thickness),
        thin_film_ior=float(thin_film_ior),
        texture_kind=int(texture_kind),
        texture_id=int(texture_id),
    )


def build_spheres(rows: list[dict[str, Any]], dtype: Any = jnp.float32) -> Spheres:
    """Stack per-sphere rows into the dense SoA table.

    Rows are reordered cheap-tier first / exact-tier last (stable within
    each tier) so the float32 sweeps can run plain math on the cheap
    prefix; ``n_exact`` records the split.
    """
    if not rows:
        raise ValueError("scene needs at least one sphere")

    def is_exact(r: dict[str, Any]) -> bool:
        return float(r["radius"]) > EXACT_TIER_RADIUS or float(
            np.abs(np.asarray(r["center"])).max()
        ) > EXACT_TIER_CENTER

    rows = sorted(rows, key=is_exact)  # stable: cheap tier keeps input order
    n_exact = sum(1 for r in rows if is_exact(r))

    def col(name: str, d: Any) -> jax.Array:
        return jnp.asarray(np.stack([np.asarray(r[name]) for r in rows]), dtype=d)

    return Spheres(
        n_exact=n_exact,
        center=col("center", dtype),
        radius=col("radius", dtype),
        reflection_gain=col("reflection_gain", dtype),
        specular_gain=col("specular_gain", dtype),
        specular_roughness=col("specular_roughness", dtype),
        iridescence_gain=col("iridescence_gain", dtype),
        diffuse_gain=col("diffuse_gain", dtype),
        diffuse_color=col("diffuse_color", dtype),
        specular_ior=col("specular_ior", dtype),
        thin_film_weight=col("thin_film_weight", dtype),
        thin_film_thickness=col("thin_film_thickness", dtype),
        thin_film_ior=col("thin_film_ior", dtype),
        texture_kind=col("texture_kind", jnp.int32),
        texture_id=col("texture_id", jnp.int32),
    )


def build_lights(
    point_position: Any,
    domes: list[tuple[float, Any]] | None = None,
    dtype: Any = jnp.float32,
) -> Lights:
    """Build the light table. ``domes`` is a list of (intensity, color)."""
    domes = domes or []
    if domes:
        intensity = jnp.asarray([d[0] for d in domes], dtype=dtype)
        color = jnp.asarray(np.stack([np.asarray(d[1], dtype=np.float64) for d in domes]), dtype=dtype)
    else:
        intensity = jnp.zeros((1,), dtype=dtype)
        color = jnp.ones((1, 3), dtype=dtype)
    return Lights(
        point_position=jnp.asarray(np.asarray(point_position, dtype=np.float64), dtype=dtype),
        dome_intensity=intensity,
        dome_color=color,
    )


def make_scene(
    spheres: Spheres,
    lights: Lights,
    camera_position: Any,
    width: int,
    height: int,
    texture_atlas: Any | None = None,
    texture_hw: Any | None = None,
    dtype: Any = jnp.float32,
) -> Scene:
    if texture_atlas is None:
        texture_atlas = jnp.zeros((1, 1, 1, 3), dtype=dtype)
    else:
        texture_atlas = jnp.asarray(texture_atlas, dtype=dtype)
    if texture_hw is None:
        # Every texture assumed to fill the atlas slot (single-size case).
        t = texture_atlas.shape[0]
        texture_hw = np.tile(
            np.asarray([[texture_atlas.shape[1], texture_atlas.shape[2]]], np.int32), (t, 1)
        )
    texture_hw = jnp.asarray(texture_hw, jnp.int32)
    cam = Camera(
        position=jnp.asarray(np.asarray(camera_position, dtype=np.float64), dtype=dtype),
        width=int(width),
        height=int(height),
    )
    return Scene(
        spheres=spheres, lights=lights, camera=cam, texture_atlas=texture_atlas, texture_hw=texture_hw
    )


def scene_dtype(scene: Scene) -> Any:
    return scene.spheres.center.dtype


def cast_scene(scene: Scene, dtype: Any) -> Scene:
    """Cast every floating leaf of the scene to ``dtype`` (ints untouched)."""

    def cast(x: Any) -> Any:
        if isinstance(x, (jax.Array, np.ndarray)) and jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(x, dtype=dtype)
        return x

    return jax.tree_util.tree_map(cast, scene)
