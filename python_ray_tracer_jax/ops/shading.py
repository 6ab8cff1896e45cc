"""The full shading stack, vectorized over ray lanes.

Re-implements every live term of the reference's ``NumpyShader``
(``/root/reference/ray_tracer/infrastructure/numpy/shader.py:35-320``) as
pure functions over packed per-lane arrays with per-lane (gathered) material
parameters.  Where the reference shades one extracted batch per shape with
scalar material constants, we shade *all* lanes at once with materials
gathered by nearest-hit index — identical per-lane math, no stream
compaction (SURVEY §3.7 hot-loop item 3).

Term-by-term provenance:

* ambient: constant (0.004, 0.004, 0.004) — ``shader.py:183-184``
* diffuse: ``texture(p) * max(n·L, 0) * in_light * diffuse_gain`` —
  ``shader.py:130-141``
* dome: ``Σ_d intensity_d * max(n·(0,1,0), 0)`` times the *last* dome
  light's color — ``shader.py:234-244``
* GGX specular + glint: ``shader.py:246-320`` (Schlick Fresnel, GGX D,
  Smith Schlick-GGX G, ``eps = 1e-8``, glint ``(1-NdotV)^2.5 * NdotL``
  scaled by ``specular_gain`` *inside* — so the later outer
  ``* specular_gain`` at ``shader.py:106`` makes the glint effectively
  gain²; replicated)
* thin-film iridescence: ``shader.py:186-232``
* textures: constant color (``shader.py:13-19``), checker
  ``trunc(2x) mod 2 == trunc(2z) mod 2`` (``shader.py:22-32``),
  equirectangular image UV per ``NumpyTexturedSphere``
  (``shape.py:57-90`` — dead code in the reference but part of its spec).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene import Lights, Scene, Spheres
from .vecmath import dot, normalize

AMBIENT = 0.004  # shader.py:184
SHADING_EPS = 1e-8  # shader.py:275
GLINT_EXPONENT = 2.5  # shader.py:309
NUDGE = 0.0001  # shader.py:77


class LaneMaterial(NamedTuple):
    """Per-lane material parameters gathered from the sphere table."""

    center: jax.Array  # (N, 3)
    radius: jax.Array  # (N,)
    specular_gain: jax.Array
    specular_roughness: jax.Array
    iridescence_gain: jax.Array
    diffuse_gain: jax.Array
    diffuse_color: jax.Array  # (N, 3)
    specular_ior: jax.Array
    thin_film_weight: jax.Array
    thin_film_thickness: jax.Array
    thin_film_ior: jax.Array
    texture_kind: jax.Array  # (N,) int32
    texture_id: jax.Array  # (N,) int32


# Above this sphere count the (N, S) one-hot becomes the memory bottleneck
# and row gathers win (their backward scatter only matters for training,
# which runs on small inverse-task scenes — BASELINE config 5 is 64 spheres).
_ONEHOT_MAX_SPHERES = 128

_FLOAT_FIELDS = (
    "radius",
    "specular_gain",
    "specular_roughness",
    "iridescence_gain",
    "diffuse_gain",
    "specular_ior",
    "thin_film_weight",
    "thin_film_thickness",
    "thin_film_ior",
)


def gather_material(spheres: Spheres, idx: jax.Array) -> LaneMaterial:
    """Per-lane material rows for each lane's nearest sphere.

    Small sphere tables: ONE ``one_hot(idx) @ M`` matmul over a stacked
    (S, 15) material matrix, whose transpose is another matmul rather than
    a 518k-lane scatter-add.  Large tables use row gathers (the one-hot
    would dominate memory).  Which form is faster on a GPU is an open
    measurement (ROADMAP A4).
    """
    dtype = spheres.center.dtype
    s = spheres.center.shape[0]
    if s <= _ONEHOT_MAX_SPHERES:
        mat = jnp.concatenate(
            [spheres.center, spheres.diffuse_color]
            + [getattr(spheres, f)[:, None] for f in _FLOAT_FIELDS],
            axis=1,
        )  # (S, 6 + len(_FLOAT_FIELDS))
        onehot = jax.nn.one_hot(idx, s, dtype=dtype)  # (N, S)
        # HIGHEST precision: a reduced-precision matmul (bf16 or TF32
        # passes) would round material values; full float32 is exact for a
        # one-hot product (products against 1.0 and 0.0 are exact).
        rows = jnp.matmul(onehot, mat, precision=jax.lax.Precision.HIGHEST)  # (N, C)
        center = rows[:, 0:3]
        diffuse_color = rows[:, 3:6]
        scalars = {f: rows[:, 6 + i] for i, f in enumerate(_FLOAT_FIELDS)}
    else:
        g = lambda a: jnp.take(a, idx, axis=0)
        center = g(spheres.center)
        diffuse_color = g(spheres.diffuse_color)
        scalars = {f: g(getattr(spheres, f)) for f in _FLOAT_FIELDS}
    return LaneMaterial(
        center=center,
        diffuse_color=diffuse_color,
        texture_kind=jnp.take(spheres.texture_kind, idx, axis=0),
        texture_id=jnp.take(spheres.texture_id, idx, axis=0),
        **scalars,
    )


def texture_color(point: jax.Array, normal: jax.Array, mat: LaneMaterial, scene: Scene) -> jax.Array:
    """Per-lane diffuse texture lookup, selected by ``texture_kind``.

    All three texture kinds are evaluated and blended by select — masked
    lanes instead of per-object dispatch (the array-programming replacement for the
    reference's ``Texture`` class hierarchy, ``shader.py:13-32``).
    """
    dtype = point.dtype
    # Constant color (shader.py:17-19).
    const_c = mat.diffuse_color

    # Checker (shader.py:29-32): trunc-toward-zero int cast, then mod 2.
    cx = jnp.trunc(point[..., 0] * 2.0).astype(jnp.int32) % 2
    cz = jnp.trunc(point[..., 2] * 2.0).astype(jnp.int32) % 2
    checker_c = jnp.where((cx == cz)[..., None], jnp.ones((), dtype), jnp.zeros((), dtype))

    # Equirectangular image texture (shape.py:68-81): UV from the unit
    # normal; nearest-texel gather from the atlas.  UV scales by each
    # texture's NATIVE (h, w) so padded atlas slots never sample padding.
    # The lookup is piecewise-constant, so UV carries NO gradient; without
    # the stop_gradient, asin'(+-1) = inf on pole/dead lanes turns the
    # would-be zero cotangent into 0 * inf = NaN.
    normal = jax.lax.stop_gradient(normal)
    ny = jnp.clip(normal[..., 1], -1.0, 1.0)  # guard asin on dead lanes
    u = 0.5 + jnp.arctan2(normal[..., 2], normal[..., 0]) / (2.0 * jnp.pi)
    v = 0.5 - jnp.arcsin(ny) / jnp.pi
    u = u % 1.0
    v = v % 1.0
    hw = jnp.take(scene.texture_hw, mat.texture_id, axis=0)  # (N, 2) int32
    th_l = hw[..., 0].astype(dtype)
    tw_l = hw[..., 1].astype(dtype)
    ti = jnp.clip((u * (tw_l - 1.0)).astype(jnp.int32), 0, hw[..., 1] - 1)
    tj = jnp.clip((v * (th_l - 1.0)).astype(jnp.int32), 0, hw[..., 0] - 1)
    image_c = scene.texture_atlas[mat.texture_id, tj, ti, :].astype(dtype)

    kind = mat.texture_kind[..., None]
    return jnp.where(kind == 1, checker_c, jnp.where(kind == 2, image_c, const_c))


def dome_light(normal: jax.Array, lights: Lights) -> jax.Array:
    """Dome (sky) contribution — ``shader.py:234-244``.

    Intensities of all dome lights accumulate with the same up-facing factor;
    only the last dome light's color scales the sum (reference quirk kept).
    """
    updot = jnp.maximum(normal[..., 1], 0.0)  # n · (0,1,0)
    intensity = jnp.sum(lights.dome_intensity) * updot
    return lights.dome_color[-1][None, :] * intensity[..., None]


def ggx_specular(
    normal: jax.Array,
    to_light: jax.Array,
    to_camera: jax.Array,
    mat: LaneMaterial,
) -> jax.Array:
    """GGX microfacet specular + edge glint — ``shader.py:246-320``.

    Returns the scalar ``spec_final`` per lane (the reference broadcasts it
    to RGB at ``shader.py:318-320``).
    """
    eps = SHADING_EPS
    L = normalize(to_light)  # shader.py:278 (re-normalization kept)
    V = normalize(to_camera)  # shader.py:279
    H = normalize(L + V)  # shader.py:280

    n_dot_v = jnp.clip(dot(normal, V), 0.0, 1.0)
    n_dot_h_raw = dot(normal, H)
    n_dot_h = jnp.clip(n_dot_h_raw, 0.0, 1.0)
    v_dot_h = jnp.clip(dot(V, H), 0.0, 1.0)
    n_dot_l = jnp.clip(dot(normal, L), 0.0, 1.0)

    f0 = ((mat.specular_ior - 1.0) / (mat.specular_ior + 1.0)) ** 2
    fresnel = f0 + (1.0 - f0) * (1.0 - v_dot_h) ** 5

    alpha = mat.specular_roughness**2
    # shader.py's (n·h)^2 (alpha^2 - 1) + 1, computed as
    # alpha^2 + |n x h|^2 (1 - alpha^2): the same value for a unit normal
    # (Lagrange's identity, 1 - (n·h)^2 = |n x h|^2).  The direct form
    # cancels near the highlight peak, where the sum is ~alpha^2: in
    # float32 that moved highlight pixels by up to 6e-3 and the roughness
    # and IOR gradients by ~1.5e-3 relative to float64.
    nxh = jnp.cross(normal, H)
    denom = jnp.where(n_dot_h_raw > 0, alpha**2 + dot(nxh, nxh) * (1.0 - alpha**2), 1.0)
    dist = (alpha**2) / (jnp.pi * (denom**2 + eps))

    def g1(x_dot_n: jax.Array) -> jax.Array:
        # Double-where guards sqrt(0) (roughness 0 and grazing/back-facing
        # x simultaneously): its backward is inf and the would-be-zero
        # cotangent becomes 0 * inf = NaN, poisoning every upstream
        # gradient.  Forward is bitwise unchanged.
        arg = alpha**2 + (1.0 - alpha**2) * (x_dot_n**2)
        pos = arg > 0
        root = jnp.where(pos, jnp.sqrt(jnp.where(pos, arg, 1.0)), 0.0)
        return 2.0 * x_dot_n / (x_dot_n + root + eps)

    geom = g1(n_dot_l) * g1(n_dot_v)

    spec_base = (fresnel * dist * geom) / (4.0 * n_dot_v + eps)
    glint = (1.0 - n_dot_v) ** GLINT_EXPONENT * n_dot_l
    spec_final = spec_base + mat.specular_gain * glint
    return jnp.where(n_dot_v <= 0, jnp.zeros_like(spec_final), spec_final)


def iridescence(normal: jax.Array, to_camera: jax.Array, mat: LaneMaterial) -> jax.Array:
    """Thin-film interference tint — ``shader.py:186-232``."""
    view_angle = jnp.clip(dot(normal, to_camera), 0.0, 1.0)
    angle_factor = jnp.abs(view_angle - 0.5) * 2.0
    phase = angle_factor * jnp.pi * mat.thin_film_thickness * 10.0
    ip = jnp.sin(phase)
    hue = (mat.thin_film_ior - 1.0) / 2.0
    r = ip * hue + (1.0 - hue) * (1.0 - ip)
    g = ip * (1.0 - hue) + hue * (1.0 - ip)
    b = 0.5 + 0.5 * ip
    film = jnp.stack([r, g, b], axis=-1)
    return film * (mat.thin_film_weight * mat.iridescence_gain)[..., None]


class ShadeResult(NamedTuple):
    """Local (non-recursive) shading plus the mirror-continuation weight.

    The reference folds the recursive reflection into the specular term as
    ``(spec + refl*0.5) * specular_gain * in_light`` (``shader.py:106``).
    Splitting that sum, a bounce's contribution to its parent is the parent's
    ``refl_coeff = 0.5 * specular_gain * in_light`` — carried as throughput
    by the scan in :mod:`..render`.
    """

    color: jax.Array  # (N, 3) local color (ambient+diffuse+dome+spec+irid)
    refl_coeff: jax.Array  # (N,) weight of the reflected ray's color


def shade(
    point: jax.Array,  # (N, 3) intersection points
    normal: jax.Array,  # (N, 3) unit normals
    to_light: jax.Array,  # (N, 3) unit dir to the point light
    to_camera: jax.Array,  # (N, 3) unit dir to the *original* camera
    in_light: jax.Array,  # (N,) shadow visibility in [0, 1]
    mat: LaneMaterial,
    scene: Scene,
) -> ShadeResult:
    """Everything ``NumpyShader.create`` computes except the recursion.

    Term order preserved from ``shader.py:86-110``:
    ``((((ambient + diffuse) + dome) + spec_refl) + iridescence)``.
    """
    dtype = point.dtype
    ambient = jnp.full_like(point, jnp.asarray(AMBIENT, dtype))

    n_dot_l = jnp.maximum(dot(normal, to_light), 0.0)  # shader.py:138
    diffuse = texture_color(point, normal, mat, scene) * (n_dot_l * in_light * mat.diffuse_gain)[..., None]

    dome = dome_light(normal, scene.lights)

    spec = ggx_specular(normal, to_light, to_camera, mat)
    spec_term = (spec * mat.specular_gain * in_light)[..., None] * jnp.ones((1, 3), dtype)

    irid = iridescence(normal, to_camera, mat)

    color = ambient + diffuse + dome + spec_term + irid
    refl_coeff = 0.5 * mat.specular_gain * in_light
    return ShadeResult(color=color, refl_coeff=refl_coeff)
