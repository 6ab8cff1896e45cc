"""Split a scene into optimizable parameters and static structure.

The reference is forward-only (SURVEY §2 row 18); inverse rendering is the
new capability BASELINE.json configs 3/5 mandate.  ``jax.grad`` wants a
pytree of float leaves, so a :class:`..scene.Scene` is partitioned into

* **params** — a flat dict of the differentiable leaves (sphere geometry +
  material columns, light parameters, camera position, optionally the
  image-texture atlas texels), and
* **static** — the scene template carrying everything else (texture kinds /
  ids, image dims).

``combine`` re-assembles a scene; gradients flow through every param leaf.

Texture recovery (``atlas=True``): the equirectangular atlas
(``Scene.texture_atlas``, the feature spec'd by ``NumpyTexturedSphere``,
``/root/reference/ray_tracer/infrastructure/numpy/shape.py:57-90``) becomes
the param leaf ``"textures.atlas"``.  Every sampling site reads it through
``jnp`` gathers (``ops/shading.py:texture_color``), so ``jax.grad`` derives
the scatter-add adjoint automatically — each texel accumulates the loss
sensitivity of the rays that sampled it.  Off by default: most scenes have no image textures
and the atlas can dwarf every other leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import jax

from ..scene import Scene

# Differentiable sphere-table columns (all material semantics of
# NumpyShader.__init__, shader.py:36-54, promoted per-sphere).
SPHERE_PARAM_FIELDS = (
    "center",
    "radius",
    "reflection_gain",
    "specular_gain",
    "specular_roughness",
    "iridescence_gain",
    "diffuse_gain",
    "diffuse_color",
    "specular_ior",
    "thin_film_weight",
    "thin_film_thickness",
    "thin_film_ior",
)
LIGHT_PARAM_FIELDS = ("point_position", "dome_intensity", "dome_color")

Params = dict[str, jax.Array]


def scene_to_params(
    scene: Scene,
    *,
    sphere_fields: Iterable[str] = SPHERE_PARAM_FIELDS,
    light_fields: Iterable[str] = LIGHT_PARAM_FIELDS,
    camera: bool = True,
    atlas: bool = False,
) -> Params:
    """Extract the requested differentiable leaves as a flat dict.

    ``atlas=True`` adds the image-texture atlas ``(T, Ht, Wt, 3)`` as the
    leaf ``"textures.atlas"`` — inverse TEXTURE rendering (recover texels
    from observations).  Keep the atlas in [0, 1] with an update mask or a
    post-step clip; the renderer itself does not clamp texel reads.
    """
    params: Params = {}
    for f in sphere_fields:
        params[f"spheres.{f}"] = getattr(scene.spheres, f)
    for f in light_fields:
        params[f"lights.{f}"] = getattr(scene.lights, f)
    if camera:
        params["camera.position"] = scene.camera.position
    if atlas:
        params["textures.atlas"] = scene.texture_atlas
    return params


def combine(params: Params, template: Scene) -> Scene:
    """Rebuild a scene from params + the static template."""
    sphere_kw: dict[str, Any] = {}
    light_kw: dict[str, Any] = {}
    camera_kw: dict[str, Any] = {}
    scene_kw: dict[str, Any] = {}
    for key, val in params.items():
        group, field = key.split(".", 1)
        if group == "spheres":
            sphere_kw[field] = val
        elif group == "lights":
            light_kw[field] = val
        elif group == "camera":
            camera_kw[field] = val
        elif group == "textures" and field == "atlas":
            scene_kw["texture_atlas"] = val
        else:
            raise KeyError(f"unknown param group in {key!r}")
    scene = template
    if scene_kw:
        scene = dataclasses.replace(scene, **scene_kw)
    if sphere_kw:
        scene = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, **sphere_kw))
    if light_kw:
        scene = dataclasses.replace(scene, lights=dataclasses.replace(scene.lights, **light_kw))
    if camera_kw:
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, **camera_kw))
    return scene
