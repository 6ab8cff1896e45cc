"""JSON scene + render-settings loader.

The reference shipped a JSON scene format whose loader was deleted; the
schema survives as test data (``/root/reference/tests/testdata/
input_scene.json:1-16`` and ``input_render_settings.json:1-9`` — SURVEY
§5.6 calls it "a useful checklist for the new config surface").  This
module adopts and extends that schema:

Scene file — a list of typed objects:
  {"type": "Sphere", "centerXYZ": [..], "radius": r,
   "colorRGB": [..],                       # -> diffuse_color
   "reflection": g,                        # kept as reflection_gain (vestigial
                                           #   in the reference, shader.py:45)
   "roughness": a,                         # -> specular_roughness
   "texture": "" | "checker" | "<png>",    # const / procedural / image
   # extensions (all optional, defaults = reference hardcodes):
   "diffuse_gain": g, "specular_gain": g, "iridescence_gain": g,
   "specular_ior": n, "thin_film_weight": w, "thin_film_thickness": t,
   "thin_film_ior": n}
  {"type": "Light", "centerXYZ": [..], "intensityRGB": [..]}   # point light
  {"type": "DomeLight", "intensity": i, "colorRGB": [..]}
  {"type": "Camera", "positionXYZ": [..]}                      # extension

Settings file (reference keys kept, rendering options added):
  {"image_width": W, "image_height": H, "max_specular_depth": D,
   "output_path": "...", "dtype": "float32", "visibility": "hard",
   "max_samples_per_pixel": 1, "stochastic_roughness": false,
   "rng_seed": 0, "denoise": false}
The removed kernel-choosing keys (``use_pallas``, ``block_rays``,
``block_spheres``, ``pallas_interpret``) are an error that names the key.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..scene import (
    TEXTURE_CHECKER,
    TEXTURE_CONST,
    TEXTURE_IMAGE,
    Scene,
    build_lights,
    build_spheres,
    make_scene,
    make_sphere_row,
)

_DTYPES = {"float32": jnp.float32, "float64": jnp.float64}  # no bf16: see PERF.md
# Kernels are chosen by the renderer from the platform and the scene, not
# by settings; files that still choose them are refused, not ignored.
_REMOVED_KEYS = frozenset({"use_pallas", "block_rays", "block_spheres", "pallas_interpret"})


def load_scene(path: str | Path, *, width: int = 960, height: int = 540, dtype: Any = jnp.float32) -> Scene:
    """Parse a JSON scene file into the SoA scene pytree."""
    objects = json.loads(Path(path).read_text())
    if not isinstance(objects, list):
        raise ValueError(f"{path}: scene file must be a JSON list of objects")

    rows: list[dict[str, Any]] = []
    point_light: Any = None
    domes: list[tuple[float, Any]] = []
    camera_position: Any = (0.0, 0.2, -2.0)
    atlas_images: list[np.ndarray] = []

    for obj in objects:
        kind = obj.get("type")
        if kind == "Sphere":
            texture = obj.get("texture", "")
            tex_kind, tex_id = TEXTURE_CONST, 0
            if texture == "checker":
                tex_kind = TEXTURE_CHECKER
            elif texture:
                from ..utils.image import load_png

                atlas_images.append(np.asarray(load_png(Path(path).parent / texture), np.float64) / 255.0)
                tex_kind, tex_id = TEXTURE_IMAGE, len(atlas_images) - 1
            rows.append(
                make_sphere_row(
                    obj["centerXYZ"],
                    obj["radius"],
                    diffuse_color=obj.get("colorRGB", (1.0, 1.0, 1.0)),
                    reflection_gain=obj.get("reflection", 0.0),
                    specular_roughness=obj.get("roughness", 0.0),
                    diffuse_gain=obj.get("diffuse_gain", 1.0),
                    specular_gain=obj.get("specular_gain", 0.0),
                    iridescence_gain=obj.get("iridescence_gain", 0.0),
                    specular_ior=obj.get("specular_ior", 1.5),
                    thin_film_weight=obj.get("thin_film_weight", 0.1),
                    thin_film_thickness=obj.get("thin_film_thickness", 0.3),
                    thin_film_ior=obj.get("thin_film_ior", 1.4),
                    texture_kind=tex_kind,
                    texture_id=tex_id,
                )
            )
        elif kind == "Light":
            point_light = obj["centerXYZ"]  # intensityRGB unused, like the
            # reference's PointLight (domain.py:26-30: "TODO: intensity")
        elif kind == "DomeLight":
            domes.append((float(obj.get("intensity", 0.1)), obj.get("colorRGB", (1.0, 1.0, 1.0))))
        elif kind == "Camera":
            camera_position = obj["positionXYZ"]
        else:
            raise ValueError(f"{path}: unknown object type {kind!r}")

    if point_light is None:
        raise ValueError(f"{path}: scene needs a point light (the reference shades lights[0], shader.py:75)")

    atlas = None
    atlas_hw = None
    if atlas_images:
        ht = max(a.shape[0] for a in atlas_images)
        wt = max(a.shape[1] for a in atlas_images)
        padded = np.zeros((len(atlas_images), ht, wt, 3))
        for i, a in enumerate(atlas_images):
            padded[i, : a.shape[0], : a.shape[1], :] = a[..., :3]
        atlas = padded
        # Native extents per texture: the samplers map UV over each
        # texture's own (h, w), never the zero padding (ADVICE r1).
        atlas_hw = np.asarray([[a.shape[0], a.shape[1]] for a in atlas_images], np.int32)

    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights(point_light, domes=domes, dtype=dtype)
    return make_scene(
        spheres, lights, camera_position, width, height,
        texture_atlas=atlas, texture_hw=atlas_hw, dtype=dtype,
    )


def load_settings(path: str | Path) -> tuple[RenderConfig, dict[str, Any]]:
    """Parse a render-settings JSON into (RenderConfig, extras).

    extras carries the non-config keys: image_width/height, output_path.
    """
    raw = json.loads(Path(path).read_text())
    removed = sorted(set(raw) & _REMOVED_KEYS)
    if removed:
        raise ValueError(f"{path}: render-settings key(s) no longer supported: {', '.join(removed)}")
    cfg = RenderConfig(
        max_depth=int(raw.get("max_specular_depth", 3)),
        dtype=_DTYPES[raw.get("dtype", "float32")],
        visibility=raw.get("visibility", "hard"),
        # old schema's sampling knob (input_render_settings.json:4)
        samples_per_pixel=int(raw.get("max_samples_per_pixel", 1)),
        stochastic_roughness=bool(raw.get("stochastic_roughness", False)),
        rng_seed=int(raw.get("rng_seed", 0)),
    )
    extras = {
        "width": int(raw.get("image_width", 960)),
        "height": int(raw.get("image_height", 540)),
        "output_path": raw.get("output_path", "render_out.png"),
        "denoise": bool(raw.get("denoise", False)),  # old schema key, input_render_settings.json:7
    }
    return cfg, extras
