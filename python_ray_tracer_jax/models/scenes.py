"""Built-in scenes.

``reference_scene`` reproduces the reference demo scene literal
(``/root/reference/main.py:13-51``) — the golden-image scene.  The other
builders cover BASELINE.json configs 4 and 5 (1024-sphere scale test and the
64-sphere inverse-rendering task).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from ..scene import (
    TEXTURE_CHECKER,
    Scene,
    build_lights,
    build_spheres,
    make_scene,
    make_sphere_row,
)


def reference_scene(width: int = 960, height: int = 540, dtype: Any = jnp.float32) -> Scene:
    """The 3-sphere README scene, ref ``main.py:13-51``.

    Sphere 1: white, all gains zero (silhouette + ambient/dome only).
    Sphere 2: red constant texture, specular_gain 1, roughness 0.1.
    Ground: giant checker sphere (r=99999), diffuse 1, specular 0.1.
    Lights: point at (-2, 1, 2); dome intensity 0.1 white.
    Camera at (0, 0.2, -2).
    """
    rows = [
        make_sphere_row(
            (0.55, 0.5, 3.0),
            1.0,
            reflection_gain=0.0,
            specular_gain=0.0,
            specular_roughness=0.01,
            iridescence_gain=0.0,
            diffuse_gain=0.0,
            diffuse_color=(1.0, 1.0, 1.0),
        ),
        make_sphere_row(
            (-0.45, 0.1, 1.0),
            0.4,
            reflection_gain=0.0,
            specular_gain=1.0,
            specular_roughness=0.1,
            iridescence_gain=0.0,
            diffuse_gain=0.0,
            diffuse_color=(1.0, 0.0, 0.0),
        ),
        make_sphere_row(
            (0.0, -99999.5, 0.0),
            99999.0,
            reflection_gain=0.0,
            specular_gain=0.1,
            specular_roughness=0.5,
            iridescence_gain=0.0,
            diffuse_gain=1.0,
            diffuse_color=(1.0, 1.0, 1.0),
            texture_kind=TEXTURE_CHECKER,
        ),
    ]
    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights((-2.0, 1.0, 2.0), domes=[(0.1, (1.0, 1.0, 1.0))], dtype=dtype)
    return make_scene(spheres, lights, (0.0, 0.2, -2.0), width, height, dtype=dtype)


def all_effects_scene(width: int = 960, height: int = 540, dtype: Any = jnp.float32) -> Scene:
    """Every feature at once (the reference's ``docs/images/all_effects.png``
    montage, ``README.md:12-20`` there): checker ground, glossy red sphere,
    iridescent sphere, mirror sphere, matte colored sphere, point + dome
    light."""
    rows = [
        # mirror sphere
        make_sphere_row((0.9, 0.35, 2.6), 0.85, specular_gain=1.0, specular_roughness=0.02),
        # glossy red sphere
        make_sphere_row(
            (-0.9, 0.0, 1.6), 0.5, specular_gain=0.9, specular_roughness=0.15,
            diffuse_gain=0.6, diffuse_color=(0.9, 0.05, 0.05),
        ),
        # iridescent sphere
        make_sphere_row(
            (0.0, -0.1, 1.1), 0.35, specular_gain=0.4, specular_roughness=0.3,
            iridescence_gain=2.5, diffuse_gain=0.25, diffuse_color=(0.2, 0.2, 0.4),
        ),
        # matte green sphere
        make_sphere_row(
            (-2.0, 0.3, 3.2), 0.8, diffuse_gain=1.0, diffuse_color=(0.1, 0.7, 0.2),
            specular_gain=0.15, specular_roughness=0.5,
        ),
        # checker ground
        make_sphere_row(
            (0.0, -99999.5, 0.0), 99999.0, specular_gain=0.1, specular_roughness=0.5,
            diffuse_gain=1.0, texture_kind=TEXTURE_CHECKER,
        ),
    ]
    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights((-2.0, 2.5, -1.0), domes=[(0.12, (0.9, 0.95, 1.0))], dtype=dtype)
    return make_scene(spheres, lights, (0.0, 0.3, -2.2), width, height, dtype=dtype)


def random_spheres_scene(
    n_spheres: int = 1024,
    width: int = 1920,
    height: int = 1080,
    seed: int = 0,
    dtype: Any = jnp.float32,
) -> Scene:
    """BASELINE config 4: many random spheres (the sweep-kernel scale test)."""
    rng = np.random.default_rng(seed)
    rows = []
    # Keep the checker ground for visual reference.
    rows.append(
        make_sphere_row(
            (0.0, -99999.5, 0.0),
            99999.0,
            specular_gain=0.1,
            specular_roughness=0.5,
            diffuse_gain=1.0,
            texture_kind=TEXTURE_CHECKER,
        )
    )
    for _ in range(n_spheres - 1):
        center = rng.uniform([-12.0, -0.3, 1.0], [12.0, 6.0, 30.0])
        radius = rng.uniform(0.1, 0.5)
        color = rng.uniform(0.1, 1.0, size=3)
        rows.append(
            make_sphere_row(
                center,
                radius,
                specular_gain=float(rng.uniform(0.0, 1.0)),
                specular_roughness=float(rng.uniform(0.05, 0.8)),
                iridescence_gain=float(rng.uniform(0.0, 0.3)),
                diffuse_gain=float(rng.uniform(0.3, 1.0)),
                diffuse_color=color,
            )
        )
    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights((-8.0, 10.0, -2.0), domes=[(0.15, (1.0, 1.0, 1.0))], dtype=dtype)
    return make_scene(spheres, lights, (0.0, 1.0, -4.0), width, height, dtype=dtype)


def textured_spheres_scene(
    n_spheres: int = 1024,
    width: int = 1920,
    height: int = 1080,
    tex_side: int = 512,
    n_textures: int = 2,
    seed: int = 13,
    dtype: Any = jnp.float32,
) -> Scene:
    """Config-4-scale scene with equirectangular image textures.

    Every 4th sphere samples one of ``n_textures`` random ``tex_side``²
    images, a big texture atlas beside a big sphere table.  Checker ground
    kept.
    """
    from ..scene import TEXTURE_IMAGE

    rng = np.random.default_rng(seed)
    atlas = rng.uniform(0.05, 1.0, (n_textures, tex_side, tex_side, 3)).astype(np.float32)
    rows = [
        make_sphere_row(
            (0.0, -99999.5, 0.0), 99999.0, specular_gain=0.1,
            specular_roughness=0.5, diffuse_gain=1.0, texture_kind=TEXTURE_CHECKER,
        )
    ]
    for i in range(n_spheres - 1):
        center = rng.uniform([-12.0, -0.3, 1.0], [12.0, 6.0, 30.0])
        kw = dict(
            specular_gain=float(rng.uniform(0.0, 1.0)),
            specular_roughness=float(rng.uniform(0.05, 0.8)),
            diffuse_gain=float(rng.uniform(0.3, 1.0)),
            diffuse_color=rng.uniform(0.1, 1.0, 3),
        )
        if i % 4 == 0:
            kw.update(texture_kind=TEXTURE_IMAGE, texture_id=i % n_textures)
        rows.append(make_sphere_row(center, float(rng.uniform(0.1, 0.5)), **kw))
    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights((-8.0, 10.0, -2.0), domes=[(0.15, (1.0, 1.0, 1.0))], dtype=dtype)
    return make_scene(
        spheres, lights, (0.0, 1.0, -4.0), width, height, texture_atlas=atlas, dtype=dtype
    )


def texture_task_scene(
    texture: Any,
    width: int = 256,
    height: int = 144,
    dtype: Any = jnp.float32,
) -> Scene:
    """Single image-textured sphere filling the frame — the inverse-TEXTURE
    rendering task (recover the atlas texels from observations).

    The sphere faces the camera with ``diffuse_gain=1`` and no specular
    terms, and the point light sits behind the camera, so most of the
    visible hemisphere is lit and nearly every front-facing texel of the
    equirectangular map (``shape.py:57-90``) receives loss signal.
    """
    from ..scene import TEXTURE_IMAGE

    atlas = np.asarray(texture, np.float32)[None]  # (1, Ht, Wt, 3)
    rows = [
        make_sphere_row(
            (0.0, 0.0, 2.2),
            1.4,
            diffuse_gain=1.0,
            texture_kind=TEXTURE_IMAGE,
            texture_id=0,
        )
    ]
    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights((0.5, 1.0, -6.0), domes=[(0.05, (1.0, 1.0, 1.0))], dtype=dtype)
    return make_scene(
        spheres, lights, (0.0, 0.0, -1.0), width, height, texture_atlas=atlas, dtype=dtype
    )


def inverse_task_scene(
    n_spheres: int = 64,
    width: int = 256,
    height: int = 144,
    seed: int = 7,
    dtype: Any = jnp.float32,
) -> Scene:
    """BASELINE config 5: small multi-sphere scene for inverse rendering."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_spheres):
        center = rng.uniform([-3.0, -0.2, 1.0], [3.0, 2.0, 8.0])
        radius = rng.uniform(0.15, 0.45)
        color = rng.uniform(0.1, 1.0, size=3)
        rows.append(
            make_sphere_row(
                center,
                radius,
                specular_gain=float(rng.uniform(0.0, 0.5)),
                specular_roughness=float(rng.uniform(0.1, 0.6)),
                diffuse_gain=float(rng.uniform(0.5, 1.0)),
                diffuse_color=color,
            )
        )
    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights((-4.0, 6.0, -1.0), domes=[(0.1, (1.0, 1.0, 1.0))], dtype=dtype)
    return make_scene(spheres, lights, (0.0, 0.6, -3.0), width, height, dtype=dtype)
