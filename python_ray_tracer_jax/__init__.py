"""Differentiable sphere ray tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``tristanGIANDO/python_ray_tracer`` (reference mounted at
``/root/reference``): sphere ray tracing with Lambertian diffuse, GGX
microfacet specular + glint, hard shadows, mirror reflections, thin-film
iridescence, checker / image textures, point + dome lights — made
differentiable (``jax.grad`` through the whole pipeline with optional smooth
visibility), fast (dense XLA sweeps, and one Pallas GPU kernel for the
hard-visibility sweep of big sphere tables) and scalable
(``shard_map`` over device meshes).
"""

from .config import RenderConfig, faraway
from .render import render, render_jit, trace
from .scene import (
    TEXTURE_CHECKER,
    TEXTURE_CONST,
    TEXTURE_IMAGE,
    Camera,
    Lights,
    Scene,
    Spheres,
    build_lights,
    build_spheres,
    cast_scene,
    make_scene,
    make_sphere_row,
)

__all__ = [
    "RenderConfig",
    "faraway",
    "render",
    "render_jit",
    "trace",
    "Camera",
    "Lights",
    "Scene",
    "Spheres",
    "build_lights",
    "build_spheres",
    "cast_scene",
    "make_scene",
    "make_sphere_row",
    "TEXTURE_CHECKER",
    "TEXTURE_CONST",
    "TEXTURE_IMAGE",
]

__version__ = "0.1.0"
