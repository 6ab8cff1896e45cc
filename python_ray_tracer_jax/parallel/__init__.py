"""Multi-device parallelism: device meshes + shard_map rendering.

The reference has zero parallelism or communication machinery (SURVEY §2
rows 14-17); this package is the from-scratch scale-out layer.
"""

from .mesh import RAY_AXIS, SPHERE_AXIS, make_mesh, round_up
from .sharded import pad_spheres, render_sharded, render_sharded_jit, trace_sharded

__all__ = [
    "RAY_AXIS",
    "SPHERE_AXIS",
    "make_mesh",
    "round_up",
    "pad_spheres",
    "render_sharded",
    "render_sharded_jit",
    "trace_sharded",
]
