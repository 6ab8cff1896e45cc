"""Device-mesh construction and padding helpers.

The reference is single-process/single-threaded (SURVEY §2 rows 14-17: zero
parallelism, zero communication backends).  The scale-out design (SURVEY
§5.7-5.8) shards the flattened ray/pixel axis across devices and — for the
context-parallel analog — optionally the sphere axis, with scene parameters
replicated and reductions finished by collectives.  The devices of one
host are joined all to all, so the mesh shape follows the algorithm only.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh

RAY_AXIS = "rays"
SPHERE_AXIS = "spheres"


def make_mesh(
    n_rays_shards: int | None = None,
    n_sphere_shards: int = 1,
    *,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a 2D ``(rays, spheres)`` mesh.

    Defaults to all visible devices on the ray axis (pure tile/data
    parallelism); pass ``n_sphere_shards > 1`` to also shard the sphere
    sweep (the sequence/context-parallel analog of SURVEY §5.7).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_rays_shards is None:
        if len(devices) % n_sphere_shards:
            raise ValueError(f"{len(devices)} devices not divisible by {n_sphere_shards} sphere shards")
        n_rays_shards = len(devices) // n_sphere_shards
    n = n_rays_shards * n_sphere_shards
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.array(devices[:n]).reshape(n_rays_shards, n_sphere_shards)
    return Mesh(grid, (RAY_AXIS, SPHERE_AXIS))


def round_up(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)
