"""Multi-process initialization and cross-process utilities (SURVEY §5.8).

The reference has no distributed communication of any kind (no NCCL / MPI /
Gloo / UCX — SURVEY §2 row 17).  Here it is ``jax.distributed.initialize`` +
XLA collectives: the ``psum``/``all_gather`` emitted by :mod:`.sharded` are
handed by XLA to NCCL on GPUs.  There is no hand-rolled transport layer.

Usage, one process per GPU, each told the cluster explicitly:

    from python_ray_tracer_jax.parallel import distributed
    distributed.initialize("host0:7777", num_processes=4, process_id=i)
    mesh = distributed.global_mesh()      # every device of every process
    image = gather_image(render_sharded(scene, cfg, mesh))   # process 0 saves
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import RAY_AXIS, SPHERE_AXIS


def _already_initialized() -> bool:
    """Whether the JAX distributed client is already up.

    Checked WITHOUT touching any backend: ``jax.process_count()`` would
    initialize local XLA first, after which ``jax.distributed.initialize``
    refuses to run ("must be called before any JAX computations") — the
    exact failure mode that silently degraded multi-host runs to
    single-process in round 1 (ADVICE r1, distributed.py:33).
    """
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except (ImportError, AttributeError):  # pragma: no cover - JAX internals moved
        return getattr(jax.distributed, "_is_initialized", lambda: False)()


def initialize(coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    All three arguments are required: nothing on a GPU host describes the
    cluster to JAX, so every process is told the coordinator's
    ``host:port``, the process count and its own id.  Missing arguments
    and errors from ``jax.distributed.initialize`` raise — a multi-process
    job that cannot form its cluster must fail loudly, not degrade to
    single-process.
    """
    if _already_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed initialization needs coordinator_address, num_processes "
            "and process_id (--coordinator/--num-processes/--process-id), one process per GPU"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_sphere_shards: int = 1) -> Mesh:
    """(rays, spheres) mesh over every device of every process."""
    devices = jax.devices()
    if len(devices) % n_sphere_shards:
        raise ValueError(f"{len(devices)} devices not divisible by {n_sphere_shards}")
    grid = np.array(devices).reshape(len(devices) // n_sphere_shards, n_sphere_shards)
    return Mesh(grid, (RAY_AXIS, SPHERE_AXIS))


def gather_image(image: jax.Array) -> np.ndarray:
    """Fetch a (possibly cross-host sharded) rendered image to every host.

    Multi-process arrays are not directly addressable; process_allgather
    moves the shards once, at the end of the pipeline — the only
    host<->device transfer in the render path (SURVEY §5.8).
    """
    if jax.process_count() == 1:
        return np.asarray(image)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(image, tiled=True))


def barrier(name: str = "sync") -> None:
    """Cross-process barrier (init/checkpoint coordination, SURVEY §5.3)."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
