"""Worker for the 2-process jax.distributed loopback test.

Each process owns 2 virtual CPU devices; the 4-device global mesh shards
the ray axis across processes.  Process 0 writes the gathered image.
Usage: python distributed_worker.py <process_id> <num_processes> <coord> <out.npy>
"""

import os
import sys

pid, nprocs, coord, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from python_ray_tracer_jax.parallel import distributed  # noqa: E402

# Through the documented entry point — it must initialize BEFORE any JAX
# computation touches a backend (ADVICE r1 regression).
distributed.initialize(coordinator_address=coord, num_processes=nprocs, process_id=pid)
assert distributed._already_initialized()
distributed.initialize(coordinator_address=coord, num_processes=nprocs, process_id=pid)  # idempotent

import jax.numpy as jnp  # noqa: E402

from python_ray_tracer_jax import RenderConfig  # noqa: E402
from python_ray_tracer_jax.models.scenes import reference_scene  # noqa: E402
from python_ray_tracer_jax.parallel import render_sharded  # noqa: E402

assert jax.device_count() == 2 * nprocs, jax.devices()
mesh = distributed.global_mesh(n_sphere_shards=1)

scene = reference_scene(64, 36, dtype=jnp.float32)
cfg = RenderConfig(max_depth=2, dtype=jnp.float32)
img = jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, mesh)
gathered = distributed.gather_image(img)
distributed.barrier("render-done")
if pid == 0:
    np.save(out_path, gathered)
print(f"proc {pid} ok", flush=True)
