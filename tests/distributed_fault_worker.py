"""Worker for the multi-host fault-injection test (SURVEY §5.3).

Runs a checkpointed distributed optimize loop on the 2-process CPU
loopback cluster.  Worker ``kill_pid`` SIGKILLs itself after
``kill_after`` completed steps — simulating a host failure mid-training;
the relaunched cluster must resume from the last checkpoint.

Usage:
  python distributed_fault_worker.py <pid> <nprocs> <coord> <ckpt> <steps>
      <kill_pid> <kill_after> <done_marker>

``kill_pid = -1`` disables the fault (the recovery run).  Process 0 owns
the checkpoint file; every process keeps identical (replicated) state, so
single-writer checkpointing is consistent.  On success, process 0 writes
``done_marker`` containing "<resumed_from> <final_step> <final_loss>".
"""

import os
import signal
import sys

pid, nprocs, coord, ckpt, steps, kill_pid, kill_after, done_marker = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), sys.argv[8],
)

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from python_ray_tracer_jax.parallel import distributed  # noqa: E402

distributed.initialize(coordinator_address=coord, num_processes=nprocs, process_id=pid)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from python_ray_tracer_jax import RenderConfig, render  # noqa: E402
from python_ray_tracer_jax.models.scenes import reference_scene  # noqa: E402
from python_ray_tracer_jax.optim import make_loss_fn, scene_to_params  # noqa: E402
from python_ray_tracer_jax.optim.train import init_state, make_train_step  # noqa: E402
from python_ray_tracer_jax.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

mesh = distributed.global_mesh(n_sphere_shards=1)

scene = reference_scene(32, 16, dtype=jnp.float32)
cfg = RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth")
target = jnp.clip(render(scene, RenderConfig(max_depth=2, dtype=jnp.float32)), 0.0, 1.0)

params = scene_to_params(scene, sphere_fields=("diffuse_color",), light_fields=(), camera=False)
optimizer = optax.adam(1e-2)
state = init_state(params, optimizer)
resumed_from = 0
if os.path.exists(ckpt):
    state = load_checkpoint(ckpt, state)
    resumed_from = int(state.step)

step_fn = make_train_step(make_loss_fn(scene, target, cfg, mesh), optimizer)

loss = float("nan")
for i in range(int(state.step), steps):
    state, loss = step_fn(state)
    loss = float(loss)
    distributed.barrier(f"step-{i}")
    if pid == 0:
        save_checkpoint(ckpt, state)
    distributed.barrier(f"ckpt-{i}")
    if pid == kill_pid and (i + 1) >= kill_after:
        os.kill(os.getpid(), signal.SIGKILL)  # simulated host failure

distributed.barrier("train-done")
if pid == 0:
    with open(done_marker, "w") as f:
        f.write(f"{resumed_from} {int(state.step)} {loss}")
print(f"proc {pid} done at step {int(state.step)}", flush=True)
