"""Multi-host (multi-process) rendering via jax.distributed CPU loopback.

SURVEY §4's recipe for testing the pod path without a pod: two local
processes, a loopback coordinator, 2 virtual CPU devices each — the
4-device global mesh shards rays ACROSS process boundaries, and the final
image crosses hosts through process_allgather (parallel/distributed.py).
"""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from python_ray_tracer_jax import RenderConfig, render
from python_ray_tracer_jax.models.scenes import reference_scene

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_loopback_render(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    out = tmp_path / "img.npy"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "distributed_worker.py"), str(i), "2", coord, str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outputs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-2000:]
    assert out.exists()

    got = np.load(out)
    expected = np.asarray(render(reference_scene(64, 36, dtype=jnp.float32), RenderConfig(max_depth=2, dtype=jnp.float32)))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


def test_worker_kill_mid_optimize_then_cluster_resume(tmp_path):
    """Multi-host fault injection (SURVEY §5.3): SIGKILL one worker of a
    2-process distributed optimize run mid-training; the whole job dies (as
    a scheduler would tear it down), then a relaunched cluster must resume
    from the last checkpoint and finish all steps."""
    coord = f"127.0.0.1:{_free_port()}"
    ckpt = tmp_path / "dist.ckpt.npz"
    done = tmp_path / "done.txt"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    steps, kill_after = 6, 2

    def launch(coord, kill_pid):
        return [
            subprocess.Popen(
                [
                    sys.executable, str(REPO / "tests" / "distributed_fault_worker.py"),
                    str(i), "2", coord, str(ckpt), str(steps), str(kill_pid), str(kill_after), str(done),
                ],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in range(2)
        ]

    # Run 1: worker 1 kills itself after `kill_after` checkpointed steps.
    procs = launch(coord, kill_pid=1)
    assert procs[1].wait(timeout=300) == -signal.SIGKILL
    # Worker 0 cannot finish without its peer; tear it down like a job
    # scheduler reaping a broken allocation.
    try:
        procs[0].wait(timeout=20)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].wait(timeout=30)
    assert not done.exists()
    assert ckpt.exists(), "no checkpoint survived the failure"

    # Run 2: fresh cluster (new coordinator), resumes and completes.
    procs = launch(f"127.0.0.1:{_free_port()}", kill_pid=-1)
    outputs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-2000:]
    resumed_from, final_step, final_loss = done.read_text().split()
    assert int(resumed_from) >= kill_after, "did not resume from the checkpoint"
    assert int(resumed_from) < steps
    assert int(final_step) == steps
    assert np.isfinite(float(final_loss))


def test_two_process_loopback_cli_render(tmp_path):
    """The CLI reaches the multi-host path (VERDICT r2 item 5): two
    loopback processes run ``cli render --distributed`` with 2 virtual
    CPU devices each; process 0 gathers and writes the PNG; the image
    matches the single-process CLI render."""
    from python_ray_tracer_jax.utils.image import load_png

    coord = f"127.0.0.1:{_free_port()}"
    out = tmp_path / "dist.png"
    base_env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    base_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    args = [
        "render", "--builtin", "reference", "--width", "64", "--height", "36",
        "--depth", "2", "-o", str(out),
        "--distributed", "--coordinator", coord, "--num-processes", "2",
    ]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "python_ray_tracer_jax.cli", *args, "--process-id", str(i)],
            env=base_env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outputs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-2000:]
    assert out.exists()

    # single-process CLI reference image
    out1 = tmp_path / "single.png"
    p = subprocess.run(
        [sys.executable, "-m", "python_ray_tracer_jax.cli", "render", "--builtin", "reference",
         "--width", "64", "--height", "36", "--depth", "2", "-o", str(out1)],
        env=base_env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300,
    )
    assert p.returncode == 0, p.stdout[-2000:]
    np.testing.assert_array_equal(load_png(out), load_png(out1))
