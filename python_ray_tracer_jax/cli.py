"""Command-line interface: ``render``, ``bench``, ``optimize``.

The reference's entire UX is ``python main.py`` with a hardcoded scene
(``/root/reference/main.py:1-57`` — no CLI, no flags).  This CLI is the
config surface SURVEY §5.6 specifies: JSON scene files (the resurrected
old schema), render settings, metrics JSONL, profiler capture, and
checkpointed optimization runs.

    python -m python_ray_tracer_jax.cli render --scene scene.json -o out.png
    python -m python_ray_tracer_jax.cli render --builtin reference -o out.png
    python -m python_ray_tracer_jax.cli bench --width 960 --height 540
    python -m python_ray_tracer_jax.cli optimize --target ref.png --steps 200
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np


def _add_render_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", type=str, help="JSON scene file")
    p.add_argument(
        "--builtin",
        type=str,
        choices=["reference", "all_effects", "random1024", "textured1024", "inverse64"],
        help="built-in scene",
    )
    p.add_argument("--settings", type=str, help="JSON render-settings file")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument(
        "--depth",
        type=str,
        default="3",
        help="max reflection depth, or 'auto' to bound it by the scene's "
        "reflection energy decay (matches unbounded recursion below uint8 precision)",
    )
    # No bfloat16: the ray-sphere quadratic cancels catastrophically at 8
    # mantissa bits (PERF.md).
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "float64"])
    p.add_argument("--visibility", type=str, default="hard", choices=["hard", "smooth"])
    p.add_argument("--metrics", type=str, help="JSONL metrics output path")
    p.add_argument("--profile", type=str, help="jax.profiler trace logdir")
    p.add_argument("--denoise", action="store_true", help="NL-means denoise the output")
    p.add_argument("--spp", type=int, default=1, help="samples per pixel (jittered supersampling)")
    p.add_argument("--stochastic-roughness", action="store_true", help="sample glossy GGX reflections")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed for sampling")
    p.add_argument(
        "--ray-shards", type=int, default=0,
        help="shard the ray axis over this many devices (0 = single-device "
        "path; with --distributed, defaults to every device of every process)",
    )
    p.add_argument(
        "--sphere-shards", type=int, default=1,
        help="additionally shard the sphere sweep over this many devices "
        "(context-parallel analog; total devices = ray x sphere shards)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="initialize the multi-process runtime (jax.distributed, one "
        "process per GPU) before building the mesh; PNG writes happen on "
        "process 0 only; needs --coordinator, --num-processes and --process-id",
    )
    p.add_argument("--coordinator", type=str, help="coordinator address (host:port) for --distributed")
    p.add_argument("--num-processes", type=int, help="process count for --distributed")
    p.add_argument("--process-id", type=int, help="this process's id for --distributed")


def _build(args) -> tuple:
    from .config import RenderConfig
    from .models import scenes as builtin

    dtype = {"float32": jnp.float32, "float64": jnp.float64}[args.dtype]
    extras = {}
    depth_auto = str(args.depth) == "auto"
    if args.settings:
        from .io import load_settings

        cfg, extras = load_settings(args.settings)
        width, height = extras["width"], extras["height"]
    else:
        cfg = RenderConfig(
            max_depth=1 if depth_auto else int(args.depth),
            dtype=dtype,
            visibility=args.visibility,
            samples_per_pixel=getattr(args, "spp", 1),
            stochastic_roughness=getattr(args, "stochastic_roughness", False),
            rng_seed=getattr(args, "seed", 0),
        )
        width, height = args.width, args.height

    if args.scene:
        from .io import load_scene

        scene = load_scene(args.scene, width=width, height=height, dtype=cfg.dtype)
    else:
        name = args.builtin or "reference"
        if name == "reference":
            scene = builtin.reference_scene(width, height, dtype=cfg.dtype)
        elif name == "all_effects":
            scene = builtin.all_effects_scene(width, height, dtype=cfg.dtype)
        elif name == "random1024":
            scene = builtin.random_spheres_scene(width=width, height=height, dtype=cfg.dtype)
        elif name == "textured1024":
            scene = builtin.textured_spheres_scene(width=width, height=height, dtype=cfg.dtype)
        else:
            scene = builtin.inverse_task_scene(width=width, height=height, dtype=cfg.dtype)
    if depth_auto:
        import dataclasses

        from .render import auto_max_depth

        cfg = dataclasses.replace(cfg, max_depth=auto_max_depth(scene))
        print(f"auto depth: {cfg.max_depth}", file=sys.stderr)  # noqa: T201
    return scene, cfg, extras


def _maybe_mesh(args):
    """Build the (rays, spheres) mesh the CLI flags ask for, or None.

    ``--distributed`` additionally brings up the multi-host runtime first
    (SURVEY §5.8); the mesh then spans every device of every process.
    """
    ray_shards = getattr(args, "ray_shards", 0)
    sphere_shards = getattr(args, "sphere_shards", 1)
    dist = getattr(args, "distributed", False)
    if not dist and ray_shards == 0 and sphere_shards == 1:
        return None
    if dist:
        from .parallel.distributed import initialize

        initialize(
            coordinator_address=getattr(args, "coordinator", None),
            num_processes=getattr(args, "num_processes", None),
            process_id=getattr(args, "process_id", None),
        )
    from .parallel import make_mesh

    return make_mesh(ray_shards or None, sphere_shards)


def cmd_render(args) -> int:
    from .render import render
    from .utils.image import save_png
    from .utils.metrics import MetricsLogger, profile_trace, rays_per_second

    # Mesh/distributed first: jax.distributed.initialize must run before
    # anything touches the backend, and _build creates device arrays.
    mesh = _maybe_mesh(args)
    scene, cfg, extras = _build(args)
    metrics = MetricsLogger(args.metrics)
    if mesh is None:
        fn = jax.jit(render, static_argnums=1)
        run = lambda: fn(scene, cfg)  # noqa: E731
    else:
        from .parallel.sharded import render_sharded_jit

        run = lambda: render_sharded_jit(scene, cfg, mesh)  # noqa: E731

    t0 = time.perf_counter()
    img = jax.block_until_ready(run())
    compile_s = time.perf_counter() - t0
    with profile_trace(args.profile):
        t0 = time.perf_counter()
        img = jax.block_until_ready(run())
        render_s = time.perf_counter() - t0
    if mesh is not None:
        from .parallel.distributed import gather_image

        img = jnp.asarray(gather_image(img))
        if jax.process_count() > 1 and jax.process_index() != 0:
            return 0  # process 0 owns the PNG write

    # Settings-file keys apply when the CLI flag doesn't override them
    # (documented schema: output_path / denoise, io/scene_json.py).
    if getattr(args, "denoise", False) or extras.get("denoise", False):
        from .utils.denoise import nl_means_denoise

        img = nl_means_denoise(jnp.clip(img, 0.0, 1.0))

    out = args.output or extras.get("output_path") or "render_out.png"
    save_png(np.asarray(img), out)
    n = scene.camera.width * scene.camera.height
    rec = metrics.log(
        "render",
        compile_s=round(compile_s, 4),
        render_s=round(render_s, 6),
        **{k: round(v, 1) for k, v in rays_per_second(n, cfg.max_depth, render_s).items()},
        output=str(out),
    )
    print(json.dumps(rec))  # noqa: T201
    return 0


def cmd_bench(args) -> int:
    from . import bench as bench_mod

    bench_mod.main(
        width=args.width,
        height=args.height,
        depth=args.depth,
        steps=args.steps,
    )
    return 0


def cmd_optimize(args) -> int:
    from .optim import make_loss_fn, scene_to_params
    from .optim.train import init_state, make_train_step_k
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.image import load_png
    from .utils.metrics import MetricsLogger

    import optax

    mesh = _maybe_mesh(args)  # before _build: see cmd_render
    scene, cfg, _extras = _build(args)
    target = jnp.asarray(np.asarray(load_png(args.target), np.float32) / 255.0, cfg.dtype)
    if target.shape[:2] != (scene.camera.height, scene.camera.width):
        print(  # noqa: T201
            f"error: target is {target.shape[1]}x{target.shape[0]}, "
            f"scene renders {scene.camera.width}x{scene.camera.height}",
            file=sys.stderr,
        )
        return 2

    if args.train_fields:
        wanted = {f.strip() for f in args.train_fields.split(",") if f.strip()}
        sphere_fields = tuple(k.split(".", 1)[1] for k in wanted if k.startswith("spheres."))
        light_fields = tuple(k.split(".", 1)[1] for k in wanted if k.startswith("lights."))
        params = scene_to_params(
            scene,
            sphere_fields=sphere_fields,
            light_fields=light_fields,
            camera="camera.position" in wanted,
        )
        if not params:
            print(f"error: no valid keys in --train-fields {args.train_fields!r}", file=sys.stderr)
            return 2
    else:
        params = scene_to_params(scene)
    optimizer = optax.adam(args.lr)
    state = init_state(params, optimizer)
    if args.checkpoint and Path(args.checkpoint).exists():
        state = load_checkpoint(args.checkpoint, state)
        print(f"resumed from {args.checkpoint} at step {int(state.step)}", file=sys.stderr)  # noqa: T201

    step_k = make_train_step_k(make_loss_fn(scene, target, cfg, mesh=mesh), optimizer)
    metrics = MetricsLogger(args.metrics)
    start = int(state.step)
    if start >= args.steps:
        print(  # noqa: T201
            json.dumps({"final_loss": None, "steps": start, "note": "checkpoint already past --steps"})
        )
        return 0
    # On-device multi-step driver: K Adam steps per dispatch (lax.scan),
    # host sync only at chunk/checkpoint boundaries, so host dispatch is paid
    # once per chunk.  Chunks clip at checkpoint boundaries so
    # --checkpoint-every semantics are exact.
    k = max(1, args.sync_every)
    loss = None
    i = start
    while i < args.steps:
        boundary = (
            (i // args.checkpoint_every + 1) * args.checkpoint_every
            if args.checkpoint
            else args.steps
        )
        kk = min(k, boundary - i, args.steps - i)
        t0 = time.perf_counter()
        state, losses = step_k(state, kk)
        losses = np.asarray(losses)  # one host transfer per chunk
        step_s = round((time.perf_counter() - t0) / kk, 6)
        for j in range(kk):
            metrics.log("step", step=i + j, loss=float(losses[j]), step_s=step_s)
        loss = float(losses[-1])
        i += kk
        if args.checkpoint and i % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, state)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)
    print(json.dumps({"final_loss": loss, "steps": args.steps}))  # noqa: T201
    return 0


def main(argv: list[str] | None = None) -> int:
    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="python_ray_tracer_jax")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_opts(p)
    p.add_argument("-o", "--output", type=str, help="output PNG path")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--steps", type=int, default=200, help="Adam steps per timed on-device scan")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("optimize", help="inverse rendering against a target image")
    _add_render_opts(p)
    p.add_argument("--target", type=str, required=True, help="target PNG")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument(
        "--train-fields",
        type=str,
        help="comma-separated param keys to optimize (e.g. "
        "'spheres.center,spheres.diffuse_color,lights.point_position'); "
        "default: everything",
    )
    p.add_argument("--checkpoint", type=str, help="checkpoint path (resume if exists)")
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument(
        "--sync-every",
        type=int,
        default=25,
        help="Adam steps per device dispatch (on-device lax.scan); the host "
        "syncs for metrics/checkpoints only at chunk boundaries — 1 restores "
        "the step-at-a-time driver",
    )
    p.set_defaults(fn=cmd_optimize)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
