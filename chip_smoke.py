"""Smoke test of the renderer and the inverse-rendering trainer on one GPU.

    python chip_smoke.py          # one GPU: golden render, training, sweep kernel
    python chip_smoke.py --four   # four GPUs: the sharded paths against one GPU and float64

Every phase runs through the normal entry points (the CLI, ``render``,
``make_loss_fn``) and checks its results; any failure raises, so the exit
code is non-zero.  With no GPU it fails at once.  The float64 references
are computed by a child process pinned to the CPU (``JAX_PLATFORMS=cpu``,
x64 on), which never opens the card; the timed GPU program stays float32.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "out" / "chip_smoke"

# Golden forward (BASELINE config 1/2): the reference scene.
GOLDEN_W, GOLDEN_H, GOLDEN_DEPTH = 960, 540, 6
# Training: smooth visibility, Adam through ``cli optimize``.
TRAIN_DEPTH, TRAIN_STEPS, TRAIN_LR = 3, 20, 1e-3
# Sweep kernel against XLA: (label, scene, spheres, width, height, depth).
SWEEP_CASES = (
    ("(a) reference scene 960x540 depth 6", "reference", 3, 960, 540, 6),
    ("(b) 1024 random spheres 1920x1080 depth 4", "random", 1024, 1920, 1080, 4),
)
VJP_CASE = (64, 256, 144)  # inverse_task_scene spheres, width, height; depth 2
# Four GPUs: the config-5 step and the (2, 2) forward of config 4's table.
FOUR_STEP_CASE = (64, 960, 540, 3)  # spheres, width, height, depth (smooth)
FOUR_FORWARD_CASE = (1024, 960, 540, 4)  # spheres, width, height, depth (hard)

# Tolerances, each with its reason.
# f32 rounding at silhouettes and shadow edges flips isolated uint8 values.
GOLDEN_MAX_DIFF_FRACTION = 2e-4
# f32 summation over 518,400 pixels against a float64 sum.
GRAD_REL_TOL = 1e-3
# The kernel and XLA evaluate the same formulas; ties and rounding of
# near-grazing hits may flip a handful of winners.
SWEEP_IDX_AGREE = 0.9999
SWEEP_T_REL_TOL = 1e-5
VJP_REL_TOL = 1e-4
# Sharded step vs one device, both against float64: the config-5 case is
# ill-conditioned in float32 (on the CPU, moving the camera by 2 ulps moves
# its geometry gradients by 8-10%), so two float32 programs that only fuse
# and sum differently do not agree to 1e-4.  Each four-device quantity must
# be no further from float64 than 3x the one-device distance (floor
# GRAD_REL_TOL); a lost or doubled shard moves a gradient by 25% or more.
SHARD_VS_ONE_ERR = 3.0


def _write_atomic(path: Path, save) -> None:
    tmp = path.with_name(path.name + ".tmp")
    save(tmp)
    os.replace(tmp, path)


def _perturbed_params(params: dict) -> dict:
    """Parameters moved off the reference scene, for a training target."""
    import jax.numpy as jnp

    out = dict(params)
    out["spheres.center"] = params["spheres.center"] + jnp.asarray([0.04, -0.02, 0.03], params["spheres.center"].dtype)
    out["spheres.diffuse_color"] = params["spheres.diffuse_color"] * 0.85
    out["lights.point_position"] = params["lights.point_position"] + 0.3
    return out


def cpu_reference(work: Path) -> None:
    """Child process: float64 references on the CPU, written into ``work``.

    1. ``golden64.npy``: uint8 render of the reference scene (plain path).
    2. ``target.png``: the training target, a float64 smooth render of the
       scene with perturbed parameters.
    3. ``grad64.npz``: the float64 gradient of the training loss at the
       scene's own parameters, against that target.
    """
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from python_ray_tracer_jax import RenderConfig, render
    from python_ray_tracer_jax.models.scenes import reference_scene
    from python_ray_tracer_jax.optim import combine, make_loss_fn, scene_to_params
    from python_ray_tracer_jax.utils.image import load_png, save_png, to_uint8

    f64 = jnp.float64
    scene = reference_scene(GOLDEN_W, GOLDEN_H, dtype=f64)
    img = jax.jit(render, static_argnums=1)(scene, RenderConfig(max_depth=GOLDEN_DEPTH, dtype=f64))
    _write_atomic(work / "golden64.npy", lambda p: np.save(open(p, "wb"), to_uint8(np.asarray(img))))

    cfg = RenderConfig(max_depth=TRAIN_DEPTH, dtype=f64, visibility="smooth")
    params = scene_to_params(scene)
    target = jax.jit(render, static_argnums=1)(combine(_perturbed_params(params), scene), cfg)
    _write_atomic(work / "target.png", lambda p: save_png(np.asarray(target), p))

    tgt = jnp.asarray(load_png(work / "target.png") / 255.0, f64)
    grads = jax.jit(jax.grad(make_loss_fn(scene, tgt, cfg)))(params)
    _write_atomic(work / "grad64.npz", lambda p: np.savez(open(p, "wb"), **{k: np.asarray(v) for k, v in grads.items()}))


def cpu_reference_four(work: Path) -> None:
    """Child process: float64 loss and gradient of the four-GPU step case on
    the CPU, at the float32 scene's own values and the GPU's target
    (``four_target.npy``), written to ``four_grad64.npz``."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from python_ray_tracer_jax import RenderConfig
    from python_ray_tracer_jax.models.scenes import inverse_task_scene
    from python_ray_tracer_jax.optim import make_loss_fn, scene_to_params

    f64 = jnp.float64
    n_spheres, w, h, depth = FOUR_STEP_CASE
    scene = jax.tree_util.tree_map(
        lambda x: x.astype(f64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        inverse_task_scene(n_spheres=n_spheres, width=w, height=h, dtype=jnp.float32),
    )
    cfg = RenderConfig(max_depth=depth, dtype=f64, visibility="smooth")
    target = jnp.asarray(np.load(work / "four_target.npy"), f64)
    loss, grads = jax.jit(jax.value_and_grad(make_loss_fn(scene, target, cfg)))(scene_to_params(scene))
    out = {k: np.asarray(v) for k, v in grads.items()}
    out["loss"] = np.asarray(loss)
    _write_atomic(work / "four_grad64.npz", lambda p: np.savez(open(p, "wb"), **out))


def _wait_for(path: Path, child: subprocess.Popen, timeout_s: float = 900.0) -> None:
    deadline = time.time() + timeout_s
    while not path.exists():
        if child.poll() is not None and not path.exists():
            raise RuntimeError(f"CPU reference process exited ({child.returncode}) without writing {path.name}")
        if time.time() > deadline:
            raise TimeoutError(f"no {path.name} after {timeout_s} s")
        time.sleep(0.5)


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _median_time(fn, *args, reps: int = 7) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run only the four-GPU sharded paths")
    ap.add_argument("--cpu-reference", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--cpu-reference-four", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    if args.cpu_reference:
        cpu_reference(Path(args.cpu_reference))
        return 0
    if args.cpu_reference_four:
        cpu_reference_four(Path(args.cpu_reference_four))
        return 0

    import jax

    # Phase 1: the device.  No GPU, no result.
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    from python_ray_tracer_jax.utils.cache import enable_compile_cache
    from python_ray_tracer_jax.utils.device import card_name_and_power_limit

    cache_dir = enable_compile_cache()
    card_lines = card_name_and_power_limit()
    print(card_lines, flush=True)
    card = card_lines.splitlines()[0]

    def say(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    n_dev = len(jax.devices())
    say(f"device_kind={dev.device_kind} count={n_dev} jax={jax.__version__} cache={cache_dir}")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)

    if args.four:
        four_gpu_phase(say)
    else:
        one_gpu_phases(say)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": n_dev}}))
    return 0


def one_gpu_phases(say) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from python_ray_tracer_jax import cli
    from python_ray_tracer_jax.config import RenderConfig
    from python_ray_tracer_jax.models.scenes import reference_scene
    from python_ray_tracer_jax.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_jax.utils.image import load_png

    child = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu-reference", str(WORK)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    try:
        # Phase 2: golden forward through the CLI, against CPU float64.
        png = WORK / "render.png"
        t0 = time.perf_counter()
        rc = cli.main([
            "render", "--builtin", "reference", "--width", str(GOLDEN_W), "--height", str(GOLDEN_H),
            "--depth", str(GOLDEN_DEPTH), "-o", str(png),
        ])
        assert rc == 0, f"cli render exited {rc}"
        say(f"golden: cli render {time.perf_counter() - t0:.1f} s (compile included)")
        ours = load_png(png).astype(np.int64)
        _wait_for(WORK / "golden64.npy", child)
        ref = np.load(WORK / "golden64.npy").astype(np.int64)
        diff = np.abs(ours - ref)
        n_diff = int((diff > 0).sum())
        say(f"golden: {n_diff} of {diff.size} uint8 values differ from the CPU float64 render, largest difference {int(diff.max())}")
        assert n_diff <= GOLDEN_MAX_DIFF_FRACTION * diff.size, f"golden: {n_diff} differing values"

        # Phase 3: training through the normal path.
        _wait_for(WORK / "target.png", child)
        metrics = WORK / "train.jsonl"
        t0 = time.perf_counter()
        rc = cli.main([
            "optimize", "--builtin", "reference", "--width", str(GOLDEN_W), "--height", str(GOLDEN_H),
            "--depth", str(TRAIN_DEPTH), "--visibility", "smooth", "--target", str(WORK / "target.png"),
            "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--metrics", str(metrics),
        ])
        assert rc == 0, f"cli optimize exited {rc}"
        losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
        say(f"training: {len(losses)} Adam steps in {time.perf_counter() - t0:.1f} s (compile included), "
            f"loss {losses[0]:.6g} -> {losses[-1]:.6g}")
        assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), losses
        assert losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}"

        scene = reference_scene(GOLDEN_W, GOLDEN_H, dtype=jnp.float32)
        cfg = RenderConfig(max_depth=TRAIN_DEPTH, dtype=jnp.float32, visibility="smooth")
        target = jnp.asarray(load_png(WORK / "target.png") / 255.0, jnp.float32)
        params = scene_to_params(scene)
        step = jax.jit(jax.value_and_grad(make_loss_fn(scene, target, cfg)))
        compiled = step.lower(params).compile()
        say(f"training: memory_analysis {compiled.memory_analysis()}")
        _, grads = step(params)
        _wait_for(WORK / "grad64.npz", child)
        g64 = np.load(WORK / "grad64.npz")
        worst = 0.0
        for k in sorted(grads):
            rel = _rel(grads[k], g64[k])
            worst = max(worst, rel)
            say(f"training: first-step gradient {k}: relative difference to CPU float64 {rel:.3g}")
        assert worst <= GRAD_REL_TOL, f"gradient differs from float64 by {worst:.3g}"
        say(f"training: peak_bytes_in_use {(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')}")
        child.wait(timeout=60)
        assert child.returncode == 0, f"CPU reference process exited {child.returncode}"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()

    # Phase 4: the sweep kernel against plain XLA, on the card, float32.
    sweep_phase(say)


def sweep_phase(say) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from python_ray_tracer_jax.camera import ray_directions
    from python_ray_tracer_jax.config import RenderConfig, faraway
    from python_ray_tracer_jax.models.scenes import inverse_task_scene, random_spheres_scene, reference_scene
    from python_ray_tracer_jax.ops import sweep_gpu
    from python_ray_tracer_jax.ops.intersect import intersect_two_tier, nearest_hit
    from python_ray_tracer_jax.ops.vecmath import reflect
    from python_ray_tracer_jax.render import render

    far = faraway(jnp.float32)

    def forced(form: str, cfg: RenderConfig):
        """A jitted render whose hard sweeps all take ``form`` on the card."""
        return jax.jit(lambda s: render(s, cfg, route=lambda platform, n_spheres: form))

    for label, kind, n_spheres, w, h, depth in SWEEP_CASES:
        if kind == "reference":
            scene = reference_scene(w, h, dtype=jnp.float32)
        else:
            scene = random_spheres_scene(n_spheres=n_spheres, width=w, height=h, dtype=jnp.float32)
        sp = scene.spheres
        d = ray_directions(scene.camera, jnp.float32)
        o = jnp.broadcast_to(scene.camera.position, d.shape)
        kern = jax.jit(lambda o, d, c, r, ne=sp.n_exact: sweep_gpu.nearest_hit(o, d, c, r, far, ne))(
            o, d, sp.center, sp.radius)
        xla = jax.jit(lambda o, d, c, r, ne=sp.n_exact: nearest_hit(intersect_two_tier(o, d, c, r, far, ne).t, far))(
            o, d, sp.center, sp.radius)
        same = np.asarray(kern.idx) == np.asarray(xla.idx)
        tk, tx = np.asarray(kern.t), np.asarray(xla.t)
        t_rel = float(np.max(np.abs(tk - tx)[same] / np.maximum(np.abs(tx[same]), 1e-30)))
        say(f"sweep {label}: first-bounce nearest idx agrees on {same.mean():.6%} of rays, "
            f"max relative t difference {t_rel:.3g}")
        assert same.mean() >= SWEEP_IDX_AGREE and t_rel <= SWEEP_T_REL_TOL

        cfg = RenderConfig(max_depth=depth, dtype=jnp.float32)
        fns = {form: forced(form, cfg) for form in ("xla", "kernel")}
        times, imgs = {}, {}
        for form in ("xla", "kernel", "kernel", "xla"):
            imgs[form] = np.asarray(fns[form](scene))
            times.setdefault(form, []).append(_median_time(fns[form], scene))
        diff = np.abs(imgs["kernel"] - imgs["xla"])
        say(f"sweep {label}: image max abs difference kernel vs XLA {float(diff.max()):.3g}, "
            f"values above 1e-3: {int((diff > 1e-3).sum())}")
        assert (diff > 1e-3).mean() <= 1.0 - SWEEP_IDX_AGREE
        say(f"sweep {label}: hard forward median of 7 warm runs, XLA {[round(t * 1e3, 3) for t in times['xla']]} ms, "
            f"Triton kernel {[round(t * 1e3, 3) for t in times['kernel']]} ms (runs in the order XLA, kernel, kernel, XLA)")

    # VJP of the kernel against jax.grad of the plain path: a loss on
    # the nearest t of two bounces.
    n_spheres, w, h = VJP_CASE
    scene = inverse_task_scene(n_spheres=n_spheres, width=w, height=h)
    sp = scene.spheres
    d0 = ray_directions(scene.camera, jnp.float32)
    o0 = jnp.broadcast_to(scene.camera.position, d0.shape)

    def t_loss(nearest):
        def loss(c, r):
            o, d, total = o0, d0, 0.0
            for _ in range(2):
                near = nearest(o, d, c, r)
                t = jnp.where(near.hit, near.t, 0.0)
                total = total + jnp.sum(jnp.sin(t))
                p = o + d * t[:, None]
                normal = (p - c[near.idx]) / r[near.idx][:, None]
                o, d = p + normal * 1e-4, reflect(d, normal)
            return total
        return jax.jit(jax.grad(loss, argnums=(0, 1)))

    g_k = t_loss(lambda o, d, c, r: sweep_gpu.nearest_hit(o, d, c, r, far, sp.n_exact))(sp.center, sp.radius)
    g_x = t_loss(lambda o, d, c, r: nearest_hit(intersect_two_tier(o, d, c, r, far, sp.n_exact).t, far))(
        sp.center, sp.radius)
    for name, a, b in zip(("center", "radius"), g_k, g_x):
        rel = _rel(a, b)
        say(f"sweep VJP inverse_task_scene({n_spheres}) {w}x{h} depth 2: "
            f"d(loss)/d({name}) relative difference {rel:.3g}")
        assert rel <= VJP_REL_TOL


def four_gpu_phase(say) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from python_ray_tracer_jax.config import RenderConfig
    from python_ray_tracer_jax.models.scenes import inverse_task_scene, random_spheres_scene
    from python_ray_tracer_jax.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_jax.optim.train import init_state, make_train_step
    from python_ray_tracer_jax.parallel import make_mesh, render_sharded
    from python_ray_tracer_jax.render import render
    from python_ray_tracer_jax.utils.image import to_uint8

    devices = jax.devices()
    assert len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}"

    # 4-way ray-sharded Adam step (BASELINE config 5), against one device
    # and against float64 from a CPU child.
    n_spheres, w, h, depth = FOUR_STEP_CASE
    scene = inverse_task_scene(n_spheres=n_spheres, width=w, height=h)
    cfg = RenderConfig(max_depth=depth, dtype=jnp.float32, visibility="smooth")
    hard = RenderConfig(max_depth=depth, dtype=jnp.float32)
    target = jnp.clip(jax.jit(render, static_argnums=1)(scene, hard), 0.0, 1.0) * 0.9
    _write_atomic(WORK / "four_target.npy", lambda p: np.save(open(p, "wb"), np.asarray(target)))
    child = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu-reference-four", str(WORK)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    try:
        params = scene_to_params(scene)
        results = {}
        for label, mesh in (("one device", None), ("4-way ray-sharded", make_mesh())):
            opt = optax.adam(1e-2)
            loss_fn = make_loss_fn(scene, target, cfg, mesh=mesh)
            grad_fn = jax.jit(jax.value_and_grad(loss_fn))
            loss, grads = grad_fn(params)
            t = _median_time(grad_fn, params, reps=5)
            step = make_train_step(loss_fn, opt)  # donates its state: give it copies
            state, step_loss = step(init_state(jax.tree_util.tree_map(jnp.copy, params), opt))
            assert np.isfinite(float(step_loss)) and all(np.isfinite(np.asarray(v)).all() for v in state.params.values())
            results[label] = (float(loss), grads, state.params)
            say(f"sharded step: {label}: loss {float(loss):.8g}, loss+gradient median {t * 1e3:.3f} ms")
        _wait_for(WORK / "four_grad64.npz", child)
        ref = np.load(WORK / "four_grad64.npz")
        child.wait(timeout=60)
        assert child.returncode == 0, f"CPU reference process exited {child.returncode}"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    (l1, g1, p1), (l4, g4, p4) = results["one device"], results["4-way ray-sharded"]
    l64 = float(ref["loss"])
    img1 = np.asarray(jax.jit(render, static_argnums=1)(scene, cfg))
    img4 = np.asarray(jax.jit(render_sharded, static_argnums=(1, 2))(scene, cfg, make_mesh()))
    d = np.abs(img4 - img1).max(axis=2)
    say(f"sharded step: smooth image max difference {float(d.max()):.3g}, pixels above 1e-3: {int((d > 1e-3).sum())}")
    # Each quantity: (name, one device, four devices, float64).
    rows = [("loss", l1, l4, l64)] + [(f"gradient {k}", g1[k], g4[k], ref[k]) for k in sorted(g1)]
    step_ok = True
    for name, one, four, f64 in rows:
        e1, e4 = _rel(one, f64), _rel(four, f64)
        ok = e4 <= SHARD_VS_ONE_ERR * max(e1, GRAD_REL_TOL)
        step_ok &= ok
        say(f"sharded step: {name}: relative difference to float64 one device {e1:.3g}, four devices {e4:.3g}; "
            f"four vs one {_rel(four, one):.3g}{'' if ok else '  <-- FAIL'}")
    say("sharded step: updated parameters, four vs one device: worst "
        f"{max(_rel(p4[k], p1[k]) for k in p1):.3g}")

    # (2, 2) rays x spheres hard forward of config 4's table, against one device.
    n_spheres, w, h, depth = FOUR_FORWARD_CASE
    big = random_spheres_scene(n_spheres=n_spheres, width=w, height=h, dtype=jnp.float32)
    hard = RenderConfig(max_depth=depth, dtype=jnp.float32)
    one = jax.jit(render, static_argnums=1)
    mesh = make_mesh(2, 2)
    sharded = jax.jit(render_sharded, static_argnums=(1, 2))
    img1 = np.asarray(one(big, hard))
    img4 = np.asarray(sharded(big, hard, mesh))
    t1 = _median_time(one, big, hard, reps=5)
    t4 = _median_time(sharded, big, hard, mesh, reps=5)
    du = np.abs(to_uint8(img4).astype(int) - to_uint8(img1).astype(int))
    n_diff = int((du > 0).sum())
    say(f"(2, 2) forward: {n_diff} of {du.size} uint8 values differ from one device, "
        f"max float difference {float(np.abs(img4 - img1).max()):.3g}; median {t1 * 1e3:.3f} ms on one device, "
        f"{t4 * 1e3:.3f} ms on the (2, 2) mesh")
    assert step_ok, "sharded step: four devices further from float64 than one device allows"
    assert n_diff <= GOLDEN_MAX_DIFF_FRACTION * du.size, f"(2, 2) forward: {n_diff} differing values"


if __name__ == "__main__":
    sys.exit(main())
