"""Headline benchmark: rays/s per device, forward+backward, 960x540 depth-3.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline (BASELINE.md, measured on the reference NumPy implementation,
which is forward-only): full 960x540 render of the main.py scene in
1.40 s = 3.7e5 primary rays/s.  We run a K-step Adam loop (render + L2
pixel loss + gradients w.r.t. all scene parameters + update) at the same
resolution with depth-3 reflections — strictly more work per ray than the
baseline's forward-only pass — as ONE on-device lax.scan (200 steps, the
shape of a real optimize run), so per-dispatch host latency does not
enter the number.  vs_baseline is the speedup over the reference's
forward-only primary rays/s.

Runs only on a GPU: anywhere else it raises before measuring.

Lives in the package so ``python -m python_ray_tracer_jax.cli bench``
works from anywhere (the root ``bench.py`` delegates here).
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

BASELINE_PRIMARY_RAYS_PER_S = 518_400 / 1.40  # BASELINE.md: 960x540 in 1.40 s


def main(width: int = 960, height: int = 540, depth: int = 3, steps: int = 200) -> dict:
    """Run the headline fwd+bwd benchmark and print/return its JSON record."""
    import numpy as np
    import optax

    from .config import RenderConfig
    from .models.scenes import reference_scene
    from .optim import make_loss_fn, scene_to_params
    from .render import render
    from .utils.cache import enable_compile_cache
    from .utils.device import card_name_and_power_limit, require_gpu

    enable_compile_cache()
    dev = require_gpu()
    card = card_name_and_power_limit()

    cfg = RenderConfig(max_depth=depth, dtype=jnp.float32, visibility="smooth")
    scene = reference_scene(width, height, dtype=jnp.float32)
    target = jnp.clip(render(scene, RenderConfig(max_depth=depth, dtype=jnp.float32)), 0.0, 1.0)

    params = scene_to_params(scene)
    optimizer = optax.adam(1e-3)
    loss_fn = make_loss_fn(scene, target, cfg)

    @jax.jit
    def run_steps(params, opt_state):
        def body(carry, _):
            p, s = carry
            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, s = optimizer.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s), loss

        (params, opt_state), losses = jax.lax.scan(body, (params, opt_state), None, length=steps)
        return params, opt_state, losses

    opt_state = optimizer.init(params)
    params_w, opt_w, losses = run_steps(params, opt_state)  # compile + warm
    float(np.asarray(losses[-1]))  # forced host fetch — guarantees completion

    elapsed = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        _, _, losses2 = run_steps(params_w, opt_w)
        float(np.asarray(losses2[-1]))
        elapsed = min(elapsed, (time.perf_counter() - start) / steps)

    rays_per_s = (width * height) / elapsed
    record = {
        "metric": f"fwd_bwd_primary_rays_per_s_{width}x{height}_depth{depth}",
        "value": round(rays_per_s, 1),
        "unit": "rays/s/device",
        "vs_baseline": round(rays_per_s / BASELINE_PRIMARY_RAYS_PER_S, 3),
        "step_ms": round(elapsed * 1e3, 3),
        "device": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }
    print(json.dumps(record))  # noqa: T201
    return record


if __name__ == "__main__":
    main()
