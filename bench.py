"""Headline benchmark entry point (driver contract: prints ONE JSON line).

Delegates to :mod:`python_ray_tracer_jax.bench` — the canonical harness
lives in the package so ``python -m python_ray_tracer_jax.cli bench``
works from any directory.
"""

from __future__ import annotations

from python_ray_tracer_jax.bench import main

if __name__ == "__main__":
    main()
