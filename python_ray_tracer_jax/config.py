"""Render configuration.

The reference has no config system in the live path (SURVEY §5.6): scenes are
Python literals (``/root/reference/main.py:13-51``) and the only knobs are the
hardcoded gains.  Here every rendering decision that fixes trace-time shapes
or control flow is a static, hashable dataclass so it can be a ``jit``
static argument.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

# Sentinel distance for "ray missed" (reference FARAWAY = 1e39,
# base.py:12 / shader.py:10).  1e39 only fits in float64; for float32 we
# use a large finite value so masked-lane arithmetic never produces
# inf/nan.  bfloat16 is deliberately NOT offered as a compute dtype: the
# intersection quadratic cancels catastrophically at 8 mantissa bits and
# moves most of the golden image's uint8 values (PERF.md).
_FARAWAY = {
    jnp.dtype(jnp.float64): 1.0e39,
    jnp.dtype(jnp.float32): 1.0e30,
}

VISIBILITY_HARD = "hard"
VISIBILITY_SMOOTH = "smooth"


def faraway(dtype: Any) -> float:
    return _FARAWAY[jnp.dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering options (hashable — usable as a jit static arg).

    Attributes:
        max_depth: number of trace segments.  ``max_depth=1`` is primary rays
            only; each extra level follows one mirror bounce.  The reference
            recurses without bound (``shader.py:143-161`` → ``base.py:91``,
            measured depth 56); reflection energy decays by
            ``0.5 * specular_gain`` per bounce (``shader.py:106``) so a
            finite depth reproduces the image to under half a uint8 quantum.
        dtype: compute dtype.  float64 bit-matches the reference; float32
            is the accelerator default.
        visibility: ``"hard"`` replicates the reference's step-function hit
            and shadow tests exactly; ``"smooth"`` relaxes them with
            sigmoids of sharpness ``edge_sharpness``/``shadow_sharpness`` so
            silhouettes and shadows carry useful gradients.
        ray_chunk: when > 0, trace rays in sequential chunks of this size
            (a lax.map over tiles).  Bounds the XLA path's O(chunk * S)
            working set for huge frames / sphere counts; 0 = whole frame
            at once.
        samples_per_pixel: stratified-jitter supersampling (the old
            engine's ``max_samples_per_pixel``, settings schema
            ``input_render_settings.json:4``).  1 = the reference's single
            center ray per pixel.
        stochastic_roughness: sample the GGX half-vector distribution for
            reflection directions instead of perfect mirrors — the glossy
            blur the reference's stale ``test_roughness_statistical``
            specs (``tests/test_ray_tracing.py:68-81`` upstream).
            Deterministic given ``rng_seed``.
        rng_seed: PRNG seed for supersampling/stochastic paths (replay is
            bitwise-reproducible for a fixed seed).
        tie_mode: what to do when two spheres tie EXACTLY for the nearest
            hit.  ``"first"`` (default): the lowest-index sphere wins —
            identical to the reference except on measure-zero ties.
            ``"sum"``: shade both tied spheres and add the results, the
            reference's actual double-shading semantics
            (``base.py:103,119`` shades every sphere whose distance equals
            the minimum and sums) — INCLUDING both winners' mirror
            recursion trees (the second winner's continuation runs as a
            nested fixed-depth trace).  Covers 2-way ties; ties inside
            the second continuation follow lowest-index (deeper tie
            combinations are measure-zero-squared).  Hard visibility,
            XLA path only, O(depth²) bounce cost — the exactness mode.
    """

    max_depth: int = 3
    dtype: Any = jnp.float32
    visibility: str = VISIBILITY_HARD
    edge_sharpness: float = 200.0
    shadow_sharpness: float = 200.0
    ray_chunk: int = 0
    remat: bool = False  # jax.checkpoint each bounce: recompute in backward
    samples_per_pixel: int = 1
    stochastic_roughness: bool = False
    rng_seed: int = 0
    intersect_mode: str = "auto"
    tie_mode: str = "first"

    def __post_init__(self) -> None:
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if self.samples_per_pixel < 1:
            raise ValueError("samples_per_pixel must be >= 1")
        if self.visibility not in (VISIBILITY_HARD, VISIBILITY_SMOOTH):
            raise ValueError(f"unknown visibility mode: {self.visibility}")
        if self.intersect_mode not in ("auto", "reference", "stable"):
            raise ValueError(f"unknown intersect mode: {self.intersect_mode}")
        if self.tie_mode not in ("first", "sum"):
            raise ValueError(f"unknown tie mode: {self.tie_mode}")

    @property
    def stable_intersect(self) -> bool:
        """Use the compensated-arithmetic sweep (float32 default).

        ``auto``: float64 keeps the reference's exact coefficient form (bit
        parity); narrower dtypes get the hardened form.
        """
        if self.intersect_mode == "auto":
            return jnp.dtype(self.dtype) != jnp.dtype(jnp.float64)
        return self.intersect_mode == "stable"

    @property
    def faraway(self) -> float:
        return faraway(self.dtype)

    def __hash__(self) -> int:  # jnp dtypes aren't hashable as class objects on all versions
        return hash(
            (
                self.max_depth,
                str(jnp.dtype(self.dtype)),
                self.visibility,
                self.edge_sharpness,
                self.shadow_sharpness,
                self.ray_chunk,
                self.remat,
                self.samples_per_pixel,
                self.stochastic_roughness,
                self.rng_seed,
                self.intersect_mode,
                self.tie_mode,
            )
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RenderConfig):
            return NotImplemented
        return (
            self.max_depth == other.max_depth
            and jnp.dtype(self.dtype) == jnp.dtype(other.dtype)
            and self.visibility == other.visibility
            and self.edge_sharpness == other.edge_sharpness
            and self.shadow_sharpness == other.shadow_sharpness
            and self.ray_chunk == other.ray_chunk
            and self.remat == other.remat
            and self.samples_per_pixel == other.samples_per_pixel
            and self.stochastic_roughness == other.stochastic_roughness
            and self.rng_seed == other.rng_seed
            and self.intersect_mode == other.intersect_mode
            and self.tie_mode == other.tie_mode
        )
