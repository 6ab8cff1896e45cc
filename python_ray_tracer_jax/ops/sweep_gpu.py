"""Nearest-hit and hard-shadow sphere sweeps as Pallas kernels for NVIDIA GPUs.

The XLA sweep (``render._sweep`` + its reductions) is written over
(N rays x S spheres) tables.  These kernels compute the same reductions
without tables: one program takes ``BLOCK_RAYS`` rays, walks the sphere
table in chunks of ``CHUNK`` rows with ``fori_loop``, and keeps the running
nearest ``(t, idx)`` — or, for the shadow test, the running
``(min t over other spheres, t of the lane's own sphere)`` — in registers.
Traffic is O(N + S) bytes; the sphere table is small and is read through
L2 by every program.  Programs share nothing.

Numerics are the XLA sweep's two tiers (:mod:`.intersect`, split at scene
build as ``Spheres.n_exact``): :func:`.intersect.quadratic_plain` on the
cheap prefix, :func:`.intersect.quadratic_stable` on the exact suffix (the
reference's r = 99999 ground sphere).  The formulas are the same Python
functions the XLA path runs, applied to (BLOCK_RAYS, CHUNK) tiles.

Gradients: :func:`nearest_hit` has a custom VJP.  The backward pass
recomputes each lane's winning ``t`` in XLA with the winner's tier formula
and differentiates that — the subgradient ``jnp.min`` takes on the XLA
path.  The shadow test is a step function and carries no gradient.

Routing: :func:`sweep_route` decides from the platform and the sphere
count; :func:`routed` turns that into ``lax.platform_dependent`` branches,
so the choice is made when the computation is lowered and a CPU
computation in a GPU process never lowers the kernel.  ``render`` takes
another route function to compare the two forms.  ``interpret=True``
runs the kernels in the Pallas interpreter; only tests pass it.
"""

from __future__ import annotations

import functools
from typing import Callable, TypeVar

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import NearestHit, quadratic_plain, quadratic_stable

_T = TypeVar("_T")

# Rays per program and sphere rows per loop step (both powers of two), and
# the Triton launch shape.
BLOCK_RAYS = 128
CHUNK = 2
NUM_WARPS = 2
NUM_STAGES = 1

# Hard-visibility sweeps of at least this many spheres take the kernel on
# CUDA devices; smaller tables stay on XLA, which fuses the whole bounce.
SWEEP_KERNEL_MIN_SPHERES = 16

_INT_MAX = 2**31 - 1
# Padding rows: zero radius far below the scene; the kernel also masks them
# by row index, so they never win and never shadow.
_PAD_CENTER = (0.0, -1.0e7, 0.0)


def sweep_route(platform: str, n_spheres: int) -> str:
    """``"kernel"`` or ``"xla"`` for a hard sweep of ``n_spheres`` on ``platform``
    (a lowering platform name: ``"cuda"``, ``"cpu"``, ...)."""
    if platform == "cuda" and n_spheres >= SWEEP_KERNEL_MIN_SPHERES:
        return "kernel"
    return "xla"


def routed(
    kernel_fn: Callable[..., _T],
    xla_fn: Callable[..., _T],
    n_spheres: int,
    *args,
    route: Callable[[str, int], str] = sweep_route,
) -> _T:
    """``kernel_fn(*args)`` on the CUDA platform where ``route`` gives the
    kernel, ``xla_fn(*args)`` everywhere else, chosen at lowering time."""
    branches = {p: kernel_fn for p in ("cuda",) if route(p, n_spheres) == "kernel"}
    if not branches:
        return xla_fn(*args)
    return jax.lax.platform_dependent(*args, default=xla_fn, **branches)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _tiers(n_spheres: int, n_exact: int) -> tuple[tuple[int, int, int, bool], ...]:
    """Static ``(first row, rows, chunk, exact)`` for each non-empty tier."""
    s_cheap = n_spheres - min(n_exact, n_spheres)
    out = []
    for base, rows, exact in ((0, s_cheap, False), (s_cheap, n_spheres - s_cheap, True)):
        if rows:
            out.append((base, rows, min(CHUNK, pl.next_power_of_2(rows)), exact))
    return tuple(out)


def _tier_tables(center: jax.Array, radius: jax.Array, tiers) -> list[jax.Array]:
    """(cx, cy, cz, r) columns per tier, padded to a multiple of its chunk."""
    tables = []
    for base, rows, chunk, _ in tiers:
        pad = _round_up(rows, chunk) - rows
        c = center[base : base + rows]
        r = radius[base : base + rows]
        if pad:
            c = jnp.concatenate([c, jnp.broadcast_to(jnp.asarray(_PAD_CENTER, c.dtype), (pad, 3))])
            r = jnp.concatenate([r, jnp.zeros((pad,), r.dtype)])
        tables += [c[:, 0], c[:, 1], c[:, 2], r]
    return tables


def _ray_columns(origin: jax.Array, direction: jax.Array, n_pad: int) -> list[jax.Array]:
    o = jnp.broadcast_to(origin, direction.shape)
    n = direction.shape[0]
    if n_pad != n:
        o = jnp.concatenate([o, jnp.broadcast_to(o[:1], (n_pad - n, 3))])
        direction = jnp.concatenate([direction, jnp.broadcast_to(direction[:1], (n_pad - n, 3))])
    return [o[:, 0], o[:, 1], o[:, 2], direction[:, 0], direction[:, 1], direction[:, 2]]


def _sweep_kernel(*refs, tiers, faraway: float, shadow: bool):
    n_in = 6 + int(shadow) + 4 * len(tiers)
    ins, outs = refs[:n_in], refs[n_in:]
    o = tuple(ins[i][...][:, None] for i in range(3))  # (B, 1)
    d = tuple(ins[3 + i][...][:, None] for i in range(3))
    dtype = o[0].dtype
    block = o[0].shape[0]
    pos = 6
    if shadow:
        self_idx = ins[6][...][:, None]
        pos = 7
        inf = jnp.asarray(jnp.inf, dtype)
        carry = (jnp.full((block,), inf), jnp.full((block,), inf))
    else:
        far = jnp.asarray(faraway, dtype)
        carry = (jnp.full((block,), far), jnp.zeros((block,), jnp.int32))

    for base, rows, chunk, exact in tiers:
        cx, cy, cz, cr = ins[pos : pos + 4]
        pos += 4
        quad = quadratic_stable if exact else quadratic_plain

        def body(k, carry, cx=cx, cy=cy, cz=cz, cr=cr, base=base, rows=rows, chunk=chunk, quad=quad):
            start = k * chunk
            sl = pl.ds(start, chunk)
            c = (cx[sl][None, :], cy[sl][None, :], cz[sl][None, :])  # (1, K)
            r = cr[sl][None, :]
            t = quad(o, d, c, r, faraway).t  # (B, K)
            row = start + jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
            sidx = row + base
            if shadow:
                t = jnp.where(row < rows, t, inf)
                is_self = sidx == self_idx
                others = jnp.min(jnp.where(is_self, inf, t), axis=1)
                mine = jnp.min(jnp.where(is_self, t, inf), axis=1)
                return jnp.minimum(carry[0], others), jnp.minimum(carry[1], mine)
            t = jnp.where(row < rows, t, far)
            tb = jnp.min(t, axis=1)
            ib = jnp.min(jnp.where(t == tb[:, None], sidx, _INT_MAX), axis=1)
            take = tb < carry[0]  # strict: the earlier chunk wins ties (lower index)
            return jnp.where(take, tb, carry[0]), jnp.where(take, ib, carry[1])

        carry = jax.lax.fori_loop(0, cx.shape[0] // chunk, body, carry)

    if shadow:
        # Reference semantics (shader.py:127-128): lit iff the lane's own
        # sphere is the nearest hit along the shadow ray.
        outs[0][...] = (carry[1] <= carry[0]).astype(dtype)
    else:
        outs[0][...] = carry[0]
        outs[1][...] = jnp.where(carry[0] == far, 0, carry[1])


def _sweep_call(origin, direction, center, radius, self_idx, faraway, n_exact, interpret):
    n = direction.shape[0]
    n_pad = _round_up(n, BLOCK_RAYS)
    tiers = _tiers(center.shape[0], n_exact)
    shadow = self_idx is not None
    args = _ray_columns(origin, direction, n_pad)
    if shadow:
        args.append(jnp.pad(self_idx.astype(jnp.int32), (0, n_pad - n)))
    tables = _tier_tables(center, radius, tiers)
    ray_spec = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    dtype = direction.dtype
    out_shape = [jax.ShapeDtypeStruct((n_pad,), dtype)]
    if not shadow:
        out_shape.append(jax.ShapeDtypeStruct((n_pad,), jnp.int32))
    out = pl.pallas_call(
        functools.partial(_sweep_kernel, tiers=tiers, faraway=faraway, shadow=shadow),
        grid=(n_pad // BLOCK_RAYS,),
        in_specs=[ray_spec] * len(args) + [pl.BlockSpec(x.shape, lambda i: (0,)) for x in tables],
        out_specs=[ray_spec] * len(out_shape),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="sphere_sweep_shadow" if shadow else "sphere_sweep_nearest",
    )(*args, *tables)
    return [x[:n] for x in out]


def winner_t(origin, direction, center, radius, idx, n_exact: int, faraway: float) -> jax.Array:
    """Each lane's ``t`` against its own sphere ``idx``, in that sphere's tier."""
    o = jnp.broadcast_to(origin, direction.shape)
    c = jnp.take(center, idx, axis=0)
    r = jnp.take(radius, idx, axis=0)
    cols = lambda v: tuple(v[:, i] for i in range(3))  # noqa: E731
    args = (cols(o), cols(direction), cols(c), r, faraway)
    t_plain = quadratic_plain(*args).t
    t_exact = quadratic_stable(*args).t
    exact = idx >= center.shape[0] - min(n_exact, center.shape[0])
    return jnp.where(exact, t_exact, t_plain)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def _nearest(origin, direction, center, radius, faraway, n_exact, interpret):
    t, idx = _sweep_call(origin, direction, center, radius, None, faraway, n_exact, interpret)
    return t, idx


def _nearest_fwd(origin, direction, center, radius, faraway, n_exact, interpret):
    t, idx = _sweep_call(origin, direction, center, radius, None, faraway, n_exact, interpret)
    return (t, idx), (origin, direction, center, radius, t, idx)


def _nearest_bwd(faraway, n_exact, interpret, residuals, cotangents):
    origin, direction, center, radius, t, idx = residuals
    g_t, _ = cotangents  # idx is an integer output: no cotangent
    hit = t != jnp.asarray(faraway, t.dtype)

    def t_of(o, d, c, r):
        t_w = winner_t(o, d, c, r, idx, n_exact, faraway)
        return jnp.where(hit, t_w, jnp.zeros_like(t_w))

    _, pull = jax.vjp(t_of, origin, direction, center, radius)
    return pull(g_t)


_nearest.defvjp(_nearest_fwd, _nearest_bwd)


def nearest_hit(
    origin: jax.Array,  # (N, 3)
    direction: jax.Array,  # (N, 3) unit
    center: jax.Array,  # (S, 3), cheap rows first, exact rows last
    radius: jax.Array,  # (S,)
    faraway: float,
    n_exact: int,
    *,
    interpret: bool = False,
) -> NearestHit:
    """Nearest sphere per ray: the kernel form of the XLA sweep + argmin
    (lowest index wins exact ties, ``idx = 0`` on a miss)."""
    origin = jnp.broadcast_to(origin, direction.shape)
    t, idx = _nearest(origin, direction, center, radius, faraway, n_exact, interpret)
    return NearestHit(t=t, idx=idx, hit=t != jnp.asarray(faraway, t.dtype))


def shadow_hard(
    origin: jax.Array,  # (N, 3) nudged surface points
    direction: jax.Array,  # (N, 3) unit directions to the light
    center: jax.Array,
    radius: jax.Array,
    self_idx: jax.Array,  # (N,) int32, each lane's own sphere
    faraway: float,
    n_exact: int,
    *,
    interpret: bool = False,
) -> jax.Array:
    """Hard visibility in {0, 1}: ``t_self <= min(t over other spheres)``."""
    sg = jax.lax.stop_gradient
    (lit,) = _sweep_call(
        sg(origin), sg(direction), sg(center), sg(radius), self_idx, faraway, n_exact, interpret
    )
    return lit
