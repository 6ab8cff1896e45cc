"""Inverse rendering: differentiable loss + Adam training step.

New capability (the reference is forward-only, SURVEY §2 row 18).  The loss
is an L2 pixel loss against a target image (BASELINE.json config 3 names
``ref_spec_noRoughness_domelight.png`` as the canonical target); the
training step is a jit-compiled ``value_and_grad`` + optax Adam update.

Multi-device (BASELINE config 5): the same step with the render expressed via
``shard_map`` over a mesh — rays sharded, params replicated.  Differentiating
through ``shard_map`` makes XLA insert the gradient ``psum`` itself and
overlap it with backward compute; no hand-written collective calls needed
in the training loop.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh

from ..config import RenderConfig
from ..render import render
from ..scene import Scene
from .params import Params, combine


def l2_image_loss(image: jax.Array, target: jax.Array) -> jax.Array:
    """Mean squared pixel error (images clipped like the PNG writer clips,
    ``base.py:148``, so loss compares displayable color)."""
    return jnp.mean((jnp.clip(image, 0.0, 1.0) - target) ** 2)


def make_loss_fn(
    template: Scene,
    target: jax.Array,  # (H, W, 3) float in [0, 1]
    cfg: RenderConfig,
    mesh: Mesh | None = None,
) -> Callable[[Params], jax.Array]:
    """Loss as a pure function of the parameter dict.

    With a mesh, rendering (and therefore the backward pass) runs sharded;
    the returned scalar is replicated.
    """

    def loss_fn(params: Params) -> jax.Array:
        scene = combine(params, template)
        if mesh is None:
            image = render(scene, cfg)
        else:
            from ..parallel.sharded import render_sharded

            image = render_sharded(scene, cfg, mesh)
        return l2_image_loss(image, jnp.asarray(target, cfg.dtype))

    return loss_fn


def masked_updates(masks: Params) -> optax.GradientTransformation:
    """Element-wise update masks (freeze parts of parameter arrays).

    ``masks`` has the params' structure with 0/1 arrays (or scalars)
    broadcastable to each leaf — e.g. optimize one sphere's row while the
    rest of the table stays put.  Chain after the optimizer:
    ``optax.chain(optax.adam(lr), masked_updates(masks))``.
    """

    def init(_):
        return optax.EmptyState()

    def update(updates, state, params=None):
        del params
        return jax.tree_util.tree_map(lambda u, m: u * m, updates, masks), state

    return optax.GradientTransformation(init, update)


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: jax.Array


def make_train_step(
    loss_fn: Callable[[Params], jax.Array],
    optimizer: optax.GradientTransformation,
):
    """Build ``step(state) -> (state, loss)``, jit-compiled with donation."""

    @functools.partial(jax.jit, donate_argnums=0)
    def train_step(state: TrainState) -> tuple[TrainState, jax.Array]:
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def make_train_step_k(
    loss_fn: Callable[[Params], jax.Array],
    optimizer: optax.GradientTransformation,
):
    """Build ``step_k(state, k) -> (state, (k,) losses)`` — K Adam steps per
    dispatch as an on-device ``lax.scan``.

    One host round trip per K steps instead of per step, so host dispatch
    and synchronization are paid once per chunk.  The loss history comes
    back as one (k,) device array — the only per-chunk transfer.  ``k`` is static (one compile per distinct
    chunk size; :func:`fit` uses at most two).
    """

    @functools.partial(jax.jit, donate_argnums=0, static_argnums=1)
    def train_step_k(state: TrainState, k: int) -> tuple[TrainState, jax.Array]:
        def body(s: TrainState, _) -> tuple[TrainState, jax.Array]:
            loss, grads = jax.value_and_grad(loss_fn)(s.params)
            updates, opt_state = optimizer.update(grads, s.opt_state, s.params)
            params = optax.apply_updates(s.params, updates)
            return TrainState(params, opt_state, s.step + 1), loss

        return jax.lax.scan(body, state, None, length=k)

    return train_step_k


def init_state(params: Params, optimizer: optax.GradientTransformation) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))


def fit(
    template: Scene,
    target: jax.Array,
    cfg: RenderConfig,
    params: Params,
    *,
    steps: int = 100,
    learning_rate: float = 1e-2,
    mesh: Mesh | None = None,
    update_mask: Params | None = None,
    callback: Callable[[int, float], None] | None = None,
    sync_every: int = 25,
) -> tuple[Params, list[float]]:
    """Adam-optimize scene params against a target image.

    ``update_mask`` (optional) freezes parameter elements where 0 — see
    :func:`masked_updates`.  Returns the final params and the per-step
    loss history.

    ``sync_every``: steps per device dispatch (:func:`make_train_step_k`).
    The host syncs — and ``callback`` fires, with the per-step losses from
    the chunk's history array — only at chunk boundaries.  1 restores the
    step-at-a-time driver.
    """
    optimizer = optax.adam(learning_rate)
    if update_mask is not None:
        optimizer = optax.chain(optimizer, masked_updates(update_mask))
    loss_fn = make_loss_fn(template, target, cfg, mesh)
    step_fn = make_train_step_k(loss_fn, optimizer)
    state = init_state(params, optimizer)
    history: list[float] = []
    k = max(1, min(sync_every, steps))
    done = 0
    while done < steps:
        kk = min(k, steps - done)
        state, losses = step_fn(state, kk)
        chunk = [float(x) for x in np.asarray(losses)]  # ONE host transfer
        for j, loss_val in enumerate(chunk):
            if callback is not None:
                callback(done + j, loss_val)
        history.extend(chunk)
        done += kk
    return state.params, history
