"""Gradient-transformation optimizers as functions over dicts of tensors.

The port of ``repro/optim/optimizers.py``: ``sgd`` (the paper's client
optimizer), ``adam`` (its server optimizer), ``momentum`` (with
Nesterov), ``adamw`` and ``yogi`` (the adaptive federated servers), and
the transformations ``clip_by_global_norm``, ``chain`` and
``scale_by_schedule``. As in the reference, an ``Optimizer`` is a pair
``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``, and ``apply_updates`` adds the (already negated)
updates. Every call returns new tensors; nothing is updated in place.
Scalar coefficients are computed in float32, as the reference computes
them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

Params = dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """The fp32 L2 norm over every tensor, summed tensor by tensor in the
    reference's tree order."""
    from repro_torch.core.compression import jax_leaf_order

    return torch.sqrt(sum(tree[k].float().square().sum() for k in jax_leaf_order(tree)))


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.float() + updates[k]).to(p.dtype) for k, p in params.items()}


def _resolve_lr(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(np.float32(lr))


class ScaleState(NamedTuple):
    count: int


def sgd(learning_rate) -> Optimizer:
    """Plain SGD — the paper's client optimizer."""

    def init(params):
        return ScaleState(count=0)

    def update(grads, state, params=None):
        lr = _resolve_lr(learning_rate, state.count)
        return {k: -lr * g.float() for k, g in grads.items()}, ScaleState(state.count + 1)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    count: int
    trace: Params


def momentum(learning_rate, decay: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(count=0, trace=_zeros_like(params))

    def update(grads, state, params=None):
        lr = _resolve_lr(learning_rate, state.count)
        trace = {k: decay * state.trace[k] + g.float() for k, g in grads.items()}
        if nesterov:
            upd = {k: -(lr * (decay * trace[k] + g.float())) for k, g in grads.items()}
        else:
            upd = {k: -lr * t for k, t in trace.items()}
        return upd, MomentumState(count=state.count + 1, trace=trace)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam — the paper's server optimizer (Reddi et al. adaptive FL)."""

    def init(params):
        return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    def update(grads, state, params=None):
        count = state.count + 1
        lr = _resolve_lr(learning_rate, state.count)
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float() for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * g.float().square() for k, g in grads.items()}
        c = np.float32(count)
        mu_hat_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** c))
        nu_hat_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** c))
        upd = {k: -lr * (mu[k] * mu_hat_scale) / ((nu[k] * nu_hat_scale).sqrt() + eps)
               for k in mu}
        return upd, AdamState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    base = adam(learning_rate, b1, b2, eps)

    def update(grads, state, params):
        upd, state = base.update(grads, state, params)
        # lr * weight_decay in float32, as the reference's traced lr makes it
        decay = float(np.float32(_resolve_lr(learning_rate, state.count - 1))
                      * np.float32(weight_decay))
        return {k: u - decay * params[k].float() for k, u in upd.items()}, state

    return Optimizer(base.init, update)


def yogi(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3) -> Optimizer:
    """Yogi (additive second moment) — from Adaptive Federated Optimization."""

    def init(params):
        return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    def update(grads, state, params=None):
        count = state.count + 1
        lr = _resolve_lr(learning_rate, state.count)
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float() for k, g in grads.items()}
        nu = {}
        for k, g in grads.items():
            g2 = g.float().square()
            nu[k] = state.nu[k] - (1 - b2) * torch.sign(state.nu[k] - g2) * g2
        c = np.float32(count)
        mu_hat_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** c))
        upd = {k: -lr * (mu[k] * mu_hat_scale) / (nu[k].abs().sqrt() + eps) for k in mu}
        return upd, AdamState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update)


class ClipState(NamedTuple):
    inner: object


def clip_by_global_norm(inner: Optimizer, max_norm: float) -> Optimizer:
    def init(params):
        return ClipState(inner=inner.init(params))

    def update(grads, state, params=None):
        scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        upd, inner_state = inner.update(grads, state.inner, params)
        return upd, ClipState(inner=inner_state)

    return Optimizer(init, update)


class ChainState(NamedTuple):
    states: tuple


def chain(*optimizers: Optimizer) -> Optimizer:
    """Compose transformations left-to-right on the update stream."""

    def init(params):
        return ChainState(states=tuple(o.init(params) for o in optimizers))

    def update(grads, state, params=None):
        upd, new_states = grads, []
        for o, s in zip(optimizers, state.states):
            upd, s = o.update(upd, s, params)
            new_states.append(s)
        return upd, ChainState(states=tuple(new_states))

    return Optimizer(init, update)


def scale_by_schedule(schedule) -> Optimizer:
    def init(params):
        return ScaleState(count=0)

    def update(grads, state, params=None):
        s = schedule(state.count)
        return {k: g * s for k, g in grads.items()}, ScaleState(count=state.count + 1)

    return Optimizer(init, update)
