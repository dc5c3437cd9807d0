"""Gradient-transformation optimizers as functions over dicts of tensors.

The port of ``repro/optim/optimizers.py`` for the two optimizers the
FedAvg parity plane uses: ``sgd`` (the client optimizer) and ``adam``
(the paper's server optimizer). As in the reference, an ``Optimizer``
is a pair ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)``, and ``apply_updates`` adds the (already negated)
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


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam — the paper's server optimizer (Reddi et al. adaptive FL)."""

    def init(params):
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamState(count=0, mu=zeros, nu={k: z.clone() for k, z in zeros.items()})

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
