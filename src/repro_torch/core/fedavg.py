"""FedAvg round engine (paper Alg. 1) on the parity plane.

The port of ``repro/core/fedavg.py``'s ``init_server_state``,
``_client_update`` and ``_fedavg_round_body`` for the reference's
``_PARITY_PLANE``: full participation, no compression, no adversary,
the example-weighted mean, then the server optimizer (Adam in the
paper) with the aggregated delta as its pseudo-gradient.

A round is plain functions over dicts of tensors. The K clients run one
after another in a Python loop, each on its own copy of the round-start
parameters; its delta is folded into the weighted mean as soon as it
exists, so only one client's parameters, gradients and delta are alive
at a time. The randomness of client k's local step s in round r comes
from generators seeded by (seed, r, k, s), as the reference folds the
same four numbers into its key (``fvn.step_seed``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import fvn as fvn_lib
from repro_torch.core.compression import client_wire_bytes, tree_param_bytes
from repro_torch.core.plan import FederatedPlan, make_server_optimizer
from repro_torch.optim import Optimizer, apply_updates, sgd


class ServerState(NamedTuple):
    params: dict
    opt_state: object
    round_idx: int


def init_server_state(plan: FederatedPlan, params: dict) -> ServerState:
    return ServerState(params=params, opt_state=make_server_optimizer(plan).init(params),
                       round_idx=0)


def _client_update(loss_fn: Callable, client_opt: Optimizer, sigma: Optional[float],
                   seed: int, params: dict, client_batch: dict, client_idx: int,
                   round_idx: int):
    """Local optimization for one client. client_batch leaves have shape
    (S_local, b, ...). ``sigma`` is the FVN std (None disables the
    perturbation). Returns (delta = w^r - w_hat, mean loss over the
    steps that hold examples)."""
    device = next(iter(params.values())).device
    n_steps = client_batch["weight"].shape[0]
    p, opt_state = params, client_opt.init(params)
    losses, ns = [], []
    for s in range(n_steps):
        step_batch = {k: v[s] for k, v in client_batch.items()}
        p_eval = p
        if sigma is not None:
            noise = torch.Generator(device=device).manual_seed(
                fvn_lib.step_seed(seed, round_idx, client_idx, s, 0))
            p_eval = fvn_lib.perturb(p, noise, sigma)
        data = torch.Generator().manual_seed(fvn_lib.step_seed(seed, round_idx, client_idx, s, 1))
        leaves = {k: v.detach().requires_grad_() for k, v in p_eval.items()}
        loss, _ = loss_fn(leaves, step_batch, data)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, opt_state = client_opt.update(dict(zip(leaves, grads)), opt_state, p)
        p = apply_updates(p, updates)
        losses.append(loss.detach())
        ns.append(step_batch["weight"].sum())
    delta = {k: params[k].float() - p[k].float() for k in params}
    losses, ns = torch.stack(losses), torch.stack(ns)
    step_mask = (ns > 0).float()
    mean_loss = (losses * step_mask).sum() / torch.clamp(step_mask.sum(), min=1.0)
    return delta, mean_loss


def _aggregate_client_updates(loss_fn, client_opt, sigma, seed, params, round_batch,
                              round_idx):
    """Every client's local update, folded into the example-weighted
    mean of the deltas (the reference's ``weighted_mean``) as each client
    finishes. Returns (wbar, per-client losses (K,), n_k (K,))."""
    K = round_batch["weight"].shape[0]
    n_k = round_batch["weight"].reshape(K, -1).sum(dim=1)
    w = n_k / torch.clamp(n_k.sum(), min=1.0)
    wbar = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
    losses = []
    for k in range(K):
        client_batch = {name: v[k] for name, v in round_batch.items()}
        delta, loss = _client_update(loss_fn, client_opt, sigma, seed, params,
                                     client_batch, k, round_idx)
        for name, d in delta.items():
            wbar[name].add_(w[k] * d)
        losses.append(loss)
    return wbar, torch.stack(losses), n_k


def _fedavg_round_body(loss_fn, client_opt, server_opt, sigma, seed, state: ServerState,
                       round_batch: dict):
    """One FedAvg round: client deltas -> weighted mean -> server
    optimizer. The metrics carry the reference's parity-plane keys."""
    K = round_batch["weight"].shape[0]
    wbar, losses, n_k = _aggregate_client_updates(
        loss_fn, client_opt, sigma, seed, state.params, round_batch, state.round_idx)
    updates, opt_state = server_opt.update(wbar, state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    n = torch.clamp(n_k.sum(), min=1.0)
    metrics = {
        "loss": float((losses * n_k).sum() / n),
        "examples": float(n_k.sum()),
        "delta_norm": math.sqrt(sum(float(x.square().sum()) for x in wbar.values())),
        "corrupted": 0.0,
        "participants": K,
        "uplink_bytes": K * client_wire_bytes("none", state.params),
        "downlink_bytes": K * tree_param_bytes(state.params),
        "sim_time_s": 0.0,
        "server_steps": 1.0,
        "staleness_mean": 0.0,
    }
    return ServerState(params, opt_state, state.round_idx + 1), metrics


def make_round_step(loss_fn: Callable, plan: FederatedPlan, seed: int):
    """Returns round_step(state, round_batch) -> (state, metrics).

    round_batch leaves: (K, S_local, b, ...) tensors on the parameters'
    device; "weight" (K, S_local, b) marks real examples (the paper's
    n_k weighting)."""
    client_opt = sgd(plan.client_lr)
    server_opt = make_server_optimizer(plan)

    def round_step(state: ServerState, round_batch: dict):
        sigma = fvn_lib.fvn_sigma(plan.fvn, state.round_idx) if plan.fvn.enabled else None
        return _fedavg_round_body(loss_fn, client_opt, server_opt, sigma, seed, state,
                                  round_batch)

    return round_step
