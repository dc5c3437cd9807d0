"""FedAvg round engine (paper Alg. 1).

The port of ``repro/core/fedavg.py``'s ``init_server_state``,
``_client_update`` and ``_fedavg_round_body`` with full participation,
no adversary and the example-weighted mean, then the server optimizer
(Adam in the paper) with the aggregated delta as its pseudo-gradient.
The uplink is fp32 (the reference's ``_PARITY_PLANE``) or compressed;
under the weighted mean a compressed uplink always takes the reference's
code-domain fast path (``_code_fast_path``).

A round is plain functions over dicts of tensors. The K clients run one
after another in a Python loop, each on its own copy of the round-start
parameters. On the fp32 uplink a client's delta is folded into the
weighted mean as soon as it exists, so only one client's parameters,
gradients and delta are alive at a time. A compressed uplink needs the
K deltas stacked per leaf, (K, ...): the shared scale of a leaf is a
max over all clients, so no delta can be folded in before the last
client has finished. The randomness of client k's local step s in round
r comes from generators seeded by (seed, r, k, s), as the reference
folds the same four numbers into its key (``fvn.step_seed``); the
compression plane's rounding keys are the reference's threefry keys
(``core/keys.py``) from the base key ``PRNGKey(seed)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import fvn as fvn_lib
from repro_torch.core import keys as keys_lib
from repro_torch.core.compression import (
    CompressionConfig,
    client_wire_bytes,
    code_domain_aggregate,
    code_domain_aggregate_ef,
    tree_param_bytes,
)
from repro_torch.core.plan import FederatedPlan, make_server_optimizer
from repro_torch.optim import Optimizer, apply_updates, sgd


class ServerState(NamedTuple):
    params: dict
    opt_state: object
    round_idx: int
    ef: Optional[dict] = None  # EF21 residuals, {name: (K, ...) fp32}, or None


def init_server_state(plan: FederatedPlan, params: dict) -> ServerState:
    K = plan.clients_per_round
    ef = None
    if plan.compression.error_feedback:
        ef = {k: torch.zeros((K, *p.shape), dtype=torch.float32, device=p.device)
              for k, p in params.items()}
    return ServerState(params=params, opt_state=make_server_optimizer(plan).init(params),
                       round_idx=0, ef=ef)


def _code_fast_path(compression: CompressionConfig) -> bool:
    """The reference's static selector (``repro/core/fedavg.py:189-206``):
    a compressing plane under the weighted mean with no delta adversary.
    The port runs only that aggregator and no adversary, so every
    compressing plane takes it."""
    return compression.kind in ("int8", "int4", "topk")


# Distinct fold_in tags keep the plane's streams apart (the reference's).
_COHORT_TAG, _COMPRESS_TAG, _AGG_TAG, _CORRUPT_TAG = (0x636F68, 0x636D70, 0x616767, 0x626164)


def _plane_keys(base_key: torch.Tensor, round_idx: int):
    """(cohort, compression, aggregation, corruption) keys of a round."""
    rk = keys_lib.fold_in(base_key, round_idx)
    return tuple(keys_lib.fold_in(rk, tag)
                 for tag in (_COHORT_TAG, _COMPRESS_TAG, _AGG_TAG, _CORRUPT_TAG))


def _client_key_fanout(compression: CompressionConfig, qkey: torch.Tensor, K: int):
    """The round's client keys (K, 2): fold_in(qkey, k); None uncompressed."""
    if compression.kind == "none":
        return None
    return keys_lib.fold_in(qkey, torch.arange(K))


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


def _client_examples(round_batch: dict) -> torch.Tensor:
    K = round_batch["weight"].shape[0]
    return round_batch["weight"].reshape(K, -1).sum(dim=1)


def _client_updates(loss_fn, client_opt, sigma, seed, params, round_batch, round_idx):
    """Each client's local update in turn: yields (k, delta, mean loss)."""
    for k in range(round_batch["weight"].shape[0]):
        client_batch = {name: v[k] for name, v in round_batch.items()}
        yield (k, *_client_update(loss_fn, client_opt, sigma, seed, params, client_batch, k,
                                  round_idx))


def _aggregate_client_updates(loss_fn, client_opt, sigma, seed, params, round_batch,
                              round_idx):
    """Every client's local update, folded into the example-weighted
    mean of the deltas (the reference's ``weighted_mean``) as each client
    finishes. Returns (wbar, per-client losses (K,), n_k (K,))."""
    n_k = _client_examples(round_batch)
    w = n_k / torch.clamp(n_k.sum(), min=1.0)
    wbar = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
    losses = []
    for k, delta, loss in _client_updates(loss_fn, client_opt, sigma, seed, params,
                                          round_batch, round_idx):
        for name, d in delta.items():
            wbar[name].add_(w[k] * d)
        losses.append(loss)
    return wbar, torch.stack(losses), n_k


def _stacked_client_deltas(loss_fn, client_opt, sigma, seed, params, round_batch, round_idx):
    """Every client's local update, its delta written into slot k of a
    (K, ...) fp32 stack per leaf. Returns (deltas, losses (K,), n_k (K,))."""
    n_k = _client_examples(round_batch)
    deltas = {k: torch.empty((n_k.shape[0], *v.shape), dtype=torch.float32, device=v.device)
              for k, v in params.items()}
    losses = []
    for k, delta, loss in _client_updates(loss_fn, client_opt, sigma, seed, params,
                                          round_batch, round_idx):
        for name, d in delta.items():
            deltas[name][k].copy_(d)
        losses.append(loss)
    return deltas, torch.stack(losses), n_k


def _wire_metrics(compression: CompressionConfig, params: dict, participants: int,
                  K: int) -> dict:
    """The round's wire bytes as exact ints: uplink counts the reporting
    clients' compressed deltas, downlink every sampled client."""
    return {
        "participants": participants,
        "uplink_bytes": participants * client_wire_bytes(compression, params),
        "downlink_bytes": K * tree_param_bytes(params),
    }


def _fedavg_round_body(loss_fn, client_opt, server_opt, sigma, seed, state: ServerState,
                       round_batch: dict, compression: CompressionConfig):
    """One FedAvg round: client deltas -> (compressed, code-domain)
    weighted mean -> server optimizer. The metrics carry the reference's
    keys."""
    K = round_batch["weight"].shape[0]
    ef = state.ef
    if _code_fast_path(compression):
        _, qkey, _, _ = _plane_keys(keys_lib.PRNGKey(seed), state.round_idx)
        ckeys = _client_key_fanout(compression, qkey, K)
        deltas, losses, n_k = _stacked_client_deltas(
            loss_fn, client_opt, sigma, seed, state.params, round_batch, state.round_idx)
        pmask = torch.ones(K, dtype=torch.float32, device=n_k.device)
        if compression.error_feedback:
            wbar, ef = code_domain_aggregate_ef(compression, deltas, n_k, pmask, ckeys, ef)
        else:
            wbar = code_domain_aggregate(compression, deltas, n_k, pmask, ckeys)
        del deltas
    else:
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
        **_wire_metrics(compression, state.params, K, K),
        "sim_time_s": 0.0,
        "server_steps": 1.0,
        "staleness_mean": 0.0,
    }
    return ServerState(params, opt_state, state.round_idx + 1, ef), metrics


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
                                  round_batch, plan.compression)

    return round_step
