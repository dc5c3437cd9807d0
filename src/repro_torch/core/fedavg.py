"""FedAvg round engine (paper Alg. 1), and the large-model fedsgd engine.

The port of ``repro/core/fedavg.py``'s fedavg round (``:148-355``,
``:526-634``) and its fedsgd round (``:665-775``); the buffered-async
engine (``core/async_engine.py``) shares its cohort, client updates and
payload stage. FedAvg: client
deltas -> cohort mask -> uplink compression -> corruption -> aggregator
-> server optimizer (Adam in the paper), the aggregated delta the server
optimizer's pseudo-gradient. Each stage is a
plane of ``ServerPlane``: the cohort (``core/cohort.py``), the compressor
(``core/compression.py``), the adversary (``core/corruption.py``) and the
aggregator (``core/aggregation.py``).

A round is plain functions over dicts of tensors. The K clients run one
after another in a Python loop, each on its own copy of the round-start
parameters; a dropped client runs its local steps too, with its example
weights masked to 0, as the reference's vmapped clients do. Three paths
aggregate, chosen as the reference's selector (``_code_fast_path``)
chooses:

- the code-domain fast path: a compressed uplink under the weighted mean
  with no delta adversary (``code_domain_aggregate{,_ef}``);
- the slow path: a robust aggregator or a delta adversary needs each
  client's compressed delta, stacked per leaf as (K, ...), before the
  adversary and the aggregator see them;
- the fp32 weighted mean with no delta adversary, which folds each
  client's delta into the mean as soon as it exists, so only one client's
  parameters, gradients and delta are alive at a time; it adds in the
  order ``aggregation.weighted_mean`` does, so the two give the same bits.

The fedsgd round collapses the K clients into one example-weighted
forward and backward at the round-start weights over the cohort-masked
round batch flattened to K·S·b examples: FVN's noise is drawn once, at
``fvn_key(PRNGKey(seed), r, 0, 0)``, the delta is ``client_lr * grad``,
and a compressed plan compresses that aggregate with the round's
compression key as one client would (``make_compressor`` at K = 1). No
per-client delta exists, so robust aggregators, error feedback and delta
adversaries need the fedavg engine (``_check_fedsgd_*``).

The randomness of client k's local step s in round r comes from the
reference's key ``fvn_key(PRNGKey(seed), r, k, s)``, as JAX's does, bit
for bit (``repro/core/fedavg.py:389-391``): FVN's noise from the key
itself (``fvn.perturb``: one normal kernel launch a step on the card),
SpecAugment's masks from its data key ``fold_in(·, 1)``. The server
plane's draws are the reference's threefry draws (``core/keys.py``) from
the same base key.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import fvn as fvn_lib
from repro_torch.core import keys as keys_lib
from repro_torch.core.aggregation import AGG_HYPER_DEFAULTS, get_aggregator
from repro_torch.core.cohort import identity_cohort, make_cohort_fn, make_latency_fn
from repro_torch.core.compression import (
    CompressionConfig,
    client_wire_bytes,
    code_domain_aggregate,
    code_domain_aggregate_ef,
    make_compressor,
    tree_param_bytes,
)
from repro_torch.core.corruption import DELTA_KINDS, identity_corruption, make_corruption_fn
from repro_torch.core.plan import FederatedPlan, make_server_optimizer
from repro_torch.optim import Optimizer, apply_updates, sgd


class ServerState(NamedTuple):
    params: dict
    opt_state: object
    round_idx: int
    ef: Optional[dict] = None  # EF21 residuals, {name: (K, ...) fp32}, or None
    # the stale adversary's cache (plan.corruption.kind == "stale"): each
    # participant's last honest post-compression delta, {name: (K, ...)}
    stale: Optional[dict] = None
    # the async engine's buffer of pending staleness-tagged deltas
    # (plan.engine == "async", an ``async_engine.AsyncBuffer``): it
    # persists across waves
    abuf: Optional[object] = None


class ServerPlane(NamedTuple):
    """The server side of a round: cohort -> compression -> corruption ->
    aggregation, with the aggregator's name and the adversary's kind for
    the fast-path selector."""

    cohort: Callable  # (key, weight) -> (weight', pmask)
    compress: Callable  # (deltas, ckeys) -> deltas
    compression: CompressionConfig
    aggregate: Callable  # (deltas, n_k, pmask, key) -> wbar
    corrupt: Callable = identity_corruption  # (key, deltas, pmask, stale) -> (.., cmask, stale')
    aggregator_name: str = "weighted_mean"
    corruption_kind: str = "none"


def _client_axis_zeros(params: dict, K: int) -> dict:
    return {k: torch.zeros((K, *p.shape), dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def init_server_state(plan: FederatedPlan, params: dict) -> ServerState:
    K = plan.clients_per_round
    ef = _client_axis_zeros(params, K) if plan.compression.error_feedback else None
    stale = _client_axis_zeros(params, K) if plan.corruption.kind == "stale" else None
    abuf = None
    if plan.engine == "async":
        from repro_torch.core.async_engine import init_async_buffer

        abuf = init_async_buffer(params, plan.asynchrony.resolve_buffer(K))
    return ServerState(params=params, opt_state=make_server_optimizer(plan).init(params),
                       round_idx=0, ef=ef, stale=stale, abuf=abuf)


def _code_fast_path(plane: ServerPlane) -> bool:
    """The reference's selector (``repro/core/fedavg.py:189-206``): the
    plane compresses, aggregates with the weighted mean, and no delta
    adversary needs the per-client deltas the fast path never makes."""
    return (plane.compression.kind in ("int8", "int4", "topk")
            and plane.aggregator_name == "weighted_mean"
            and plane.corruption_kind not in DELTA_KINDS)


def _streamed_mean(plane: ServerPlane) -> bool:
    """fp32 uplink, weighted mean, no delta adversary: each client's delta
    folds into the mean as it is made (the reference's slow path computes
    the same)."""
    return (plane.compression.kind == "none" and plane.aggregator_name == "weighted_mean"
            and plane.corruption_kind not in DELTA_KINDS)


# Distinct fold_in tags keep the plane's streams apart (the reference's).
_COHORT_TAG, _COMPRESS_TAG, _AGG_TAG, _CORRUPT_TAG = (0x636F68, 0x636D70, 0x616767, 0x626164)
_LATENCY_TAG = 0x6C6174


def _plane_keys(base_key: torch.Tensor, round_idx: int):
    """(cohort, compression, aggregation, corruption) keys of a round."""
    rk = keys_lib.fold_in(base_key, round_idx)
    return tuple(keys_lib.fold_in(rk, tag)
                 for tag in (_COHORT_TAG, _COMPRESS_TAG, _AGG_TAG, _CORRUPT_TAG))


def _latency_key(base_key: torch.Tensor, round_idx: int) -> torch.Tensor:
    return keys_lib.fold_in(keys_lib.fold_in(base_key, round_idx), _LATENCY_TAG)


def _plan_server_plane(plan: FederatedPlan) -> ServerPlane:
    """The plan's server plane (the reference's ``_make_server_plane``
    with the plan's knobs; the port has no traced-knob round step). A full
    cohort draws nothing."""
    cohort = plan.cohort
    agg_fn = get_aggregator(plan.aggregation.name)
    hypers = dict(AGG_HYPER_DEFAULTS, **plan.aggregation.hypers)
    return ServerPlane(
        cohort=identity_cohort if cohort.full else make_cohort_fn(
            cohort.participation, cohort.straggler_frac, cohort.straggler_keep),
        compress=make_compressor(plan.compression),
        compression=plan.compression,
        aggregate=lambda deltas, n_k, pmask, key: agg_fn(deltas, n_k, pmask, hypers, key),
        corrupt=make_corruption_fn(plan.corruption.kind, plan.corruption.rate,
                                   plan.corruption.scale),
        aggregator_name=plan.aggregation.name,
        corruption_kind=plan.corruption.kind,
    )


def _apply_cohort(plane: ServerPlane, ckey: torch.Tensor, round_batch: dict):
    """The round batch with its example weights masked by the drawn
    cohort, and the (K,) mask of reporting clients."""
    weight, pmask = plane.cohort(ckey, round_batch["weight"])
    return dict(round_batch, weight=weight), pmask


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
    base_key = keys_lib.PRNGKey(seed)
    n_steps = client_batch["weight"].shape[0]
    p, opt_state = params, client_opt.init(params)
    losses, ns = [], []
    for s in range(n_steps):
        step_batch = {k: v[s] for k, v in client_batch.items()}
        key = fvn_lib.fvn_key(base_key, round_idx, client_idx, s)
        p_eval = p if sigma is None else fvn_lib.perturb(p, key, sigma)
        data_key = keys_lib.fold_in(key, 1)
        leaves = {k: v.detach().requires_grad_() for k, v in p_eval.items()}
        loss, _ = loss_fn(leaves, step_batch, data_key)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, opt_state = client_opt.update(dict(zip(leaves, grads)), opt_state, p)
        p = apply_updates(p, updates)
        losses.append(loss.detach())
        ns.append(step_batch["weight"].sum())
        # the step's perturbed copy, gradients and updates, freed before the
        # next step's and before the delta (at a 2 G-parameter model, 16 GB)
        del p_eval, leaves, grads, updates
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


def _sim_time_s(latency_fn, base_key: torch.Tensor, round_idx: int, pmask: torch.Tensor,
                K: int) -> float:
    """A barrier round's simulated duration: its slowest participant's
    arrival (0.0 with no latency model)."""
    if latency_fn is None:
        return 0.0
    times = latency_fn(_latency_key(base_key, round_idx), K)
    return float((times * pmask.cpu()).max())


def _delta_payload_stage(plane: ServerPlane, deltas: dict, ef, pmask, ckeys, xkey, stale):
    """The slow path's per-client payloads: (EF-)compression, then the
    delta adversary (``repro/core/fedavg.py:526-561``). A client that does
    not report keeps its residual. Returns (deltas', ef', cmask, stale')."""
    if plane.compression.error_feedback:
        target = {n: d + ef[n] for n, d in deltas.items()}
        del deltas
        sent = plane.compress(target, ckeys)
        sel = {n: (pmask > 0).reshape((-1,) + (1,) * (s.dim() - 1)) for n, s in sent.items()}
        deltas = {n: torch.where(sel[n], s, 0.0) for n, s in sent.items()}
        ef = {n: torch.where(sel[n], target[n] - s, ef[n]) for n, s in sent.items()}
        del sent, target
    elif plane.compression.kind != "none":
        deltas = plane.compress(deltas, ckeys)
    deltas, cmask, stale = plane.corrupt(xkey, deltas, pmask, stale)
    return deltas, ef, cmask, stale


def _server_stage(plane: ServerPlane, deltas: dict, n_k, pmask, ckeys, keys: tuple, ef,
                  stale):
    """Everything the slow path does after the clients: the payload stage,
    then the aggregator. ``keys`` is the round's (aggregation, corruption)
    key pair. Returns (wbar, ef', cmask, stale')."""
    akey, xkey = keys
    deltas, ef, cmask, stale = _delta_payload_stage(plane, deltas, ef, pmask, ckeys, xkey,
                                                    stale)
    return plane.aggregate(deltas, n_k, pmask, akey), ef, cmask, stale


def _fedavg_round_body(loss_fn, client_opt, server_opt, sigma, seed, state: ServerState,
                       round_batch: dict, plane: ServerPlane, latency_fn=None):
    """One FedAvg round: client deltas -> cohort -> compression ->
    corruption -> aggregator -> server optimizer. The metrics carry the
    reference's keys."""
    K = round_batch["weight"].shape[0]
    base_key = keys_lib.PRNGKey(seed)
    ckey, qkey, akey, xkey = _plane_keys(base_key, state.round_idx)
    round_batch, pmask = _apply_cohort(plane, ckey, round_batch)
    ckeys = _client_key_fanout(plane.compression, qkey, K)
    ef, stale = state.ef, state.stale
    cmask = torch.zeros_like(pmask)
    args = (loss_fn, client_opt, sigma, seed, state.params, round_batch, state.round_idx)
    if _streamed_mean(plane):
        wbar, losses, n_k = _aggregate_client_updates(*args)
    else:
        deltas, losses, n_k = _stacked_client_deltas(*args)
        if not _code_fast_path(plane):
            wbar, ef, cmask, stale = _server_stage(plane, deltas, n_k, pmask, ckeys,
                                                   (akey, xkey), ef, stale)
        elif plane.compression.error_feedback:
            wbar, ef = code_domain_aggregate_ef(plane.compression, deltas, n_k, pmask, ckeys,
                                                ef)
        else:
            wbar = code_domain_aggregate(plane.compression, deltas, n_k, pmask, ckeys)
        del deltas
    updates, opt_state = server_opt.update(wbar, state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    n = torch.clamp(n_k.sum(), min=1.0)
    participants = int(pmask.sum())
    metrics = {
        "loss": float((losses * n_k).sum() / n),
        "examples": float(n_k.sum()),
        "delta_norm": math.sqrt(sum(float(x.square().sum()) for x in wbar.values())),
        "corrupted": float(cmask.sum()),
        **_wire_metrics(plane.compression, state.params, participants, K),
        "sim_time_s": _sim_time_s(latency_fn, base_key, state.round_idx, pmask, K),
        "server_steps": 1.0,
        "staleness_mean": 0.0,
    }
    return ServerState(params, opt_state, state.round_idx + 1, ef, stale, state.abuf), metrics


def _make_fedavg_round(loss_fn: Callable, plan: FederatedPlan, seed: int):
    client_opt = sgd(plan.client_lr)
    server_opt = make_server_optimizer(plan)
    plane = _plan_server_plane(plan)
    latency_fn = make_latency_fn(plan.latency) if plan.latency.enabled else None

    def round_step(state: ServerState, round_batch: dict):
        sigma = fvn_lib.fvn_sigma(plan.fvn, state.round_idx) if plan.fvn.enabled else None
        return _fedavg_round_body(loss_fn, client_opt, server_opt, sigma, seed, state,
                                  round_batch, plane, latency_fn)

    return round_step


def _check_fedsgd_aggregator(aggregator: str) -> None:
    if aggregator != "weighted_mean":
        raise ValueError(
            "fedsgd collapses clients into one weighted forward/backward — "
            "per-client deltas never exist, so robust aggregators "
            f"({aggregator!r}) need the fedavg engine"
        )


def _check_fedsgd_compression(compression: Optional[CompressionConfig]) -> None:
    if compression is not None and compression.error_feedback:
        raise ValueError(
            "error feedback keeps a per-client compression residual, but "
            "fedsgd collapses clients into one weighted forward/backward — "
            "per-client deltas never exist; use the fedavg engine"
        )


def _check_fedsgd_corruption(kind: str) -> None:
    if kind in DELTA_KINDS:
        raise ValueError(
            "delta corruptions transform per-client deltas, but fedsgd "
            "collapses clients into one weighted forward/backward — use "
            f"the fedavg engine for corruption kind {kind!r} (the "
            "data-plane 'label_shuffle' adversary works on either engine)"
        )


def _fedsgd_round_body(loss_fn, server_opt, sigma, client_lr: float, seed: int,
                       state: ServerState, round_batch: dict, plane: ServerPlane,
                       latency_fn=None):
    """One fedsgd round: the cohort-masked round batch flattened to
    K·S·b examples, one forward and backward at the (FVN-perturbed)
    round-start weights, wbar = client_lr · grad (compressed as one
    client's delta under a compressed plan), the server optimizer. The
    metrics carry the reference's keys."""
    K, S = round_batch["weight"].shape[:2]
    base_key = keys_lib.PRNGKey(seed)
    ckey, qkey, _, _ = _plane_keys(base_key, state.round_idx)
    round_batch, pmask = _apply_cohort(plane, ckey, round_batch)
    flat = {k: v.reshape((K * S * v.shape[2],) + v.shape[3:]) for k, v in round_batch.items()}
    key = fvn_lib.fvn_key(base_key, state.round_idx, 0, 0)
    p_eval = state.params if sigma is None else fvn_lib.perturb(state.params, key, sigma)
    leaves = {k: v.detach().requires_grad_() for k, v in p_eval.items()}
    loss, _ = loss_fn(leaves, flat, keys_lib.fold_in(key, 1))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    # the delta of the one-step client update
    wbar = {k: client_lr * g.float() for k, g in zip(leaves, grads)}
    del leaves, grads, p_eval
    if plane.compression.kind != "none":
        # the aggregate compressed as one client's delta (the reference's
        # server-side proxy; the wire bytes still count each reporting client)
        wbar = {k: v[0] for k, v in plane.compress({k: v[None] for k, v in wbar.items()},
                                                    qkey[None]).items()}
    updates, opt_state = server_opt.update(wbar, state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    metrics = {
        "loss": float(loss.detach()),
        "examples": float(flat["weight"].sum()),
        "delta_norm": math.sqrt(sum(float(x.square().sum()) for x in wbar.values())),
        # delta corruptions are fedavg-only; label_shuffle is counted host-side
        "corrupted": 0.0,
        **_wire_metrics(plane.compression, state.params, int(pmask.sum()), K),
        "sim_time_s": _sim_time_s(latency_fn, base_key, state.round_idx, pmask, K),
        "server_steps": 1.0,
        "staleness_mean": 0.0,
    }
    return ServerState(params, opt_state, state.round_idx + 1, state.ef, state.stale,
                       state.abuf), metrics


def _make_fedsgd_round(loss_fn: Callable, plan: FederatedPlan, seed: int):
    """The large-model engine: one local step at the round-start weights
    for every client, collapsed into one example-weighted forward and
    backward (``repro/core/fedavg.py:665-692``)."""
    _check_fedsgd_aggregator(plan.aggregation.name)
    _check_fedsgd_compression(plan.compression)
    _check_fedsgd_corruption(plan.corruption.kind)
    server_opt = make_server_optimizer(plan)
    plane = _plan_server_plane(plan)
    latency_fn = make_latency_fn(plan.latency) if plan.latency.enabled else None

    def round_step(state: ServerState, round_batch: dict):
        sigma = fvn_lib.fvn_sigma(plan.fvn, state.round_idx) if plan.fvn.enabled else None
        return _fedsgd_round_body(loss_fn, server_opt, sigma, plan.client_lr, seed, state,
                                  round_batch, plane, latency_fn)

    return round_step


def make_round_step(loss_fn: Callable, plan: FederatedPlan, seed: int):
    """Returns round_step(state, round_batch) -> (state, metrics) of the
    plan's engine.

    round_batch leaves: (K, S_local, b, ...) tensors on the parameters'
    device; "weight" (K, S_local, b) marks real examples (the paper's
    n_k weighting)."""
    if plan.engine == "async":
        from repro_torch.core.async_engine import make_async_round

        return make_async_round(loss_fn, plan, seed)
    if plan.engine == "fedsgd":
        return _make_fedsgd_round(loss_fn, plan, seed)
    return _make_fedavg_round(loss_fn, plan, seed)
