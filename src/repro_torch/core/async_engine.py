"""Buffered-asynchronous round engine (FedBuff-style streaming server).

The port of ``repro/core/async_engine.py``. The sync engines wait for
every sampled client and aggregate once a round; this engine lets the
clients' uploads arrive in simulated time and steps the server whenever
its buffer fills, as production asynchronous FL does (FedBuff, Nguyen et
al. 2022):

- every wave, the K sampled clients train from the wave's opening
  parameters (the fedavg engine's cohort, client updates and payload
  stage: ``_apply_cohort``, ``_stacked_client_deltas``,
  ``_delta_payload_stage``), so a client computes and uploads what it
  would in a sync round;
- each upload arrives at a time drawn from the device-tier latency model
  (``cohort.LatencyConfig``); the participants arrive in time order (a
  stable sort of the host's fp32 times, the non-participants at +inf
  after them, never arriving);
- arrivals fill the size-B buffer (``AsyncBuffer``) in arrival order; when
  it holds B deltas the server flushes: each delta scaled by its
  staleness discount ``1 / (1 + s)**beta`` (``s`` the server versions
  applied since its client downloaded), the plan's aggregator with the key
  ``fold_in(akey, version)``, then one server optimizer step;
- the buffer persists across waves in ``ServerState.abuf``: an arrival
  that did not fill it waits for a later wave's flush, stale-discounted.

The discount scales each delta before the aggregator, whose weight
normalization would cancel a discount folded into the weights. It is
computed on the host in fp32, so the card and the CPU apply the same
values; it is exactly 1.0 at ``s == 0`` for any beta and at ``beta == 0``
for any s, and a flush whose discounts are all 1.0 scales nothing.

A wave's simulated duration ``sim_time_s`` is the arrival time of its
last flush; a wave with no flush costs its last participant's arrival.
``delta_norm`` is the wave's parameter displacement (a wave applies 0..K
server steps).

Sync parity: with B = K, full participation, one device tier and zero
jitter, every arrival time is equal, the stable sort keeps client order,
and each wave flushes once at staleness 0, folding the deltas in client
order as the sync engine's weighted mean does: the same bits.

The arrival stream is a plain Python loop over the participants, and the
buffer is written in place: a wave consumes the state it is given. The
buffer is indexed by arrival order; the wave's (K, ...) stack is never
copied into that order.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import fvn as fvn_lib
from repro_torch.core import keys as keys_lib
from repro_torch.core.cohort import make_latency_fn
from repro_torch.core.fedavg import (
    ServerPlane,
    ServerState,
    _apply_cohort,
    _client_axis_zeros,
    _client_key_fanout,
    _delta_payload_stage,
    _latency_key,
    _plan_server_plane,
    _plane_keys,
    _stacked_client_deltas,
    _wire_metrics,
)
from repro_torch.core.plan import FederatedPlan, make_server_optimizer
from repro_torch.kernels.ref import xla_exp_f32, xla_log1p_f32
from repro_torch.optim import apply_updates, sgd


class AsyncBuffer(NamedTuple):
    """The server's pending-update buffer (``ServerState.abuf``). Slots
    [0, count) are filled; a flush empties it by resetting ``count``.
    ``version`` counts the server steps applied: the staleness clock."""

    deltas: dict              # {name: (B, ...) fp32} pending client deltas
    weights: torch.Tensor     # (B,) fp32 example counts n_k, on the deltas' device
    versions: torch.Tensor    # (B,) int32 on the host: server version at download
    count: int                # filled slots
    version: int              # server version (flushes so far)


def init_async_buffer(params: dict, buffer_size: int) -> AsyncBuffer:
    device = next(iter(params.values())).device
    return AsyncBuffer(
        deltas=_client_axis_zeros(params, buffer_size),
        weights=torch.zeros((buffer_size,), dtype=torch.float32, device=device),
        versions=torch.zeros((buffer_size,), dtype=torch.int32),
        count=0,
        version=0,
    )


def staleness_discount(staleness, beta: float) -> torch.Tensor:
    """``1/(1+s)**beta`` as ``exp(-beta * log1p(s))`` in fp32 on the host,
    with XLA's CPU exp and log1p (``ref.xla_exp_f32``, ``ref.xla_log1p_f32``),
    so the discount equals the reference's bit for bit: exactly 1.0 at
    s == 0 for any beta and at beta == 0 for any s."""
    s = torch.as_tensor(staleness, dtype=torch.float32).cpu()
    return xla_exp_f32(torch.tensor(-beta, dtype=torch.float32) * xla_log1p_f32(s))


def _flush(plane: ServerPlane, server_opt, buf: AsyncBuffer, params: dict, opt_state,
           akey: torch.Tensor, beta: float):
    """One server step over the full buffer: each slot scaled by its
    discount (in place: the slots are dead after the flush), the
    aggregator, the server optimizer. Returns (params', opt_state', the
    slots' staleness (B,) fp32)."""
    B = buf.weights.shape[0]
    s = (buf.version - buf.versions).float()
    disc = staleness_discount(s, beta)
    if not bool((disc == 1.0).all()):
        for d in buf.deltas.values():
            d.mul_(disc.to(d.device).reshape((B,) + (1,) * (d.dim() - 1)))
    ones = torch.ones((B,), dtype=torch.float32, device=buf.weights.device)
    wbar = plane.aggregate(buf.deltas, buf.weights, ones, keys_lib.fold_in(akey, buf.version))
    updates, opt_state = server_opt.update(wbar, opt_state, params)
    return apply_updates(params, updates), opt_state, s


def _async_round_body(loss_fn, client_opt, server_opt, sigma, seed: int, state: ServerState,
                      round_batch: dict, plane: ServerPlane, latency_fn: Callable,
                      buffer_size: int, beta: float):
    """One wave: cohort -> client deltas -> payload stage -> the arrival
    stream into the buffer, flushing whenever it fills. The metrics carry
    the reference's keys (``repro/core/async_engine.py:229-245``)."""
    K = round_batch["weight"].shape[0]
    base_key = keys_lib.PRNGKey(seed)
    ckey, qkey, akey, xkey = _plane_keys(base_key, state.round_idx)
    round_batch, pmask = _apply_cohort(plane, ckey, round_batch)
    deltas, losses, n_k = _stacked_client_deltas(loss_fn, client_opt, sigma, seed, state.params,
                                                 round_batch, state.round_idx)
    ckeys = _client_key_fanout(plane.compression, qkey, K)
    deltas, ef, cmask, stale = _delta_payload_stage(plane, deltas, state.ef, pmask, ckeys, xkey,
                                                    state.stale)

    times = latency_fn(_latency_key(base_key, state.round_idx), K)  # (K,) fp32, host
    live = pmask.cpu()
    order = torch.argsort(torch.where(live > 0, times, torch.inf), stable=True)
    buf = state.abuf
    v0 = buf.version  # every client of the wave downloaded the opening version
    params, opt_state = state.params, state.opt_state
    flushes, applied, t_last = 0, 0, 0.0
    stale_sum = torch.zeros((), dtype=torch.float32)
    for k in order[: int((live > 0).sum())].tolist():
        slot = buf.count
        for name, d in deltas.items():
            buf.deltas[name][slot].copy_(d[k])
        buf.weights[slot] = n_k[k]
        buf.versions[slot] = v0
        buf = buf._replace(count=slot + 1)
        if buf.count == buffer_size:
            params, opt_state, s = _flush(plane, server_opt, buf, params, opt_state, akey, beta)
            flushes, applied, t_last = flushes + 1, applied + buffer_size, float(times[k])
            stale_sum = stale_sum + s.sum()
            buf = buf._replace(count=0, version=buf.version + 1)
    del deltas

    n = torch.clamp(n_k.sum(), min=1.0)
    participants = int(live.sum())
    disp = math.sqrt(sum(float((params[name] - state.params[name]).float().square().sum())
                         for name in params)) if flushes else 0.0
    metrics = {
        "loss": float((losses * n_k).sum() / n),
        "examples": float(n_k.sum()),
        "delta_norm": disp,
        "corrupted": float(cmask.sum()),
        **_wire_metrics(plane.compression, state.params, participants, K),
        "sim_time_s": t_last if flushes else float((times * live).max()),
        "server_steps": float(flushes),
        "staleness_mean": float(stale_sum / torch.tensor(float(max(applied, 1)))),
    }
    return ServerState(params, opt_state, state.round_idx + 1, ef, stale, buf), metrics


def make_async_round(loss_fn: Callable, plan: FederatedPlan, seed: int):
    """Returns round_step(state, round_batch) -> (state, metrics) for
    ``plan.engine == "async"``; the round batch as the fedavg engine's,
    the state from ``init_server_state`` (it carries the buffer). The
    arrival times always come from ``plan.latency``, enabled or not.
    The step consumes the state it is given: it writes that state's
    buffer (slots, weights, versions) in place, so a caller keeps only
    the returned state and never steps, retries or compares the old one."""
    client_opt = sgd(plan.client_lr)
    server_opt = make_server_optimizer(plan)
    plane = _plan_server_plane(plan)
    latency_fn = make_latency_fn(plan.latency)
    buffer_size = plan.asynchrony.resolve_buffer(plan.clients_per_round)
    beta = plan.asynchrony.staleness_beta

    def round_step(state: ServerState, round_batch: dict):
        sigma = fvn_lib.fvn_sigma(plan.fvn, state.round_idx) if plan.fvn.enabled else None
        return _async_round_body(loss_fn, client_opt, server_opt, sigma, seed, state,
                                 round_batch, plane, latency_fn, buffer_size, beta)

    return round_step
