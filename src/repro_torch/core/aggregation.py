"""Server-side aggregation: the registry of rules that reduce client deltas.

The port of ``repro/core/aggregation.py``. Every aggregator takes
(deltas, n_k, pmask, hypers, key): ``deltas`` is {name: (K, ...)}, the
clients' deltas stacked per leaf; ``n_k`` and ``pmask`` are (K,), dropped
clients already at 0; ``hypers`` holds ``trim_frac``, ``dp_clip`` and
``dp_sigma``; ``key`` is the round's aggregation key (``core/keys.py``).

- ``weighted_mean``: the paper's sum of (n_k / n) delta_k.
- ``trimmed_mean``: per coordinate, the ``trim_frac`` lowest and highest
  participants dropped and the rest averaged.
- ``coordinate_median``: the per-coordinate median over participants.
- ``clipped_mean``: each client's delta clipped to L2 norm ``dp_clip``,
  the uniform mean over participants, plus N(0, (dp_sigma * dp_clip /
  m)^2) noise (DP-FedAvg).

The robust rules treat a coordinate that is NaN or infinite like a
non-participant, excluded per coordinate with ``where`` (a mask multiply
would keep NaN * 0 = NaN); ``clipped_mean`` gives a client with any such
coordinate weight 0. Ranks come from two stable sorts, so tied values
(common after quantization) get distinct ranks.

Sums over the clients are written as one fold in client order, each term
its own product, so the card and the CPU add in the same order.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core.compression import jax_leaf_order
from repro_torch.kernels import threefry_normal

Aggregator = Callable[..., dict]

_AGGREGATORS: Dict[str, Aggregator] = {}

# the aggregators' knobs and their plan defaults (plan.AggregatorConfig)
AGG_HYPER_DEFAULTS = {"trim_frac": 0.1, "dp_clip": 1.0, "dp_sigma": 0.0}


def register_aggregator(name: str):
    def deco(fn: Aggregator) -> Aggregator:
        _AGGREGATORS[name] = fn
        return fn

    return deco


def get_aggregator(name: str) -> Aggregator:
    try:
        return _AGGREGATORS[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; "
                       f"available: {sorted(_AGGREGATORS)}") from None


def available_aggregators() -> list[str]:
    return sorted(_AGGREGATORS)


def _client_fold(w, d: torch.Tensor) -> torch.Tensor:
    """sum_k w[k] * d[k] over the leading axis in client order from 0, or
    sum_k d[k] with ``w`` None."""
    out = torch.zeros(d.shape[1:], dtype=torch.float32, device=d.device)
    for k in range(d.shape[0]):
        out = out + (d[k] if w is None else w[k] * d[k])
    return out


@register_aggregator("weighted_mean")
def weighted_mean(deltas: dict, n_k, pmask, hypers, key) -> dict:
    """The paper's sum_k (n_k / n) delta_k."""
    n = torch.clamp(n_k.sum(), min=1.0)
    w = (n_k / n).float()
    return {name: _client_fold(w, d.float()) for name, d in deltas.items()}


def _contributors(flat: torch.Tensor, pmask: torch.Tensor) -> torch.Tensor:
    """(K, M) bool: participating and finite, per coordinate."""
    return (pmask[:, None] > 0) & torch.isfinite(flat)


def _contributor_ranks(flat: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Each client's rank per coordinate among the contributors, which come
    first (the others sort as +inf); ties ranked in client order."""
    vals = torch.where(ok, flat, torch.inf)
    order = torch.argsort(vals, dim=0, stable=True)
    return torch.argsort(order, dim=0, stable=True).float()


def _masked_mean(flat: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The mean of flat over ``keep`` per coordinate; a dropped NaN or
    infinity cannot come back as NaN * 0."""
    cnt = torch.clamp(keep.sum(dim=0).float(), min=1.0)
    return _client_fold(None, torch.where(keep, flat, 0.0)) / cnt


def _robust(d: torch.Tensor, pmask: torch.Tensor, keep_rule) -> torch.Tensor:
    flat = d.float().reshape(d.shape[0], -1)
    ok = _contributors(flat, pmask)
    m = torch.clamp(ok.sum(dim=0).float(), min=1.0)  # (M,)
    keep = keep_rule(_contributor_ranks(flat, ok), m) & ok
    return _masked_mean(flat, keep).reshape(d.shape[1:])


@register_aggregator("trimmed_mean")
def trimmed_mean(deltas: dict, n_k, pmask, hypers, key) -> dict:
    trim = hypers["trim_frac"]

    def keep(ranks, m):
        # trimmed a side, clamped so that one client always survives
        t = torch.minimum(torch.clamp(torch.floor(trim * m), min=0.0),
                          torch.ceil(m / 2.0) - 1.0)
        return (ranks >= t) & (ranks < m - t)

    return {name: _robust(d, pmask, keep) for name, d in deltas.items()}


@register_aggregator("coordinate_median")
def coordinate_median(deltas: dict, n_k, pmask, hypers, key) -> dict:
    def keep(ranks, m):
        lo = torch.floor((m - 1.0) / 2.0)
        hi = torch.ceil((m - 1.0) / 2.0)
        return (ranks == lo) | (ranks == hi)

    return {name: _robust(d, pmask, keep) for name, d in deltas.items()}


@register_aggregator("clipped_mean")
def clipped_mean(deltas: dict, n_k, pmask, hypers, key) -> dict:
    """DP-FedAvg: per-client L2 clip, the uniform mean over participants,
    then Gaussian noise at the clip-bounded sensitivity clip / m. A client
    with any non-finite coordinate gets weight 0 and its coordinates are
    zeroed before the sum. The squared norm sums the leaves in the
    reference's tree order, and leaf i of that order draws its noise from
    ``split(key, L)[i]``. With ``dp_sigma`` 0 no noise is drawn."""
    names = jax_leaf_order(deltas)
    device = pmask.device
    f32 = dict(dtype=torch.float32, device=device)
    clip = torch.tensor(hypers["dp_clip"], **f32)
    sigma = hypers["dp_sigma"]
    m = torch.clamp(pmask.sum(), min=1.0)
    sq = 0
    for name in names:
        d = deltas[name]
        sq = sq + d.float().square().reshape(d.shape[0], -1).sum(dim=1)
    finite = torch.isfinite(sq)
    scale = torch.clamp(clip / torch.sqrt(torch.clamp(sq, min=1e-24)), max=1.0)
    w = torch.where(finite, scale, 0.0) * pmask / m
    noise_std = torch.tensor(hypers["dp_sigma"] * hypers["dp_clip"], **f32) / m
    out = {}
    for name in names:
        d = deltas[name]
        out[name] = _client_fold(w, torch.where(torch.isfinite(d), d, 0.0).float())
    if sigma != 0.0:  # one normal kernel launch for every leaf
        noisy = threefry_normal.normal_axpy([out[n] for n in names],
                                            keys_lib.split(key.cpu(), len(names)),
                                            [noise_std] * len(names))
        out = dict(zip(names, noisy))
    return {name: out[name] for name in deltas}
