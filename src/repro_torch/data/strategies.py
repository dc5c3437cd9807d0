"""Client sampling strategies for federated rounds.

The port's own copy of ``repro/data/strategies.py`` for plain corpora:
the same draws from the same generator, so a seed selects the same
clients in both packages. The virtual-population draws wait for
``VirtualPopulation``.

- ``uniform``: the paper's default — every speaker equally likely.
- ``weighted-by-examples``: selection probability proportional to the
  client's utterance count.
- ``stratified``: split speakers into utterance-count quantile strata
  and draw round-robin across strata.

A strategy is ``fn(rng, corpus, k) -> (k,) int64`` of distinct client
ids.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

Strategy = Callable[[np.random.Generator, object, int], np.ndarray]

_STRATEGIES: Dict[str, Strategy] = {}


def register_strategy(name: str):
    def deco(fn: Strategy) -> Strategy:
        _STRATEGIES[name] = fn
        return fn

    return deco


def get_strategy(name: str) -> Strategy:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown client sampling strategy {name!r}; available: {sorted(_STRATEGIES)}"
        ) from None


def available_strategies() -> list[str]:
    return sorted(_STRATEGIES)


@register_strategy("uniform")
def uniform(rng: np.random.Generator, corpus, k: int) -> np.ndarray:
    return rng.choice(corpus.num_speakers, size=k, replace=False)


@register_strategy("weighted-by-examples")
def weighted_by_examples(rng: np.random.Generator, corpus, k: int) -> np.ndarray:
    counts = corpus.counts.astype(np.float64)
    return rng.choice(corpus.num_speakers, size=k, replace=False, p=counts / counts.sum())


@register_strategy("stratified")
def stratified(rng: np.random.Generator, corpus, k: int) -> np.ndarray:
    """Round-robin over utterance-count quantile strata (Fig. 2 skew)."""
    n_strata = int(min(4, k, corpus.num_speakers))
    # speakers sorted by count, split into n_strata near-equal bins
    order = np.argsort(corpus.counts, kind="stable")
    strata = np.array_split(order, n_strata)
    # shuffle within each stratum, then deal clients round-robin
    pools = [rng.permutation(s) for s in strata]
    chosen = []
    i = 0
    while len(chosen) < k:
        pool = pools[i % n_strata]
        j = i // n_strata
        if j < len(pool):
            chosen.append(pool[j])
        i += 1
        if i >= n_strata * max(len(p) for p in pools):
            break
    return np.asarray(chosen[:k], np.int64)
