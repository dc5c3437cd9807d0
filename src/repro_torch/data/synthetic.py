"""Synthetic token-LM client data and the data plane's adversary: the
port of ``repro/data/synthetic.py`` (``synthetic_lm_clients`` ``:9``,
``synthetic_lm_batch`` ``:44``, ``label_shuffle`` ``:49-68``). Numpy
only; the same seed gives the reference's arrays bit for bit."""

from __future__ import annotations

import numpy as np


def synthetic_lm_clients(
    num_clients: int,
    vocab_size: int,
    seq_len: int,
    examples_per_client: int,
    concentration: float = 0.5,
    seed: int = 0,
):
    """Returns tokens (C, N, S) int32 with per-client unigram skew.

    Sequences follow a shared bigram backbone (so there is signal to
    learn) re-weighted by a per-client unigram prior (the non-IID part).
    """
    rng = np.random.default_rng(seed)
    V = vocab_size
    ranks = np.arange(1, V + 1)
    base = (1.0 / ranks) / (1.0 / ranks).sum()
    # shared deterministic "grammar": next-token preference table
    shift = rng.integers(1, V, size=V)
    out = np.zeros((num_clients, examples_per_client, seq_len), np.int32)
    for c in range(num_clients):
        crng = np.random.default_rng(seed * 9176 + c + 1)
        prior = crng.dirichlet(base * V * concentration)
        for i in range(examples_per_client):
            t = crng.choice(V, p=prior)
            for s in range(seq_len):
                out[c, i, s] = t
                # mix grammar-following with client-prior resampling
                if crng.random() < 0.7:
                    t = (t + shift[t]) % V
                else:
                    t = crng.choice(V, p=prior)
    return out


def synthetic_lm_batch(batch: int, seq_len: int, vocab_size: int, seed: int = 0):
    """(batch, seq_len) int32 tokens drawn uniformly over the vocabulary."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, size=(batch, seq_len)).astype(np.int32)


def label_shuffle(labels, label_len, valid, rng) -> int:
    """Data-plane adversary: permute one client's (labels, label_len)
    rows among its valid example slots, IN PLACE, so features no longer
    match their transcripts — the client then trains honestly on
    poisoned pairs (the gradient, not the wire, carries the damage).

    ``labels`` is (E, U), ``label_len`` (E,), ``valid`` an (E,) bool
    mask of real (non-padding) slots: only valid rows move, so padded
    zero-length transcripts never land on real features. Returns the
    number of shuffled examples (0 when fewer than two are valid —
    nothing to permute).
    """
    pos = np.flatnonzero(valid)
    if pos.size < 2:
        return 0
    perm = rng.permutation(pos.size)
    labels[pos] = labels[pos[perm]]
    label_len[pos] = label_len[pos[perm]]
    return int(pos.size)
