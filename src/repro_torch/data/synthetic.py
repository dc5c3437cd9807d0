"""The data plane's adversary: the port of ``repro/data/synthetic.py``'s
``label_shuffle`` (``:49-68``). The LM client generators of that module
wait for the LM tasks (ROADMAP M8)."""

from __future__ import annotations

import numpy as np


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
