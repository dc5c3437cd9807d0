"""Federated round batching: client selection, data limiting, packing.

The port's own copy of ``repro/data/pipeline.py`` for plain corpora:
numpy only, and the same seed packs bitwise-equal round batches, with the
data-plane ``label_shuffle`` adversary (``label_shuffle_rate``), the
IID packer ``pack_round``, a forced step count (``steps``, with
``RoundBatch.pad_steps``) and the per-client evaluation batch
(``per_client_eval_batch``). Virtual populations wait for ROADMAP M9; the
legacy per-example packer, the reference's parity oracle, is left out.

A round batch is a fixed-shape set of arrays:
    features : (K, S, B, T, F)   S = local steps, B = local batch
    labels   : (K, S, B, U)
    label_len, frame_len : (K, S, B)
    mask     : (K, S, B)  1.0 for real examples, 0.0 for padding
    n_k      : (K,)       number of real examples per client (paper's n_k)

The *data limit* L (paper §4.2.1) caps how many examples a client
contributes in one round; per-client cursors still traverse the whole
local dataset over the rounds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.data.strategies import get_strategy
from repro_torch.data.synthetic import label_shuffle


@dataclasses.dataclass
class RoundBatch:
    features: np.ndarray
    labels: np.ndarray
    label_len: np.ndarray
    frame_len: np.ndarray
    mask: np.ndarray
    n_k: np.ndarray

    def engine_batch(self) -> dict:
        """The round engine's input layout (mask enters as "weight")."""
        return {"features": self.features, "labels": self.labels,
                "frame_len": self.frame_len, "label_len": self.label_len,
                "weight": self.mask}

    def pad_steps(self, steps: int) -> "RoundBatch":
        """Weight-0 local steps appended up to ``steps``: exact no-ops under
        the engine's n_k weighting (a step's loss and gradient are 0)."""
        S = self.mask.shape[1]
        if steps <= S:
            return self

        def pad(a):
            return np.concatenate([a, np.zeros((a.shape[0], steps - S) + a.shape[2:], a.dtype)],
                                  axis=1)

        return RoundBatch(pad(self.features), pad(self.labels), pad(self.label_len),
                          pad(self.frame_len), pad(self.mask), self.n_k)


class FederatedSampler:
    """Selects K clients per round and packs their (possibly limited)
    local datasets into fixed-shape round batches."""

    def __init__(
        self,
        corpus,
        clients_per_round: int,
        local_batch_size: int,
        data_limit: Optional[int] = None,
        local_epochs: int = 1,
        seed: int = 0,
        max_steps=None,
        steps: Optional[int] = None,
        strategy: str = "uniform",
        label_shuffle_rate: float = 0.0,
    ):
        self.corpus = corpus
        self.K = clients_per_round
        self.b = local_batch_size
        self.data_limit = data_limit
        self.local_epochs = local_epochs
        self.rng = np.random.default_rng(seed)
        self._select = get_strategy(strategy)
        # the label_shuffle adversary: each round, Bernoulli(rate)-selected
        # clients get their round labels permuted among their real
        # examples. Its own RNG keeps the selection and packing stream
        # byte-identical to an uncorrupted run at rate 0.
        self.label_shuffle_rate = float(label_shuffle_rate)
        self._corrupt_rng = np.random.default_rng((seed + 1) * 0xC0FFEE)
        self.corrupted_counts: list = []
        # per-client cursors, created on first visit; each client's
        # first order is seeded by its own id
        self._seed = seed
        self._cursors: dict = {}
        self._orders: dict = {}
        # ``steps`` forces the local-step count S (a sweep pads its points
        # to one shape); else the count the data needs
        self.steps = int(steps) if steps is not None else self.natural_steps(
            corpus, local_batch_size, data_limit=data_limit, local_epochs=local_epochs,
            max_steps=max_steps)

    @staticmethod
    def natural_steps(corpus, local_batch_size: int, data_limit: Optional[int] = None,
                      local_epochs: int = 1, max_steps: Optional[int] = None) -> int:
        """The local-step count a round needs to hold every selected
        client's (possibly limited) contribution — the single source of
        truth for batch shapes AND for CFMQ mu accounting."""
        n_max = data_limit if data_limit is not None else int(corpus.counts.max())
        steps = max(1, int(np.ceil(local_epochs * n_max / local_batch_size)))
        if max_steps is not None:
            steps = min(steps, max_steps)
        return steps

    def _count(self, cid: int) -> int:
        return int(self.corpus.counts[cid])

    def _order(self, cid: int) -> np.ndarray:
        o = self._orders.get(cid)
        if o is None:
            o = np.random.default_rng(self._seed + 7 * cid).permutation(self._count(cid))
            self._orders[cid] = o
        return o

    def _client_indices(self, cid: int) -> np.ndarray:
        """This round's example indices for one client (length = limit),
        advancing the cursor with a reshuffle at each full pass."""
        n = self._count(cid)
        limit = min(self.data_limit, n) if self.data_limit is not None else n
        c = int(self._cursors.get(cid, 0))
        order = self._order(cid)
        pos = c % n
        if limit <= n - pos and not (pos == 0 and c > 0):
            # the whole contribution sits inside the current pass
            self._cursors[cid] = c + limit
            return order[pos:pos + limit]
        out = np.empty(limit, np.int64)
        filled = 0
        while filled < limit:
            if c % n == 0 and c > 0:
                order = self.rng.permutation(n)
                self._orders[cid] = order
            take = min(n - c % n, limit - filled)
            out[filled:filled + take] = order[c % n:c % n + take]
            filled += take
            c += take
        self._cursors[cid] = c
        return out

    def _gather_indices(self, chosen: np.ndarray):
        """(K, S*b) example-index matrix (-1 = padding) + per-client n_k."""
        E = self.steps * self.b
        ex = np.full((len(chosen), E), -1, np.int64)
        n_k = np.zeros((len(chosen),), np.float32)
        for j, cid in enumerate(chosen):
            idx = self._client_indices(int(cid))
            if self.local_epochs > 1:
                idx = np.tile(idx, self.local_epochs)
            m = min(len(idx), E)
            ex[j, :m] = idx[:m]
            n_k[j] = m
        return ex, n_k

    def _shuffle_labels(self, rb: RoundBatch) -> RoundBatch:
        """The label_shuffle adversary on Bernoulli-selected clients, in
        place on the freshly packed (copied, contiguous) arrays; the
        round's corrupted-client count is appended to
        ``corrupted_counts``."""
        K = rb.labels.shape[0]
        hit = self._corrupt_rng.random(K) < self.label_shuffle_rate
        # (K, S, b, ...) -> (K, S*b, ...) views onto the same memory
        labels = rb.labels.reshape(K, -1, rb.labels.shape[-1])
        label_len = rb.label_len.reshape(K, -1)
        mask = rb.mask.reshape(K, -1)
        for k in np.flatnonzero(hit):
            label_shuffle(labels[k], label_len[k], mask[k] > 0, self._corrupt_rng)
        self.corrupted_counts.append(int(hit.sum()))
        return rb

    def next_round(self) -> RoundBatch:
        rb = self._next_round()
        if self.label_shuffle_rate > 0.0:
            rb = self._shuffle_labels(rb)
        return rb

    def _next_round(self) -> RoundBatch:
        K, b, S = self.K, self.b, self.steps
        chosen = np.asarray(self._select(self.rng, self.corpus, K), np.int64)
        ex, n_k = self._gather_indices(chosen)
        pad = ex < 0
        np.copyto(ex, 0, where=pad)                  # safe gather index
        rows = chosen[:, None]
        c = self.corpus
        # fancy-indexing copies, so padded slots can be zeroed in place
        feats = c.arena_features[rows, ex]           # (K, S*b, T, F)
        labels = c.arena_labels[rows, ex]
        label_len = c.arena_label_len[rows, ex]
        frame_len = c.arena_frame_len[rows, ex]
        if pad.any():
            feats[pad] = 0.0
            labels[pad] = 0
            label_len[pad] = 0
            frame_len[pad] = 0
        mask = (~pad).astype(np.float32)
        T, F = feats.shape[2:]
        U = labels.shape[-1]
        return RoundBatch(
            feats.reshape(K, S, b, T, F),
            labels.reshape(K, S, b, U),
            label_len.reshape(K, S, b),
            frame_len.reshape(K, S, b),
            mask.reshape(K, S, b),
            n_k,
        )


def per_client_eval_batch(corpus, client_ids, n: int = 4) -> dict:
    """The per-client evaluation plane's batch (``core/clienteval.py``):
    each tracked client's first ``n`` arena examples in the engine-batch
    layout with a leading client axis,

        features : (C, n, T, F)    labels : (C, n, U)
        frame_len, label_len, weight : (C, n)

    The first examples, not a draw, so the panel measures the same
    utterances every round. A client with fewer than ``n`` examples pads
    with weight-0 slots (a clipped gather, then zeroed)."""
    ids = np.asarray(client_ids, np.int64)
    counts = np.asarray(corpus.counts, np.int64)[ids]
    cols = np.arange(n, dtype=np.int64)[None, :]
    pad = cols >= counts[:, None]
    ex = np.minimum(cols, np.maximum(counts[:, None] - 1, 0))
    rows = ids[:, None]
    feats = corpus.arena_features[rows, ex]
    labels = corpus.arena_labels[rows, ex]
    label_len = corpus.arena_label_len[rows, ex]
    frame_len = corpus.arena_frame_len[rows, ex]
    if pad.any():
        feats[pad] = 0.0
        labels[pad] = 0
        label_len[pad] = 0
        frame_len[pad] = 0
    return {"features": feats, "labels": labels, "frame_len": frame_len,
            "label_len": label_len, "weight": (~pad).astype(np.float32)}


def pack_round(examples: dict, K: int, steps: int, batch: int) -> RoundBatch:
    """Pack a flat example dict into a (K, steps, batch, ...) round — the
    IID baseline's rounds, drawn from the global pool; a pool shorter
    than K·steps·batch wraps around (``np.resize``)."""
    need = K * steps * batch
    n = examples["labels"].shape[0]
    idx = np.resize(np.arange(n), need)
    feats = examples["features"][idx].reshape(K, steps, batch, *examples["features"].shape[1:])
    labels = examples["labels"][idx].reshape(K, steps, batch, -1)
    label_len = examples["label_len"][idx].reshape(K, steps, batch)
    frame_len = examples["frame_len"][idx].reshape(K, steps, batch)
    mask = np.ones((K, steps, batch), np.float32)
    n_k = np.full((K,), steps * batch, np.float32)
    return RoundBatch(feats, labels, label_len, frame_len, mask, n_k)
