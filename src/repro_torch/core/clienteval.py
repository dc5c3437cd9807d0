"""Per-client evaluation plane: quality per client, not just the fleet.

The port of ``repro/core/clienteval.py``. Fleet-average WER hides a long
tail under speaker-split non-IID data: some clients improve far less
than the average. A ``ClientEvalPlane`` fixes a panel of clients when it
is built, packs each one's first ``n`` arena examples once
(``data.per_client_eval_batch``: the same utterances every round, so the
curves move only because the model moved) and measures each round

- ``client_loss``: (C,) the task loss of each tracked client
  (``FederatedTask.client_loss``: each client's loss over its examples,
  as the reference's vmap over the client axis);
- ``client_quality``: (C,) the task's metric of each client
  (``FederatedTask.client_quality``): WER through one greedy decode over
  the panel for the RNN-T, clipped perplexity for the enc-dec and the
  language models, the weighted error rate for the keyword classifier.

``fairness_spread`` reduces the last round's panel to the summary
schema's fields (p10/p90/gap of loss and quality, ``clients_tracked``;
``core/metrics.py:SPREAD_KEYS``); the per-round curves go into the
emitters' ``extras["client_eval"]``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import empty_spread
from repro_torch.data import per_client_eval_batch


def default_panel(corpus, clients: int) -> np.ndarray:
    """Client ids evenly spaced over the population, so every point of a
    sweep tracks the same clients and the spreads compare across rows."""
    num = int(getattr(corpus, "num_clients", None) or corpus.num_speakers)
    clients = min(clients, num)
    return np.unique(np.linspace(0, num - 1, clients).astype(np.int64))


def fairness_spread(client_loss, client_quality) -> dict:
    """p10/p90/gap over the panel, of the loss and of the task metric: the
    gap (p90 - p10) is how much worse the worst-served decile of clients
    has it than the best-served."""
    loss = np.asarray(client_loss, np.float64)
    qual = np.asarray(client_quality, np.float64)
    lo_l, hi_l = np.percentile(loss, [10.0, 90.0])
    lo_q, hi_q = np.percentile(qual, [10.0, 90.0])
    return {
        "client_loss_p10": float(lo_l),
        "client_loss_p90": float(hi_l),
        "client_loss_gap": float(hi_l - lo_l),
        "client_quality_p10": float(lo_q),
        "client_quality_p90": float(hi_q),
        "client_quality_gap": float(hi_q - lo_q),
        "clients_tracked": int(loss.shape[0]),
    }


class ClientEvalPlane:
    """A fixed client panel measured once a round::

        plane = ClientEvalPlane(task, corpus, clients=6)
        for r in range(rounds):
            state, metrics = engine.step(state, batch)
            plane.measure(state.params)
        row = summary_row(**plane.spread(), ...)
        extras = {"client_eval": plane.curves()}
    """

    def __init__(self, task, corpus, clients: int = 6, n: int = 4, client_ids=None):
        self.task = task
        self.client_ids = (np.asarray(client_ids, np.int64) if client_ids is not None
                           else default_panel(corpus, clients))
        self.batch = per_client_eval_batch(corpus, self.client_ids, n=n)
        self.history: list = []

    def measure(self, params: dict) -> dict:
        """One round's panel: each client's loss and quality."""
        rec = {"client_loss": self.task.client_loss(params, self.batch),
               "client_quality": self.task.client_quality(params, self.batch)}
        self.history.append(rec)
        return rec

    def spread(self) -> dict:
        """The summary's fairness fields from the last measured round;
        ``empty_spread()`` if none ran."""
        if not self.history:
            return empty_spread()
        last = self.history[-1]
        return fairness_spread(last["client_loss"], last["client_quality"])

    def curves(self) -> dict:
        """The per-round per-client curves, JSON-ready: {client_ids (C,),
        quality_metric, client_loss (R, C), client_quality (R, C)}."""
        return {
            "client_ids": self.client_ids.tolist(),
            "quality_metric": self.task.quality_metric,
            "client_loss": [r["client_loss"].tolist() for r in self.history],
            "client_quality": [r["client_quality"].tolist() for r in self.history],
        }
