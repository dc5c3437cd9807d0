"""The summary-row schema of a run.

The port's copy of ``repro/core/metrics.py:56-106`` (``SUMMARY_KEYS``,
``summary_row``) and of ``repro/core/clienteval.py:34-59``
(``SPREAD_KEYS``, ``empty_spread``): a run without the per-client
evaluation plane (``core/clienteval.py``) reports the empty fairness
spread.
"""

from __future__ import annotations

from typing import Optional

# Keys of one run summary, grouped: quality, per-client fairness spread,
# CFMQ cost, wire accounting, cohort and adversary tallies, wall-clock
# axis, run bookkeeping. "quality"/"quality_hard" are in the task's
# metric, named by "quality_metric" (WER for the RNN-T; lower is better).
SUMMARY_KEYS = (
    "rounds",
    "final_loss",
    "quality",
    "quality_hard",
    "quality_metric",
    "client_loss_p10",
    "client_loss_p90",
    "client_loss_gap",
    "client_quality_p10",
    "client_quality_p90",
    "client_quality_gap",
    "clients_tracked",
    "cfmq_tb",
    "cfmq_bytes",
    "payload_bytes",
    "uplink_bytes_client",
    "uplink_bytes_total",
    "wire_bytes_total",
    "downlink_bytes_round",
    "participants_mean",
    "corrupted_mean",
    "corrupted_total",
    "n_params",
    "sim_time_s",
    "server_steps_total",
    "staleness_mean",
    "wall_s",
)

# The per-client fairness spread (p10/p90/gap of loss and quality over a
# client panel) and the panel's size.
SPREAD_KEYS = (
    "client_loss_p10",
    "client_loss_p90",
    "client_loss_gap",
    "client_quality_p10",
    "client_quality_p90",
    "client_quality_gap",
    "clients_tracked",
)


def empty_spread() -> dict:
    """The spread fields when per-client eval is off: zeros, tracked
    count 0."""
    out = {k: 0.0 for k in SPREAD_KEYS}
    out["clients_tracked"] = 0
    return out


def summary_row(extras: Optional[dict] = None, **fields) -> dict:
    """Build one summary row, strictly: every ``SUMMARY_KEYS`` field
    must be present and nothing else may ride as a field. Emitter-
    specific keys (curves, ids) go in ``extras`` and may not shadow a
    schema field."""
    missing = [k for k in SUMMARY_KEYS if k not in fields]
    unknown = [k for k in fields if k not in SUMMARY_KEYS]
    if missing or unknown:
        raise ValueError(
            f"summary_row: missing fields {missing}, unknown fields {unknown} "
            "(schema drift — see repro_torch.core.metrics.SUMMARY_KEYS)")
    extras = dict(extras or {})
    shadowed = [k for k in extras if k in SUMMARY_KEYS]
    if shadowed:
        raise ValueError(
            f"summary_row: extras {shadowed} shadow schema fields — pass "
            "them as fields, not extras")
    row = {k: fields[k] for k in SUMMARY_KEYS}
    row.update(extras)
    return row
