"""CFMQ — Cost of Federated Model Quality (paper §2.3, Eqs. 1-2).

    mu   = e*N / (b*K)                       average local steps/client
    CFMQ = R * K * (P + alpha * mu * nu)     [bytes]

with R rounds, K clients/round, P round-trip payload bytes, nu peak
client memory per step, alpha the balance term. The paper approximates
P = 2 * model_bytes and nu = 1.1 * model_bytes with alpha = 1.

The port of ``repro/core/cfmq.py``. Under full participation with no
compression the paper's payload formula is exact; a compressed uplink or
a partial cohort is priced by its measured wire bytes
(``measured_payload``). Byte counts are Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CFMQTerms:
    rounds: int
    clients_per_round: int          # K
    payload_bytes: float            # P (round-trip)
    local_steps: float              # mu
    peak_memory_bytes: float        # nu
    alpha: float = 1.0

    @property
    def per_round_bytes(self) -> float:
        return self.clients_per_round * (
            self.payload_bytes + self.alpha * self.local_steps * self.peak_memory_bytes
        )

    @property
    def total_bytes(self) -> float:
        return self.rounds * self.per_round_bytes

    @property
    def total_terabytes(self) -> float:
        return self.total_bytes / 1e12


def mu_local_steps(local_epochs: float, examples_per_round: float,
                   batch_size: float, clients_per_round: float) -> float:
    """Eq. 1: mu = e*N/(b*K)."""
    return local_epochs * examples_per_round / (batch_size * clients_per_round)


def paper_payload(model_bytes: float) -> float:
    """Paper approximation: round trip = 2x model size (exact for an
    fp32 uplink under full participation)."""
    return 2.0 * model_bytes


def paper_peak_memory(model_bytes: float) -> float:
    """Paper approximation: model + 10% intermediate storage."""
    return 1.1 * model_bytes


def wire_payload(downlink_bytes: float, uplink_bytes: float, clients_per_round: int) -> float:
    """Measured per-client round-trip payload P from a round's wire
    totals; with no compression and full participation it equals
    ``paper_payload``."""
    return (downlink_bytes + uplink_bytes) / max(clients_per_round, 1)


def plan_wire_accounting(plan, params: dict) -> tuple[int, int]:
    """(uplink bytes per reporting client, downlink bytes per round) as
    exact Python ints over the parameter shapes, the uplink compressed as
    the plan says."""
    from repro_torch.core.compression import client_wire_bytes, tree_param_bytes

    return (client_wire_bytes(plan.compression, params),
            plan.clients_per_round * tree_param_bytes(params))


def measured_payload(plan, params: dict, mean_participants: float) -> Optional[float]:
    """None on the paper's plane (no compression, full participation):
    callers use ``paper_payload``. Else the wire-accurate per-client P
    with the uplink scaled by the mean number of reporting clients. An
    adversary does not enter: a corrupted participant uploads a full
    payload."""
    if plan.compression.kind == "none" and plan.cohort.full:
        return None
    up_per_client, down_per_round = plan_wire_accounting(plan, params)
    return wire_payload(down_per_round, up_per_client * mean_participants,
                        plan.clients_per_round)


def round_wire_bytes(up_per_client: int, down_per_round: int, participants) -> int:
    """Exact bytes one round puts on the wire."""
    return int(down_per_round) + int(up_per_client) * int(round(float(participants)))


def accumulate_wire_bytes(up_per_client: int, down_per_round: int, participants) -> int:
    """The exact wire bytes of a run from its rounds' participant counts."""
    return sum(round_wire_bytes(up_per_client, down_per_round, p) for p in participants)


def seconds_to_target(losses, sim_times_s, target: float) -> Optional[float]:
    """CFMQ's wall-clock axis: the simulated seconds until the loss curve
    first reaches ``target`` (round r costs the cumulative simulated time
    through r), or None if it never does, which keeps a run that never
    converges off the frontier."""
    total = 0.0
    for loss, t in zip(losses, sim_times_s):
        total += float(t)
        if float(loss) <= target:
            return total
    return None


def cfmq(
    rounds: int,
    clients_per_round: int,
    model_bytes: float,
    local_epochs: float = 1.0,
    examples_per_round: Optional[float] = None,
    batch_size: float = 1.0,
    alpha: float = 1.0,
    payload_bytes: Optional[float] = None,
    peak_memory_bytes: Optional[float] = None,
    local_steps: Optional[float] = None,
) -> CFMQTerms:
    """Build CFMQ terms with the paper's approximations as defaults."""
    if local_steps is None:
        if examples_per_round is None:
            raise ValueError("cfmq needs local_steps or examples_per_round")
        local_steps = mu_local_steps(local_epochs, examples_per_round,
                                     batch_size, clients_per_round)
    return CFMQTerms(
        rounds=rounds,
        clients_per_round=clients_per_round,
        payload_bytes=paper_payload(model_bytes) if payload_bytes is None else payload_bytes,
        local_steps=local_steps,
        peak_memory_bytes=(paper_peak_memory(model_bytes)
                           if peak_memory_bytes is None else peak_memory_bytes),
        alpha=alpha,
    )
