"""FederatedPlan — the experiment configuration of the paper's Alg. 1.

The port of ``repro/core/plan.py`` with full participation, the
example-weighted mean, no adversary, no latency model, and the
``fedavg`` engine with an Adam or SGD server; the uplink may be
compressed (``CompressionConfig``, the reference's own config), which
under the weighted mean always takes the code-domain fast path. The
reference's other nested server-plane configs are flattened here to the
one field each that selects a plane; a plan that sets any of them off
the parity plane raises ``NotImplementedError`` naming the ROADMAP item
that ports it, so no setting is ever ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.compression import CompressionConfig


@dataclasses.dataclass(frozen=True)
class FVNConfig:
    """Federated Variational Noise (paper §4.2.2): per-client Gaussian
    weight noise at each local step, std ramped linearly over rounds."""

    enabled: bool = False
    std: float = 0.01  # target std (E5: 0.01, E6: 0.02, E7: ramp to 0.03)
    ramp_rounds: int = 0  # 0 = constant std; >0 = linear 0 -> std


# field -> (parity value, the ROADMAP item that ports the other values)
_PARITY = {
    "engine": ("fedavg", "M5 (fedsgd) / M7 (async)"),
    "server_optimizer": (("adam", "sgd"), "M2 (momentum, yogi)"),
    "participation": (1.0, "M6 (core/cohort.py)"),
    "straggler_frac": (0.0, "M6 (core/cohort.py)"),
    "aggregator": ("weighted_mean", "M6 (core/aggregation.py)"),
    "corruption": ("none", "M6 (core/corruption.py)"),
    "latency": (False, "M6 (core/cohort.py latency model)"),
}


@dataclasses.dataclass(frozen=True)
class FederatedPlan:
    clients_per_round: int = 4  # K (paper sweeps 32 -> 128)
    local_batch_size: int = 2  # b
    local_epochs: int = 1  # e
    local_steps: Optional[int] = None  # fixed step count (engine shape); None = from data
    data_limit: Optional[int] = None  # paper §4.2.1 non-IID dial (None = no limit)
    client_sampling: str = "uniform"  # see repro_torch.data.strategies
    client_lr: float = 0.008  # paper's coarse-swept client SGD lr
    server_optimizer: str = "adam"  # "adam" | "sgd"
    server_lr: float = 1e-3
    server_warmup_rounds: int = 0  # linear ramp-up (Baseline style)
    server_decay_rounds: int = 0  # >0: exponential decay (E9/E10 style)
    server_decay_rate: float = 0.9
    fvn: FVNConfig = dataclasses.field(default_factory=FVNConfig)
    engine: str = "fedavg"
    # server plane: the uplink compression, then one field each standing
    # for the reference's config of the same stage (CohortConfig,
    # AggregatorConfig.name, CorruptionConfig.kind, LatencyConfig.enabled)
    compression: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)
    participation: float = 1.0
    straggler_frac: float = 0.0
    aggregator: str = "weighted_mean"
    corruption: str = "none"
    latency: bool = False
    # CFMQ constants (paper §4.3.1)
    alpha: float = 1.0
    param_bytes: int = 4  # bytes per parameter on the wire

    def __post_init__(self):
        if not isinstance(self.compression, CompressionConfig):
            raise TypeError(f"compression must be a CompressionConfig, got "
                            f"{self.compression!r}")
        for name, (parity, item) in _PARITY.items():
            value = getattr(self, name)
            allowed = parity if isinstance(parity, tuple) else (parity,)
            if value not in allowed:
                raise NotImplementedError(
                    f"{name}={value!r} is off the FedAvg parity plane; the port runs "
                    f"{name} in {allowed} until ROADMAP {item} is ported")


def server_lr_schedule(plan: FederatedPlan):
    from repro_torch.optim import constant, linear_rampup, linear_rampup_exp_decay

    if plan.server_decay_rounds > 0:
        return linear_rampup_exp_decay(
            plan.server_lr,
            max(plan.server_warmup_rounds, 1),
            plan.server_decay_rounds,
            plan.server_decay_rate,
        )
    if plan.server_warmup_rounds > 0:
        return linear_rampup(plan.server_lr, plan.server_warmup_rounds)
    return constant(plan.server_lr)


def make_server_optimizer(plan: FederatedPlan):
    from repro_torch import optim

    make = {"adam": optim.adam, "sgd": optim.sgd}[plan.server_optimizer]
    return make(server_lr_schedule(plan))
