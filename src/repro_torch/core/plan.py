"""FederatedPlan — the experiment configuration of the paper's Alg. 1.

The port of ``repro/core/plan.py`` for its three engines (``fedavg``,
``fedsgd`` and the buffered-async ``async``) and the four server
optimizers (``adam``, ``sgd``, ``momentum``, ``yogi``). The server plane's
configs are the reference's own:
``CohortConfig`` (partial participation, stragglers), ``CompressionConfig``
(the uplink), ``AggregatorConfig`` (the aggregation rule and its knobs),
``CorruptionConfig`` (the adversary, the data-plane ``label_shuffle``
among them), ``LatencyConfig`` (simulated arrival times) and
``AsyncConfig`` (the async engine's buffer and staleness discount). The
experiment ladder E0–E10 is expressed as plans (``core/experiments.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.aggregation import available_aggregators
from repro_torch.core.cohort import LatencyConfig
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.corruption import CorruptionConfig


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Cohort dynamics (``core/cohort.py``): the fraction of sampled
    clients that report back and the straggler deadline model."""

    participation: float = 1.0  # P(sampled client reports back)
    straggler_frac: float = 0.0  # P(reporting client hits the deadline)
    straggler_keep: float = 0.5  # fraction of local steps a straggler completes

    @property
    def full(self) -> bool:
        """True iff the cohort is the paper's all-K-report assumption."""
        return self.participation >= 1.0 and self.straggler_frac <= 0.0


@dataclasses.dataclass(frozen=True)
class FVNConfig:
    """Federated Variational Noise (paper §4.2.2): per-client Gaussian
    weight noise at each local step, std ramped linearly over rounds."""

    enabled: bool = False
    std: float = 0.01  # target std (E5: 0.01, E6: 0.02, E7: ramp to 0.03)
    ramp_rounds: int = 0  # 0 = constant std; >0 = linear 0 -> std


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Server aggregation (``core/aggregation.py``): the registered rule
    that reduces the client deltas, and its knobs."""

    name: str = "weighted_mean"
    trim_frac: float = 0.1  # trimmed_mean: fraction trimmed per side
    dp_clip: float = 1.0  # clipped_mean: per-client L2 clip norm
    dp_sigma: float = 0.0  # clipped_mean: DP noise multiplier

    @property
    def hypers(self) -> dict:
        """The knob dict the aggregation registry takes."""
        return {"trim_frac": self.trim_frac, "dp_clip": self.dp_clip,
                "dp_sigma": self.dp_sigma}


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """The buffered-async engine (``engine="async"``, FedBuff-style): the
    server buffers arriving client deltas and steps when ``buffer_size`` of
    them are in, each delta discounted by its staleness
    ``exp(-beta * log1p(s))`` == ``1 / (1 + s)**beta``, ``s`` the server
    versions applied since that client downloaded. ``buffer_size=0``
    resolves to the plan's K (one flush a wave under full participation:
    the sync-parity configuration)."""

    buffer_size: int = 0  # B; 0 resolves to clients_per_round
    staleness_beta: float = 0.5  # staleness discount exponent

    def resolve_buffer(self, clients_per_round: int) -> int:
        return self.buffer_size if self.buffer_size > 0 else clients_per_round


ENGINES = ("fedavg", "fedsgd", "async")
SERVER_OPTIMIZERS = ("adam", "sgd", "momentum", "yogi")
_CONFIGS = {"cohort": CohortConfig, "compression": CompressionConfig,
            "aggregation": AggregatorConfig, "corruption": CorruptionConfig,
            "latency": LatencyConfig, "asynchrony": AsyncConfig}


@dataclasses.dataclass(frozen=True)
class FederatedPlan:
    clients_per_round: int = 4  # K (paper sweeps 32 -> 128)
    local_batch_size: int = 2  # b
    local_epochs: int = 1  # e
    local_steps: Optional[int] = None  # fixed step count (engine shape); None = from data
    data_limit: Optional[int] = None  # paper §4.2.1 non-IID dial (None = no limit)
    client_sampling: str = "uniform"  # see repro_torch.data.strategies
    client_lr: float = 0.008  # paper's coarse-swept client SGD lr
    server_optimizer: str = "adam"  # "adam" | "sgd" | "momentum" | "yogi"
    server_lr: float = 1e-3
    server_warmup_rounds: int = 0  # linear ramp-up (Baseline style)
    server_decay_rounds: int = 0  # >0: exponential decay (E9/E10 style)
    server_decay_rate: float = 0.9
    fvn: FVNConfig = dataclasses.field(default_factory=FVNConfig)
    engine: str = "fedavg"  # "fedavg" | "fedsgd" (one collapsed forward/backward) | "async"
    # server plane: cohort -> compression -> corruption -> aggregation
    cohort: CohortConfig = dataclasses.field(default_factory=CohortConfig)
    compression: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)
    aggregation: AggregatorConfig = dataclasses.field(default_factory=AggregatorConfig)
    corruption: CorruptionConfig = dataclasses.field(default_factory=CorruptionConfig)
    # the async engine's buffer, and the simulated arrival times that order
    # its update stream; latency.enabled prices a sync round in seconds too
    asynchrony: AsyncConfig = dataclasses.field(default_factory=AsyncConfig)
    latency: LatencyConfig = dataclasses.field(default_factory=LatencyConfig)
    # CFMQ constants (paper §4.3.1)
    alpha: float = 1.0
    param_bytes: int = 4  # bytes per parameter on the wire

    def __post_init__(self):
        for name, cls in _CONFIGS.items():
            if not isinstance(getattr(self, name), cls):
                raise TypeError(f"{name} must be a {cls.__name__}, got "
                                f"{getattr(self, name)!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; available: {ENGINES}")
        if self.server_optimizer not in SERVER_OPTIMIZERS:
            raise ValueError(f"unknown server optimizer {self.server_optimizer!r}; "
                             f"available: {SERVER_OPTIMIZERS}")
        if self.aggregation.name not in available_aggregators():
            raise ValueError(f"unknown aggregator {self.aggregation.name!r}; available: "
                             f"{available_aggregators()}")


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

    # each of SERVER_OPTIMIZERS is the optimizer of that name
    return getattr(optim, plan.server_optimizer)(server_lr_schedule(plan))
