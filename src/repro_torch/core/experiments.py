"""The paper's experiment ladder E0-E10 as FederatedPlans.

The port of ``repro/core/experiments.py``. The paper's absolute settings
(K=128 clients, lr=0.008, a 4k word-piece RNN-T on Librispeech) are kept
where they are structural (optimizer types, FVN stds, which knob each
experiment turns) and made scale parameters where they are resource-bound
(K, batch, rounds). The relationships between the experiments — what E2
changes against E1, E7 against E5/E6, E9/E10 against E0 — are the
paper's. E0 runs on IID-shuffled pools (``run_federated(iid=True)``) and
E10 with more SpecAugment (``run_federated(specaug_scale=...)``): the
driver applies both, as the reference's does.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.plan import FederatedPlan, FVNConfig


def ladder(
    clients_per_round: int = 8,
    local_batch_size: int = 4,
    data_limit: int = 8,
    server_lr: float = 0.01,
    client_lr: float = 0.05,
    warmup_rounds: int = 10,
    fvn_std: float = 0.01,
    fvn_ramp_rounds: int = 60,
) -> dict[str, FederatedPlan]:
    """Scaled E0-E10. E0 (the IID Baseline) is expressed as a federated
    plan fed IID-shuffled data (the paper's §2.2 observation that central
    mini-batch SGD is the IID limit of FedAvg)."""
    base = FederatedPlan(
        clients_per_round=clients_per_round,
        local_batch_size=local_batch_size,
        local_epochs=1,
        client_lr=client_lr,
        server_optimizer="adam",
        server_lr=server_lr,
        server_warmup_rounds=warmup_rounds,
    )

    def fvn(std, ramp=0):
        return FVNConfig(enabled=True, std=std, ramp_rounds=ramp)

    cost_reduced = dict(data_limit=data_limit, fvn=fvn(3 * fvn_std, fvn_ramp_rounds),
                        server_warmup_rounds=max(2, warmup_rounds // 4),
                        server_decay_rounds=40, server_decay_rate=0.85)
    return {
        # E0: central IID baseline (run on IID-shuffled pools)
        "E0": dataclasses.replace(base, fvn=fvn(fvn_std, fvn_ramp_rounds)),
        # E1: non-IID, no data limit, no FVN (Table 1)
        "E1": base,
        # E2-E4: data limiting sweep (Table 2)
        "E2": dataclasses.replace(base, data_limit=data_limit),
        "E3": dataclasses.replace(base, data_limit=data_limit * 2),
        "E4": dataclasses.replace(base, data_limit=data_limit * 4),
        # E5-E7: FVN sweep at the E2 data limit (Table 3)
        "E5": dataclasses.replace(base, data_limit=data_limit, fvn=fvn(fvn_std)),
        "E6": dataclasses.replace(base, data_limit=data_limit, fvn=fvn(2 * fvn_std)),
        "E7": dataclasses.replace(base, data_limit=data_limit,
                                  fvn=fvn(3 * fvn_std, fvn_ramp_rounds)),
        # E8: FVN without data limit (Table 4)
        "E8": dataclasses.replace(base, fvn=fvn(3 * fvn_std, fvn_ramp_rounds)),
        # E9/E10: cost-reduced — shorter ramp-up + exp decay; E10 also
        # increases SpecAugment (applied by the training driver)
        "E9": dataclasses.replace(base, **cost_reduced),
        "E10": dataclasses.replace(base, **cost_reduced),
    }
