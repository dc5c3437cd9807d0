"""Optimizers and schedules over dicts of tensors."""
from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    ScaleState,
    adam,
    apply_updates,
    sgd,
)
from repro_torch.optim.schedules import constant, linear_rampup, linear_rampup_exp_decay

__all__ = [
    "AdamState",
    "Optimizer",
    "ScaleState",
    "adam",
    "apply_updates",
    "sgd",
    "constant",
    "linear_rampup",
    "linear_rampup_exp_decay",
]
