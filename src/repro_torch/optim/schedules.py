"""Learning-rate schedules of the paper's experiments.

The port of the schedules in ``repro/optim/schedules.py`` that the
server's learning-rate plan uses (``repro/core/plan.py:163-175``). Each
is a ``count -> float`` function of an integer step count, computed in
float32 as the reference computes it.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def constant(value: float):
    def schedule(count):
        return float(_F(value))

    return schedule


def linear_rampup(peak: float, warmup_steps: int):
    """Linear 0->peak over warmup_steps, then constant (Baseline E0)."""

    def schedule(count):
        frac = np.minimum(_F(count) / _F(max(warmup_steps, 1)), _F(1.0))
        return float(_F(peak) * frac)

    return schedule


def linear_rampup_exp_decay(peak: float, warmup_steps: int, decay_steps: int, decay_rate: float):
    """Short ramp-up + exponential decay — the E9/E10 cost-reducing schedule."""

    def schedule(count):
        c = _F(count)
        warm = np.minimum(c / _F(max(warmup_steps, 1)), _F(1.0))
        decay = _F(decay_rate) ** (np.maximum(c - _F(warmup_steps), _F(0.0))
                                   / _F(max(decay_steps, 1)))
        return float(_F(peak) * warm * decay)

    return schedule
