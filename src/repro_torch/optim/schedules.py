"""Learning-rate and noise schedules of the paper's experiments.

The port of ``repro/optim/schedules.py``: the Baseline's (E0) linear
ramp-up, the cost-reduced configs' (E9/E10) shorter ramp-up with
exponential decay, FVN's linear ramp to a target (E7) and a step
function. Each is a ``count -> float`` function of an integer step
count, computed in float32 as the reference computes it.
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


def linear_ramp_to(target: float, ramp_steps: int, start: float = 0.0):
    """Linear start->target over ramp_steps then hold — FVN sigma ramp (E7)."""

    def schedule(count):
        frac = np.minimum(_F(count) / _F(max(ramp_steps, 1)), _F(1.0))
        return float(_F(start) + _F(target - start) * frac)

    return schedule


def piecewise(boundaries, values):
    """Step function: values[i] for count in [boundaries[i-1], boundaries[i])."""
    assert len(values) == len(boundaries) + 1
    table = np.asarray(values, np.float32)

    def schedule(count):
        idx = int(np.sum(np.asarray(boundaries, np.int32) <= np.int32(count)))
        return float(table[idx])

    return schedule
