"""Cohort dynamics: partial participation, dropout, stragglers, latency.

The port of ``repro/core/cohort.py``. A round's cohort is a mask of its
example weights: a dropped client's weights are 0 for every local step,
so its local steps change nothing, its delta is 0 and so is its n_k; a
straggler keeps only the first ``ceil(straggler_keep * S)`` of its real
local steps. The clients still run every local step, as the reference's
vmapped clients do. A round always keeps at least one client: when every
draw fails, the one with the smallest draw is kept.

Every draw is the reference's threefry draw from the round's cohort key
(``core/keys.py``), so the masks equal JAX's bit for bit. The draws are
made on the key's device (the host) and the masks moved to the weights'.

The latency model draws each client's upload arrival time from its
device tier and a lognormal jitter; a barrier round lasts until its
slowest participant arrives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as keys_lib
from repro_torch.kernels.ref import xla_exp_f32


@dataclasses.dataclass(frozen=True)
class LatencyConfig:
    """Per-client round-trip latency (device tiers and jitter): client k's
    upload arrives ``base_s * tier_speeds[tier_k] * exp(spread * normal())``
    seconds after the round starts, ``tier_k`` a draw over ``tier_probs``.
    With ``enabled`` a round's simulated duration is its slowest
    participant's arrival."""

    enabled: bool = False
    base_s: float = 60.0                       # median round-trip seconds
    spread: float = 0.25                       # lognormal jitter sigma
    tier_speeds: tuple = (1.0, 2.0, 4.0)       # slowdown per device tier
    tier_probs: tuple = (0.5, 0.3, 0.2)        # tier mix of the fleet

    def __post_init__(self):
        if len(self.tier_speeds) != len(self.tier_probs):
            raise ValueError(
                f"tier_speeds ({len(self.tier_speeds)}) and tier_probs "
                f"({len(self.tier_probs)}) must pair up one speed per tier")


def tier_assignments(key: torch.Tensor, K: int, tier_probs) -> torch.Tensor:
    """(K,) int32 tier draw from the fleet mix: the number of cumulative
    probabilities (float32, summed in order) a uniform draw reaches."""
    u = keys_lib.uniform(key, (K,))
    cum = torch.from_numpy(np.cumsum(np.asarray(tier_probs, np.float32)))
    idx = (u[:, None] >= cum[None, :].to(u.device)).sum(dim=1)
    return torch.clamp(idx, max=len(tier_probs) - 1).to(torch.int32)


def draw_latencies(key: torch.Tensor, K: int, base_s: float, spread: float, tier_speeds,
                   tier_probs) -> torch.Tensor:
    """(K,) float32 simulated upload arrival times, seconds from the round's
    start, on the key's device, equal bit for bit to the reference's
    jitted program: XLA folds the spread into the normal's √2 (``keys.normal``
    with ``scale``) and takes its CPU exp (``ref.xla_exp_f32``), so two
    arrivals sort as they do there."""
    tkey, jkey = keys_lib.split(key, 2)
    tiers = tier_assignments(tkey, K, tier_probs)
    speed = torch.tensor(tier_speeds, dtype=torch.float32, device=tiers.device)[tiers.long()]
    jitter = xla_exp_f32(keys_lib.normal(jkey, (K,), scale=spread))
    return base_s * speed * jitter


def make_latency_fn(cfg: LatencyConfig):
    """Returns latencies(key, K) -> (K,) float32 arrival times."""
    def latencies(key: torch.Tensor, K: int) -> torch.Tensor:
        return draw_latencies(key, K, cfg.base_s, cfg.spread, cfg.tier_speeds, cfg.tier_probs)

    return latencies


def rescue_mask(u: torch.Tensor) -> torch.Tensor:
    """One-hot over the first argmin: exactly one most available client,
    even where draws tie."""
    return torch.arange(u.shape[0], device=u.device) == torch.argmin(u)


def participation_mask(key: torch.Tensor, K: int, participation: float) -> torch.Tensor:
    """(K,) float32 mask of the reporting clients; never all zero."""
    u = keys_lib.uniform(key, (K,))
    survivors = u < participation
    return torch.where(survivors.any(), survivors, rescue_mask(u)).float()


def straggler_step_mask(key: torch.Tensor, weight: torch.Tensor, straggler_frac: float,
                        straggler_keep: float) -> torch.Tensor:
    """(K, S) float32 mask on weight's device: a straggler keeps only the
    first ``ceil(straggler_keep * real_steps)`` of its steps, real_steps
    counting the steps that hold an example, so padding never moves the
    deadline."""
    K, S = weight.shape[:2]
    is_straggler = (keys_lib.uniform(key, (K,)) < straggler_frac).to(weight.device)
    real_steps = (weight.amax(dim=2) > 0).sum(dim=1).float()
    keep_steps = torch.ceil(straggler_keep * real_steps)
    step_ok = torch.arange(S, dtype=torch.float32, device=weight.device)[None, :] \
        < keep_steps[:, None]
    return torch.where(is_straggler[:, None], step_ok, True).float()


def make_cohort_fn(participation: float, straggler_frac: float, straggler_keep: float):
    """Returns cohort(key, weight) -> (weight', pmask): the round batch's
    (K, S, b) example weights masked by the drawn cohort, and the (K,)
    mask of reporting clients, both on weight's device."""
    def cohort(key: torch.Tensor, weight: torch.Tensor):
        K = weight.shape[0]
        pmask = participation_mask(keys_lib.fold_in(key, 0), K, participation).to(weight.device)
        smask = straggler_step_mask(keys_lib.fold_in(key, 1), weight, straggler_frac,
                                    straggler_keep)
        return weight * pmask[:, None, None] * smask[:, :, None], pmask

    return cohort


def identity_cohort(key: torch.Tensor, weight: torch.Tensor):
    """Full participation (the paper's plane): no draw."""
    return weight, torch.ones(weight.shape[0], dtype=torch.float32, device=weight.device)
