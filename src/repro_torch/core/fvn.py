"""Federated Variational Noise (paper §4.2.2).

The port of ``repro/core/fvn.py``. Each client draws its own Gaussian
weight noise at each local step, all from N(0, sigma(round)), with sigma
on a linear ramp over rounds (E7). The reference folds (round, client,
step) into a JAX key; here the same four numbers seed a
``torch.Generator`` (``step_seed``), so the noise is deterministic per
(seed, round, client, step) and distinct across them. The two packages
never draw the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keys
from repro_torch.core.plan import FVNConfig


def fvn_sigma(cfg: FVNConfig, round_idx: int) -> float:
    """Noise std for a round (linear ramp, paper E7), computed in float32
    as the reference computes it."""
    if not cfg.enabled:
        return 0.0
    if cfg.ramp_rounds > 0:
        frac = np.minimum(np.float32(round_idx) / np.float32(cfg.ramp_rounds), np.float32(1.0))
        return float(np.float32(cfg.std) * frac)
    return float(np.float32(cfg.std))


def fvn_key(base_key: torch.Tensor, round_idx: int, client_idx: int, step_idx: int):
    """``repro/core/fvn.py:33-36``: the client step's threefry key."""
    k = keys.fold_in(base_key, round_idx)
    k = keys.fold_in(k, client_idx)
    return keys.fold_in(k, step_idx)


def step_seed(seed: int, round_idx: int, client_idx: int, step_idx: int) -> int:
    """A 64-bit seed for FVN's generator at one (round, client, step)."""
    state = np.random.SeedSequence([seed, round_idx, client_idx, step_idx])
    return int(state.generate_state(1, np.uint64)[0])


def perturb(params: dict, generator: torch.Generator, sigma: float) -> dict:
    """params + N(0, sigma): one independent draw per tensor, in the
    dict's order, on the generator's device."""
    return {
        k: (p.float() + sigma * torch.randn(p.shape, generator=generator, device=p.device))
        .to(p.dtype)
        for k, p in params.items()
    }
