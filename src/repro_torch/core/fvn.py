"""Federated Variational Noise (paper §4.2.2).

The port of ``repro/core/fvn.py``. Each client draws its own Gaussian
weight noise at each local step, all from N(0, sigma(round)), with sigma
on a linear ramp over rounds (E7). The noise is the reference's: the
client step's key ``fvn_key(PRNGKey(seed), round, client, step)`` split
into one key per tensor in JAX's tree order, then ``jax.random.normal``
per tensor, bit for bit, drawn and added by the normal kernel in one
launch a client step (``kernels/threefry_normal.py``; its plain version
on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keys
from repro_torch.core.compression import jax_leaf_order
from repro_torch.core.plan import FVNConfig
from repro_torch.kernels import threefry_normal


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


def perturb(params: dict, key: torch.Tensor, sigma: float) -> dict:
    """params + N(0, sigma), ``repro/core/fvn.py:40-48``: tensor i of
    JAX's tree order (``jax_leaf_order``) draws ``jax.random.normal``
    from ``split(key, L)[i]``, and (p.float() + sigma · noise) is cast
    back to p's dtype. One kernel launch for all the tensors on the card."""
    names = jax_leaf_order(params)
    lkeys = keys.split(key.cpu(), len(names))
    noisy = threefry_normal.normal_axpy([params[n] for n in names], lkeys,
                                        [sigma] * len(names))
    out = dict(zip(names, noisy))
    return {name: out[name] for name in params}
