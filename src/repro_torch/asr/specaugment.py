"""SpecAugment (Park et al., 2019): time and frequency masks on log-mel
features. The port of ``repro/asr/specaugment.py:23-53``.

As in the reference, one draw per call: every mask's width and start are
scalars shared by the whole batch, drawn from a threefry key with the
reference's splits and ``randint`` (``core/keys.py``), so the masks equal
JAX's for the same key bit for bit. The scalars are hashed on the host:
no device sync, and the masks do not depend on the features' device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    freq_masks: int = 2
    freq_mask_width: int = 27     # F parameter of the paper
    time_masks: int = 2
    time_mask_frac: float = 0.05  # max time-mask width as fraction of T
    enabled: bool = True


def _mask_axis(key, x, axis_len: int, max_width: int, num_masks: int, axis: int):
    """Apply ``num_masks`` random contiguous zero-masks along ``axis``."""
    idx = torch.arange(axis_len, device=x.device)
    shape = [1] * x.ndim
    shape[axis] = axis_len
    for mask_key in keys.split(key, num_masks):
        k1, k2 = keys.split(mask_key)
        width = keys.randint(k1, 0, max_width + 1)
        start = keys.randint(k2, 0, max(axis_len - width, 1))
        mask = (idx >= start) & (idx < start + width)
        x = x * (1.0 - mask.reshape(shape).to(x.dtype))
    return x


def spec_augment(key: torch.Tensor, features: torch.Tensor,
                 cfg: SpecAugmentConfig) -> torch.Tensor:
    """features (..., T, F); ``key`` one threefry key (2,) (per client
    step under FL, so each client augments independently)."""
    if not cfg.enabled:
        return features
    t_len, f_len = features.shape[-2], features.shape[-1]
    kf, kt = keys.split(key)
    max_f = min(cfg.freq_mask_width, f_len)
    max_t = max(1, int(t_len * cfg.time_mask_frac))
    if cfg.freq_masks > 0:
        features = _mask_axis(kf, features, f_len, max_f, cfg.freq_masks, axis=-1)
    if cfg.time_masks > 0:
        features = _mask_axis(kt, features, t_len, max_t, cfg.time_masks, axis=-2)
    return features
