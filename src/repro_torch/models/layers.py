"""Parameter initializers, drawn from an explicit ``torch.Generator``.

The port's counterparts of ``repro/models/layers.py:21-27``: the same
distributions and scales, in the JAX layout (``x @ w``, w of shape
(d_in, d_out)). The draws differ from JAX's; tests that compare the two
packages carry JAX's weights across with ``repro_torch.convert``.
"""

from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32, scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=generator.device)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32, scale: float = 1.0):
    w = torch.randn((vocab, d), generator=generator, device=generator.device)
    return (w * (scale / math.sqrt(d))).to(dtype)
