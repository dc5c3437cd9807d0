"""Parameter initializers, drawn from an explicit ``torch.Generator``,
and the time loops of the recurrent layers.

The initializers are the port's counterparts of
``repro/models/layers.py:21-27``: the same distributions and scales, in
the JAX layout (``x @ w``, w of shape (d_in, d_out)). The draws differ
from JAX's; tests that compare the two packages carry JAX's weights
across with ``repro_torch.convert``. ``scan`` and ``chunked_scan`` are
the counterparts of ``lax.scan`` and ``repro/models/layers.py:155-176``.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32, scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=generator.device)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32, scale: float = 1.0):
    w = torch.randn((vocab, d), generator=generator, device=generator.device)
    return (w * (scale / math.sqrt(d))).to(dtype)


def scan(body, carry, xs):
    """``lax.scan`` as a Python loop: body(carry, x_t) -> (carry, y_t)
    over the leading axis of xs. Returns (carry, ys stacked on axis 0)."""
    ys = []
    for x in xs:
        carry, y = body(carry, x)
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(body, carry, xs, chunk: int):
    """``scan`` over checkpointed chunks of ``chunk`` steps: the backward
    keeps only each chunk's initial carry and recomputes its steps, the
    memory fix for long recurrences. As in the reference, a length that
    ``chunk`` does not divide, or that is at most ``chunk``, is one plain
    scan, and so is ``chunk`` 0. The carry is a tuple of tensors."""
    S = xs.shape[0]
    if not chunk or S % chunk or S <= chunk:
        return scan(body, carry, xs)

    def run(xc, *c):
        c, ys = scan(body, c, xc)
        return (*c, ys)

    ys = []
    for xc in xs.split(chunk):
        *carry, y = checkpoint(run, xc, *carry, use_reentrant=False)
        ys.append(y)
    return tuple(carry), torch.cat(ys)
