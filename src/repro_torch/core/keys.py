"""Threefry key words: the part of ``jax.random`` the compression plane uses.

The reference derives every stochastic-rounding draw of the code-domain
fast path from its round key with ``jax.random.fold_in`` alone
(``repro/core/fedavg.py:213-224``, ``:414``;
``repro/core/compression.py:366-370``). ``fold_in(key, d)`` is one
threefry2x32 block of the key words over the counter words ``(0, d)``,
whichever way ``jax_threefry_partitionable`` is set, so the port holds
these keys bitwise to JAX's.

A key is its two 32-bit words as an int64 tensor of shape ``(..., 2)``
(values in [0, 2**32)); leading axes fold many keys at once.
``jax.random.split`` and ``normal`` are not here: only the slow path's
compressor and FVN use them, and ``split`` changes with
``jax_threefry_partitionable``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import threefry2x32_pair

_M32 = 0xFFFFFFFF


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: the words (0, seed)."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"a key seed is a 32-bit word, got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: key (..., 2) and data (an int or
    an integer tensor broadcastable to ``key.shape[:-1]``, taken modulo
    2**32) -> key (broadcast shape, 2)."""
    d = (torch.as_tensor(data, dtype=torch.int64, device=key.device)) & _M32
    o0, o1 = threefry2x32_pair(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The raw words of ``key`` (a key here is its words already)."""
    return key
