"""Threefry keys and draws: the part of ``jax.random`` the port uses.

The reference derives every draw of its server plane from its round key:
``fold_in`` for the plane's streams and the clients' keys
(``repro/core/fedavg.py:213-224``, ``:414``), ``split`` for the per-leaf
keys of the compressor, the gaussian adversary and the DP noise and for
the corruption mask's and the latency model's key pairs
(``repro/core/compression.py:567``, ``corruption.py:133``, ``:212``,
``aggregation.py:175``, ``cohort.py:88``), ``uniform`` for the cohort,
corruption and tier masks, and ``normal`` for the gaussian adversary, the
DP noise and the latency jitter.

A key is its two 32-bit words as an int64 tensor of shape ``(..., 2)``
(values in [0, 2**32)); leading axes make many keys at once.

``fold_in(key, d)`` is one threefry2x32 block over the counter words
``(0, d)``, whichever way ``jax_threefry_partitionable`` is set. ``split``,
``uniform`` and ``normal`` follow the non-partitionable threefry, the
default of the jax that ``requirements.txt`` pins (``jax_threefry_
partitionable=False``): ``split(key, n)`` is one block over the counters
``iota(2n)`` halved, ``uniform`` is ``ref.threefry_uniform_ref`` scaled,
and ``normal`` is ``sqrt(2) * erf_inv(uniform(lo, 1))`` with ``lo`` the
float32 after -1 and XLA's float32 ``erf_inv`` restated operation by
operation (``ref.uniform_to_normal``). ``split``, ``uniform`` and
``normal`` equal JAX's bit for bit (``normal`` as jax 0.9.0 compiles it on
the CPU). ``randint`` draws one scalar as ``jax.random.randint`` does, bit
for bit; the client step's SpecAugment masks come from it
(``repro/asr/specaugment.py:23-53``). Large draws on the card (FVN, the
gaussian adversary, the DP noise) go through the normal kernel
(``kernels/threefry_normal.py``) instead, which gives the same bits.

A single key on the CPU (shape ``(2,)``) is hashed with Python integers:
the client step folds and splits a few dozen scalar keys, and a threefry
block as tensor operations costs about a hundred small launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import (NORMAL_LO, bits_to_uniform, threefry2x32_pair,
                                     threefry_bits_ref, uniform_to_normal)

_M32 = 0xFFFFFFFF
# jax.random.normal's lower end: the float32 after -1 toward 0
_NORMAL_LO = NORMAL_LO


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: the words (0, seed)."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"a key seed is a 32-bit word, got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def _scalar(key: torch.Tensor) -> bool:
    return key.dim() == 1 and key.device.type == "cpu"


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: key (..., 2) and data (an int or
    an integer tensor broadcastable to ``key.shape[:-1]``, taken modulo
    2**32) -> key (broadcast shape, 2)."""
    if _scalar(key) and isinstance(data, int):
        k0, k1 = key.tolist()
        return torch.tensor(threefry2x32_pair(k0, k1, 0, data & _M32), dtype=torch.int64)
    d = (torch.as_tensor(data, dtype=torch.int64, device=key.device)) & _M32
    o0, o1 = threefry2x32_pair(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: key (..., 2) -> keys (..., n, 2). One
    threefry2x32 block per pair of counters (i, n + i) of ``iota(2n)``;
    the first output words of all blocks, then the second ones, make the
    2n words of the n keys in order."""
    if n < 1:
        raise ValueError(f"split makes at least one key, got n={n}")
    if _scalar(key):
        k0, k1 = key.tolist()
        blocks = [threefry2x32_pair(k0, k1, i, n + i) for i in range(n)]
        words = [b[0] for b in blocks] + [b[1] for b in blocks]
        return torch.tensor(words, dtype=torch.int64).reshape(n, 2)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32_pair(key[..., 0:1], key[..., 1:2], i, i + n)
    return torch.cat([o0, o1], dim=-1).reshape(*key.shape[:-1], n, 2)


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    """The 32-bit words of ``jax.random.bits(key, shape)`` (int64)."""
    kd = key.to(torch.int64)
    return threefry_bits_ref(kd[..., 0:1], kd[..., 1:2], math.prod(shape)).reshape(
        *key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: key
    (..., 2) -> (..., *shape) float32 in [minval, maxval): the [0, 1)
    draw times (maxval - minval) plus minval, rounded once to float32 as
    the fused multiply-add XLA emits (the product of two float32 values
    is exact in float64), then at least minval."""
    f = bits_to_uniform(_bits(key, tuple(shape)))
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    width = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    return torch.maximum(lo, (f.double() * width.double() + lo.double()).float())


def normal(key: torch.Tensor, shape, scale: float = 1.0) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: key (..., 2) -> (...,
    *shape) float32, sqrt(2) * erf_inv of a uniform draw on [lo, 1) with
    lo the float32 after -1 toward 0, bit for bit. ``scale``: ``scale *
    normal`` as a jitted program computes it with a constant scale, the
    constants folded (``ref.uniform_to_normal``)."""
    return uniform_to_normal(bits_to_uniform(_bits(key, tuple(shape))), scale)


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def randint(key: torch.Tensor, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` (int32) for one key
    (2,): ``jax._src.random._randint``'s algorithm on Python integers.
    Two 32-bit words, ``hi`` from ``k1`` and ``lo`` from ``k2`` of
    ``split(key)``, give ``minval + ((hi % span) * (2**32 % span) + lo %
    span) % span`` in uint32 arithmetic, with ``span = maxval - minval``
    as an unsigned word (1 when ``maxval <= minval``, one more when
    ``maxval`` is above the int32 range, whose ends clip both bounds).
    No device is touched."""
    if key.shape != (2,):
        raise ValueError(f"randint draws from one key (2,), got {tuple(key.shape)}")
    out_of_range = maxval > _I32_MAX
    lo_v, hi_v = (min(max(v, _I32_MIN), _I32_MAX) for v in (minval, maxval))
    k1, k2 = split(key.cpu()).tolist()
    hi = threefry2x32_pair(*k1, 0, 0)[0]  # bits(key, ()): lane 0 of block (0, 0)
    lo = threefry2x32_pair(*k2, 0, 0)[0]
    span = (hi_v - lo_v) & _M32
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    mult = _rem(_rem(2**16, span) ** 2 & _M32, span)
    offset = _rem((((_rem(hi, span) * mult) & _M32) + _rem(lo, span)) & _M32, span)
    return _wrap_i32(lo_v + offset)


def _rem(x: int, span: int) -> int:
    """XLA's unsigned remainder: by 0 (a span of 2**32 wrapped) it is x."""
    return x % span if span else x


def _wrap_i32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The raw words of ``key`` (a key here is its words already)."""
    return key
