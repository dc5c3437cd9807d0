"""Attention: projections, blockwise (online-softmax) attention and
one-token decode attention, over plain parameter dicts.

The port of ``repro/models/attention.py:29-243``. ``blockwise_attention``
runs K10 (``kernels/flash_attention.py``) and ``decode_attention`` K11
(``kernels/decode_attention.py``) on the card; on the CPU each wrapper
takes its plain version, the reference's algorithm in fp32. Layouts are
the reference's: q (B, S, H, D), k and v (B, S, Kv, D), caches (B, S, Kv,
D).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    use_bias: bool = False
    causal: bool = True
    window: Optional[int] = None        # sliding-window width (None = full)
    logit_softcap: float = 0.0
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)


def attn_init(generator: torch.Generator, cfg: AttnConfig,
              dtype: torch.dtype = torch.float32, device=None) -> dict:
    H, Kv, D, M = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_model
    dev = generator.device if device is None else device
    p = {"wq": dense_init(generator, M, H * D, dtype, device=dev),
         "wk": dense_init(generator, M, Kv * D, dtype, device=dev),
         "wv": dense_init(generator, M, Kv * D, dtype, device=dev),
         "wo": dense_init(generator, H * D, M, dtype, device=dev)}
    if cfg.use_bias:
        for name, n in (("bq", H * D), ("bk", Kv * D), ("bv", Kv * D)):
            p[name] = torch.zeros((n,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((D,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((D,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: dict, cfg: AttnConfig, x, positions):
    """x (B, S, M) -> q (B, S, H, D), k and v (B, S, Kv, D), rope applied."""
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.use_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        logit_softcap: float = 0.0, q_offset: int = 0, block_kv: int = 512,
                        query_scale: Optional[float] = None):
    """Online-softmax attention, q (B, Sq, H, D), k and v (B, Sk, Kv, D):
    K10. Returns (B, Sq, H, Dv) in q's dtype."""
    return flash_attention(q, k, v, causal=causal, window=window, logit_softcap=logit_softcap,
                           q_offset=q_offset, scale=query_scale, block_kv=block_kv)


def decode_attention(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                     ring: bool = False, logit_softcap: float = 0.0,
                     query_scale: Optional[float] = None):
    """One-token attention, q (B, H, D), caches (B, S, Kv, D), pos the
    current token's index (already written): K11. ``ring``: the cache is a
    ring buffer of width S, slot j holding position pos - ((pos - j) mod S)."""
    return flash_decode(q, k_cache, v_cache, pos, window=window, ring=ring,
                        logit_softcap=logit_softcap, scale=query_scale)


def device_pos(pos, device) -> torch.Tensor:
    """``pos`` (an int or a 0-d integer tensor) as one int32 on ``device``;
    an int is filled in on the device, without a copy that waits for it."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((), pos, dtype=torch.int32, device=device)


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """``lax.dynamic_update_slice(cache, new, (0, slot, 0, 0))`` for one
    token, in place: new (B, 1, Kv, D) into cache (B, S, Kv, D) at ``slot``
    clamped into [0, S - 1], as XLA clamps the start (so a slot past the
    end writes the last one)."""
    idx = torch.clamp(slot, 0, cache.shape[1] - 1).reshape(1).long()
    cache.index_copy_(1, idx, new.to(cache.dtype))


def attn_forward(p: dict, cfg: AttnConfig, x, positions=None, block_kv: int = 512):
    """Full-sequence (train / prefill) attention. Returns (out, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = blockwise_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                            logit_softcap=cfg.logit_softcap, block_kv=min(block_kv, S),
                            query_scale=cfg.query_scale)
    out = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"].to(x.dtype)
    return out, (k, v)


def attn_decode(p: dict, cfg: AttnConfig, x, k_cache, v_cache, pos, ring: bool = False):
    """Single-token decode, x (B, 1, M), caches (B, S, Kv, D), pos a
    scalar. Writes the new token's k/v at slot (pos % S if ring else pos,
    clamped as XLA clamps) in place, then attends. Returns (out (B, 1, M),
    k_cache, v_cache)."""
    B, S = x.shape[0], k_cache.shape[1]
    pos_t = device_pos(pos, x.device)
    q, k, v = _project_qkv(p, cfg, x, pos_t.long().expand(B, 1))
    slot = torch.remainder(pos_t, S) if ring else pos_t
    write_slot(k_cache, k, slot)
    write_slot(v_cache, v, slot)
    o = decode_attention(q[:, 0], k_cache, v_cache, pos_t, window=cfg.window, ring=ring,
                         logit_softcap=cfg.logit_softcap, query_scale=cfg.query_scale)
    out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"].to(x.dtype)
    return out, k_cache, v_cache
