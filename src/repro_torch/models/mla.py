"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434).

The port of ``repro/models/mla.py``. Keys and values are compressed into
a rank-``kv_lora`` latent c_kv plus one shared rope key head; the cache
holds only (c_kv, k_rope), (S, kv_lora + qk_rope_dim) a token, and the
per-head no-rope keys and the values are expanded from the latent at
attention time. Parameters are the reference's leaves and shapes, so
``repro_torch.convert.params_from_jax`` carries them across.

``mla_forward`` attends over the full sequence through the port's
``blockwise_attention`` with a q·k width of ``qk_nope_dim + qk_rope_dim``
and a v width of ``v_dim`` (192 and 128 at deepseek-v2-lite's width): K10
on the card, differentiated by K10's backward under autograd.
``mla_decode`` scores one token against the compressed cache in latent
space with einsums, as the reference does (it has no Pallas kernel there),
in the reference's dtypes: the absorbed query in x's dtype, the scores and
the softmax in fp32, the latent sum cast back to x's dtype before ``w_uv``.
It writes the token's c_kv and k_rope into the caches in place, at ``pos``
clamped into the cache as ``lax.dynamic_update_slice`` clamps its start.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import blockwise_attention, device_pos, write_slot
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1.0e30


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0


def mla_init(generator: torch.Generator, cfg: MLAConfig, dtype: torch.dtype = torch.float32,
             device=None) -> dict:
    """The reference's leaves (``repro/models/mla.py:35``); ``device`` None
    is the generator's, ``"meta"`` gives the shapes."""
    dev = generator.device if device is None else device
    H, M = cfg.n_heads, cfg.d_model

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, dtype, device=dev)

    return {
        "wq": dense(M, H * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
        "w_dkv": dense(M, cfg.kv_lora),          # down-projection to the latent
        "w_krope": dense(M, cfg.qk_rope_dim),    # the shared rope key
        "w_uk": dense(cfg.kv_lora, H * cfg.qk_nope_dim),
        "w_uv": dense(cfg.kv_lora, H * cfg.v_dim),
        "wo": dense(H * cfg.v_dim, M),
        "kv_norm": torch.ones((cfg.kv_lora,), dtype=dtype, device=dev),
    }


def _queries(p: dict, cfg: MLAConfig, x, positions):
    """x (B, S, M) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr), rope applied."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latents(p: dict, cfg: MLAConfig, x, positions):
    """x (B, S, M) -> c_kv (B, S, R) normed, k_rope (B, S, dr) rope applied."""
    c_kv = rms_norm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"])
    k_rope = apply_rope(x @ p["w_krope"].to(x.dtype), positions, cfg.rope_theta)
    return c_kv, k_rope


def _expand(p: dict, cfg: MLAConfig, c_kv):
    """The latent (B, S, R) -> k_nope (B, S, H, dn), v (B, S, H, dv)."""
    B, S, _ = c_kv.shape
    H = cfg.n_heads
    k_nope = (c_kv @ p["w_uk"].to(c_kv.dtype)).reshape(B, S, H, cfg.qk_nope_dim)
    v = (c_kv @ p["w_uv"].to(c_kv.dtype)).reshape(B, S, H, cfg.v_dim)
    return k_nope, v


def mla_forward(p: dict, cfg: MLAConfig, x, positions=None, block_kv: int = 512):
    """Full-sequence causal MLA over x (B, S, M): K10 on the card. Returns
    (out (B, S, M), (c_kv, k_rope)) for the cache."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latents(p, cfg, x, positions)
    k_nope, v = _expand(p, cfg, c_kv)
    H, dr = cfg.n_heads, cfg.qk_rope_dim
    q = torch.cat([q_nope, q_rope], dim=-1)                            # (B, S, H, dn + dr)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    scale = (cfg.qk_nope_dim + dr) ** -0.5
    o = blockwise_attention(q, k, v, causal=True, block_kv=min(block_kv, S), query_scale=scale)
    out = o.reshape(B, S, H * cfg.v_dim) @ p["wo"].to(x.dtype)
    return out, (c_kv, k_rope)


def mla_decode(p: dict, cfg: MLAConfig, x, ckv_cache, krope_cache, pos):
    """One token x (B, 1, M) at ``pos`` (an int or a 0-d integer tensor)
    against the compressed caches ckv (B, S, R) and krope (B, S, dr),
    written in place. Scores in latent space: q_nope·k_nope = (q_nope
    W_uk^T)·c_kv, so no per-head key is expanded over S; the values are
    expanded after the softmax-weighted latent sum. Returns (out (B, 1,
    M), ckv_cache, krope_cache)."""
    B = x.shape[0]
    S, R = ckv_cache.shape[1], ckv_cache.shape[2]
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim
    pos_t = device_pos(pos, x.device)
    positions = pos_t.long().expand(B, 1)
    q_nope, q_rope = _queries(p, cfg, x, positions)          # (B, 1, H, dn), (B, 1, H, dr)
    c_kv, k_rope = _latents(p, cfg, x, positions)            # (B, 1, R), (B, 1, dr)
    write_slot(ckv_cache, c_kv, pos_t)
    write_slot(krope_cache, k_rope, pos_t)

    w_uk = p["w_uk"].to(x.dtype).reshape(R, H, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)             # (B, H, R)
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_cache.float())
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), krope_cache.float())
    s = s * ((dn + dr) ** -0.5)
    valid = torch.arange(S, device=x.device) <= pos_t
    s = torch.where(valid[None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhs,bsr->bhr", w, ckv_cache.float())             # (B, H, R)
    w_uv = p["w_uv"].to(x.dtype).reshape(R, H, dv)
    o = torch.einsum("bhr,rhd->bhd", lat.to(x.dtype), w_uv)              # (B, H, dv)
    out = o.reshape(B, 1, H * dv) @ p["wo"].to(x.dtype)
    return out, ckv_cache, krope_cache
