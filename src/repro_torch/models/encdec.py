"""Encoder-decoder transformer (Whisper-style), the [audio] backbone.

The port of ``repro/models/encdec.py:36-259``. As in the reference, the
mel-spectrogram and conv front end is a stub: ``frames`` are precomputed
frame embeddings (B, T, d_model). The backbone is a bidirectional
encoder with sinusoidal positions, a causal decoder with cross-attention,
the teacher-forced LM loss, and serving: ``prefill`` builds the caches
and ``decode_step`` runs one token against them.

Parameters are one flat dict keyed by the reference's tree paths, in its
stacked layout: ``enc_layers.attn.wq`` is (L, M, H·D) and layer l reads
index l, so ``repro_torch.convert.params_from_jax`` carries JAX's
parameters across unchanged. Every attention of ``encode``, ``prefill``,
``decode_train`` and ``loss_fn`` runs K10 on the card (``encode``: one a
layer; the decoder: self and cross, two a layer), and every attention
of ``decode_step`` K11 (two a layer).

``decode_step`` writes the new token's k/v at ``pos`` clamped into the
self cache, as ``lax.dynamic_update_slice`` clamps its start, and updates
the cache in place. ``prefill`` returns a self cache as long as the
prompt, so a decode step straight after it overwrites the last prompt
slot, in both packages: serving copies ``prefill``'s caches into an
``init_cache(B, total)`` first (F6 in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import (
    AttnConfig,
    _project_qkv,
    attn_init,
    blockwise_attention,
    decode_attention,
    device_pos,
    write_slot,
)
from repro_torch.models.layers import (
    embed_init,
    layer_norm,
    lm_loss,
    mlp_apply,
    mlp_init,
    sinusoidal_positions,
)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    enc_layers: int
    dec_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    max_source: int = 1500
    max_target: int = 448
    act: str = "gelu"
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    loss_chunk: int = 64

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def attn_cfg(self, causal: bool) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
                          head_dim=self.head_dim, rope_theta=0.0, causal=causal)


def _ln(prefix: str, d: int, dt, device) -> dict:
    return {prefix: torch.ones((d,), dtype=dt, device=device),
            prefix + "_b": torch.zeros((d,), dtype=dt, device=device)}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _stacked(layers: list, prefix: str) -> dict:
    flat = [_flat(lp) for lp in layers]
    return {f"{prefix}.{k}": torch.stack([f[k] for f in flat]) for k in flat[0]}


def _enc_layer_init(generator, cfg: EncDecConfig) -> dict:
    dt, dev = cfg.pdtype, generator.device
    return {**_ln("norm1", cfg.d_model, dt, dev), **_ln("norm2", cfg.d_model, dt, dev),
            "attn": attn_init(generator, cfg.attn_cfg(False), dt),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, gated=False, dtype=dt)}


def _dec_layer_init(generator, cfg: EncDecConfig) -> dict:
    dt, dev = cfg.pdtype, generator.device
    return {**_ln("norm1", cfg.d_model, dt, dev), **_ln("norm2", cfg.d_model, dt, dev),
            **_ln("norm3", cfg.d_model, dt, dev),
            "self_attn": attn_init(generator, cfg.attn_cfg(True), dt),
            "cross_attn": attn_init(generator, cfg.attn_cfg(False), dt),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, gated=False, dtype=dt)}


def init_params(cfg: EncDecConfig, generator: torch.Generator) -> dict:
    """Random parameters on ``generator``'s device with the reference's
    initializers (``repro/models/encdec.py:100-111``); the draws are the
    generator's, not JAX's."""
    dt, dev = cfg.pdtype, generator.device
    pos = torch.randn((cfg.max_target, cfg.d_model), generator=generator, device=dev) * 0.01
    return {
        **_stacked([_enc_layer_init(generator, cfg) for _ in range(cfg.enc_layers)],
                   "enc_layers"),
        **_ln("enc_norm", cfg.d_model, dt, dev),
        "tok_embed": embed_init(generator, cfg.vocab, cfg.d_model, dt),
        "pos_embed": pos.to(dt),
        **_stacked([_dec_layer_init(generator, cfg) for _ in range(cfg.dec_layers)],
                   "dec_layers"),
        **_ln("final_norm", cfg.d_model, dt, dev),
    }


def param_count(cfg: EncDecConfig) -> int:
    M, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    q, kv = M * cfg.n_heads * cfg.head_dim, M * cfg.n_kv * cfg.head_dim
    attn = 2 * q + 2 * kv
    enc = attn + 2 * M * F + 4 * M
    dec = 2 * attn + 2 * M * F + 6 * M
    return cfg.enc_layers * enc + cfg.dec_layers * dec + V * M + cfg.max_target * M + 4 * M


def _layers(params: dict, prefix: str, n: int) -> list:
    """Layer l's parameters as the reference's nested dict, each leaf
    index l of the stacked tensor (a view)."""
    out = [{} for _ in range(n)]
    for name, t in params.items():
        if not name.startswith(prefix + "."):
            continue
        *path, leaf = name[len(prefix) + 1:].split(".")
        for l in range(n):
            node = out[l]
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t[l]
    return out


def encode(cfg: EncDecConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d_model) stub embeddings -> (B, T, d_model)."""
    x = frames.to(cfg.cdtype)
    B, T, _ = x.shape
    x = x + sinusoidal_positions(T, cfg.d_model, x.device).to(x.dtype)[None]
    acfg = cfg.attn_cfg(False)
    positions = torch.zeros((B, T), dtype=torch.long, device=x.device)
    for lp in _layers(params, "enc_layers", cfg.enc_layers):
        h = layer_norm(x, lp["norm1"], lp["norm1_b"])
        q, k, v = _project_qkv(lp["attn"], acfg, h, positions)
        o = blockwise_attention(q, k, v, causal=False, block_kv=min(512, T))
        x = x + o.reshape(B, T, -1) @ lp["attn"]["wo"].to(x.dtype)
        h2 = layer_norm(x, lp["norm2"], lp["norm2_b"])
        x = x + mlp_apply(lp["mlp"], h2, cfg.act)
    return layer_norm(x, params["enc_norm"], params["enc_norm_b"])


def _cross_kv(lp: dict, acfg: AttnConfig, enc_out: torch.Tensor):
    """Cross-attention K, V (B, T, Kv, D) from the encoder output."""
    B, T, _ = enc_out.shape
    k = (enc_out @ lp["cross_attn"]["wk"].to(enc_out.dtype)).reshape(B, T, acfg.n_kv,
                                                                     acfg.head_dim)
    v = (enc_out @ lp["cross_attn"]["wv"].to(enc_out.dtype)).reshape(B, T, acfg.n_kv,
                                                                     acfg.head_dim)
    return k, v


def _cross_q(lp: dict, acfg: AttnConfig, h: torch.Tensor) -> torch.Tensor:
    """The cross-attention query: ``_project_qkv``'s q, which is all the
    reference keeps of it (the cross config has no bias, norm or rope)."""
    B, S, _ = h.shape
    return (h @ lp["cross_attn"]["wq"].to(h.dtype)).reshape(B, S, acfg.n_heads, acfg.head_dim)


def _dec_layer(cfg: EncDecConfig, lp: dict, x, enc_out, pos_q, cross=None):
    """One decoder layer over a token block. ``cross``: the layer's
    cross K, V when the caller has them (``prefill``). Returns (x, (k, v))."""
    acfg, xcfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
    h = layer_norm(x, lp["norm1"], lp["norm1_b"])
    q, k, v = _project_qkv(lp["self_attn"], acfg, h, pos_q)
    o = blockwise_attention(q, k, v, causal=True, block_kv=min(512, x.shape[1]))
    x = x + o.reshape(*x.shape[:2], -1) @ lp["self_attn"]["wo"].to(x.dtype)
    h2 = layer_norm(x, lp["norm2"], lp["norm2_b"])
    q2 = _cross_q(lp, xcfg, h2)
    ck, cv = cross if cross is not None else _cross_kv(lp, xcfg, enc_out)
    o2 = blockwise_attention(q2, ck, cv, causal=False, block_kv=min(512, enc_out.shape[1]))
    x = x + o2.reshape(*x.shape[:2], -1) @ lp["cross_attn"]["wo"].to(x.dtype)
    h3 = layer_norm(x, lp["norm3"], lp["norm3_b"])
    x = x + mlp_apply(lp["mlp"], h3, cfg.act)
    return x, (k, v)


def _embed_tokens(cfg: EncDecConfig, params: dict, tokens: torch.Tensor):
    B, U = tokens.shape
    x = params["tok_embed"].to(cfg.cdtype)[tokens]
    pe = params["pos_embed"].to(x.dtype)
    x = x + pe[torch.arange(U, device=x.device) % pe.shape[0]][None]  # wraps past max_target
    return x, torch.arange(U, device=x.device).expand(B, U)


def decode_train(cfg: EncDecConfig, params: dict, tokens, enc_out):
    """Teacher-forced decoder over tokens (B, U): the final hidden state."""
    x, pos_q = _embed_tokens(cfg, params, tokens)
    for lp in _layers(params, "dec_layers", cfg.dec_layers):
        x, _ = _dec_layer(cfg, lp, x, enc_out, pos_q)
    return layer_norm(x, params["final_norm"], params["final_norm_b"])


def loss_fn(cfg: EncDecConfig, params: dict, batch: dict, key=None):
    """batch: frames (B, T, d_model), tokens (B, U), optional weight (B,).
    Returns (loss, {"lm_loss": loss}); ``key`` is unused, as the
    reference's ``rng``."""
    enc_out = encode(cfg, params, batch["frames"])
    h = decode_train(cfg, params, batch["tokens"], enc_out)
    loss = lm_loss(h, params["tok_embed"].to(cfg.cdtype).T, batch["tokens"],
                   chunk=min(cfg.loss_chunk, h.shape[1]), weight=batch.get("weight"))
    return loss, {"lm_loss": loss}


# ------------------------------------------------------------------ serving

def init_cache(cfg: EncDecConfig, batch: int, seq_len: int, device="cuda") -> dict:
    L, Kv, D, T = cfg.dec_layers, cfg.n_kv, cfg.head_dim, cfg.max_source
    z = dict(dtype=cfg.cdtype, device=device)
    return {"self_k": torch.zeros((L, batch, seq_len, Kv, D), **z),
            "self_v": torch.zeros((L, batch, seq_len, Kv, D), **z),
            "cross_k": torch.zeros((L, batch, T, Kv, D), **z),
            "cross_v": torch.zeros((L, batch, T, Kv, D), **z)}


def prefill(cfg: EncDecConfig, params: dict, frames, tokens):
    """Encode the source and run the decoder teacher-forced over a token
    prefix, building the caches. Returns (last position's logits (B, V)
    fp32, cache)."""
    enc_out = encode(cfg, params, frames)
    x, pos_q = _embed_tokens(cfg, params, tokens)
    xcfg = cfg.attn_cfg(False)
    sk, sv, ck, cv = [], [], [], []
    for lp in _layers(params, "dec_layers", cfg.dec_layers):
        cross = _cross_kv(lp, xcfg, enc_out)
        x, (k, v) = _dec_layer(cfg, lp, x, enc_out, pos_q, cross)
        for acc, t in zip((sk, sv, ck, cv), (k, v, *cross)):
            acc.append(t)
    x = layer_norm(x, params["final_norm"], params["final_norm_b"])
    logits = (x[:, -1] @ params["tok_embed"].to(cfg.cdtype).T).float()
    cache = {name: torch.stack(ts) for name, ts in
             (("self_k", sk), ("self_v", sv), ("cross_k", ck), ("cross_v", cv))}
    return logits, cache


def decode_step(cfg: EncDecConfig, params: dict, cache: dict, tokens, pos):
    """One decoder token (B, 1) against the caches at ``pos`` (an int or a
    0-d integer tensor, read on the device). Writes the token's self k/v
    into the cache in place (at pos clamped into it). Returns (logits
    (B, V) fp32, cache)."""
    B = tokens.shape[0]
    x = params["tok_embed"].to(cfg.cdtype)[tokens]
    pos_t = device_pos(pos, x.device)
    pe = params["pos_embed"].to(x.dtype)
    # index_select: indexing with a 0-d device tensor would copy it to the host
    x = x + pe.index_select(0, torch.remainder(pos_t, pe.shape[0]).long().reshape(1))[None]
    acfg, xcfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
    positions = pos_t.long().expand(B, 1)
    cross_pos = device_pos(cache["cross_k"].shape[2] - 1, x.device)
    for l, lp in enumerate(_layers(params, "dec_layers", cfg.dec_layers)):
        sk, sv = cache["self_k"][l], cache["self_v"][l]
        h = layer_norm(x, lp["norm1"], lp["norm1_b"])
        q, k, v = _project_qkv(lp["self_attn"], acfg, h, positions)
        write_slot(sk, k, pos_t)
        write_slot(sv, v, pos_t)
        o = decode_attention(q[:, 0], sk, sv, pos_t)
        x = x + o.reshape(B, 1, -1) @ lp["self_attn"]["wo"].to(x.dtype)
        h2 = layer_norm(x, lp["norm2"], lp["norm2_b"])
        q2 = _cross_q(lp, xcfg, h2)
        o2 = decode_attention(q2[:, 0], cache["cross_k"][l], cache["cross_v"][l], cross_pos)
        x = x + o2.reshape(B, 1, -1) @ lp["cross_attn"]["wo"].to(x.dtype)
        h3 = layer_norm(x, lp["norm3"], lp["norm3_b"])
        x = x + mlp_apply(lp["mlp"], h3, cfg.act)
    x = layer_norm(x, params["final_norm"], params["final_norm_b"])
    logits = (x[:, 0] @ params["tok_embed"].to(cfg.cdtype).T).float()
    return logits, cache
