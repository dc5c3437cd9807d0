"""Decoder-only transformer LM: the dense, MoE and MLA architectures (qwen3,
deepseek-67b, command-r, gemma3, the mistral backbone, phi-3.5-moe,
deepseek-v2-lite).

The port of ``repro/models/transformer.py``. Parameters are one flat
dict keyed by the reference's tree paths, in its stacked layout: every
leaf under ``layers.`` has a leading (L, ...) axis (``layers.attn.wq`` is
(L, M, H·D)) and layer l reads index l, so
``repro_torch.convert.params_from_jax`` carries JAX's parameters across
unchanged and the leaf order (FVN's per-leaf keys, the wire bytes) is
JAX's. Layer heterogeneity is data, as in the reference: ``layer_windows``
gives each layer's window width (0: full attention), and
``moe_first_dense`` leading dense layers live under ``dense_layers.``.

Every full-sequence attention (``trunk``, ``loss_fn``, ``prefill``) runs
K10 on the card, differentiated by K10's backward under autograd, and
every ``decode_step`` attention K11, one launch a layer each. A layer of
window 0 gives the kernels no window (the reference passes a window wider
than the sequence, ``S + 1`` or ``pos + 2``, which masks nothing).

``decode_step`` writes the new token's k/v into the cache in place, at
``pos`` (``pos mod S`` for a ring cache) clamped into the cache as
``lax.dynamic_update_slice`` clamps its start. ``prefill`` returns a
cache as long as the prompt, so a decode step straight after it
overwrites the last prompt slot, in both packages: serving copies
``prefill``'s cache into an ``init_cache(B, total)`` first (F6 in
ROADMAP.md).

A config with ``mla`` (multi-head latent attention, ``models/mla.py``)
takes it in every layer where the reference does (``repro/models/
transformer.py:109-110``, ``:150-151``, ``:247-251``, ``:269-271``,
``:377-380``): its cache is the compressed ``{"ckv", "krope"}`` (L, B, S,
kv_lora) and (L, B, S, qk_rope_dim), its full-sequence attention K10 at a
q·k width of qk_nope_dim + qk_rope_dim. As in the reference, MLA ignores
the layer's window in the forward and ``ring`` in a decode step (it writes
at ``pos``, clamped into a cache that ``init_cache(ring=True)`` may have
sized at the window: F7 in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.ref import tanh
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.encdec import _flat, _layers
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
    dense_init,
    embed_init,
    layer_norm,
    lm_loss,
    mlp_apply,
    mlp_init,
    rms_norm,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rms"                  # "rms" | "ln"
    rms_plus_one: bool = False         # gemma convention
    qk_norm: bool = False
    use_bias: bool = False
    parallel_block: bool = False       # command-r style attn + mlp in parallel
    rope_theta: float = 10000.0
    window: Optional[int] = None       # sliding window width for local layers
    global_every: int = 0              # 0: all layers follow `window`;
                                       # k > 0: every k-th layer is global (gemma3)
    logit_softcap: float = 0.0
    emb_scale: bool = False            # multiply embeddings by sqrt(d) (gemma)
    moe: Optional[moe_lib.MoEConfig] = None
    moe_first_dense: int = 0           # leading dense layers (deepseek-v2)
    first_dense_ff: int = 0
    mla: Optional[mla_lib.MLAConfig] = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    loss_chunk: int = 256

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.head_dim, rope_theta=self.rope_theta,
            qk_norm=self.qk_norm, use_bias=self.use_bias,
            logit_softcap=self.logit_softcap,
        )

    def layer_windows(self) -> list:
        """Each stacked layer's window width (``repro/models/transformer.py:85``);
        0 = full attention."""
        n = self.n_layers - self.moe_first_dense
        if self.window is None:
            return [0] * n
        if self.global_every <= 0:
            return [self.window] * n
        return [0 if (idx + 1) % self.global_every == 0 else self.window
                for idx in range(self.moe_first_dense, self.n_layers)]


# ------------------------------------------------------------------ init

def _layer_init(generator, cfg: TransformerConfig, device) -> dict:
    dt = cfg.pdtype
    p = {"norm1": torch.ones((cfg.d_model,), dtype=dt, device=device)}
    if not cfg.parallel_block:
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    if cfg.norm == "ln":
        p["norm1_b"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        if not cfg.parallel_block:
            p["norm2_b"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    if cfg.mla is not None:
        p["attn"] = mla_lib.mla_init(generator, cfg.mla, dt, device=device)
    else:
        p["attn"] = attn_init(generator, cfg.attn_cfg(), dt, device=device)
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_init(generator, cfg.d_model, cfg.moe, dt, device=device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt, device=device)
    return p


def _stacked(generator, cfg: TransformerConfig, n: int, prefix: str, device) -> dict:
    """``n`` layers' parameters stacked on a leading axis, one leaf a name."""
    flat = [_flat(_layer_init(generator, cfg, device), prefix) for _ in range(n)]
    return {k: torch.stack([f[k] for f in flat]) for k in flat[0]}


def init_params(cfg: TransformerConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's initializers
    (``repro/models/transformer.py:120``); the draws are the generator's,
    not JAX's. ``device`` None is the generator's; ``"meta"`` gives every
    leaf's shape and dtype without memory."""
    dev = generator.device if device is None else device
    n_scan = cfg.n_layers - cfg.moe_first_dense
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, cfg.pdtype, device=dev),
        **_stacked(generator, cfg, n_scan, "layers", dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=dev),
        "unembed": dense_init(generator, cfg.d_model, cfg.vocab, cfg.pdtype, device=dev),
    }
    if cfg.norm == "ln":
        params["final_norm_b"] = torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=dev)
    if cfg.moe_first_dense > 0:
        dense_cfg = _dense_cfg(cfg)
        params.update(_stacked(generator, dense_cfg, cfg.moe_first_dense, "dense_layers", dev))
    return params


def _dense_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """The config of the leading dense layers (``moe_first_dense``)."""
    return dataclasses.replace(cfg, moe=None, moe_first_dense=0,
                               d_ff=cfg.first_dense_ff or cfg.d_ff)


# ------------------------------------------------------------------ forward

def _norm(cfg: TransformerConfig, p: dict, x, which: str):
    if cfg.norm == "ln":
        return layer_norm(x, p[which], p[which + "_b"])
    return rms_norm(x, p[which], plus_one=cfg.rms_plus_one)


def _final_norm(cfg: TransformerConfig, params: dict, x):
    return _norm(cfg, params, x, "final_norm")


def _ffn(cfg: TransformerConfig, lp: dict, h, is_moe: bool):
    """The layer's MLP or MoE: (out, aux loss)."""
    if is_moe:
        return moe_lib.moe_apply(lp["moe"], cfg.moe, h, cfg.act)
    return mlp_apply(lp["mlp"], h, cfg.act), None


def _layer_forward(cfg: TransformerConfig, lp: dict, x, window: int, is_moe: bool,
                   block_kv: int = 512):
    """One layer over the full sequence: (x, its cache entries ((k, v), or
    MLA's (c_kv, k_rope)), aux or None). MLA takes no window, as in the
    reference."""
    h = _norm(cfg, lp, x, "norm1")
    if cfg.mla is not None:
        attn_out, kv = mla_lib.mla_forward(lp["attn"], cfg.mla, h, block_kv=block_kv)
    else:
        attn_out, kv = _attn_forward_dynwin(lp["attn"], cfg.attn_cfg(), h, window, block_kv)
    if cfg.parallel_block:
        m, aux = _ffn(cfg, lp, h, is_moe)
        return x + attn_out + m, kv, aux
    x = x + attn_out
    m, aux = _ffn(cfg, lp, _norm(cfg, lp, x, "norm2"), is_moe)
    return x + m, kv, aux


def _attn_forward_dynwin(p: dict, acfg: AttnConfig, x, window: int, block_kv: int):
    """Causal attention over x (B, S, M) with the layer's window (0: full):
    K10 on the card. Returns (out, (k, v))."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, acfg, x, positions)
    o = blockwise_attention(q, k, v, causal=True, window=window or None,
                            logit_softcap=acfg.logit_softcap, block_kv=min(block_kv, S),
                            query_scale=acfg.query_scale)
    out = o.reshape(B, S, acfg.n_heads * acfg.head_dim) @ p["wo"].to(x.dtype)
    return out, (k, v)


def embed_tokens(cfg: TransformerConfig, params: dict, tokens):
    x = params["embed"].to(cfg.cdtype)[tokens]
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _stack_forward(cfg: TransformerConfig, params: dict, x, keep_kv: bool):
    """The dense layers, then the stacked layers over embeddings x:
    (x, aux total fp32, {prefix: [(k, v) a layer]} when ``keep_kv``)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = {}
    groups = []
    if cfg.moe_first_dense > 0:
        groups.append(("dense_layers", _dense_cfg(cfg), [0] * cfg.moe_first_dense, False))
    groups.append(("layers", cfg, cfg.layer_windows(), cfg.moe is not None))
    for prefix, gcfg, windows, is_moe in groups:
        kv_list = []
        for lp, w in zip(_layers(params, prefix, len(windows)), windows):
            x, kv, aux = _layer_forward(gcfg, lp, x, w, is_moe)
            if aux is not None:
                aux_total = aux_total + aux
            if keep_kv:
                kv_list.append(kv)
        kvs[prefix] = kv_list
    return x, aux_total, kvs


def forward(cfg: TransformerConfig, params: dict, tokens):
    """tokens (B, S) -> (final hidden (B, S, D), aux loss)."""
    return trunk(cfg, params, embed_tokens(cfg, params, tokens))


def trunk(cfg: TransformerConfig, params: dict, x):
    """The layer stack from embeddings x (B, S, D) -> (hidden, aux loss)."""
    x, aux, _ = _stack_forward(cfg, params, x, keep_kv=False)
    return _final_norm(cfg, params, x), aux


def loss_fn(cfg: TransformerConfig, params: dict, batch: dict, key=None):
    """Next-token LM loss. batch: {"tokens": (B, S) int, optional "weight"
    (B,)}. Returns (lm + aux, {"lm_loss", "aux_loss"}); ``key`` is
    unused, as the reference's ``rng``."""
    h, aux = forward(cfg, params, batch["tokens"])
    loss = lm_loss(h, params["unembed"].to(cfg.cdtype), batch["tokens"],
                   chunk=cfg.loss_chunk, logit_softcap=cfg.logit_softcap,
                   weight=batch.get("weight"))
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


def unembed(cfg: TransformerConfig, params: dict, x):
    """x (..., D) final hidden -> logits (..., V) fp32, soft-capped."""
    logits = (x @ params["unembed"].to(cfg.cdtype)).float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * tanh(logits / cfg.logit_softcap)
    return logits


# ------------------------------------------------------------------ cache

def init_cache(cfg: TransformerConfig, batch: int, seq_len: int, ring: bool = False,
               device="cuda") -> dict:
    """{"layers": {"k", "v"}} of (L, B, S, Kv, D) zeros in the compute dtype
    (and "dense_layers" for the leading dense layers); with ``mla``,
    {"ckv", "krope"} of (L, B, S, kv_lora) and (L, B, S, qk_rope_dim).
    ``ring=True`` sizes the windowed layers at their window (a ring buffer)
    where every layer is windowed."""
    n_scan = cfg.n_layers - cfg.moe_first_dense
    z = dict(dtype=cfg.cdtype, device=device)

    def kv_cache(n, s):
        if cfg.mla is not None:
            return {"ckv": torch.zeros((n, batch, s, cfg.mla.kv_lora), **z),
                    "krope": torch.zeros((n, batch, s, cfg.mla.qk_rope_dim), **z)}
        return {"k": torch.zeros((n, batch, s, cfg.n_kv, cfg.head_dim), **z),
                "v": torch.zeros((n, batch, s, cfg.n_kv, cfg.head_dim), **z)}

    s_main = seq_len
    if ring and cfg.window is not None and cfg.global_every == 0:
        s_main = min(seq_len, cfg.window)
    cache = {"layers": kv_cache(n_scan, s_main)}
    if cfg.moe_first_dense > 0:
        cache["dense_layers"] = kv_cache(cfg.moe_first_dense, seq_len)
    return cache


def _attn_decode_dynwin(p: dict, acfg: AttnConfig, x, k_cache, v_cache, pos_t, window: int,
                        ring: bool):
    """One token x (B, 1, M) at ``pos_t`` against a layer's caches (B, S,
    Kv, D), written in place: K11 on the card."""
    B, S = x.shape[0], k_cache.shape[1]
    q, k, v = _project_qkv(p, acfg, x, pos_t.long().expand(B, 1))
    slot = torch.remainder(pos_t, S) if ring else pos_t
    write_slot(k_cache, k, slot)
    write_slot(v_cache, v, slot)
    o = decode_attention(q[:, 0], k_cache, v_cache, pos_t, window=window or None, ring=ring,
                         logit_softcap=acfg.logit_softcap, query_scale=acfg.query_scale)
    return o.reshape(B, 1, acfg.n_heads * acfg.head_dim) @ p["wo"].to(x.dtype)


def _cache_names(cfg: TransformerConfig) -> tuple:
    """A layer group's cache entries, in the order a layer's forward
    returns them."""
    return ("ckv", "krope") if cfg.mla is not None else ("k", "v")


def _layer_decode(cfg: TransformerConfig, lp: dict, x, rows: tuple, pos_t, window: int,
                  is_moe: bool, ring: bool):
    """One layer at one token; ``rows`` the layer's caches (``_cache_names``),
    written in place."""
    h = _norm(cfg, lp, x, "norm1")
    if cfg.mla is not None:
        attn_out = mla_lib.mla_decode(lp["attn"], cfg.mla, h, *rows, pos_t)[0]
    else:
        attn_out = _attn_decode_dynwin(lp["attn"], cfg.attn_cfg(), h, *rows, pos_t, window,
                                       ring)
    if cfg.parallel_block:
        return x + attn_out + _ffn(cfg, lp, h, is_moe)[0]
    x = x + attn_out
    return x + _ffn(cfg, lp, _norm(cfg, lp, x, "norm2"), is_moe)[0]


def decode_step(cfg: TransformerConfig, params: dict, cache: dict, tokens, pos,
                ring: bool = False):
    """tokens (B, 1); ``pos`` the position being written (an int or a 0-d
    integer tensor, read on the device). Writes each layer's k/v (MLA's
    c_kv/k_rope) into the cache in place. Returns (logits (B, V) fp32,
    cache)."""
    x = embed_tokens(cfg, params, tokens)
    pos_t = device_pos(pos, x.device)
    groups = []
    if cfg.moe_first_dense > 0:
        groups.append(("dense_layers", _dense_cfg(cfg), [0] * cfg.moe_first_dense, False,
                       False))
    groups.append(("layers", cfg, cfg.layer_windows(), cfg.moe is not None, ring))
    for prefix, gcfg, windows, is_moe, gring in groups:
        caches = [cache[prefix][name] for name in _cache_names(cfg)]
        for l, (lp, w) in enumerate(zip(_layers(params, prefix, len(windows)), windows)):
            x = _layer_decode(gcfg, lp, x, tuple(c[l] for c in caches), pos_t, w, is_moe, gring)
    x = _final_norm(cfg, params, x)
    return unembed(cfg, params, x[:, 0]), cache


def prefill(cfg: TransformerConfig, params: dict, tokens):
    """A causal forward building the cache: (last token's logits, cache),
    the cache laid out as ``init_cache(..., ring=False)`` with seq_len =
    tokens.shape[1] (``_kv_to_cache``, ``repro/models/transformer.py:377``)."""
    return prefill_embeds(cfg, params, embed_tokens(cfg, params, tokens))


def prefill_embeds(cfg: TransformerConfig, params: dict, x):
    """Prefill from embeddings x (B, S, D), the VLM's entry point."""
    x, _, kvs = _stack_forward(cfg, params, x, keep_kv=True)
    names = _cache_names(cfg)
    cache = {prefix: {name: torch.stack([e[i] for e in kv]) for i, name in enumerate(names)}
             for prefix, kv in kvs.items()}
    x = _final_norm(cfg, params, x)
    return unembed(cfg, params, x[:, -1]), cache
