"""Zamba2-style hybrid (arXiv:2411.15242): a Mamba2 backbone with one
shared attention + MLP block applied periodically.

The port of ``repro/models/hybrid.py``. For n_layers Mamba2 layers with the
shared block every ``attn_every``: G full groups of [shared block ->
attn_every Mamba2 layers], then a tail [shared block -> the rest]. The
shared block's weights are the same at every application; each
application has its own KV cache. Parameters are one flat dict keyed by
the reference's tree paths in its stacked layout: ``groups.*`` leaves have
leading (G, E, ...) axes, ``tail.*`` (tail, ...), and ``shared_attn.*``
one weight set, so ``repro_torch.convert.params_from_jax`` carries JAX's
parameters across unchanged.

The Mamba2 layers run K13 (``kernels/ssm_scan.py``), or the chunked SSD
form with ``ssm_chunked``; the shared block's attention runs on
``models/attention.py``: K10 and K10's backward in training, K11 in
``decode_step``. As in the reference there is no prefill: serving enters
through ``decode_step``, which writes each application's k/v and each
layer's SSM and conv states into the cache in place.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import AttnConfig, attn_decode, attn_forward, attn_init, \
    device_pos
from repro_torch.models.encdec import _flat
from repro_torch.models.layers import dense_init, embed_init, lm_loss, mlp_apply, mlp_init, \
    rms_norm
from repro_torch.models.ssm import MambaConfig, mamba_forward, mamba_forward_chunked, \
    mamba_init, mamba_init_state, mamba_step


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int                 # number of Mamba2 layers
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int                     # the shared block's MLP
    vocab: int
    attn_every: int = 6
    ssm_state: int = 64
    ssm_headdim: int = 64
    ssm_chunked: bool = False     # the chunked SSD form (models/ssm.py)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    loss_chunk: int = 256

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.attn_every

    @property
    def tail(self) -> int:
        return self.n_layers - self.n_groups * self.attn_every

    @property
    def n_attn_applications(self) -> int:
        return self.n_groups + (1 if self.tail else 0)

    def mamba_cfg(self) -> MambaConfig:
        return MambaConfig(d_model=self.d_model, headdim=self.ssm_headdim,
                           d_state=self.ssm_state)

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
                          head_dim=self.head_dim)


def _mamba_layer_init(generator, cfg: HybridConfig, device) -> dict:
    return {"norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=device),
            "mamba": mamba_init(generator, cfg.mamba_cfg(), cfg.pdtype, device=device)}


def _stack(layers: list) -> dict:
    """Per-layer flat dicts stacked on a new leading axis, one leaf a name."""
    return {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}


def init_params(cfg: HybridConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's initializers and layout
    (``repro/models/hybrid.py:85``); the draws are the generator's.
    ``device`` None is the generator's; ``"meta"`` gives the shapes."""
    dev = generator.device if device is None else device
    dt = cfg.pdtype
    G, E = cfg.n_groups, cfg.attn_every
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dt, device=dev),
        **_flat({"norm1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                 "norm2": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                 "attn": attn_init(generator, cfg.attn_cfg(), dt, device=dev),
                 "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, gated=True, dtype=dt,
                                 device=dev)}, "shared_attn"),
    }
    if G:
        groups = [_stack([_flat(_mamba_layer_init(generator, cfg, dev)) for _ in range(E)])
                  for _ in range(G)]
        params.update(_flat(_stack(groups), "groups"))
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
    params["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab, dt, device=dev)
    if cfg.tail:
        params.update(_flat(_stack([_flat(_mamba_layer_init(generator, cfg, dev))
                                    for _ in range(cfg.tail)]), "tail"))
    return params


def _sub(params: dict, prefix: str) -> dict:
    """The nested dict under ``prefix.`` (views of the leaves)."""
    out = {}
    for name, t in params.items():
        if not name.startswith(prefix + "."):
            continue
        *path, leaf = name[len(prefix) + 1:].split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


def _unbind(tree: dict, dims: int) -> dict:
    """Every leaf of a nested dict unbound on its ``dims`` leading axes
    (nested tuples of views). Under autograd one backward node stacks the
    layers' gradients, where indexing a leaf layer by layer would add each
    layer's gradient into a zero tensor of the whole stack."""
    def split(t, n):
        return t if n == 0 else tuple(split(u, n - 1) for u in t.unbind(0))

    return {k: _unbind(v, dims) if isinstance(v, dict) else split(v, dims)
            for k, v in tree.items()}


def _mamba_layers(cfg: HybridConfig, params: dict) -> list:
    """[((group or None, layer index), the layer's parameters)] in the
    reference's order: the groups' layers, then the tail's."""
    out = []
    groups = _unbind(_sub(params, "groups"), 2)
    for g in range(cfg.n_groups):
        out += [((g, e), _pick(groups, g, e)) for e in range(cfg.attn_every)]
    tail = _unbind(_sub(params, "tail"), 1)
    out += [((None, e), _pick(tail, e)) for e in range(cfg.tail)]
    return out


def _pick(tree: dict, *idx) -> dict:
    """Every leaf (nested tuples) of an unbound tree at ``idx``."""
    def at(t):
        for i in idx:
            t = t[i]
        return t

    return {k: _pick(v, *idx) if isinstance(v, dict) else at(v) for k, v in tree.items()}


def _shared_block_forward(cfg: HybridConfig, sp: dict, x):
    h = rms_norm(x, sp["norm1"])
    a, kv = attn_forward(sp["attn"], cfg.attn_cfg(), h, block_kv=min(512, x.shape[1]))
    x = x + a
    return x + mlp_apply(sp["mlp"], rms_norm(x, sp["norm2"]), "silu"), kv


def _mamba_layer_fwd(cfg: HybridConfig, lp: dict, x):
    h = rms_norm(x, lp["norm"])
    if cfg.ssm_chunked:
        return x + mamba_forward_chunked(lp["mamba"], cfg.mamba_cfg(), h)
    return x + mamba_forward(lp["mamba"], cfg.mamba_cfg(), h)


def forward(cfg: HybridConfig, params: dict, tokens):
    """tokens (B, S) -> the final hidden (B, S, D): the shared block at the
    head of each group and of the tail, each Mamba2 layer residual."""
    x = params["embed"].to(cfg.cdtype)[tokens]
    sp = _sub(params, "shared_attn")
    for (g, e), lp in _mamba_layers(cfg, params):
        if e == 0:
            x = _shared_block_forward(cfg, sp, x)[0]
        x = _mamba_layer_fwd(cfg, lp, x)
    return rms_norm(x, params["final_norm"])


def loss_fn(cfg: HybridConfig, params: dict, batch: dict, key=None):
    """Next-token LM loss. batch {"tokens": (B, S), optional "weight"
    (B,)}. Returns (loss, {"lm_loss"}); ``key`` is unused, as the
    reference's ``rng``."""
    h = forward(cfg, params, batch["tokens"])
    loss = lm_loss(h, params["unembed"].to(cfg.cdtype), batch["tokens"],
                   chunk=min(cfg.loss_chunk, h.shape[1]), weight=batch.get("weight"))
    return loss, {"lm_loss": loss}


# -------------------------------------------------------------- serving

def init_cache(cfg: HybridConfig, batch: int, seq_len: int, device="cuda") -> dict:
    """{"attn_k", "attn_v": (applications, B, S, Kv, D) in the compute
    dtype, "groups": the Mamba2 states on (G, E, ...) axes, "tail": on
    (tail, ...)}, all zeros."""
    one = mamba_init_state(cfg.mamba_cfg(), batch, cfg.cdtype, device=device)

    def rep(tree, *dims):
        return {k: rep(v, *dims) if isinstance(v, dict) else
                v.expand(*dims, *v.shape).clone() for k, v in tree.items()}

    shape = (cfg.n_attn_applications, batch, seq_len, cfg.n_kv, cfg.head_dim)
    cache = {"attn_k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
             "attn_v": torch.zeros(shape, dtype=cfg.cdtype, device=device),
             "groups": rep(one, cfg.n_groups, cfg.attn_every)}
    if cfg.tail:
        cache["tail"] = rep(one, cfg.tail)
    return cache


def _shared_block_decode(cfg: HybridConfig, sp: dict, x, kc, vc, pos_t):
    h = rms_norm(x, sp["norm1"])
    a, _, _ = attn_decode(sp["attn"], cfg.attn_cfg(), h, kc, vc, pos_t)
    x = x + a
    return x + mlp_apply(sp["mlp"], rms_norm(x, sp["norm2"]), "silu")


def _write_state(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _write_state(dst[k], v)
        else:
            dst[k].copy_(v)


def decode_step(cfg: HybridConfig, params: dict, cache: dict, tokens, pos):
    """tokens (B, 1); ``pos`` the position being written (an int or a 0-d
    integer tensor). Writes each application's k/v at ``pos`` and each
    layer's states into the cache in place. Returns (logits (B, V) fp32,
    cache)."""
    x = params["embed"].to(cfg.cdtype)[tokens]
    pos_t = device_pos(pos, x.device)
    sp = _sub(params, "shared_attn")
    mc = cfg.mamba_cfg()
    groups = _unbind(cache["groups"], 2)              # views of the cache
    tail = _unbind(cache["tail"], 1) if cfg.tail else None
    for (g, e), lp in _mamba_layers(cfg, params):
        app = cfg.n_groups if g is None else g
        if e == 0:
            x = _shared_block_decode(cfg, sp, x, cache["attn_k"][app], cache["attn_v"][app],
                                     pos_t)
        state = _pick(tail, e) if g is None else _pick(groups, g, e)
        out, new = mamba_step(lp["mamba"], mc, rms_norm(x, lp["norm"]), state)
        _write_state(state, new)
        x = x + out
    x = rms_norm(x, params["final_norm"])
    return (x[:, 0] @ params["unembed"].to(cfg.cdtype)).float(), cache
