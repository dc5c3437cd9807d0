"""Unified model interface: ``build_model(config) -> ModelBundle``.

The port of ``repro/models/model_zoo.py:48-62`` for the configurations
the port has: the decoder-only transformer (kind ``dense``, or ``moe``
with a ``MoEConfig``, ``:127-137``), the Zamba2 hybrid (kind ``hybrid``,
``:138-147``, no prefill: serving enters through ``decode_step``), the
RWKV-6 stack (kind ``ssm``, ``RWKVModelConfig``, ``:28-123`` and
``:148-156``), the enc-dec (kind ``audio``, ``:157-165``), the VLM (kind
``vlm``, ``:166-173``), the RNN-T (kind ``rnnt``, ``:175-180``) and the
keyword classifier (kind ``keyword``, ``:181-186``). A bundle binds the config to
its functions and to one ``device``, the card unless the caller names the
CPU: ``init`` puts the parameters there, ``init_cache`` the caches, and
``loss_fn``, ``prefill`` and ``decode_step`` move the batch or tokens
they are given there. ``device=None`` moves nothing: the parameters stay
on the generator's device and the batch where the caller put it (the
federated task's bundle: the round engine places both). Any other
config type raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.models import encdec, hybrid, keyword, rnnt, transformer, vlm
from repro_torch.models.layers import dense_init, embed_init, lm_loss
from repro_torch.models.rwkv import RWKVConfig, _ln, rwkv_init_state, rwkv_layer_forward, \
    rwkv_layer_init


@dataclasses.dataclass
class ModelBundle:
    name: str
    kind: str                    # dense | moe | hybrid | ssm | audio | vlm | rnnt | keyword
    config: Any
    init: Callable               # (generator) -> params on ``device``
    loss_fn: Callable            # (params, batch, key) -> (loss, aux)
    prefill: Optional[Callable] = None      # (params, batch) -> (logits, cache)
    decode_step: Optional[Callable] = None  # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Optional[Callable] = None   # (batch, seq_len, ring=False) -> cache
    device: Optional[str] = "cuda"
    module: Optional[nn.Module] = None      # the RNN-T's shape-only template (meta)

    @staticmethod
    def param_count(params: dict) -> int:
        return sum(t.numel() for t in params.values())


def _on(device, batch: dict) -> dict:
    return batch if device is None else {k: v.to(device) for k, v in batch.items()}


def _to(device, t):
    return t if device is None else t.to(device)


# ------------------------------------------------------------- rwkv model

@dataclasses.dataclass(frozen=True)
class RWKVModelConfig:
    name: str
    n_layers: int
    rwkv: RWKVConfig
    vocab: int
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    loss_chunk: int = 256

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def _rwkv_init(cfg: RWKVModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters in the reference's layout (``:66``); ``device``
    None is the generator's, ``"meta"`` gives the shapes."""
    dev = generator.device if device is None else device
    D, dt = cfg.rwkv.d_model, cfg.pdtype
    layers = [rwkv_layer_init(generator, cfg.rwkv, dt, device=dev) for _ in range(cfg.n_layers)]
    return {
        "embed": embed_init(generator, cfg.vocab, D, dt, device=dev),
        **{f"layers.{k}": torch.stack([lp[k] for lp in layers]) for k in layers[0]},
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
        "final_norm_b": torch.zeros((D,), dtype=dt, device=dev),
        "unembed": dense_init(generator, D, cfg.vocab, dt, device=dev),
    }


def _rwkv_layer_state(states: dict, l: int) -> dict:
    return {k: _rwkv_layer_state(v, l) if isinstance(v, dict) else v[l]
            for k, v in states.items()}


def _rwkv_stack_states(states: list) -> dict:
    return {k: _rwkv_stack_states([s[k] for s in states]) if isinstance(states[0][k], dict)
            else torch.stack([s[k] for s in states]) for k in states[0]}


def _rwkv_forward(cfg: RWKVModelConfig, params: dict, tokens, states=None):
    """tokens (B, S) -> (the final hidden (B, S, D), the new per-layer states
    stacked on L, or None when ``states`` is None: training)."""
    x = params["embed"].to(cfg.cdtype)[tokens]
    # each stacked leaf unbound once: one backward node stacks its layers'
    # gradients, where indexing it layer by layer would add each layer's
    # gradient into a zero tensor of the whole stack
    layers = {k[len("layers."):]: v.unbind(0) for k, v in params.items()
              if k.startswith("layers.")}
    new = []
    for l in range(cfg.n_layers):
        lp = {k: v[l] for k, v in layers.items()}
        x, st = rwkv_layer_forward(lp, cfg.rwkv, x,
                                   None if states is None else _rwkv_layer_state(states, l))
        new.append(st)
    x = _ln(x, params["final_norm"], params["final_norm_b"])
    return x, None if states is None else _rwkv_stack_states(new)


def _rwkv_loss(cfg: RWKVModelConfig, params: dict, batch: dict, key=None):
    h, _ = _rwkv_forward(cfg, params, batch["tokens"])
    loss = lm_loss(h, params["unembed"].to(cfg.cdtype), batch["tokens"],
                   chunk=min(cfg.loss_chunk, batch["tokens"].shape[1]),
                   weight=batch.get("weight"))
    return loss, {"lm_loss": loss}


def _rwkv_init_cache(cfg: RWKVModelConfig, batch: int, seq_len: int, ring: bool = False,
                     device="cuda") -> dict:
    """The zero decode state of every layer, stacked on a leading L axis
    (``seq_len`` and ``ring`` are unused: the state does not grow)."""
    one = rwkv_init_state(cfg.rwkv, batch, cfg.cdtype, device=device)
    return _rwkv_stack_states([one] * cfg.n_layers)


def _rwkv_decode(cfg: RWKVModelConfig, params: dict, cache: dict, tokens, pos=None,
                 ring: bool = False):
    """tokens (B, 1) -> (logits (B, V) fp32, the new state); ``pos`` and
    ``ring`` are ignored."""
    h, states = _rwkv_forward(cfg, params, tokens, states=cache)
    return (h[:, 0] @ params["unembed"].to(cfg.cdtype)).float(), states


def _rwkv_prefill(cfg: RWKVModelConfig, params: dict, batch: dict):
    """The prompt from a zero state: (the last token's logits, the state
    after the prompt)."""
    tokens = batch["tokens"]
    cache = _rwkv_init_cache(cfg, tokens.shape[0], 0, device=tokens.device)
    h, states = _rwkv_forward(cfg, params, tokens, states=cache)
    return (h[:, -1] @ params["unembed"].to(cfg.cdtype)).float(), states


def build_model(cfg, device: Optional[str] = "cuda") -> ModelBundle:
    if isinstance(cfg, transformer.TransformerConfig):
        return ModelBundle(
            name=cfg.name, kind="moe" if cfg.moe is not None else "dense", config=cfg,
            init=lambda generator: _on(device, transformer.init_params(cfg, generator)),
            loss_fn=lambda params, batch, key=None: transformer.loss_fn(
                cfg, params, _on(device, batch), key),
            prefill=lambda params, batch: transformer.prefill(
                cfg, params, _to(device, batch["tokens"])),
            decode_step=lambda params, cache, tokens, pos, ring=False: transformer.decode_step(
                cfg, params, cache, _to(device, tokens), pos, ring),
            init_cache=lambda batch, seq_len, ring=False: transformer.init_cache(
                cfg, batch, seq_len, ring, device=device or "cuda"),
            device=device,
        )
    if isinstance(cfg, hybrid.HybridConfig):
        return ModelBundle(
            name=cfg.name, kind="hybrid", config=cfg,
            init=lambda generator: _on(device, hybrid.init_params(cfg, generator)),
            loss_fn=lambda params, batch, key=None: hybrid.loss_fn(
                cfg, params, _on(device, batch), key),
            prefill=None,   # serving enters through decode (the SSM's prefill is its scan)
            decode_step=lambda params, cache, tokens, pos, ring=False: hybrid.decode_step(
                cfg, params, cache, _to(device, tokens), pos),
            init_cache=lambda batch, seq_len, ring=False: hybrid.init_cache(
                cfg, batch, seq_len, device=device or "cuda"),
            device=device,
        )
    if isinstance(cfg, RWKVModelConfig):
        return ModelBundle(
            name=cfg.name, kind="ssm", config=cfg,
            init=lambda generator: _on(device, _rwkv_init(cfg, generator)),
            loss_fn=lambda params, batch, key=None: _rwkv_loss(
                cfg, params, _on(device, batch), key),
            prefill=lambda params, batch: _rwkv_prefill(cfg, params, _on(device, batch)),
            decode_step=lambda params, cache, tokens, pos=None, ring=False: _rwkv_decode(
                cfg, params, cache, _to(device, tokens), pos, ring),
            init_cache=lambda batch, seq_len, ring=False: _rwkv_init_cache(
                cfg, batch, seq_len, ring, device=device or "cuda"),
            device=device,
        )
    if isinstance(cfg, encdec.EncDecConfig):
        return ModelBundle(
            name=cfg.name, kind="audio", config=cfg,
            init=lambda generator: _on(device, encdec.init_params(cfg, generator)),
            loss_fn=lambda params, batch, key=None: encdec.loss_fn(
                cfg, params, _on(device, batch), key),
            prefill=lambda params, batch: encdec.prefill(
                cfg, params, _to(device, batch["frames"]), _to(device, batch["tokens"])),
            decode_step=lambda params, cache, tokens, pos: encdec.decode_step(
                cfg, params, cache, _to(device, tokens), pos),
            init_cache=lambda batch, seq_len, ring=False: encdec.init_cache(
                cfg, batch, seq_len, device=device or "cuda"),
            device=device,
        )
    if isinstance(cfg, vlm.VLMConfig):
        return ModelBundle(
            name=cfg.name, kind="vlm", config=cfg,
            init=lambda generator: _on(device, vlm.init_params(cfg, generator)),
            loss_fn=lambda params, batch, key=None: vlm.loss_fn(
                cfg, params, _on(device, batch), key),
            prefill=lambda params, batch: vlm.prefill(cfg, params, _on(device, batch)),
            decode_step=lambda params, cache, tokens, pos, ring=False: vlm.decode_step(
                cfg, params, cache, _to(device, tokens), pos, ring),
            init_cache=lambda batch, seq_len, ring=False: vlm.init_cache(
                cfg, batch, seq_len, ring, device=device or "cuda"),
            device=device,
        )
    if isinstance(cfg, rnnt.RNNTConfig):
        module = rnnt.RNNT(cfg)
        return ModelBundle(
            name=cfg.name, kind="rnnt", config=cfg,
            init=lambda generator: _on(device, rnnt.init_params(cfg, generator)),
            loss_fn=lambda params, batch, key=None: rnnt.loss_fn(
                module, params, _on(device, batch), key),
            device=device, module=module,
        )
    if isinstance(cfg, keyword.KeywordConfig):
        return ModelBundle(
            name=cfg.name, kind="keyword", config=cfg,
            init=lambda generator: _on(device, keyword.init_params(cfg, generator)),
            loss_fn=lambda params, batch, key=None: keyword.loss_fn(
                cfg, params, _on(device, batch), key),
            device=device,
        )
    raise TypeError(f"unknown config type {type(cfg)}")
