"""Unified model interface: ``build_model(config) -> ModelBundle``.

The port of ``repro/models/model_zoo.py:48-62`` for the configurations
the port has: the decoder-only transformer (kind ``dense``, or ``moe``
with a ``MoEConfig``, ``:127-137``), the enc-dec (kind ``audio``,
``:157-165``), the RNN-T (kind ``rnnt``, ``:175-180``) and the keyword
classifier (kind ``keyword``, ``:181-186``). A bundle binds the config to
its functions and to one ``device``, the card unless the caller names the
CPU: ``init`` puts the parameters there, ``init_cache`` the caches, and
``loss_fn``, ``prefill`` and ``decode_step`` move the batch or tokens
they are given there. ``device=None`` moves nothing: the parameters stay
on the generator's device and the batch where the caller put it (the
federated task's bundle: the round engine places both). The RWKV stack,
the hybrid and the VLM are ROADMAP.md's M8 and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from torch import nn

from repro_torch.models import encdec, keyword, rnnt, transformer


@dataclasses.dataclass
class ModelBundle:
    name: str
    kind: str                    # dense | moe | audio | rnnt | keyword
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
    raise NotImplementedError(
        f"{type(cfg).__name__} is not ported yet: the port's model zoo has the dense and MoE "
        "transformer, the enc-dec, the RNN-T and the keyword classifier; the RWKV stack, the "
        "hybrid and the VLM are ROADMAP.md's M8")
