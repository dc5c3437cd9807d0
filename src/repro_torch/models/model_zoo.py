"""Unified model interface: ``build_model(config) -> ModelBundle``.

The port of ``repro/models/model_zoo.py:48-62`` for the configurations
the port has: the enc-dec (kind ``audio``, ``:157-165``). A bundle binds
the config to its functions and to one ``device``, the card unless the
caller names the CPU: ``init`` puts the parameters there (drawn on its
generator's device), ``init_cache`` the caches, and ``loss_fn``,
``prefill`` and ``decode_step`` move the batch or tokens they are given
there. Every other config family is ROADMAP.md's M8 and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.models import encdec


@dataclasses.dataclass
class ModelBundle:
    name: str
    kind: str                    # audio (the other kinds are not ported yet)
    config: Any
    init: Callable               # (generator) -> params on ``device``
    loss_fn: Callable            # (params, batch, key) -> (loss, aux)
    prefill: Optional[Callable] = None      # (params, batch) -> (logits, cache)
    decode_step: Optional[Callable] = None  # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Optional[Callable] = None   # (batch, seq_len, ring=False) -> cache
    device: str = "cuda"

    @staticmethod
    def param_count(params: dict) -> int:
        return sum(t.numel() for t in params.values())


def _on(device, batch: dict) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def build_model(cfg, device: str = "cuda") -> ModelBundle:
    if isinstance(cfg, encdec.EncDecConfig):
        return ModelBundle(
            name=cfg.name, kind="audio", config=cfg,
            init=lambda generator: _on(device, encdec.init_params(cfg, generator)),
            loss_fn=lambda params, batch, key=None: encdec.loss_fn(
                cfg, params, _on(device, batch), key),
            prefill=lambda params, batch: encdec.prefill(
                cfg, params, batch["frames"].to(device), batch["tokens"].to(device)),
            decode_step=lambda params, cache, tokens, pos: encdec.decode_step(
                cfg, params, cache, tokens.to(device), pos),
            init_cache=lambda batch, seq_len, ring=False: encdec.init_cache(
                cfg, batch, seq_len, device=device),
            device=device,
        )
    raise NotImplementedError(
        f"{type(cfg).__name__} is not ported yet: the port's model zoo has the enc-dec "
        "(ROADMAP.md's M8 lists the other models in order)")
