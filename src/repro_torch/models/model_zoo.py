"""Unified model interface: ``build_model(config) -> ModelBundle``.

The port of ``repro/models/model_zoo.py:48-62`` for the configurations
the port has: the enc-dec (kind ``audio``, ``:157-165``) and the RNN-T
(kind ``rnnt``, ``:175-180``). A bundle binds the config to its functions
and to one ``device``, the card unless the caller names the CPU: ``init``
puts the parameters there, ``init_cache`` the caches, and ``loss_fn``,
``prefill`` and ``decode_step`` move the batch or tokens they are given
there. ``device=None`` moves nothing: the parameters stay on the
generator's device and the batch where the caller put it (the federated
task's bundle: the round engine places both). Every other config family
is ROADMAP.md's M8 and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from torch import nn

from repro_torch.models import encdec, rnnt


@dataclasses.dataclass
class ModelBundle:
    name: str
    kind: str                    # audio | rnnt (the other kinds are not ported yet)
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
    raise NotImplementedError(
        f"{type(cfg).__name__} is not ported yet: the port's model zoo has the enc-dec and "
        "the RNN-T (ROADMAP.md's M8 lists the other models in order)")
