"""Keyword-spotting classifier, the tiny-model federated workload.

The port of ``repro/models/keyword.py``. A masked mean-pool over the
frame axis, then a two-layer ReLU MLP over word-piece classes: the class
of an utterance is its first word-piece, so the corpus's per-speaker
vocabulary skew becomes per-client label shift. About 10k parameters at
the container config. The model reads the engine's batch layout
({features, labels, frame_len, weight}) as it is.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class KeywordConfig:
    name: str = "keyword-tiny"
    feat_dim: int = 16
    n_classes: int = 64  # the word-piece vocabulary doubles as the class set
    hidden: int = 64
    dtype: str = "float32"
    param_dtype: str = "float32"

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def init_params(cfg: KeywordConfig, generator: torch.Generator) -> dict:
    """Random parameters on ``generator``'s device with the reference's
    initializers (``repro/models/keyword.py:43-53``)."""
    dt, dev = cfg.pdtype, generator.device
    return {
        "w1": dense_init(generator, cfg.feat_dim, cfg.hidden, dt),
        "b1": torch.zeros((cfg.hidden,), dtype=dt, device=dev),
        "w2": dense_init(generator, cfg.hidden, cfg.hidden, dt),
        "b2": torch.zeros((cfg.hidden,), dtype=dt, device=dev),
        "w_out": dense_init(generator, cfg.hidden, cfg.n_classes, dt),
        "b_out": torch.zeros((cfg.n_classes,), dtype=dt, device=dev),
    }


def forward(cfg: KeywordConfig, params: dict, features, frame_len):
    """features (B, T, F), frame_len (B,) -> logits (B, n_classes) fp32.
    The mean pools the real frames only: frame_len is the divisor."""
    dt = cfg.cdtype
    t = torch.arange(features.shape[1], device=features.device)
    mask = (t[None, :] < frame_len[:, None]).to(dt)
    pooled = (features.to(dt) * mask[:, :, None]).sum(dim=1)
    pooled = pooled / torch.clamp(frame_len, min=1).to(dt)[:, None]
    h = F.relu(pooled @ params["w1"].to(dt) + params["b1"])
    h = F.relu(h @ params["w2"].to(dt) + params["b2"])
    return (h @ params["w_out"].to(dt) + params["b_out"]).float()


def class_of(batch: dict) -> torch.Tensor:
    """The utterance's keyword class: its first word-piece id."""
    return batch["labels"][..., 0]


def loss_fn(cfg: KeywordConfig, params: dict, batch: dict, key=None):
    """Weighted CE over {features, labels, frame_len, weight}. Returns
    (loss, {"ce", "acc"}); ``key`` is unused, as the reference's ``rng``."""
    logits = forward(cfg, params, batch["features"], batch["frame_len"])
    labels = class_of(batch).long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    w = batch.get("weight")
    w = torch.ones_like(ce) if w is None else w.to(ce.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    loss = (ce * w).sum() / denom
    acc = ((logits.argmax(dim=-1) == labels).to(ce.dtype) * w).sum() / denom
    return loss, {"ce": loss, "acc": acc}


def predict(cfg: KeywordConfig, params: dict, features, frame_len) -> torch.Tensor:
    """(B,) argmax class ids."""
    return forward(cfg, params, features, frame_len).argmax(dim=-1)
