"""LLaVA-NeXT-style VLM: a Mistral-7B language backbone reading projected
vision embeddings.

The port of ``repro/models/vlm.py``. The ViT/SigLIP encoder is a stub, as
in the reference: the batch gives anyres tile patch embeddings (B, N_img,
vit_dim). The LM side is whole: the 2-layer MLP projector, the image
tokens put before the text, the LM loss over the text positions only, and
decoding against a cache whose first N_img slots hold the image tokens.

Parameters are one flat dict keyed by the reference's tree paths: the
transformer's under ``lm.`` and ``projector.{w1,b1,w2,b2}``, so
``repro_torch.convert.params_from_jax`` carries JAX's across unchanged and
``jax_leaf_order`` puts ``lm.*`` before ``projector.*`` as JAX's flatten
does. Every attention runs on the transformer's kernels: K10 (and its
backward) over the image and text positions, K11 in ``decode_step``.

``prefill`` returns a cache as long as the image and the prompt (F6 in
ROADMAP.md): copy it into ``init_cache(B, total)`` before decoding.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init, lm_loss


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    name: str
    lm: tfm.TransformerConfig
    vit_dim: int = 1024
    n_img_tokens: int = 576        # tokens per anyres tile grid (stubbed)

    @property
    def cdtype(self) -> torch.dtype:
        return self.lm.cdtype


def lm_params(params: dict) -> dict:
    """The language model's leaves, named as ``transformer`` names them."""
    return {k[len("lm."):]: v for k, v in params.items() if k.startswith("lm.")}


def init_params(cfg: VLMConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's initializers (``:34``); the
    draws are the generator's, not JAX's. ``device`` None is the
    generator's; ``"meta"`` gives the shapes alone."""
    dev = generator.device if device is None else device
    dt, D = cfg.lm.pdtype, cfg.lm.d_model
    lm = tfm.init_params(cfg.lm, generator, device=dev)
    return {
        **{f"lm.{k}": v for k, v in lm.items()},
        "projector.w1": dense_init(generator, cfg.vit_dim, D, dt, device=dev),
        "projector.b1": torch.zeros((D,), dtype=dt, device=dev),
        "projector.w2": dense_init(generator, D, D, dt, device=dev),
        "projector.b2": torch.zeros((D,), dtype=dt, device=dev),
    }


def project(params: dict, cfg: VLMConfig, image_embeds):
    """(B, N_img, vit_dim) -> (B, N_img, d_model): the 2-layer MLP with
    ``jax.nn.gelu``'s tanh form, the embeddings and then each weight cast
    to the compute dtype."""
    x = image_embeds.to(cfg.cdtype)
    h = F.gelu(x @ params["projector.w1"].to(x.dtype) + params["projector.b1"].to(x.dtype),
               approximate="tanh")
    return h @ params["projector.w2"].to(x.dtype) + params["projector.b2"].to(x.dtype)


def _embed_multimodal(cfg: VLMConfig, params: dict, batch: dict):
    img = project(params, cfg, batch["image_embeds"])                    # (B, N, D)
    txt = tfm.embed_tokens(cfg.lm, lm_params(params), batch["tokens"])
    return torch.cat([img, txt], dim=1)


def loss_fn(cfg: VLMConfig, params: dict, batch: dict, key=None):
    """batch: image_embeds (B, N_img, vit_dim), tokens (B, S_text), optional
    weight (B,). The next-token loss over the text positions (the last
    masked, the mask times the weight, chunks of ``min(loss_chunk,
    S_text)``); the image positions carry no loss, but the projector takes
    gradients through attention. ``key`` is unused, as the reference's
    ``rng``."""
    lm = lm_params(params)
    h, aux = tfm.trunk(cfg.lm, lm, _embed_multimodal(cfg, params, batch))
    tokens = batch["tokens"]
    loss = lm_loss(h[:, batch["image_embeds"].shape[1]:], lm["unembed"].to(cfg.cdtype), tokens,
                   chunk=min(cfg.lm.loss_chunk, tokens.shape[1]), weight=batch.get("weight"))
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


def prefill(cfg: VLMConfig, params: dict, batch: dict):
    """Image tiles and a text prompt -> (the last position's logits, the
    cache), the cache's first n_img positions the image tokens'."""
    return tfm.prefill_embeds(cfg.lm, lm_params(params), _embed_multimodal(cfg, params, batch))


def init_cache(cfg: VLMConfig, batch: int, seq_len: int, ring: bool = False, device="cuda"):
    return tfm.init_cache(cfg.lm, batch, seq_len, ring, device=device)


def decode_step(cfg: VLMConfig, params: dict, cache: dict, tokens, pos, ring: bool = False):
    """One text token (B, 1) at ``pos`` against the cache, written in place:
    (logits (B, V) fp32, cache)."""
    return tfm.decode_step(cfg.lm, lm_params(params), cache, tokens, pos, ring)
