"""ArchSpec plumbing: input shapes, batch layouts and sharding rules.

The port's copy of ``repro/configs/base.py``. The four assigned input
shapes; a decode shape serves one token against a seq_len cache, train_4k
is one federated round (the paper's training step), prefill_32k a prefill.
The batch makers give shape-only tensors (``device="meta"``: shape and
dtype, no memory) where the reference gives ``jax.ShapeDtypeStruct``s.

The rule makers keep the reference's parameter and cache sharding rules as
data, ``(regex over the slash-joined leaf path, P)``, with ``P`` the
port's own partition spec: one tuple of mesh-axis names, or None, per
dimension. Nothing in the port shards yet (ROADMAP.md's M9 reads them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core.plan import FederatedPlan


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


class P(tuple):
    """A partition spec: for each dimension the tuple of mesh axes it is
    split over, or None (replicated). ``P(None, "model")`` is ``(None,
    ("model",))``; ``P()`` replicates every dimension."""

    def __new__(cls, *dims):
        return super().__new__(cls, (d if d is None else (d,) if isinstance(d, str) else tuple(d)
                                     for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    citation: str
    kind: str                                    # dense|moe|hybrid|ssm|audio|vlm|rnnt
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    engine: str                                  # fedavg | fedsgd
    param_rules: Sequence[tuple[str, P]]
    cache_rules: Sequence[tuple[str, P]]
    long_policy: str = "native"                  # native | sw_variant | skip
    make_long_config: Optional[Callable[[], Any]] = None
    skip_notes: str = ""

    def config_for(self, shape_name: str):
        if shape_name == "long_500k" and self.make_long_config is not None:
            return self.make_long_config()
        return self.make_config()


def default_plan(engine: str, clients: int) -> FederatedPlan:
    """The dry-run training plan: K = client shards, 2 local steps for
    the fedavg engine (exercises the local loop), 1 for fedsgd."""
    return FederatedPlan(
        clients_per_round=clients,
        local_batch_size=8,
        engine=engine,
        server_optimizer="adam",
    )


def round_layout(shape: InputShape, n_client_shards: int, engine: str):
    """(K, S_local, b) with K*S*b == global_batch."""
    K = n_client_shards
    gb = shape.global_batch
    if gb % K:
        raise ValueError(f"global batch {gb} does not split over {K} client shards")
    per_client = gb // K
    if engine == "fedsgd":
        return K, 1, per_client
    b = min(8, per_client)
    while per_client % b:
        b -= 1
    return K, per_client // b, b


def sds(shape, dtype) -> torch.Tensor:
    """A shape-only tensor (``jax.ShapeDtypeStruct``'s stand-in)."""
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype), device="meta")


# --------------------------------------------------- train batch layouts

def lm_train_batch(shape: InputShape, K: int, S: int, b: int, dtype="bfloat16"):
    return {
        "tokens": sds((K, S, b, shape.seq_len), "int32"),
        "weight": sds((K, S, b), "float32"),
    }


def audio_train_batch(shape: InputShape, K: int, S: int, b: int, cfg):
    return {
        "frames": sds((K, S, b, cfg.max_source, cfg.d_model), cfg.dtype),
        "tokens": sds((K, S, b, shape.seq_len), "int32"),
        "weight": sds((K, S, b), "float32"),
    }


def vlm_train_batch(shape: InputShape, K: int, S: int, b: int, cfg):
    n_img = cfg.n_img_tokens
    return {
        "image_embeds": sds((K, S, b, n_img, cfg.vit_dim), cfg.lm.dtype),
        "tokens": sds((K, S, b, shape.seq_len - n_img), "int32"),
        "weight": sds((K, S, b), "float32"),
    }


def rnnt_train_batch(shape: InputShape, K: int, S: int, b: int, cfg):
    t = shape.seq_len            # audio frames
    u = max(32, shape.seq_len // 32)
    return {
        "features": sds((K, S, b, t, cfg.feat_dim), "float32"),
        "labels": sds((K, S, b, u), "int32"),
        "frame_len": sds((K, S, b), "int32"),
        "label_len": sds((K, S, b), "int32"),
        "weight": sds((K, S, b), "float32"),
    }


# --------------------------------------------------- serve batch layouts

def lm_prefill_batch(shape: InputShape):
    return {"tokens": sds((shape.global_batch, shape.seq_len), "int32")}


def audio_prefill_batch(shape: InputShape, cfg):
    return {
        "frames": sds((shape.global_batch, cfg.max_source, cfg.d_model), cfg.dtype),
        "tokens": sds((shape.global_batch, shape.seq_len), "int32"),
    }


def vlm_prefill_batch(shape: InputShape, cfg):
    return {
        "image_embeds": sds((shape.global_batch, cfg.n_img_tokens, cfg.vit_dim), cfg.lm.dtype),
        "tokens": sds((shape.global_batch, shape.seq_len - cfg.n_img_tokens), "int32"),
    }


# --------------------------------------------------- shared spec rules

BAT = ("pod", "data")            # sanitized down to ("data",) on single-pod


def batch_specs(batch_struct: dict, leading_axis=BAT) -> dict:
    """Shard the leading client/batch axis of every input leaf."""
    return {k: batch_specs(v, leading_axis) if isinstance(v, dict) else P(leading_axis)
            for k, v in batch_struct.items()}


def transformer_cache_rules(long: bool = False) -> list:
    s_ax = ("pod", "data", "model") if long else ("model",)
    bat = None if long else BAT
    return [
        (r"(layers|dense_layers)/(k|v)$", P(None, bat, s_ax)),
        (r"(layers|dense_layers)/(ckv|krope)$", P(None, bat, s_ax)),
    ]


def hybrid_cache_rules(long: bool = False) -> list:
    s_ax = ("pod", "data", "model") if long else ("model",)
    bat = None if long else BAT
    return [
        (r"attn_(k|v)$", P(None, bat, s_ax)),
        (r"groups/ssm$", P(None, None, bat, "model")),
        (r"tail/ssm$", P(None, bat, "model")),
        (r"groups/conv/x$", P(None, None, bat, None, "model")),
        (r"tail/conv/x$", P(None, bat, None, "model")),
        (r"conv/bc$", P()),
    ]


def rwkv_cache_rules(long: bool = False) -> list:
    bat = None if long else BAT
    return [
        (r"tm/S$", P(None, bat, "model")),
        (r"(tm|cm)/last$", P(None, bat, "model")),
    ]


def audio_cache_rules(long: bool = False) -> list:
    bat = None if long else BAT
    return [
        (r"self_(k|v)$", P(None, bat, ("model",))),
        (r"cross_(k|v)$", P(None, bat, None)),
    ]


# --------------------------------------------------- param spec rules

MODEL_AXIS_SIZE = 16             # model axis of both production meshes


def transformer_param_rules(n_heads: int, n_kv: int, *, mla: bool = False,
                            moe: bool = False) -> list:
    """Head-aligned tensor parallelism: shard q/o when heads divide the
    model axis, k/v when kv-heads do (else Megatron-style replication);
    FFN hidden and vocab always shard. Leading Nones cover the layer
    stack axis."""
    rules = [
        (r"(^|/)embed$", P("model", None)),
        (r"(^|/)unembed$", P(None, "model")),
    ]
    layer = r"(layers|dense_layers)"
    if mla:
        rules += [
            (layer + r"/attn/wq$", P(None, None, "model")),
            (layer + r"/attn/w_(uk|uv)$", P(None, None, "model")),
            (layer + r"/attn/wo$", P(None, "model", None)),
            (layer + r"/attn/(w_dkv|w_krope|kv_norm)$", P()),
        ]
    else:
        if n_heads % MODEL_AXIS_SIZE == 0:
            rules += [
                (layer + r"/attn/wq$", P(None, None, "model")),
                (layer + r"/attn/wo$", P(None, "model", None)),
            ]
        if n_kv % MODEL_AXIS_SIZE == 0:
            rules += [
                (layer + r"/attn/w(k|v)$", P(None, None, "model")),
            ]
    if moe:
        rules += [
            (layer + r"/moe/w_(gate|up)$", P(None, "model", None, None)),
            (layer + r"/moe/w_down$", P(None, "model", None, None)),
            (layer + r"/moe/shared/w_(gate|up)$", P(None, None, "model")),
            (layer + r"/moe/shared/w_down$", P(None, "model", None)),
            (layer + r"/moe/router$", P()),
        ]
    rules += [
        (layer + r"/mlp/w_(gate|up)$", P(None, None, "model")),
        (layer + r"/mlp/w_down$", P(None, "model", None)),
    ]
    return rules


def hybrid_param_rules() -> list:
    """zamba2: groups params have two leading stack axes (G, E)."""
    return [
        (r"(^|/)embed$", P("model", None)),
        (r"(^|/)unembed$", P(None, "model")),
        (r"shared_attn/attn/wq$", P(None, "model")),
        (r"shared_attn/attn/w(k|v)$", P(None, "model")),
        (r"shared_attn/attn/wo$", P("model", None)),
        (r"shared_attn/mlp/w_(gate|up)$", P(None, "model")),
        (r"shared_attn/mlp/w_down$", P("model", None)),
        (r"groups/.*/mamba/in_(z|x|dt)$", P(None, None, None, "model")),
        (r"groups/.*/mamba/in_bc$", P()),
        (r"groups/.*/mamba/conv_x_w$", P(None, None, None, "model")),
        (r"groups/.*/mamba/(conv_x_b|norm)$", P(None, None, "model")),
        (r"groups/.*/mamba/(A_log|D|dt_bias)$", P(None, None, "model")),
        (r"groups/.*/mamba/out_proj$", P(None, None, "model", None)),
        (r"tail/.*/mamba/in_(z|x|dt)$", P(None, None, "model")),
        (r"tail/.*/mamba/in_bc$", P()),
        (r"tail/.*/mamba/conv_x_w$", P(None, None, "model")),
        (r"tail/.*/mamba/(conv_x_b|norm)$", P(None, "model")),
        (r"tail/.*/mamba/(A_log|D|dt_bias)$", P(None, "model")),
        (r"tail/.*/mamba/out_proj$", P(None, "model", None)),
    ]


def rwkv_param_rules() -> list:
    return [
        (r"(^|/)embed$", P("model", None)),
        (r"(^|/)unembed$", P(None, "model")),
        (r"layers/(wr|wk|wv|wg|cr)$", P(None, None, "model")),
        (r"layers/(w_out|cv)$", P(None, "model", None)),
        (r"layers/ck$", P(None, None, "model")),
        (r"layers/wB$", P(None, None, "model")),
        (r"layers/wA$", P()),
        (r"layers/(u|gn_scale|gn_bias)$", P(None, "model")),
    ]


def audio_param_rules() -> list:
    """whisper-base: 8 heads < model axis -> attention replicated
    (72M model; Megatron fallback); FFN + embedding-d sharded."""
    return [
        (r"tok_embed$", P("model", None)),
        (r"(enc|dec)_layers/mlp/w_up$", P(None, None, "model")),
        (r"(enc|dec)_layers/mlp/w_down$", P(None, "model", None)),
    ]


def rnnt_param_rules() -> list:
    """122M model: LSTMs replicated (recurrent deps), vocab-sharded joint."""
    return [
        (r"joint_out$", P(None, "model")),
        (r"joint_enc$", P(None, "model")),
        (r"joint_pred$", P(None, "model")),
    ]


def prefix_rules(prefix: str, rules: list) -> list:
    """Each rule's regex under ``prefix``, but for the ones anchored at a
    path segment (``(^|/)...``), which match at any depth already."""
    return [(rx if rx.startswith("(^|/)") else prefix + rx, sp) for rx, sp in rules]
