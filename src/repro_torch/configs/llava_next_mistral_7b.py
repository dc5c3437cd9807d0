"""llava-next-mistral-7b [vlm] (hf:llava-hf/llava-v1.6-mistral-7b-hf): a
Mistral-7B language model (32 layers, d_model 4,096, 32 query heads on 8
kv heads of 128, d_ff 14,336, vocab 32,000, a 4,096-token sliding window in
every layer) reading 576 anyres tile tokens of 1,024 (the ViT is a stub:
the batch gives the patch embeddings) through the 2-layer MLP projector;
bf16 compute and bf16 parameters: 7,262,711,808 parameters. Mistral's
window makes long_500k native. The port's copy of
``repro/configs/llava_next_mistral_7b.py``; ``make_config`` takes no
keywords, as the reference's: cut its depth with ``dataclasses.replace``
on ``cfg.lm``.
"""

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.vlm import VLMConfig

ARCH_ID = "llava-next-mistral-7b"


def _lm(**kw) -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-lm",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
        d_ff=14336, vocab=32000,
        window=4096,                      # mistral native SW
        rope_theta=10000.0, act="silu",
        dtype="bfloat16", param_dtype="bfloat16",
        **kw,
    )


def make_config() -> VLMConfig:
    return VLMConfig(name=ARCH_ID, lm=_lm(), vit_dim=1024, n_img_tokens=576)


def make_smoke_config() -> VLMConfig:
    lm = TransformerConfig(
        name=ARCH_ID + "-smoke-lm",
        n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=256, vocab=128, window=32,
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )
    return VLMConfig(name=ARCH_ID + "-smoke", lm=lm, vit_dim=48, n_img_tokens=8)


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    kind="vlm",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.transformer_param_rules(32, 8) + [(r"projector/w1$", base.P(None, "model")),
                                                       (r"projector/w2$", base.P("model", None))],
    cache_rules=base.transformer_cache_rules(),
    long_policy="native",                 # mistral SW=4096 is the window variant
)
