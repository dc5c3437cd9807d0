"""qwen3-8b [dense] (hf:Qwen/Qwen3-8B): 36 layers, d_model 4,096, 32
query heads on 8 kv heads of 128, d_ff 12,288, vocab 151,936, qk_norm,
rope theta 1e6, bf16 compute and bf16 parameters. The port's copy of
``repro/configs/qwen3_8b.py``, its ``ArchSpec`` too. ``make_config``'s
keywords override any field, ``n_layers`` too (the reference's passes
them beside its fields, so a field it sets cannot be given again):
``make_config(n_layers=4)`` is ``dataclasses.replace(make_config(),
n_layers=4)`` in both packages.
"""

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "qwen3-8b"


def make_config(**kw) -> TransformerConfig:
    fields = dict(
        name=ARCH_ID,
        n_layers=36, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
        d_ff=12288, vocab=151936,
        qk_norm=True, rope_theta=1000000.0, act="silu",
        dtype="bfloat16", param_dtype="bfloat16",
    )
    return TransformerConfig(**{**fields, **kw})


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=256, vocab=128, qk_norm=True,
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="hf:Qwen/Qwen3-8B",
    kind="dense",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.transformer_param_rules(32, 8),
    cache_rules=base.transformer_cache_rules(),
    long_policy="sw_variant",
    make_long_config=lambda: make_config(window=4096),
)
