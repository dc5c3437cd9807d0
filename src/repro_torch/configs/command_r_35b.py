"""command-r-35b [dense] (hf:CohereForAI/c4ai-command-r-v01): 40 layers,
d_model 8,192, 64 query heads on 8 kv heads of 128, d_ff 22,528, vocab
256,000; no biases, attention and MLP in parallel blocks, LayerNorm; bf16
compute and bf16 parameters. Engine fedsgd; long_500k through the
4,096-token sliding-window variant. The port's copy of
``repro/configs/command_r_35b.py``. ``make_config``'s keywords override
any field (the reference's passes them beside its fields).
"""

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "command-r-35b"


def make_config(**kw) -> TransformerConfig:
    fields = dict(
        name=ARCH_ID,
        n_layers=40, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=22528, vocab=256000,
        norm="ln", parallel_block=True, use_bias=False,
        rope_theta=10000.0, act="silu",
        dtype="bfloat16", param_dtype="bfloat16",
    )
    return TransformerConfig(**{**fields, **kw})


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=256, vocab=128,
        norm="ln", parallel_block=True,
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="hf:CohereForAI/c4ai-command-r-v01",
    kind="dense",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedsgd",
    param_rules=base.transformer_param_rules(64, 8),
    cache_rules=base.transformer_cache_rules(),
    long_policy="sw_variant",
    make_long_config=lambda: make_config(window=4096),
)
