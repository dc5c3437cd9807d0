"""phi3.5-moe-42b-a6.6b [moe] (hf:microsoft/Phi-3.5-MoE-instruct): 32
layers, d_model 4,096, 32 query heads on 8 kv heads of 128, vocab 32,064,
an MoE of 16 experts of d_ff 6,400, top-2, in every layer; bf16 compute
and bf16 parameters (the router fp32): 42 G parameters, 6.6 G active.
Engine fedsgd; long_500k through the 4,096-token sliding-window variant.
The port's copy of ``repro/configs/phi35_moe_42b.py``. ``make_config``'s
keywords override any field (the reference's passes them beside its
fields).
"""

from repro_torch.configs import base
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def make_config(**kw) -> TransformerConfig:
    fields = dict(
        name=ARCH_ID,
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
        d_ff=6400, vocab=32064,
        moe=MoEConfig(n_experts=16, top_k=2, expert_ff=6400),
        rope_theta=10000.0, act="silu",
        dtype="bfloat16", param_dtype="bfloat16",
    )
    return TransformerConfig(**{**fields, **kw})


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=192, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=192, capacity_factor=4.0),
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    kind="moe",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedsgd",
    param_rules=base.transformer_param_rules(32, 8, moe=True),
    cache_rules=base.transformer_cache_rules(),
    long_policy="sw_variant",
    make_long_config=lambda: make_config(window=4096),
)
