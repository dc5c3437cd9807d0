"""deepseek-v2-lite-16b [moe] (hf:deepseek-ai/DeepSeek-V2-Lite,
arXiv:2405.04434): 27 layers, d_model 2,048, 16 heads, vocab 102,400;
multi-head latent attention with kv_lora 512, qk_nope 128, qk_rope 64 and
v 128; a dense first layer (d_ff 10,944), then 64 routed experts of d_ff
1,408, top-6, with 2 shared experts of 2,816; bf16 compute and bf16
parameters (the MoE router fp32). The port's copy of
``repro/configs/deepseek_v2_lite_16b.py``, its ``ArchSpec`` too.
``make_config``'s
keywords override any field, ``n_layers`` too (the reference's passes
them beside its fields, so a field it sets cannot be given again):
``make_config(n_layers=2)`` is ``dataclasses.replace(make_config(),
n_layers=2)`` in both packages.
"""

from repro_torch.configs import base
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "deepseek-v2-lite-16b"


def make_config(**kw) -> TransformerConfig:
    fields = dict(
        name=ARCH_ID,
        n_layers=27, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
        d_ff=1408, vocab=102400,
        moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408, n_shared=2, shared_ff=2816),
        moe_first_dense=1, first_dense_ff=10944,
        mla=MLAConfig(d_model=2048, n_heads=16, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_dim=128),
        rope_theta=10000.0, act="silu",
        dtype="bfloat16", param_dtype="bfloat16",
    )
    return TransformerConfig(**{**fields, **kw})


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=3, d_model=128, n_heads=4, n_kv=4, head_dim=32,
        d_ff=96, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=96, n_shared=1, shared_ff=96,
                      capacity_factor=4.0),
        moe_first_dense=1, first_dense_ff=192,
        mla=MLAConfig(d_model=128, n_heads=4, kv_lora=64, qk_nope_dim=32, qk_rope_dim=16,
                      v_dim=32),
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="arXiv:2405.04434",
    kind="moe",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.transformer_param_rules(16, 16, mla=True, moe=True),
    cache_rules=base.transformer_cache_rules(),
    long_policy="sw_variant",
    make_long_config=lambda: make_config(window=4096),
)
