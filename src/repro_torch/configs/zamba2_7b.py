"""zamba2-7b [hybrid] (arXiv:2411.15242): 81 Mamba2 layers, d_model 3,584
(d_inner 7,168 in 112 SSM heads of 64, state 64), one shared attention +
MLP block every 6 layers (32 heads of 112 on 32 kv heads, d_ff 14,336),
vocab 32,000, bf16 compute and bf16 parameters: 13 groups and a 3-layer
tail, 14 applications of the one shared block. The port's copy of
``repro/configs/zamba2_7b.py``, its ``ArchSpec`` too. ``make_config``'s
keywords override any field (the reference's takes none):
``make_config(n_layers=7)`` is ``dataclasses.replace(make_config(),
n_layers=7)``.
"""

from repro_torch.configs import base
from repro_torch.models.hybrid import HybridConfig

ARCH_ID = "zamba2-7b"


def make_config(**kw) -> HybridConfig:
    fields = dict(
        name=ARCH_ID,
        n_layers=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
        d_ff=14336, vocab=32000, attn_every=6,
        ssm_state=64, ssm_headdim=64,
        dtype="bfloat16", param_dtype="bfloat16",
    )
    return HybridConfig(**{**fields, **kw})


def make_smoke_config() -> HybridConfig:
    return HybridConfig(
        name=ARCH_ID + "-smoke",
        n_layers=8, d_model=128, n_heads=4, n_kv=4, head_dim=32,
        d_ff=256, vocab=128, attn_every=3,
        ssm_state=16, ssm_headdim=32,
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="arXiv:2411.15242",
    kind="hybrid",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.hybrid_param_rules(),
    cache_rules=base.hybrid_cache_rules(),
    long_policy="native",
)
