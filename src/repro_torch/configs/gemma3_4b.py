"""gemma3-4b [dense] (hf:google/gemma-3-1b-pt family): 34 layers, d_model
2,560, 8 query heads on 4 kv heads of 256, d_ff 10,240, vocab 262,144; 5
local layers (a 1,024-token window) to 1 global, qk_norm, (1 + scale)
RMSNorm, sqrt(d) embedding scale, gelu_tanh gating, one rope theta (10k,
where gemma3 splits local and global bases); bf16 compute and bf16
parameters. Engine fedavg; long_500k native (the 5:1 pattern is the
sub-quadratic variant). The port's copy of ``repro/configs/gemma3_4b.py``.
``make_config``'s keywords override any field (the reference's takes
none): ``make_config(n_layers=6)`` is ``dataclasses.replace(make_config(),
n_layers=6)``.
"""

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "gemma3-4b"


def make_config(**kw) -> TransformerConfig:
    fields = dict(
        name=ARCH_ID,
        n_layers=34, d_model=2560, n_heads=8, n_kv=4, head_dim=256,
        d_ff=10240, vocab=262144,
        window=1024, global_every=6,
        qk_norm=True, rms_plus_one=True, emb_scale=True,
        act="gelu_tanh", rope_theta=10000.0,
        dtype="bfloat16", param_dtype="bfloat16", loss_chunk=128,
    )
    return TransformerConfig(**{**fields, **kw})


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=256, vocab=128,
        window=16, global_every=2,
        qk_norm=True, rms_plus_one=True, emb_scale=True, act="gelu_tanh",
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="hf:google/gemma-3-1b-pt",
    kind="dense",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.transformer_param_rules(8, 4),
    cache_rules=base.transformer_cache_rules(),
    long_policy="native",                # 5:1 local:global pattern
)
