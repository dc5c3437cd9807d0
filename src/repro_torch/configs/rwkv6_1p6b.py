"""rwkv6-1.6b [ssm] (arXiv:2404.05892): 24 layers, d_model 2,048 in 32
heads of 64, d_ff 7,168, vocab 65,536, decay LoRA 64, attention-free, bf16
compute and bf16 parameters: 1,584,091,136 parameters. The port's copy of
``repro/configs/rwkv6_1p6b.py``, its ``ArchSpec`` too. ``make_config``'s
keywords override any field of the model config (the reference's takes
none): ``make_config(n_layers=2)`` is ``dataclasses.replace(make_config(),
n_layers=2)``.
"""

from repro_torch.configs import base
from repro_torch.models.model_zoo import RWKVModelConfig
from repro_torch.models.rwkv import RWKVConfig

ARCH_ID = "rwkv6-1.6b"


def make_config(**kw) -> RWKVModelConfig:
    fields = dict(
        name=ARCH_ID,
        n_layers=24,
        rwkv=RWKVConfig(d_model=2048, head_size=64, d_ff=7168, decay_lora=64),
        vocab=65536,
        dtype="bfloat16", param_dtype="bfloat16",
    )
    return RWKVModelConfig(**{**fields, **kw})


def make_smoke_config() -> RWKVModelConfig:
    return RWKVModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        rwkv=RWKVConfig(d_model=128, head_size=32, d_ff=256, decay_lora=16),
        vocab=128,
        dtype="float32", param_dtype="float32", loss_chunk=16,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="arXiv:2404.05892",
    kind="ssm",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.rwkv_param_rules(),
    cache_rules=base.rwkv_cache_rules(),
    long_policy="native",
)
