"""whisper-base [audio] (arXiv:2212.04356): 6+6 layers, d_model 512, 8
heads of 64, d_ff 2048, vocab 51,865, 1,500 source frames, 448 target
positions, bf16 compute and bf16 parameters (70,857,216 parameters). The
conv/mel front end is a stub: frames are precomputed embeddings. The
port's copy of ``repro/configs/whisper_base.py``, its ``ArchSpec`` too.
Its long_500k is skipped: an enc-dec with full attention and a 448-token
decoder context has no meaningful 512k decode state.
"""

from repro_torch.configs import base
from repro_torch.models.encdec import EncDecConfig

ARCH_ID = "whisper-base"


def make_config() -> EncDecConfig:
    return EncDecConfig(
        name=ARCH_ID,
        enc_layers=6, dec_layers=6, d_model=512, n_heads=8, n_kv=8,
        head_dim=64, d_ff=2048, vocab=51865,
        max_source=1500, max_target=448,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def make_smoke_config() -> EncDecConfig:
    return EncDecConfig(
        name=ARCH_ID + "-smoke",
        enc_layers=2, dec_layers=2, d_model=64, n_heads=4, n_kv=4,
        head_dim=16, d_ff=128, vocab=128, max_source=24, max_target=16,
        dtype="float32", param_dtype="float32", loss_chunk=8,
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="arXiv:2212.04356",
    kind="audio",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.audio_param_rules(),
    cache_rules=base.audio_cache_rules(),
    long_policy="skip",
    skip_notes=("enc-dec with full attention and a 448-token decoder "
                "design context; long_500k decode state is meaningless "
                "for this architecture (DESIGN.md §Arch-applicability)."),
)
