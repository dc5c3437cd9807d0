"""rnnt-librispeech — the paper's own model (Fig. 1): an 8x1152 LSTM
audio encoder, a 2x1152 LSTM label encoder with a 512-wide embedding,
joint dim 640, 4096 word-pieces, 128-dim log-mel inputs with time
stride 2, bf16 compute and fp32 parameters (105,333,760 parameters).
The port's copy of ``repro/configs/rnnt_librispeech.py``, its smoke
config and ``ArchSpec`` too (train shape only: its serve is the greedy
decode loop, not a KV-cache step).
"""

from repro_torch.asr.specaugment import SpecAugmentConfig
from repro_torch.configs import base
from repro_torch.models.rnnt import RNNTConfig

ARCH_ID = "rnnt-librispeech"


def make_config() -> RNNTConfig:
    return RNNTConfig(
        name=ARCH_ID,
        feat_dim=128, vocab=4096,
        enc_layers=8, enc_hidden=1152,
        pred_layers=2, pred_hidden=1152, pred_embed=512,
        joint_dim=640, time_stride=2,
        specaug=SpecAugmentConfig(),
        dtype="bfloat16", param_dtype="float32",
    )


def make_smoke_config() -> RNNTConfig:
    return RNNTConfig(
        name=ARCH_ID + "-smoke",
        feat_dim=16, vocab=64,
        enc_layers=2, enc_hidden=64,
        pred_layers=1, pred_hidden=64, pred_embed=32,
        joint_dim=48, time_stride=1,
        specaug=SpecAugmentConfig(freq_masks=1, freq_mask_width=4, time_masks=1),
        dtype="float32", param_dtype="float32",
    )


ARCH = base.ArchSpec(
    arch_id=ARCH_ID,
    citation="paper Fig.1 / He et al. 2019",
    kind="rnnt",
    make_config=make_config,
    make_smoke_config=make_smoke_config,
    engine="fedavg",
    param_rules=base.rnnt_param_rules(),
    cache_rules=[],
    long_policy="skip",
    skip_notes="ASR training model; serve shapes don't apply (DESIGN.md).",
)
