"""rnnt-librispeech — the paper's own model (Fig. 1): an 8x1152 LSTM
audio encoder, a 2x1152 LSTM label encoder with a 512-wide embedding,
joint dim 640, 4096 word-pieces, 128-dim log-mel inputs with time
stride 2, bf16 compute and fp32 parameters (105,333,760 parameters).
The port's copy of ``repro/configs/rnnt_librispeech.py:18-27``.
"""

from repro_torch.asr.specaugment import SpecAugmentConfig
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
