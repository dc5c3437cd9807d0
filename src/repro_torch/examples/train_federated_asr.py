"""End-to-end driver: federated RNN-T training with the paper's full
experiment surface (non-IID dial, FVN, server LR schedule, CFMQ
accounting, periodic WER evaluation, checkpointing). The port's twin of
``examples/train_federated_asr.py``: its plan and calls, on the card
unless ``--device cpu``.

The default is the tiny model; ``--size small`` a mid-size RNN-T, and
``--size paper`` the paper's RNN-T at full width
(``configs/rnnt_librispeech.make_config()``: an 8 x 1152 LSTM encoder,
4096 word-pieces) on a 2,338-speaker corpus at its widths.

    PYTHONPATH=src python -m repro_torch.examples.train_federated_asr --rounds 200
    PYTHONPATH=src python -m repro_torch.examples.train_federated_asr --rounds 2 \\
        --device cpu --ckpt-dir build/ckpt_asr --out build/train_federated_asr.json
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.asr.specaugment import SpecAugmentConfig
from repro_torch.configs import rnnt_librispeech
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.data import make_speaker_corpus
from repro_torch.launch.train import run_federated_asr, tiny_asr_setup
from repro_torch.models.rnnt import RNNTConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="tiny", choices=["tiny", "small", "paper"])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--data-limit", type=int, default=4)
    ap.add_argument("--fvn-std", type=float, default=0.03)
    ap.add_argument("--ckpt-dir", default="results/ckpt_asr_torch")
    ap.add_argument("--out", default="results/train_federated_asr_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def setup(size: str):
    """(config, corpus) of a size."""
    if size == "tiny":
        return tiny_asr_setup(seed=0)
    if size == "small":
        cfg = RNNTConfig(name="rnnt-small", feat_dim=32, vocab=256,
                         enc_layers=4, enc_hidden=256, pred_layers=2,
                         pred_hidden=256, pred_embed=128, joint_dim=160,
                         specaug=SpecAugmentConfig(freq_masks=2, freq_mask_width=6),
                         dtype="float32", param_dtype="float32")
        return cfg, make_speaker_corpus(num_speakers=96, vocab_size=256,
                                        feat_dim=32, mean_utterances=30.0, seed=0)
    return rnnt_librispeech.make_config(), make_speaker_corpus(
        num_speakers=2338, vocab_size=4096, feat_dim=128, mean_utterances=180.0, seed=0)


def make_plan(args: argparse.Namespace) -> FederatedPlan:
    return FederatedPlan(
        clients_per_round=args.clients, local_batch_size=4,
        data_limit=args.data_limit, client_lr=0.3, server_lr=0.05,
        server_warmup_rounds=max(4, args.rounds // 20),
        server_decay_rounds=args.rounds // 3, server_decay_rate=0.9,
        fvn=FVNConfig(enabled=True, std=args.fvn_std,
                      ramp_rounds=args.rounds // 2),
    )


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, corpus = setup(args.size)
    _, hist = run_federated_asr(
        cfg, corpus, make_plan(args), rounds=args.rounds, seed=0,
        eval_every=max(5, args.rounds // 10), ckpt_dir=args.ckpt_dir, device=args.device)
    print(json.dumps({k: v for k, v in hist.items() if k != "loss"}, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(hist, f)
    return hist


if __name__ == "__main__":
    main()
