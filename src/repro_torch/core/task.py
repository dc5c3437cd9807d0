"""FederatedTask — the engine's task-level entry point.

The port of ``repro/core/task.py`` for the paper's task: the RNN-T on
the speaker-split corpus. A task bundles the model (an ``RNNT``
template on the ``meta`` device), how to draw its parameters, its
functional loss, the corpus it trains on, and its evaluation: greedy
decoding and WER on the clean and hard eval splits
(``repro/core/task.py:141-163``), and the per-client evaluation plane's
hooks (``client_loss``, ``client_quality``). Two tasks exist:

- ``asr-rnnt``: the container-scale config of ``repro/core/task.py:352-368``
  on the shared 48-speaker corpus;
- ``rnnt-librispeech``: the paper's model at full width
  (``configs/rnnt_librispeech.py``) on a corpus at the paper's widths
  (128 log-mel bins, 4096 word-pieces, labels up to 32 word-pieces of 4
  frames each, so T = 128 and T' = 64 after the time stride).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.asr.specaugment import SpecAugmentConfig
from repro_torch.asr.wer import wer
from repro_torch.data import make_speaker_corpus
from repro_torch.models import rnnt


@dataclasses.dataclass(frozen=True)
class FederatedTask:
    name: str
    config: rnnt.RNNTConfig
    make_corpus: Callable  # (seed) -> SpeakerCorpus
    quality_metric: str = "wer"  # what "quality" means in the summary

    @functools.cached_property
    def model(self) -> rnnt.RNNT:
        """The shape-only module the loss is called through."""
        return rnnt.RNNT(self.config)

    def init_params(self, generator: torch.Generator) -> dict:
        return rnnt.init_params(self.config, generator)

    def loss_fn(self, params: dict, batch: dict, key=None):
        return rnnt.loss_fn(self.model, params, batch, key)

    def evaluate(self, params: dict, corpus, n: int = 64) -> dict:
        """Greedy-decode WER on ``n`` examples of the clean and the hard
        eval split, on the parameters' device."""
        return {"quality": self._decode_wer(params, corpus.eval_split(n)),
                "quality_hard": self._decode_wer(params, corpus.eval_split(n, hard=True))}

    def _decode(self, params: dict, features: np.ndarray, frame_len: np.ndarray) -> np.ndarray:
        """Greedy-decoded token ids (N, T'·4) on the host."""
        device = next(iter(params.values())).device
        hyp = rnnt.greedy_decode(self.config, params, torch.from_numpy(features).to(device),
                                 torch.from_numpy(frame_len).to(device))
        return np.asarray(hyp.cpu())

    def _decode_wer(self, params: dict, ev: dict) -> float:
        hyp = self._decode(params, ev["features"], ev["frame_len"])
        refs = [ev["labels"][i, : ev["label_len"][i]].tolist()
                for i in range(ev["labels"].shape[0])]
        hyps = [h[h != 0].tolist() for h in hyp]
        return wer(refs, hyps)

    def client_loss(self, params: dict, batch: dict) -> np.ndarray:
        """(C,) the loss of each tracked client over its examples
        (``per_client_eval_batch``'s (C, n, ...) layout), SpecAugment off
        (no key), as the reference's ``loss_fn(p, b_c)`` under a vmap over
        the clients: one forward over the flattened C·n batch, each
        client's weighted mean of the per-example losses."""
        C, n = batch["weight"].shape
        device = next(iter(params.values())).device
        flat = {k: torch.from_numpy(np.ascontiguousarray(v.reshape((C * n,) + v.shape[2:])))
                .to(device) for k, v in batch.items()}
        with torch.no_grad():
            _, aux = self.loss_fn(params, flat)
        w = flat["weight"].reshape(C, n)
        nll = aux["nll"].float().reshape(C, n)
        loss = (nll * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
        return loss.cpu().double().numpy()

    def client_quality(self, params: dict, batch: dict) -> np.ndarray:
        """(C,) WER of each tracked client: one greedy decode over the
        flattened C·n batch, then each client's WER over its real examples
        on the host (``repro/core/task.py:236-257``); 0.0 for a client with
        none."""
        C, n = batch["weight"].shape
        feats = batch["features"].reshape((C * n,) + batch["features"].shape[2:])
        hyp = self._decode(params, feats, batch["frame_len"].reshape(C * n)).reshape(C, n, -1)
        out = np.zeros((C,), np.float64)
        for c in range(C):
            real = np.flatnonzero(batch["weight"][c] > 0)
            refs = [batch["labels"][c, i, : batch["label_len"][c, i]].tolist() for i in real]
            hyps = [hyp[c, i][hyp[c, i] != 0].tolist() for i in real]
            out[c] = wer(refs, hyps) if refs else 0.0
        return out


def scaled_task(task: FederatedTask, specaug_scale: float) -> FederatedTask:
    """The task around a specaug-scaled config (E10-style regularization,
    ``repro/launch/train.py:81-95``): both mask counts times the scale,
    rounded, at least 1. Defined only for a config with a ``specaug``
    policy."""
    cfg = task.config
    if getattr(cfg, "specaug", None) is None:
        raise ValueError(
            f"specaug_scale={specaug_scale} but task {task.name!r} "
            f"({type(cfg).__name__}) has no specaug policy")
    sa = cfg.specaug
    cfg = dataclasses.replace(
        cfg, specaug=dataclasses.replace(
            sa, freq_masks=max(1, int(round(sa.freq_masks * specaug_scale))),
            time_masks=max(1, int(round(sa.time_masks * specaug_scale)))))
    return dataclasses.replace(task, config=cfg)


def default_corpus(seed: int = 0):
    """The shared container-scale speaker corpus, bitwise equal to
    ``repro.core.task.default_corpus``."""
    return make_speaker_corpus(
        num_speakers=48, vocab_size=64, feat_dim=16, mean_utterances=24.0, seed=seed
    )


def paper_width_corpus(seed: int = 0):
    """A corpus at the paper model's input and output widths."""
    return make_speaker_corpus(
        num_speakers=16, vocab_size=4096, feat_dim=128, max_label_len=32,
        frames_per_token=4, seed=seed
    )


def tiny_rnnt_config() -> rnnt.RNNTConfig:
    return rnnt.RNNTConfig(
        name="rnnt-tiny",
        feat_dim=16,
        vocab=64,
        enc_layers=2,
        enc_hidden=96,
        pred_layers=1,
        pred_hidden=96,
        pred_embed=32,
        joint_dim=64,
        time_stride=1,
        specaug=SpecAugmentConfig(
            freq_masks=1, freq_mask_width=3, time_masks=1, time_mask_frac=0.05
        ),
        dtype="float32",
        param_dtype="float32",
    )


def get_task(name: str) -> FederatedTask:
    from repro_torch.configs import rnnt_librispeech

    tasks = {
        "asr-rnnt": lambda: FederatedTask("asr-rnnt", tiny_rnnt_config(), default_corpus),
        rnnt_librispeech.ARCH_ID: lambda: FederatedTask(
            rnnt_librispeech.ARCH_ID, rnnt_librispeech.make_config(), paper_width_corpus),
    }
    if name not in tasks:
        raise KeyError(f"unknown task {name!r}; available: {sorted(tasks)}")
    return tasks[name]()
