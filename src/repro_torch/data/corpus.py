"""Synthetic speaker-split ASR corpus (the Librispeech stand-in).

The port's own copy of ``repro/data/corpus.py``: numpy only, and the
same seed gives bitwise-equal arrays, and ``iid_pool`` the IID baseline's
global pool. ``VirtualPopulation`` waits for ROADMAP M9.

The paper trains on Librispeech split by its 2338 speakers; speaker
splits are non-IID through differences in voice, vocabulary, recording
quality and utterance counts (paper Fig. 2 shows a roughly log-normal
utterance histogram). No audio corpus is available offline (repro band
2/5 — data gate), so we *simulate the gate* with a generator that
reproduces each of those non-IID factors with a controllable strength:

- voice / recording quality -> per-speaker additive bias + channel gain
  in log-mel feature space,
- vocabulary               -> per-speaker Dirichlet skew over the
  word-piece unigram distribution,
- utterance counts          -> log-normal per-speaker example counts.

Labels are word-piece id sequences; features are generated from the
labels through a *shared* random emission codebook (token -> a few
frames of log-mel), so the token<->acoustics mapping is learnable and
the IID-vs-non-IID quality gap is measurable, mirroring the paper's
E0-vs-E1 contrast qualitatively.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    num_speakers: int = 64
    vocab_size: int = 64           # word-pieces (paper: 4096)
    feat_dim: int = 16             # log-mel bins (paper: 128)
    frames_per_token: int = 2      # emission length per word-piece
    min_label_len: int = 4
    max_label_len: int = 12
    mean_utterances: float = 40.0  # log-normal mean (Fig. 2 shape)
    utterance_sigma: float = 0.6
    # non-IID strength dials
    speaker_bias_std: float = 1.0      # voice / channel offset strength
    speaker_gain_std: float = 0.15     # recording-quality gain spread
    vocab_concentration: float = 0.5   # Dirichlet conc.; small => skewed
    noise_std: float = 0.3             # per-frame acoustic noise
    seed: int = 0


class SpeakerCorpus:
    """Container of per-speaker (features, labels) example lists.

    All examples live in one padded arena built once at construction —
    (num_speakers, n_max, ...) arrays — so the federated sampler packs
    round batches by pure fancy-indexing with no per-example Python
    loop. ``speakers[i]`` entries are views into the arena rows:
      features: (n_i, T_max, feat_dim) float32
      labels:   (n_i, U_max)           int32   (0 is blank / pad)
      label_len:(n_i,)                 int32
      frame_len:(n_i,)                 int32
    """

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, F, r = cfg.vocab_size, cfg.feat_dim, cfg.frames_per_token
        self.t_max = cfg.max_label_len * r
        self.u_max = cfg.max_label_len

        # Shared emission codebook: token -> r frames of log-mel.
        self.codebook = rng.normal(0.0, 1.0, size=(V, r, F)).astype(np.float32)
        # Global word-piece unigram (zipf-ish), excluding blank id 0.
        ranks = np.arange(1, V)
        base_p = 1.0 / ranks
        self.base_unigram = base_p / base_p.sum()

        # Pass 1: per-speaker metadata draws. Each speaker has its own
        # generator, carried into pass 2 so the example stream continues
        # exactly where the metadata draws left off.
        metas = []
        for s in range(cfg.num_speakers):
            srng = np.random.default_rng(cfg.seed * 100003 + s + 1)
            bias = srng.normal(0.0, cfg.speaker_bias_std, size=(F,)).astype(np.float32)
            gain = 1.0 + srng.normal(0.0, cfg.speaker_gain_std)
            if cfg.vocab_concentration >= 1e6:   # IID limit: no vocab skew
                unigram = self.base_unigram
            else:
                unigram = srng.dirichlet(self.base_unigram * (V - 1) * cfg.vocab_concentration)
            n = max(2, int(srng.lognormal(np.log(cfg.mean_utterances), cfg.utterance_sigma)))
            metas.append((srng, bias, gain, unigram, n))

        # Pass 2: one padded arena for every speaker's examples.
        P = cfg.num_speakers
        self.counts = np.array([m[4] for m in metas], np.int64)
        self.n_max = int(self.counts.max())
        self.arena_features = np.zeros((P, self.n_max, self.t_max, F), np.float32)
        self.arena_labels = np.zeros((P, self.n_max, self.u_max), np.int32)
        self.arena_label_len = np.zeros((P, self.n_max), np.int32)
        self.arena_frame_len = np.zeros((P, self.n_max), np.int32)

        self.speakers = []
        for s, (srng, bias, gain, unigram, n) in enumerate(metas):
            feats = self.arena_features[s]
            labels = self.arena_labels[s]
            label_len = self.arena_label_len[s]
            frame_len = self.arena_frame_len[s]
            for i in range(n):
                u = int(srng.integers(cfg.min_label_len, cfg.max_label_len + 1))
                toks = srng.choice(np.arange(1, V), size=u, p=unigram)
                labels[i, :u] = toks
                label_len[i] = u
                t = u * r
                frame_len[i] = t
                emission = self.codebook[toks].reshape(t, F)
                noise = srng.normal(0.0, cfg.noise_std, size=(t, F))
                feats[i, :t] = gain * emission + bias + noise
            self.speakers.append(
                dict(features=feats[:n], labels=labels[:n], label_len=label_len[:n],
                     frame_len=frame_len[:n], bias=bias, gain=gain, n=n)
            )

    @property
    def num_speakers(self) -> int:
        return len(self.speakers)

    def iid_pool(self):
        """Flatten all speakers into one pool (central/Baseline training):
        each speaker's n real rows, in speaker order."""
        feats = np.concatenate([s["features"] for s in self.speakers])
        labels = np.concatenate([s["labels"] for s in self.speakers])
        label_len = np.concatenate([s["label_len"] for s in self.speakers])
        frame_len = np.concatenate([s["frame_len"] for s in self.speakers])
        return dict(features=feats, labels=labels, label_len=label_len, frame_len=frame_len)

    def eval_split(self, num_examples: int, seed: int = 1234, hard: bool = False):
        """Held-out eval set; ``hard=True`` mimics the *Other* sets by
        doubling acoustic noise and halving gains (harder recognition)."""
        cfg = self.cfg
        rng = np.random.default_rng(seed + (1 if hard else 0))
        F, r = cfg.feat_dim, cfg.frames_per_token
        feats = np.zeros((num_examples, self.t_max, F), np.float32)
        labels = np.zeros((num_examples, self.u_max), np.int32)
        label_len = np.zeros((num_examples,), np.int32)
        frame_len = np.zeros((num_examples,), np.int32)
        noise_std = cfg.noise_std * (2.5 if hard else 1.0)
        for i in range(num_examples):
            u = int(rng.integers(cfg.min_label_len, cfg.max_label_len + 1))
            toks = rng.choice(np.arange(1, cfg.vocab_size), size=u, p=self.base_unigram)
            labels[i, :u] = toks
            label_len[i] = u
            t = u * r
            frame_len[i] = t
            emission = self.codebook[toks].reshape(t, F)
            bias = rng.normal(0.0, cfg.speaker_bias_std, size=(F,))
            gain = 1.0 + rng.normal(0.0, cfg.speaker_gain_std)
            feats[i, :t] = gain * emission + bias + rng.normal(0.0, noise_std, size=(t, F))
        return dict(features=feats, labels=labels, label_len=label_len, frame_len=frame_len)


def make_speaker_corpus(**kwargs) -> SpeakerCorpus:
    return SpeakerCorpus(CorpusConfig(**kwargs))
