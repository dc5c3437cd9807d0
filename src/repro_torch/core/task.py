"""FederatedTask — the engine's task-level entry point.

The port of ``repro/core/task.py``. A task bundles the model (a
``ModelBundle`` of ``models/model_zoo.py``, built with ``device=None``:
the parameters live where the caller's generator draws them, the batch
where the round engine puts it), the batch adapter that maps the
engine's round-batch layout ({features, labels, frame_len, label_len,
weight}) onto the model's, the corpus it trains on, its quality metric
and its evaluation hooks, all chosen by the model's kind
(``_KIND_ADAPTERS``, ``repro/core/task.py:264-272``):

- ``rnnt``: the engine layout as it is; WER by greedy decoding on the
  clean and hard eval splits (``:141-163``), per client over the panel
  (``:236-257``);
- ``audio`` (the enc-dec): ``features`` read as precomputed frame
  embeddings and ``labels`` as the tokens (``_encdec_adapt``, ``:118``);
  perplexity, exp of the loss clipped at ``_PPL_CLIP`` (``_ppl_evaluate``
  ``:166``, ``_ppl_client_quality`` ``:207``);
- ``dense`` and ``moe`` (the decoder-only transformer), ``ssm`` (the
  RWKV-6 stack) and ``hybrid`` (the Zamba2 hybrid): ``labels`` read as the
  tokens (``_lm_adapt``, ``:112``; the label rows' padding zeros are
  trained on too, as in the reference); perplexity as the enc-dec's;
- ``keyword``: the engine layout as it is; the classification error rate
  (``_err_evaluate`` ``:183``, ``_err_client_quality`` ``:218``).

``client_loss`` is the per-client evaluation plane's loss of each tracked
client (``core/clienteval.py``), as the reference's ``vmap(loss_fn)``
over the panel's clients. ``arch_task(arch_id)`` is the task of an
``--arch`` id's smoke config (``configs/registry.py``) on the shared
corpus; a VLM has none (no adapter for kind ``vlm``, as in the reference).
The registry (``register_task``, ``available_tasks``, ``get_task(name,
seed)``, ``task_for_config``) names:

- ``asr-rnnt``: the container-scale RNN-T of ``:352-368`` on the shared
  48-speaker corpus;
- ``rnnt-librispeech``: the paper's model at full width
  (``configs/rnnt_librispeech.py``) on a corpus at the paper's widths
  (128 log-mel bins, 4096 word-pieces, labels up to 32 word-pieces of 4
  frames each, so T = 128 and T' = 64 after the time stride);
- ``asr-encdec``: the reference's ``encdec-tiny`` (``:372-393``) on the
  shared corpus, whose 16 feature bins are its d_model;
- ``whisper-base``: the enc-dec at whisper-base's full width
  (``configs/whisper_base.py``, bf16 parameters) on a corpus whose frames
  are d_model wide (``whisper_width_corpus``);
- ``lm-transformer``, ``lm-moe`` and ``keyword``: the reference's
  container-scale LM, MoE LM and keyword classifier (``:396-460``) on the
  shared corpus;
- ``qwen3-8b``: qwen3-8b at full width and 4 of its 36 layers
  (``configs/qwen3_8b.py``, bf16 parameters) on a corpus at its vocabulary
  (``qwen_width_corpus``);
- ``deepseek-v2-lite-16b``: deepseek-v2-lite-16b at full width and 2 of
  its 27 layers, the dense first layer and the first MoE layer, both with
  multi-head latent attention (``configs/deepseek_v2_lite_16b.py``, bf16
  parameters, the router fp32), on a corpus at its vocabulary
  (``deepseek_width_corpus``);
- ``lm-rwkv``: the reference's container-scale RWKV-6 LM (``rwkv-tiny``,
  ``:436-449``) on the shared corpus;
- ``rwkv6-1.6b``: rwkv6-1.6b at its full published size, all 24 layers
  (``configs/rwkv6_1p6b.py``, bf16 parameters), on a corpus at its
  vocabulary (``rwkv_width_corpus``);
- ``zamba2-7b``: zamba2-7b at full width and 7 of its 81 Mamba2 layers
  (``configs/zamba2_7b.py``, bf16 parameters), on a corpus at its
  vocabulary (``zamba_width_corpus``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.asr.specaugment import SpecAugmentConfig
from repro_torch.asr.wer import wer
from repro_torch.data import make_speaker_corpus
from repro_torch.models import encdec, keyword, rnnt
from repro_torch.models.model_zoo import ModelBundle, build_model

# Caps exp(loss) so an early-training evaluation can't overflow to inf.
_PPL_CLIP = 20.0


def _device_of(params: dict) -> torch.device:
    return next(iter(params.values())).device


def _eval_batch(ev: dict, device) -> dict:
    """An ``eval_split`` dict in the engine-batch layout (weight 1), as
    tensors on ``device``."""
    out = {k: torch.from_numpy(ev[k]).to(device)
           for k in ("features", "labels", "frame_len", "label_len")}
    out["weight"] = torch.ones((ev["labels"].shape[0],), dtype=torch.float32, device=device)
    return out


def _client_slice(batch: dict, c: int, device) -> dict:
    """Client c's examples of a (C, n, ...) panel batch, on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[c])).to(device) for k, v in batch.items()}


# ------------------------------------------------------- batch adapters


def _lm_adapt(batch: dict) -> dict:
    """LM models read the word-piece label sequence as tokens: the
    per-speaker vocabulary skew makes it non-IID text."""
    return {"tokens": batch["labels"], "weight": batch.get("weight")}


def _encdec_adapt(batch: dict) -> dict:
    """The enc-dec (Whisper-style) consumes precomputed frame embeddings:
    the corpus's feature width is its d_model."""
    return {"frames": batch["features"], "tokens": batch["labels"],
            "weight": batch.get("weight")}


# ------------------------------------------------------ evaluation hooks


def _ppl_evaluate(loss_fn: Callable) -> Callable:
    """LM and enc-dec evaluation: the clipped perplexity of the task loss
    over the eval splits."""
    def one(params: dict, ev: dict) -> float:
        with torch.no_grad():
            loss = float(loss_fn(params, _eval_batch(ev, _device_of(params)))[0])
        return float(np.exp(min(loss, _PPL_CLIP)))

    def evaluate(params: dict, corpus, n: int = 64) -> dict:
        return {"quality": one(params, corpus.eval_split(n)),
                "quality_hard": one(params, corpus.eval_split(n, hard=True))}

    return evaluate


def _client_loss(loss_fn: Callable) -> Callable:
    """(C,) the task loss of each tracked client, one forward a client:
    its weighted loss over its own examples, as the reference's
    ``vmap(loss_fn)`` over the client axis computes it."""
    def client_loss(params: dict, batch: dict) -> np.ndarray:
        device = _device_of(params)
        with torch.no_grad():
            losses = [float(loss_fn(params, _client_slice(batch, c, device))[0])
                      for c in range(batch["weight"].shape[0])]
        return np.asarray(losses, np.float64)

    return client_loss


def _ppl_client_quality(loss_fn: Callable) -> Callable:
    """(C,) clipped perplexity of each tracked client."""
    client_loss = _client_loss(loss_fn)

    def client_quality(params: dict, batch: dict) -> np.ndarray:
        return np.exp(np.minimum(client_loss(params, batch), _PPL_CLIP))

    return client_quality


def _err_evaluate(cfg: keyword.KeywordConfig) -> Callable:
    """Keyword evaluation: the classification error rate of the pooled MLP
    on ``n`` examples of the clean and the hard eval split."""
    def one(params: dict, ev: dict) -> float:
        device = _device_of(params)
        with torch.no_grad():
            pred = keyword.predict(cfg, params, torch.from_numpy(ev["features"]).to(device),
                                   torch.from_numpy(ev["frame_len"]).to(device))
        return float(np.mean(pred.cpu().numpy() != ev["labels"][:, 0]))

    def evaluate(params: dict, corpus, n: int = 64) -> dict:
        return {"quality": one(params, corpus.eval_split(n)),
                "quality_hard": one(params, corpus.eval_split(n, hard=True))}

    return evaluate


def _err_client_quality(cfg: keyword.KeywordConfig) -> Callable:
    """(C,) the weighted classification error of each tracked client: one
    forward over the flattened C·n panel."""
    def client_quality(params: dict, batch: dict) -> np.ndarray:
        C, n = batch["weight"].shape
        device = _device_of(params)
        flat = {k: torch.from_numpy(np.ascontiguousarray(v.reshape((C * n,) + v.shape[2:])))
                .to(device) for k, v in batch.items()}
        with torch.no_grad():
            logits = keyword.forward(cfg, params, flat["features"], flat["frame_len"])
        hit = (logits.argmax(dim=-1) == keyword.class_of(flat)).float().reshape(C, n)
        w = flat["weight"].reshape(C, n)
        err = 1.0 - (hit * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
        return err.cpu().double().numpy()

    return client_quality


def _rnnt_decode(cfg: rnnt.RNNTConfig, params: dict, features: np.ndarray,
                 frame_len: np.ndarray) -> np.ndarray:
    """Greedy-decoded token ids (N, T'·4) on the host."""
    device = _device_of(params)
    hyp = rnnt.greedy_decode(cfg, params, torch.from_numpy(features).to(device),
                             torch.from_numpy(frame_len).to(device))
    return np.asarray(hyp.cpu())


def _decode_wer(cfg: rnnt.RNNTConfig, params: dict, ev: dict) -> float:
    hyp = _rnnt_decode(cfg, params, ev["features"], ev["frame_len"])
    refs = [ev["labels"][i, : ev["label_len"][i]].tolist() for i in range(ev["labels"].shape[0])]
    return wer(refs, [h[h != 0].tolist() for h in hyp])


def _wer_evaluate(cfg: rnnt.RNNTConfig) -> Callable:
    """ASR evaluation: greedy RNN-T decoding and WER on ``n`` examples of
    the clean and the hard eval split, on the parameters' device."""
    def evaluate(params: dict, corpus, n: int = 64) -> dict:
        return {"quality": _decode_wer(cfg, params, corpus.eval_split(n)),
                "quality_hard": _decode_wer(cfg, params, corpus.eval_split(n, hard=True))}

    return evaluate


def _wer_client_loss(loss_fn: Callable) -> Callable:
    """(C,) the RNN-T loss of each tracked client, SpecAugment off (no
    key): one forward over the flattened C·n panel, each client's weighted
    mean of the per-example losses (the reference's per-client
    ``loss_fn``, whose loss is that weighted mean)."""
    def client_loss(params: dict, batch: dict) -> np.ndarray:
        C, n = batch["weight"].shape
        device = _device_of(params)
        flat = {k: torch.from_numpy(np.ascontiguousarray(v.reshape((C * n,) + v.shape[2:])))
                .to(device) for k, v in batch.items()}
        with torch.no_grad():
            _, aux = loss_fn(params, flat)
        w = flat["weight"].reshape(C, n)
        nll = aux["nll"].float().reshape(C, n)
        loss = (nll * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
        return loss.cpu().double().numpy()

    return client_loss


def _wer_client_quality(cfg: rnnt.RNNTConfig) -> Callable:
    """(C,) WER of each tracked client: one greedy decode over the
    flattened C·n panel, then each client's WER over its real examples on
    the host; 0.0 for a client with none."""
    def client_quality(params: dict, batch: dict) -> np.ndarray:
        C, n = batch["weight"].shape
        feats = batch["features"].reshape((C * n,) + batch["features"].shape[2:])
        hyp = _rnnt_decode(cfg, params, feats, batch["frame_len"].reshape(C * n))
        hyp = hyp.reshape(C, n, -1)
        out = np.zeros((C,), np.float64)
        for c in range(C):
            real = np.flatnonzero(batch["weight"][c] > 0)
            refs = [batch["labels"][c, i, : batch["label_len"][c, i]].tolist() for i in real]
            hyps = [hyp[c, i][hyp[c, i] != 0].tolist() for i in real]
            out[c] = wer(refs, hyps) if refs else 0.0
        return out

    return client_quality


# ------------------------------------------------------------ dispatch

# ModelBundle kind -> (quality metric, batch adapter); None adapter: the
# model consumes the engine layout as it is. No vlm kind, as in the
# reference: the speaker corpus has no images, so a VLM config has no task
# (task_for_config and arch_task raise) and trains through
# core.fedavg.make_round_step on its own batches, as the reference's dry
# run does (repro/launch/dryrun.py:84-101).
_KIND_ADAPTERS = {
    "rnnt": ("wer", None),
    "audio": ("ppl", _encdec_adapt),
    "dense": ("ppl", _lm_adapt),
    "moe": ("ppl", _lm_adapt),
    "ssm": ("ppl", _lm_adapt),
    "hybrid": ("ppl", _lm_adapt),
    "keyword": ("err", None),
}


@dataclasses.dataclass(frozen=True)
class FederatedTask:
    """One federated workload: model, batch adapter, corpus and metric.
    ``FederatedTask(name, config, make_corpus)``; everything else follows
    from the config's model kind."""

    name: str
    config: Any
    make_corpus: Callable  # (seed) -> SpeakerCorpus

    @functools.cached_property
    def bundle(self) -> ModelBundle:
        return build_model(self.config, device=None)

    @property
    def kind(self) -> str:
        return self.bundle.kind

    @property
    def quality_metric(self) -> str:
        """What "quality" means in the summary: "wer", "ppl" or "err"."""
        return self._adapter[0]

    @property
    def adapt_batch(self) -> Optional[Callable]:
        return self._adapter[1]

    @functools.cached_property
    def _adapter(self) -> tuple:
        if self.kind not in _KIND_ADAPTERS:
            raise ValueError(
                f"no federated task adapter for model kind {self.kind!r} (config "
                f"{type(self.config).__name__}); the speaker corpus has no modality for it — "
                f"adapters exist for {sorted(_KIND_ADAPTERS)}")
        return _KIND_ADAPTERS[self.kind]

    @property
    def model(self) -> rnnt.RNNT:
        """The RNN-T's shape-only module the loss is called through."""
        if self.bundle.module is None:
            raise TypeError(f"task {self.name!r} ({self.kind}) has no module template")
        return self.bundle.module

    def init_params(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device."""
        return self.bundle.init(generator)

    def loss_fn(self, params: dict, batch: dict, key=None):
        """The engine-facing loss: the model's loss behind the adapter."""
        adapt = self.adapt_batch
        return self.bundle.loss_fn(params, adapt(batch) if adapt else batch, key)

    @functools.cached_property
    def _hooks(self) -> dict:
        if self.quality_metric == "wer":
            return {"evaluate": _wer_evaluate(self.config),
                    "client_loss": _wer_client_loss(self.loss_fn),
                    "client_quality": _wer_client_quality(self.config)}
        if self.quality_metric == "err":
            return {"evaluate": _err_evaluate(self.config),
                    "client_loss": _client_loss(self.loss_fn),
                    "client_quality": _err_client_quality(self.config)}
        return {"evaluate": _ppl_evaluate(self.loss_fn),
                "client_loss": _client_loss(self.loss_fn),
                "client_quality": _ppl_client_quality(self.loss_fn)}

    def evaluate(self, params: dict, corpus, n: int = 64) -> dict:
        """{"quality", "quality_hard"} in the task's metric on ``n``
        examples of the clean and the hard eval split."""
        return self._hooks["evaluate"](params, corpus, n)

    def client_loss(self, params: dict, batch: dict) -> np.ndarray:
        """(C,) the loss of each tracked client over a (C, n, ...) panel."""
        return self._hooks["client_loss"](params, batch)

    def client_quality(self, params: dict, batch: dict) -> np.ndarray:
        """(C,) the task metric of each tracked client."""
        return self._hooks["client_quality"](params, batch)


def task_for_config(cfg, name: Optional[str] = None,
                    make_corpus: Optional[Callable] = None) -> FederatedTask:
    """THE config -> task mapping: the bundle's kind picks the adapter,
    the metric and the evaluation hooks (``repro/core/task.py:275``).
    Raises for a config the port has no model or adapter for."""
    task = FederatedTask(name or cfg.name, cfg, make_corpus or default_corpus)
    task.quality_metric  # builds the bundle and checks the kind
    return task


def arch_task(arch_id: str) -> FederatedTask:
    """A task from the ``--arch`` registry's smoke config, on the shared
    corpus (``repro/core/task.py:314-318``)."""
    from repro_torch.configs import get_arch

    return task_for_config(get_arch(arch_id).make_smoke_config(), name=arch_id)


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


# ---------------------------------------------------------------- corpus


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


# whisper-base's widths: frames d_model = 512 wide (the enc-dec reads them
# as frame embeddings), 51,865 word-pieces, labels up to 48 tokens of 8
# frames each, so T = 384 frames (7.7 s at Whisper's 50 frames a second)
# and U = 48. On the host the token codebook takes 849,756,160 B and the
# arena (16 speakers, 183 utterances, at most 23 a speaker) 289,480,576 B;
# it builds in 5.6-6.8 s on an H100 machine's host (chip_smoke.py phase 5).
WHISPER_CORPUS = dict(num_speakers=16, vocab_size=51865, feat_dim=512, max_label_len=48,
                      frames_per_token=8, mean_utterances=12.0)


def whisper_width_corpus(seed: int = 0):
    """A corpus at whisper-base's widths (``WHISPER_CORPUS``)."""
    return make_speaker_corpus(**WHISPER_CORPUS, seed=seed)


# qwen3-8b's vocabulary: 151,936 word-pieces, labels up to 128 tokens (the
# LM's sequences), 16 feature bins (the LM reads only the labels, so the
# token codebook stays 19,447,808 B on the host)
QWEN_CORPUS = dict(num_speakers=16, vocab_size=151936, feat_dim=16, max_label_len=128,
                   mean_utterances=12.0)


def qwen_width_corpus(seed: int = 0):
    """A corpus at qwen3-8b's vocabulary (``QWEN_CORPUS``)."""
    return make_speaker_corpus(**QWEN_CORPUS, seed=seed)


# deepseek-v2-lite-16b's vocabulary (102,400 word-pieces), shaped as
# QWEN_CORPUS: 128-token label rows, 16 feature bins
DEEPSEEK_CORPUS = dict(QWEN_CORPUS, vocab_size=102400)


def deepseek_width_corpus(seed: int = 0):
    """A corpus at deepseek-v2-lite-16b's vocabulary (``DEEPSEEK_CORPUS``)."""
    return make_speaker_corpus(**DEEPSEEK_CORPUS, seed=seed)


# rwkv6-1.6b's and zamba2-7b's vocabularies (65,536 and 32,000 word-pieces),
# shaped as QWEN_CORPUS: 128-token label rows, 16 feature bins
RWKV_CORPUS = dict(QWEN_CORPUS, vocab_size=65536)
ZAMBA_CORPUS = dict(QWEN_CORPUS, vocab_size=32000)


def rwkv_width_corpus(seed: int = 0):
    """A corpus at rwkv6-1.6b's vocabulary (``RWKV_CORPUS``)."""
    return make_speaker_corpus(**RWKV_CORPUS, seed=seed)


def zamba_width_corpus(seed: int = 0):
    """A corpus at zamba2-7b's vocabulary (``ZAMBA_CORPUS``)."""
    return make_speaker_corpus(**ZAMBA_CORPUS, seed=seed)


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


def tiny_encdec_config() -> encdec.EncDecConfig:
    """The reference's ``encdec-tiny`` (``repro/core/task.py:378-391``)."""
    return encdec.EncDecConfig(
        name="encdec-tiny", enc_layers=1, dec_layers=1, d_model=16, n_heads=2, n_kv=2,
        head_dim=8, d_ff=32, vocab=64, max_source=24, max_target=12, dtype="float32",
        loss_chunk=12,
    )


# ----------------------------------------------------- named registry

_TASKS: dict = {}


def register_task(name: str) -> Callable:
    """Decorator: register a task factory ``(seed) -> FederatedTask``."""
    def deco(factory):
        _TASKS[name] = factory
        return factory

    return deco


def available_tasks() -> list:
    return sorted(_TASKS)


def get_task(name: str, seed: int = 0) -> FederatedTask:
    if name not in _TASKS:
        raise KeyError(f"unknown task {name!r}; available: {available_tasks()}")
    return _TASKS[name](seed)


@register_task("asr-rnnt")
def _asr_rnnt_task(seed: int = 0) -> FederatedTask:
    """The paper's task at container scale."""
    return task_for_config(tiny_rnnt_config(), name="asr-rnnt")


@register_task("rnnt-librispeech")
def _rnnt_librispeech_task(seed: int = 0) -> FederatedTask:
    """The paper's model at full width."""
    from repro_torch.configs import rnnt_librispeech

    return task_for_config(rnnt_librispeech.make_config(), name=rnnt_librispeech.ARCH_ID,
                           make_corpus=paper_width_corpus)


@register_task("asr-encdec")
def _asr_encdec_task(seed: int = 0) -> FederatedTask:
    """Whisper-style enc-dec over precomputed frame features (d_model ==
    the corpus feat_dim, so the arena's features are the frame embeds)."""
    return task_for_config(tiny_encdec_config(), name="asr-encdec")


@register_task("whisper-base")
def _whisper_base_task(seed: int = 0) -> FederatedTask:
    """whisper-base at full width: 6 + 6 layers, d_model 512, 8 heads of
    64, d_ff 2048, vocab 51,865, bf16 parameters."""
    from repro_torch.configs import whisper_base

    return task_for_config(whisper_base.make_config(), name=whisper_base.ARCH_ID,
                           make_corpus=whisper_width_corpus)


def tiny_lm_config():
    """The reference's ``lm-tiny`` (``repro/core/task.py:399-411``)."""
    from repro_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        name="lm-tiny", n_layers=2, d_model=32, n_heads=2, n_kv=2, head_dim=16, d_ff=64,
        vocab=64, dtype="float32", loss_chunk=12,
    )


def tiny_moe_config():
    """The reference's ``moe-tiny`` (``repro/core/task.py:419-432``)."""
    from repro_torch.models.moe import MoEConfig

    return dataclasses.replace(
        tiny_lm_config(), name="moe-tiny",
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=32, capacity_factor=2.0))


@register_task("lm-transformer")
def _lm_transformer_task(seed: int = 0) -> FederatedTask:
    """A two-layer dense LM reading the corpus's label sequences."""
    return task_for_config(tiny_lm_config(), name="lm-transformer")


@register_task("lm-moe")
def _lm_moe_task(seed: int = 0) -> FederatedTask:
    """The same LM with a 4-expert top-2 MoE in place of each MLP."""
    return task_for_config(tiny_moe_config(), name="lm-moe")


@register_task("keyword")
def _keyword_task(seed: int = 0) -> FederatedTask:
    """The million-client CI workload: about 10k parameters."""
    return task_for_config(
        keyword.KeywordConfig(name="keyword-tiny", feat_dim=16, n_classes=64, hidden=64),
        name="keyword")


@register_task("qwen3-8b")
def _qwen3_8b_task(seed: int = 0) -> FederatedTask:
    """qwen3-8b at full width (d_model 4,096, 32 query heads on 8 kv heads
    of 128, d_ff 12,288, vocab 151,936, qk_norm, bf16 parameters) and 4 of
    its 36 layers: 2,016,449,536 parameters. Depth is the cut because a
    round keeps the parameters, the server's fp32 Adam moments, the fp32
    mean delta and one client's copies, perturbed copy, gradients and fp32
    updates and delta on the card: its peak was 68.3 GB at 4 layers on an
    80 GB H100, and at about 24 B a parameter 36 layers need about 197 GB."""
    from repro_torch.configs import qwen3_8b

    return task_for_config(qwen3_8b.make_config(n_layers=4), name=qwen3_8b.ARCH_ID,
                           make_corpus=qwen_width_corpus)


@register_task("deepseek-v2-lite-16b")
def _deepseek_v2_lite_16b_task(seed: int = 0) -> FederatedTask:
    """deepseek-v2-lite-16b at full width (d_model 2,048, 16 heads, vocab
    102,400, MLA with kv_lora 512 and q·k and v widths 192 and 128, bf16
    parameters) and 2 of its 27 layers: the dense first layer (d_ff
    10,944, under ``dense_layers.``) and the first MoE layer (64 experts of
    d_ff 1,408, top-6, 2 shared experts of 2,816, the fp32 router, under
    ``layers.``): 1,085,287,424 parameters. Depth is the cut because a round
    keeps the parameters, the server's fp32 Adam moments and mean delta and
    one client's copies on the card, about 34 B a parameter at qwen3-8b's
    measured peak (68.3 GB for 2.016 G): about 37 GB at 2 layers, about 530
    GB for all 27 layers' 15,706,484,224. Two layers put MLA in both layer
    groups and the first full-width MoE layer on the card."""
    from repro_torch.configs import deepseek_v2_lite_16b

    return task_for_config(deepseek_v2_lite_16b.make_config(n_layers=2),
                           name=deepseek_v2_lite_16b.ARCH_ID, make_corpus=deepseek_width_corpus)


def tiny_rwkv_config():
    """The reference's ``rwkv-tiny`` (``repro/core/task.py:438-447``)."""
    from repro_torch.models.model_zoo import RWKVModelConfig
    from repro_torch.models.rwkv import RWKVConfig

    return RWKVModelConfig(name="rwkv-tiny", n_layers=2,
                           rwkv=RWKVConfig(d_model=32, head_size=16, d_ff=64), vocab=64,
                           dtype="float32", loss_chunk=12)


@register_task("lm-rwkv")
def _lm_rwkv_task(seed: int = 0) -> FederatedTask:
    """A two-layer RWKV-6 LM reading the corpus's label sequences."""
    return task_for_config(tiny_rwkv_config(), name="lm-rwkv")


@register_task("rwkv6-1.6b")
def _rwkv6_1p6b_task(seed: int = 0) -> FederatedTask:
    """rwkv6-1.6b at its full published size (24 layers, d_model 2,048 in
    32 heads of 64, d_ff 7,168, vocab 65,536, bf16 parameters):
    1,584,091,136 parameters."""
    from repro_torch.configs import rwkv6_1p6b

    return task_for_config(rwkv6_1p6b.make_config(), name=rwkv6_1p6b.ARCH_ID,
                           make_corpus=rwkv_width_corpus)


@register_task("zamba2-7b")
def _zamba2_7b_task(seed: int = 0) -> FederatedTask:
    """zamba2-7b at full width (d_model 3,584, 112 SSM heads of 64 with
    state 64, the shared block's 32 heads of 112 and d_ff 14,336, vocab
    32,000, bf16 parameters) and 7 of its 81 Mamba2 layers: one group of 6
    and a tail of 1, so the shared block runs twice, on both code paths;
    980,754,096 parameters. Depth is the cut because a round keeps the
    parameters, the server's fp32 Adam moments and mean delta and one
    client's copies on the card: its round peaked at 32,009,919,488 B at 7
    layers on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5), about 33 B a
    parameter, so all 81 layers' 6,751,130,832 need about 220 GB."""
    from repro_torch.configs import zamba2_7b

    return task_for_config(zamba2_7b.make_config(n_layers=7), name=zamba2_7b.ARCH_ID,
                           make_corpus=zamba_width_corpus)
