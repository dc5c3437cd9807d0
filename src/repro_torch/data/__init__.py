"""Data substrate: the synthetic speaker-split corpus and federated round batching."""
from repro_torch.data.corpus import CorpusConfig, SpeakerCorpus, make_speaker_corpus
from repro_torch.data.pipeline import (FederatedSampler, RoundBatch, pack_round,
                                       per_client_eval_batch)
from repro_torch.data.strategies import available_strategies, get_strategy, register_strategy
from repro_torch.data.synthetic import synthetic_lm_batch, synthetic_lm_clients

__all__ = [
    "CorpusConfig",
    "SpeakerCorpus",
    "make_speaker_corpus",
    "FederatedSampler",
    "RoundBatch",
    "pack_round",
    "per_client_eval_batch",
    "available_strategies",
    "get_strategy",
    "register_strategy",
    "synthetic_lm_batch",
    "synthetic_lm_clients",
]
