"""The port's data plane is a bitwise copy of the JAX package's: the
corpus arena and consecutive round batches for every sampling
strategy, with and without a data limit."""

import numpy as np
import pytest

from repro.core.task import default_corpus as jax_default_corpus
from repro.data import FederatedSampler as JaxSampler
from repro.data import available_strategies as jax_strategies
from repro_torch.core.task import default_corpus, paper_width_corpus
from repro_torch.data import FederatedSampler, available_strategies

ARENA = ("arena_features", "arena_labels", "arena_label_len", "arena_frame_len", "counts")


@pytest.fixture(scope="module")
def corpora():
    return jax_default_corpus(3), default_corpus(3)


def test_corpus_arena_is_bitwise_equal(corpora):
    j, t = corpora
    for name in ARENA:
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(j.codebook, t.codebook)


def test_port_offers_every_strategy():
    assert available_strategies() == jax_strategies()


@pytest.mark.parametrize("strategy", ["uniform", "weighted-by-examples", "stratified"])
@pytest.mark.parametrize("data_limit", [3, None])
def test_three_rounds_are_bitwise_equal(corpora, strategy, data_limit):
    j, t = corpora
    kw = dict(clients_per_round=5, local_batch_size=2, data_limit=data_limit, seed=11,
              strategy=strategy)
    js, ts = JaxSampler(j, **kw), FederatedSampler(t, **kw)
    assert js.steps == ts.steps
    for _ in range(3):
        jb, tb = js.next_round().engine_batch(), ts.next_round().engine_batch()
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k


def test_paper_width_corpus_shapes():
    c = paper_width_corpus(0)
    assert c.arena_features.shape[2:] == (128, 128)   # T = 32 labels x 4 frames, 128 bins
    assert c.arena_labels.shape[2] == 32
    assert c.arena_labels.max() < 4096
