"""The port's per-client evaluation plane against ``repro.core.clienteval``:
``per_client_eval_batch`` bitwise (short clients padded with weight-0
slots), ``default_panel``, ``fairness_spread`` and ``empty_spread``
equal, and ``ClientEvalPlane.measure`` at the tiny asr-rnnt config from
JAX's parameters: each client's WER equal (one greedy decode over the
panel; at time_stride 1 the two decoders mask the same frames, F3), each
client's loss within LOSS_RTOL (the port's one forward over the
flattened panel against JAX's vmap over the clients). Then the driver's
``client_eval``: the row's spread and its curves."""

import math

import jax
import numpy as np
import pytest

from repro.core import get_task as jax_get_task
from repro.core.clienteval import SPREAD_KEYS as JAX_SPREAD_KEYS
from repro.core.clienteval import ClientEvalPlane as JaxPlane
from repro.core.clienteval import default_panel as jax_default_panel
from repro.core.clienteval import empty_spread as jax_empty_spread
from repro.core.clienteval import fairness_spread as jax_fairness_spread
from repro.data import make_speaker_corpus as jax_make_corpus
from repro.data import per_client_eval_batch as jax_eval_batch
from repro.models import rnnt as jrnnt
from repro_torch.convert import params_from_jax
from repro_torch.core import metrics
from repro_torch.core.clienteval import ClientEvalPlane, default_panel, fairness_spread
from repro_torch.core.metrics import SPREAD_KEYS, empty_spread
from repro_torch.core.plan import FederatedPlan
from repro_torch.core.task import get_task
from repro_torch.data import make_speaker_corpus, per_client_eval_batch
from repro_torch.launch import train

LOSS_RTOL = 1e-5  # a client's mean fp32 RNN-T loss, one forward against a vmap
CORPUS = dict(num_speakers=8, vocab_size=64, feat_dim=16, mean_utterances=6.0, seed=0)


@pytest.fixture(scope="module")
def corpora():
    return jax_make_corpus(**CORPUS), make_speaker_corpus(**CORPUS)


@pytest.mark.parametrize("ids,n", [([0, 3, 7], 2), (list(range(8)), None), ([5, 5, 1], 1)])
def test_eval_batch_is_bitwise_the_reference(corpora, ids, n):
    jc, tc = corpora
    n = n or int(tc.counts.max()) + 3   # every client short: weight-0 padding
    want, got = jax_eval_batch(jc, np.asarray(ids), n=n), per_client_eval_batch(tc, ids, n=n)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if n > tc.counts.min():
        assert (got["weight"] == 0).any() and (got["frame_len"][got["weight"] == 0] == 0).all()


@pytest.mark.parametrize("clients", [1, 3, 6, 8, 20])
def test_default_panel_equals_the_reference(corpora, clients):
    jc, tc = corpora
    np.testing.assert_array_equal(default_panel(tc, clients), jax_default_panel(jc, clients))


@pytest.mark.parametrize("seed", range(3))
def test_fairness_spread_and_empty_spread_equal_the_reference(seed):
    r = np.random.default_rng(seed)
    loss, qual = r.random(7) * 10, r.random(7)
    assert fairness_spread(loss, qual) == jax_fairness_spread(loss, qual)
    assert SPREAD_KEYS == JAX_SPREAD_KEYS and empty_spread() == jax_empty_spread()
    assert metrics.empty_spread is empty_spread  # one home


@pytest.fixture(scope="module")
def measured(corpora):
    """One measure of a 4-client panel, 3 examples each, in both packages
    from JAX's tiny parameters."""
    jc, tc = corpora
    jtask = jax_get_task("asr-rnnt")
    jparams = jrnnt.init_params(jtask.bundle.config, jax.random.PRNGKey(0))
    task = get_task("asr-rnnt")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    jplane, plane = JaxPlane(jtask, jc, clients=4, n=3), ClientEvalPlane(task, tc, clients=4,
                                                                          n=3)
    return jplane, jplane.measure(jparams), plane, plane.measure(params)


def test_plane_per_client_wer_equals_the_reference(measured):
    jplane, want, plane, got = measured
    np.testing.assert_array_equal(plane.client_ids, jplane.client_ids)
    assert got["client_quality"].shape == (4,)
    np.testing.assert_array_equal(got["client_quality"], want["client_quality"])


def test_plane_per_client_loss_matches_the_reference(measured):
    _, want, _, got = measured
    assert got["client_loss"].dtype == np.float64 and np.isfinite(got["client_loss"]).all()
    np.testing.assert_allclose(got["client_loss"], want["client_loss"], rtol=LOSS_RTOL)


def test_plane_spread_and_curves_equal_the_reference(measured):
    jplane, _, plane, _ = measured
    got, want = plane.curves(), jplane.curves()
    assert got.keys() == want.keys()
    assert got["client_ids"] == want["client_ids"]
    assert got["quality_metric"] == want["quality_metric"] == "wer"
    np.testing.assert_array_equal(got["client_quality"], want["client_quality"])
    np.testing.assert_allclose(got["client_loss"], want["client_loss"], rtol=LOSS_RTOL)
    s, w = plane.spread(), jplane.spread()
    assert s["clients_tracked"] == w["clients_tracked"] == 4
    for k in SPREAD_KEYS:
        np.testing.assert_allclose(s[k], w[k], rtol=LOSS_RTOL, atol=1e-9, err_msg=k)


def test_the_driver_reports_the_panel():
    """``run_federated(client_eval=3)``: the row's spread from the last
    round's panel, one curve point a round in ``extras["client_eval"]``."""
    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=2)
    _, hist = train.run_federated(task, task.make_corpus(0), plan, rounds=2, device="cpu",
                                  eval_examples=0, client_eval=3, client_eval_examples=2,
                                  log=lambda *_: None)
    curves = hist["client_eval"]
    assert hist["clients_tracked"] == 3 and len(curves["client_ids"]) == 3
    assert np.asarray(curves["client_loss"]).shape == (2, 3)
    assert np.asarray(curves["client_quality"]).shape == (2, 3)
    assert hist["client_loss_p10"] <= hist["client_loss_p90"]
    assert hist["client_quality_p10"] <= hist["client_quality_p90"]
    assert all(math.isfinite(hist[k]) for k in SPREAD_KEYS)
    assert {k: hist[k] for k in SPREAD_KEYS} == fairness_spread(curves["client_loss"][-1],
                                                                curves["client_quality"][-1])
