"""Evaluation in the port against the JAX package: the eval splits
(bitwise), the WER metric, greedy decoding (token ids, with the JAX
weights carried across) and the task's evaluate.

At ``time_stride=2`` the reference masks frames with the raw
``frame_len`` (ROADMAP F3) while the port masks with
``frame_len // time_stride``; the port is held to the reference called
with ``frame_len // 2``, which is the corrected result."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.asr.wer import levenshtein as jax_levenshtein
from repro.asr.wer import wer as jax_wer
from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
from repro.core import task as jtask
from repro.models import rnnt as jrnnt
from repro_torch.asr import wer as twer
from repro_torch.convert import params_from_jax
from repro_torch.core.task import default_corpus, get_task
from repro_torch.models import rnnt as trnnt

N_EVAL = 4  # eval examples per split: one short JAX compile, shared by the tests below


def _jax_config(tcfg):
    """The JAX twin of a port RNNTConfig (equal to the JAX task's own
    config for asr-rnnt, so the tests share its jitted decoder)."""
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
              if f.name != "specaug"}
    return jrnnt.RNNTConfig(**fields, specaug=JaxSpecAug(**dataclasses.asdict(tcfg.specaug)))


def _params(jcfg, seed=0):
    jparams = jax.tree.map(np.asarray, jrnnt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jparams, params_from_jax(jparams)


@pytest.fixture(scope="module")
def corpora():
    return default_corpus(0), jtask.default_corpus(0)


@pytest.mark.parametrize("hard", [False, True])
def test_eval_split_is_bitwise_equal(corpora, hard):
    tc, jc = corpora
    got, want = tc.eval_split(8, hard=hard), jc.eval_split(8, hard=hard)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_wer_and_levenshtein_equal_jax(seed):
    r = np.random.default_rng(seed)
    refs = [r.integers(0, 6, r.integers(0, 9)).tolist() for _ in range(12)]
    hyps = [r.integers(0, 6, r.integers(0, 9)).tolist() for _ in range(12)]
    for a, b in zip(refs, hyps):
        assert twer.levenshtein(a, b) == jax_levenshtein(a, b)
    assert twer.wer(refs, hyps) == jax_wer(refs, hyps)


def test_greedy_decode_matches_jax_at_the_tiny_config(corpora):
    tcfg = get_task("asr-rnnt").config
    jcfg = _jax_config(tcfg)
    jparams, tparams = _params(jcfg)
    ev = corpora[1].eval_split(N_EVAL)
    want = np.asarray(jtask._jitted_rnnt_decode(jcfg)(jparams, ev["features"], ev["frame_len"]))
    got = trnnt.greedy_decode(tcfg, tparams, torch.from_numpy(ev["features"]),
                              torch.from_numpy(ev["frame_len"]))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (N_EVAL, 24 * 4)
    assert (want != 0).any()  # random weights still emit tokens: the ids are compared
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_decode_masks_subsampled_frames_at_time_stride_2(corpora):
    """F3: the port's mask is frame_len // time_stride. The reference
    called with frame_len // 2 gives the same ids; with the raw frame_len
    it decodes frames of padding and gives others."""
    tcfg = dataclasses.replace(get_task("asr-rnnt").config, time_stride=2)
    jcfg = _jax_config(tcfg)
    jparams, tparams = _params(jcfg, seed=1)
    ev = corpora[1].eval_split(N_EVAL)
    decode = jax.jit(lambda p, f, n: jrnnt.greedy_decode(jcfg, p, f, n))
    want = np.asarray(decode(jparams, ev["features"], ev["frame_len"] // 2))
    raw = np.asarray(decode(jparams, ev["features"], ev["frame_len"]))
    got = trnnt.greedy_decode(tcfg, tparams, torch.from_numpy(ev["features"]),
                              torch.from_numpy(ev["frame_len"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(raw, want)


def test_task_evaluate_equals_jax_wer(corpora):
    task = get_task("asr-rnnt")
    jparams, tparams = _params(_jax_config(task.config))
    got = task.evaluate(tparams, corpora[0], N_EVAL)
    want = jtask.get_task("asr-rnnt").evaluate(jparams, corpora[1], N_EVAL)
    assert task.quality_metric == jtask.get_task("asr-rnnt").quality_metric == "wer"
    assert got == want
