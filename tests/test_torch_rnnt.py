"""The port's RNN-T against the JAX package's: the loss and every
parameter's gradient at the tiny asr-rnnt config (SpecAugment off, the
JAX weights carried across), on the chunked joint and on the fused joint
(``use_kernel=True``, the Pallas kernels in interpret mode), the
multi-chunk joint against the dense oracle, and the paper model's
parameter count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
from repro.configs import rnnt_librispeech as jax_librispeech
from repro.core.task import default_corpus as jax_default_corpus
from repro.kernels.ref import rnnt_joint_ref
from repro.models import rnnt as jrnnt
from repro.profile import tuner
from repro_torch.configs import rnnt_librispeech
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.task import get_task
from repro_torch.models import rnnt as trnnt

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5  # fp32 backprop through 24 LSTM steps, sums in another order


def _configs():
    """The tiny asr-rnnt config with SpecAugment off, in both packages."""
    tcfg = get_task("asr-rnnt").config
    tcfg = dataclasses.replace(tcfg, specaug=dataclasses.replace(tcfg.specaug, enabled=False))
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"}, specaug=JaxSpecAug(enabled=False))
    return tcfg, jcfg


def _batch():
    """Five corpus examples of different lengths, the last one a
    weight-0 padding slot (label_len 0, frame_len 0)."""
    corpus = jax_default_corpus(0)
    idx = (0, 1, 2, 3, 4)
    batch = {
        "features": corpus.arena_features[1, idx].copy(),
        "labels": corpus.arena_labels[1, idx].copy(),
        "frame_len": corpus.arena_frame_len[1, idx].copy(),
        "label_len": corpus.arena_label_len[1, idx].copy(),
        "weight": np.array([1, 1, 1, 1, 0], np.float32),
    }
    for k in ("features", "labels", "frame_len", "label_len"):
        batch[k][-1] = 0
    return batch


def _kernel_batch():
    """A batch whose lattice the Pallas joint takes (ROADMAP F4): T=16,
    U+1=8, V=64; the last slot is weight-0 padding."""
    r = np.random.default_rng(7)
    return {
        "features": r.standard_normal((4, 16, 16)).astype(np.float32),
        "labels": r.integers(1, 64, (4, 7)).astype(np.int32),
        "frame_len": np.array([16, 12, 9, 0], np.int32),
        "label_len": np.array([7, 5, 3, 0], np.int32),
        "weight": np.array([1, 1, 1, 0], np.float32),
    }


def _assert_loss_and_grads_match(tcfg, jcfg, batch):
    jparams = jax.tree.map(np.asarray, jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jrnnt.loss_fn(jcfg, p, jb), has_aux=True)(jparams)

    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    model = trnnt.RNNT(tcfg)
    loss_t, _ = trnnt.loss_fn(model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads_t = dict(zip(params, torch.autograd.grad(loss_t, list(params.values()))))

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=LOSS_RTOL)
    grads_t = params_to_jax(grads_t)
    flat_t = jax.tree_util.tree_leaves_with_path(grads_t)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(grads_j))
    assert len(flat_t) == len(flat_j) == len(params)
    for path, g in flat_t:
        np.testing.assert_allclose(g, np.asarray(flat_j[path]), atol=GRAD_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_loss_and_every_gradient_match_jax():
    _assert_loss_and_grads_match(*_configs(), _batch())


@pytest.mark.parametrize("joint_bwd", ["auto", "pallas"])
def test_kernel_joint_loss_and_every_gradient_match_jax(joint_bwd, tmp_path):
    """use_kernel=True in both packages: the JAX joint is the Pallas
    forward in interpret mode, its backward the chunked VJP ("auto" on
    the CPU) or the Pallas backward ("pallas"); the port's is K3/K4's
    plain version on the CPU."""
    tcfg, jcfg = (dataclasses.replace(c, use_kernel=True) for c in _configs())
    reg = tuner.TuningRegistry(path=str(tmp_path / "tuning.json"))
    tuner.set_registry(reg)
    try:
        reg.set_override("rnnt.joint_bwd_dispatch", joint_bwd)
        _assert_loss_and_grads_match(tcfg, jcfg, _kernel_batch())
    finally:
        tuner.set_registry(None)


@pytest.mark.parametrize("U1", [20, 25])
def test_multichunk_joint_matches_dense_oracle(U1):
    """U+1 = 20 (two chunks of 10) and 25 (three chunks of 9 with 2
    padded): the port keeps U in order (ROADMAP F1) and matches
    ``repro.kernels.ref.rnnt_joint_ref``."""
    tcfg, _ = _configs()
    r = np.random.default_rng(U1)
    B, T = 2, 5
    model = trnnt.RNNT(tcfg, device="cpu")
    params = trnnt.init_params(tcfg, torch.Generator().manual_seed(U1))
    params["joint_bias"] = torch.from_numpy(r.normal(size=tcfg.vocab).astype(np.float32))
    model.load_state_dict(params)
    enc = r.normal(size=(B, T, tcfg.enc_hidden)).astype(np.float32)
    pred = r.normal(size=(B, U1, tcfg.pred_hidden)).astype(np.float32)
    labels = r.integers(1, tcfg.vocab, size=(B, U1 - 1)).astype(np.int32)

    with torch.no_grad():
        blank_t, label_t = model.joint_logprobs(torch.from_numpy(enc), torch.from_numpy(pred),
                                                torch.from_numpy(labels))
    p = {k: v.numpy() for k, v in params.items()}
    lbl = np.concatenate([labels, np.zeros((B, 1), np.int32)], axis=1)
    blank_j, label_j = rnnt_joint_ref(enc @ p["joint_enc"], pred @ p["joint_pred"],
                                      p["joint_out"], p["joint_bias"], lbl)
    np.testing.assert_allclose(blank_t.numpy(), np.asarray(blank_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(label_t.numpy(), np.asarray(label_j), atol=1e-5, rtol=0)


def test_paper_model_parameter_count_matches_jax():
    jcfg = jax_librispeech.make_config()
    shapes = jax.eval_shape(lambda k: jrnnt.init_params(jcfg, k), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert trnnt.param_count(rnnt_librispeech.make_config()) == want == 105_333_760


def test_joint_kernel_configuration_is_refused():
    """The fused joint builds and runs on the CPU (plain version) and on
    CUDA (the kernels); it refuses tensors on any other device."""
    cfg = dataclasses.replace(get_task("asr-rnnt").config, use_kernel=True)
    model = trnnt.RNNT(cfg)
    enc = torch.zeros((2, 5, cfg.enc_hidden), device="meta")
    pred = torch.zeros((2, 4, cfg.pred_hidden), device="meta")
    with pytest.raises(ValueError, match="run on CUDA or the CPU, not meta"):
        model.joint_fused(enc, pred, torch.zeros((2, 3), dtype=torch.int32, device="meta"))
