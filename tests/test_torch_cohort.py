"""The port's cohort plane (``repro_torch/core/cohort.py``) against the
JAX package's ``repro/core/cohort.py`` on the same keys and example
weights: the participation, rescue and straggler masks bit for bit, the
latency model's tiers and its times bit for bit against the jitted
reference (the spread folded into the normal's sqrt(2), and XLA's CPU
exp, ``ref.xla_exp_f32``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cohort as jcohort
from repro_torch.core import cohort as tcohort
from repro_torch.core import keys

LATENCY_RTOL = 0.0  # XLA's exp of spread * normal (both bitwise): bit for bit


@pytest.fixture
def non_partitionable():
    """jax.random with the non-partitionable threefry (the pinned jax's
    default), restored after the test."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _keys(seed: int, data: int):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), data),
            keys.fold_in(keys.PRNGKey(seed), data))


def _weight(K: int, S: int, b: int, seed: int, pad_steps: int = 0):
    """A (K, S, b) example mask with padded examples and, for the last
    ``pad_steps`` steps of every client, whole padded steps."""
    rng = np.random.default_rng(seed)
    w = (rng.random((K, S, b)) < 0.8).astype(np.float32)
    w[:, :, 0] = 1.0
    if pad_steps:
        w[:, S - pad_steps:, :] = 0.0
    w[0, 1:, :] = 0.0  # a client with one real step
    return w


def test_the_guard_the_flag_moves_the_cohort(non_partitionable):
    """The masks depend on the threefry flag, so a test that forgot to set
    it would see other masks."""
    jkey, tkey = _keys(11, 0x636F68)
    ours = tcohort.participation_mask(tkey, 64, 0.5)
    want = np.asarray(jcohort.participation_mask(jkey, 64, 0.5))
    np.testing.assert_array_equal(ours.numpy(), want)
    jax.config.update("jax_threefry_partitionable", True)
    assert not np.array_equal(ours.numpy(), np.asarray(jcohort.participation_mask(jkey, 64, 0.5)))


@pytest.mark.parametrize("K", [1, 3, 8, 64])
@pytest.mark.parametrize("p", [0.0, 0.3, 0.75, 1.0])
def test_participation_mask_is_jax_bitwise(non_partitionable, K, p):
    for data in range(4):
        jkey, tkey = _keys(K, data)
        got = tcohort.participation_mask(tkey, K, p)
        assert got.dtype == torch.float32 and float(got.sum()) >= 1.0
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jcohort.participation_mask(jkey, K, p)))


def test_rescue_keeps_exactly_one_client_on_ties():
    u = np.array([0.5, 0.25, 0.75, 0.25, 0.25], np.float32)
    got = tcohort.rescue_mask(torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcohort.rescue_mask(jnp.asarray(u))))
    assert got.tolist() == [False, True, False, False, False]


@pytest.mark.parametrize("frac,keep", [(0.0, 0.5), (0.5, 0.5), (1.0, 0.3), (0.7, 0.0),
                                       (1.0, 1.0)])
@pytest.mark.parametrize("pad_steps", [0, 2])
def test_straggler_step_mask_is_jax_bitwise(non_partitionable, frac, keep, pad_steps):
    """Padded steps never move the deadline: the mask counts real steps."""
    w = _weight(6, 5, 3, 7, pad_steps)
    for data in range(3):
        jkey, tkey = _keys(3, data)
        got = tcohort.straggler_step_mask(tkey, torch.from_numpy(w), frac, keep)
        want = np.asarray(jcohort.straggler_step_mask(jkey, jnp.asarray(w), frac, keep))
        np.testing.assert_array_equal(got.numpy(), want)


def test_padding_gives_the_unpadded_deadline(non_partitionable):
    w = _weight(6, 3, 3, 8)
    padded = np.concatenate([w, np.zeros((6, 2, 3), np.float32)], axis=1)
    _, tkey = _keys(4, 1)
    a = tcohort.straggler_step_mask(tkey, torch.from_numpy(w), 1.0, 0.5)
    b = tcohort.straggler_step_mask(tkey, torch.from_numpy(padded), 1.0, 0.5)
    assert torch.equal(b[:, :3], a)


@pytest.mark.parametrize("knobs", [(0.75, 0.0, 0.5), (1.0, 0.5, 0.5), (0.5, 0.5, 0.25),
                                   (0.0, 1.0, 0.5)])
def test_cohort_fn_is_jax_bitwise(non_partitionable, knobs):
    w = _weight(5, 4, 2, 9, pad_steps=1)
    jfn, tfn = jcohort.make_cohort_fn(*knobs), tcohort.make_cohort_fn(*knobs)
    for data in range(3):
        jkey, tkey = _keys(5, data)
        jw, jp = jfn(jkey, jnp.asarray(w))
        tw, tp = tfn(tkey, torch.from_numpy(w))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    tw, tp = tcohort.identity_cohort(tkey, torch.from_numpy(w))
    assert torch.equal(tw, torch.from_numpy(w)) and tp.tolist() == [1.0] * 5


@pytest.mark.parametrize("probs", [(0.5, 0.3, 0.2), (1.0,), (0.1, 0.2, 0.3, 0.4)])
def test_tier_assignments_are_jax_bitwise(non_partitionable, probs):
    jkey, tkey = _keys(6, 1)
    got = tcohort.tier_assignments(tkey, 257, probs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcohort.tier_assignments(jkey, 257, probs)))


@pytest.mark.parametrize("cfg", [dict(), dict(base_s=12.5, spread=0.0),
                                 dict(spread=0.8, tier_speeds=(1.0, 3.0),
                                      tier_probs=(0.7, 0.3))])
def test_latencies_match_jax(non_partitionable, cfg):
    jcfg, tcfg = jcohort.LatencyConfig(**cfg), tcohort.LatencyConfig(**cfg)
    for data in range(3):
        jkey, tkey = _keys(7, data)
        # the reference's program is jitted: XLA folds the spread into the
        # normal's sqrt(2), which moves some times by an ulp from eager's
        want = np.asarray(jax.jit(lambda key: jcohort.make_latency_fn(jcfg)(key, 33))(jkey))
        got = tcohort.make_latency_fn(tcfg)(tkey, 33)
        assert got.dtype == torch.float32 and got.shape == (33,)
        np.testing.assert_allclose(got.numpy(), want, rtol=LATENCY_RTOL, atol=0)
    if tcfg.spread == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)  # no normal draw enters


def test_latency_config_checks_its_tiers():
    with pytest.raises(ValueError, match="pair up"):
        tcohort.LatencyConfig(tier_speeds=(1.0, 2.0), tier_probs=(1.0,))
