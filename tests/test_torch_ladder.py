"""The paper's experiment ladder in the port against the JAX package:
``ladder()``'s eleven plans field by field, the IID baseline's data
(``iid_pool``, ``pack_round``) and the label-shuffled sampler bitwise,
and two tiny rounds of the training driver against the reference's
``run_federated(prefetch=False)`` under the IID baseline, E10's
SpecAugment scale and the label-shuffle adversary (the port started from
the reference's initial parameters; every JAX draw with the
non-partitionable threefry, set and restored in the test)."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core import CorruptionConfig as JaxCorruption
from repro.core import FederatedPlan as JaxPlan
from repro.core.experiments import ladder as jax_ladder
from repro.core.task import default_corpus as jax_default_corpus
from repro.core.task import get_task as jax_get_task
from repro.data import FederatedSampler as JaxSampler
from repro.data import pack_round as jax_pack_round
from repro.launch.train import run_federated as jax_run_federated
from repro_torch.convert import params_from_jax
from repro_torch.core.corruption import CorruptionConfig
from repro_torch.core.experiments import ladder
from repro_torch.core.plan import FederatedPlan
from repro_torch.core.task import FederatedTask, default_corpus, get_task, scaled_task
from repro_torch.data import FederatedSampler, pack_round
from repro_torch.launch import train

LOSS_RTOL = 1e-4  # a round's fp32 loss after local SGD steps, two packages
PARAM_ATOL = 1e-5  # the server parameters after the driver's rounds


def _as_dict(plan) -> dict:
    """A plan's fields with each nested config as a dict."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(plan) for v in (getattr(plan, f.name),)}


@pytest.mark.parametrize("kw", [{}, dict(clients_per_round=4, local_batch_size=4,
                                         data_limit=3, warmup_rounds=3, fvn_std=0.02,
                                         fvn_ramp_rounds=7)])
def test_ladder_plans_equal_the_reference_field_by_field(kw):
    got, want = ladder(**kw), jax_ladder(**kw)
    assert list(got) == list(want) == [f"E{i}" for i in range(11)]
    for name in want:
        g, w = _as_dict(got[name]), _as_dict(want[name])
        assert g.keys() == w.keys(), name
        for field in w:
            assert g[field] == w[field], (name, field)


@pytest.fixture(scope="module")
def corpora():
    return jax_default_corpus(0), default_corpus(0)


def _assert_batches_equal(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (what, k)
        assert got[k].flags.c_contiguous, (what, k)


def test_iid_pool_and_pack_round_are_bitwise(corpora):
    j, t = corpora
    jpool, tpool = j.iid_pool(), t.iid_pool()
    _assert_batches_equal(tpool, jpool, "iid_pool")
    assert tpool["labels"].shape[0] == int(t.counts.sum())
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    n = tpool["labels"].shape[0]
    # K·S·b below the pool, and past it (np.resize wraps the pool around)
    for K, S, b, take in ((3, 2, 2, n), (4, 3, 2, n), (5, 4, 3, 40)):
        idx_j, idx_t = rng_j.permutation(n)[:take], rng_t.permutation(n)[:take]
        rb_j = jax_pack_round({k: v[idx_j] for k, v in jpool.items()}, K, S, b)
        rb_t = pack_round({k: v[idx_t] for k, v in tpool.items()}, K, S, b)
        _assert_batches_equal(rb_t.engine_batch(), rb_j.engine_batch(), f"pack {K, S, b}")
        assert np.array_equal(rb_t.n_k, rb_j.n_k)
        assert rb_t.features.shape[:3] == (K, S, b)


@pytest.mark.parametrize("data_limit", [3, None])
def test_label_shuffled_sampler_is_bitwise_over_three_rounds(corpora, data_limit):
    j, t = corpora
    kw = dict(clients_per_round=5, local_batch_size=2, data_limit=data_limit, seed=4,
              label_shuffle_rate=0.5)
    js, ts = JaxSampler(j, **kw), FederatedSampler(t, **kw)
    plain = FederatedSampler(t, **dict(kw, label_shuffle_rate=0.0))
    shuffled = 0
    for r in range(3):
        jb, tb = js.next_round(), ts.next_round()
        _assert_batches_equal(tb.engine_batch(), jb.engine_batch(), f"round {r}")
        assert np.array_equal(tb.n_k, jb.n_k)
        pb = plain.next_round().engine_batch()
        # the shuffle moves only labels, and only among real examples
        for k in ("features", "frame_len", "weight"):
            assert np.array_equal(tb.engine_batch()[k], pb[k]), (r, k)
        shuffled += int((tb.labels != pb["labels"]).any(axis=-1).sum())
    assert ts.corrupted_counts == js.corrupted_counts
    assert sum(ts.corrupted_counts) > 0 and shuffled > 0


def test_rate_zero_is_the_plain_sampler_byte_for_byte(corpora):
    _, t = corpora
    kw = dict(clients_per_round=4, local_batch_size=2, data_limit=3, seed=9)
    a, b = FederatedSampler(t, **kw), FederatedSampler(t, **kw, label_shuffle_rate=0.0)
    for r in range(3):
        _assert_batches_equal(b.next_round().engine_batch(), a.next_round().engine_batch(),
                              f"round {r}")
    assert b.corrupted_counts == []


def test_scaled_task_scales_both_mask_counts():
    task = get_task("asr-rnnt")
    sa = task.config.specaug
    for scale, want in ((2.0, (2 * sa.freq_masks, 2 * sa.time_masks)), (0.1, (1, 1))):
        got = scaled_task(task, scale).config.specaug
        assert (got.freq_masks, got.time_masks) == want
        assert got.freq_mask_width == sa.freq_mask_width and got.enabled == sa.enabled
    with pytest.raises(ValueError, match="no specaug policy"):
        scaled_task(dataclasses.replace(task, config=object()), 2.0)


def test_iid_with_label_shuffle_is_refused():
    task = get_task("asr-rnnt")
    plan = FederatedPlan(corruption=CorruptionConfig(kind="label_shuffle", rate=0.5))
    with pytest.raises(ValueError, match="bypasses the sampler"):
        train.run_federated(task, task.make_corpus(0), plan, rounds=1, device="cpu", iid=True)


# two tiny rounds under each ladder setting: (name, plan fields, driver kwargs)
K, B, LIMIT = 3, 2, 4
RUNS = {
    # FVN's parity is tests/test_torch_fedavg.py's (its plain normal is slow
    # on the CPU); here the IID packing is what is held
    "iid": (dict(server_optimizer="sgd", server_lr=1.0), dict(iid=True)),
    "specaug_scale": (dict(server_optimizer="yogi", server_lr=0.01),
                      dict(specaug_scale=2.0)),
    "label_shuffle": (dict(corruption=dict(kind="label_shuffle", rate=0.5),
                           server_optimizer="momentum", server_lr=0.5), {}),
}


def _plan(lib_plan, lib_corruption, fields: dict):
    fields = dict(fields)
    if "corruption" in fields:
        fields["corruption"] = lib_corruption(**fields["corruption"])
    return lib_plan(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=0.05,
                    **fields)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_driver_rounds_match_the_reference(name):
    fields, run_kw = RUNS[name]
    jtask = jax_get_task("asr-rnnt")
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        params0 = params_from_jax(jax.tree.map(np.asarray, jtask.bundle.init(
            jax.random.PRNGKey(0))))
        jax_state, want = jax_run_federated(jtask, jax_default_corpus(0),
                                            _plan(JaxPlan, JaxCorruption, fields), rounds=2,
                                            prefetch=False, eval_examples=2,
                                            log=lambda *_: None, **run_kw)
    finally:
        jax.config.update("jax_threefry_partitionable", before)

    class FromReference(FederatedTask):
        def init_params(self, generator):
            return {k: v.clone() for k, v in params0.items()}

    tiny = get_task("asr-rnnt")
    task = FromReference(tiny.name, tiny.config, tiny.make_corpus)
    state, got = train.run_federated(task, default_corpus(0),
                                     _plan(FederatedPlan, CorruptionConfig, fields),
                                     rounds=2, device="cpu", eval_examples=0,
                                     log=lambda *_: None, **run_kw)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for k in ("participants_mean", "corrupted_total", "corrupted_mean", "uplink_bytes_client",
              "wire_bytes_total", "cfmq_bytes"):
        assert got[k] == want[k], k
    if name == "label_shuffle":
        assert got["corrupted_total"] > 0
    # both rounds' server steps (the second yogi or momentum step included)
    want_params = params_from_jax(jax.tree.map(np.asarray, jax_state.params))
    assert state.params.keys() == want_params.keys()
    for k, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), want_params[k].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
        assert not np.array_equal(p.numpy(), params0[k].numpy()), k
