"""The asr-encdec task of the port against the JAX package's: the task
registry and its refusal, the enc-dec loss and its gradients through the
task's batch adapter from the reference's parameters, two FedAvg rounds
with FVN on against the reference's jitted ``build_round_engine(plan,
get_task("asr-encdec"))``, the perplexity evaluation, and the per-client
panel. Every JAX draw runs with the non-partitionable threefry (the
pinned jax's default), set and restored around it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FederatedPlan as JaxPlan
from repro.core import FVNConfig as JaxFVN
from repro.core import build_round_engine as jax_engine
from repro.core.clienteval import ClientEvalPlane as JaxPanel
from repro.core.task import get_task as jax_get_task
from repro.core.task import task_for_config as jax_task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import encdec as jencdec
from repro_torch.configs import whisper_base
from repro_torch.convert import params_from_jax
from repro_torch.core import task as ttask
from repro_torch.core.clienteval import ClientEvalPlane
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import available_tasks, get_task
from repro_torch.data import make_speaker_corpus
from repro_torch.models import encdec

K, B, LIMIT = 3, 2, 4      # data limit 4 at b = 2: S = 2 local steps
LOSS_RTOL = 1e-5           # the loss: fp32 sums of one forward in two orders
GRAD_ATOL = 1e-5           # gradients, relative to each leaf's largest entry
ROUND_LOSS_RTOL = 1e-4     # a round's mean loss after local SGD steps
PARAM_ATOL = 1e-5          # the server parameters after the rounds
PPL_RTOL = 1e-5            # exp of a loss held to LOSS_RTOL (loss near 4)
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=0.05,
            server_optimizer="sgd", server_lr=1.0)


def _non_partitionable(fn):
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_threefry_partitionable", before)


@pytest.fixture(scope="module")
def reference():
    """The reference's asr-encdec task, its parameters, its corpus's first
    two round batches, and two rounds of its jitted engine with FVN on."""
    jtask = jax_get_task("asr-encdec")
    jparams = jax.tree.map(np.asarray, jtask.bundle.init(jax.random.PRNGKey(0)))
    corpus = jtask.make_corpus(0)
    sampler = JaxSampler(corpus, clients_per_round=K, local_batch_size=B, data_limit=LIMIT,
                         seed=0)
    batches = [sampler.next_round().engine_batch() for _ in range(2)]

    def run():
        plan = JaxPlan(**PLAN, fvn=JaxFVN(enabled=True, std=0.01))
        engine = jax_engine(plan, jtask, base_key=jax.random.PRNGKey(1))
        step = jax.jit(engine.step)
        state = engine.init_state(jparams)
        rounds = []
        for batch in batches:
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            rounds.append(({k: float(v) for k, v in metrics.items()},
                           params_from_jax(jax.tree.map(np.asarray, state.params))))
        return rounds

    return {"task": jtask, "params": jparams, "corpus": corpus, "batches": batches,
            "rounds": _non_partitionable(run)}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_registry_names_its_tasks_and_refuses_others_as_the_reference_does():
    assert available_tasks() == ["asr-encdec", "asr-rnnt", "deepseek-v2-lite-16b", "keyword",
                                 "lm-moe", "lm-rwkv", "lm-transformer", "qwen3-8b",
                                 "rnnt-librispeech", "rwkv6-1.6b", "whisper-base", "zamba2-7b"]
    for name in available_tasks():
        task = get_task(name, seed=3)
        assert task.name == name
        assert (task.kind, task.quality_metric) in {("rnnt", "wer"), ("audio", "ppl"),
                                                    ("dense", "ppl"), ("moe", "ppl"),
                                                    ("ssm", "ppl"), ("hybrid", "ppl"),
                                                    ("keyword", "err")}
    with pytest.raises(KeyError) as port_err:
        get_task("llava-next-mistral-7b")  # a reference config whose model (vlm) is unported
    with pytest.raises(KeyError) as ref_err:
        jax_get_task("no-such-task")
    assert str(port_err.value).startswith(
        "\"unknown task 'llava-next-mistral-7b'; available: ['asr-")
    assert str(ref_err.value).startswith("\"unknown task 'no-such-task'; available: ['asr-")
    jtask = jax_get_task("asr-encdec")
    task = get_task("asr-encdec")
    assert (task.kind, task.quality_metric) == (jtask.kind, jtask.quality_metric)
    assert task.config.__dict__ == jtask.bundle.config.__dict__
    assert ttask._PPL_CLIP == 20.0


def test_whisper_base_task_is_the_full_width_model():
    task = get_task("whisper-base")
    assert task.config == whisper_base.make_config() and task.config.param_dtype == "bfloat16"
    assert encdec.param_count(task.config) == 70_857_216
    assert task.make_corpus is ttask.whisper_width_corpus


def test_whisper_width_corpus_shapes_at_a_narrow_feature_width():
    """The corpus's parameters at feat_dim 8 (the full 512 builds on the
    card's host): T = 48 tokens x 8 frames = 384 frames, U = 48 over the
    whole vocabulary, 16 speakers of up to 31 examples (the speakers' bias
    draws are feat_dim wide, so the counts move with it: 23 at 512)."""
    kw = dict(ttask.WHISPER_CORPUS, feat_dim=8)
    c = make_speaker_corpus(**kw)
    assert c.arena_features.shape == (16, 31, 384, 8)
    assert c.arena_labels.shape == (16, 31, 48) and int(c.arena_labels.max()) < 51865
    assert int(c.arena_frame_len.max()) <= 384


def test_loss_and_gradients_match_jax(reference):
    """The task's loss (the adapter reads features as frames and labels as
    tokens, the weight masks padded examples) and every parameter's
    gradient against jax.value_and_grad of the reference task's loss."""
    jtask = reference["task"]
    batch = {k: v.reshape((-1,) + v.shape[3:]).copy()  # a copy: the rounds reuse the batch
             for k, v in reference["batches"][0].items()}
    batch["weight"][-1] = 0.0  # a padded example
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtask.loss_fn, has_aux=True))(
        reference["params"], jax.tree.map(jnp.asarray, batch))
    task = get_task("asr-encdec")
    params = {k: v.requires_grad_() for k, v in params_from_jax(reference["params"]).items()}
    loss, aux = task.loss_fn(params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert torch.equal(aux["lm_loss"], loss)
    grads = torch.autograd.grad(loss, list(params.values()))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(params) == set(want)
    for (name, _), g in zip(params.items(), grads):
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_ATOL * scale,
                                   rtol=0, err_msg=name)


def test_two_fedavg_rounds_with_fvn_match_the_reference_engine(reference):
    engine = build_round_engine(FederatedPlan(**PLAN, fvn=FVNConfig(enabled=True, std=0.01)),
                                get_task("asr-encdec"), seed=1)
    state = engine.init_state(params_from_jax(reference["params"]))
    for batch, (jm, jparams) in zip(reference["batches"], reference["rounds"]):
        state, metrics = engine.step(state, _torch_batch(batch))
        assert metrics.keys() == jm.keys()
        np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=ROUND_LOSS_RTOL)
        np.testing.assert_allclose(metrics["delta_norm"], jm["delta_norm"],
                                   rtol=ROUND_LOSS_RTOL)
        for k in ("examples", "participants", "uplink_bytes", "downlink_bytes",
                  "server_steps"):
            assert metrics[k] == jm[k], k
        for name, p in state.params.items():
            np.testing.assert_allclose(p.numpy(), jparams[name].numpy(), atol=PARAM_ATOL,
                                       rtol=0, err_msg=name)


def test_perplexity_evaluation_matches_jax(reference):
    task = get_task("asr-encdec")
    got = task.evaluate(params_from_jax(reference["params"]), task.make_corpus(0), 8)
    want = reference["task"].evaluate(reference["params"], reference["corpus"], 8)
    assert got.keys() == want.keys()
    for k in want:
        assert 1.0 < got[k] < np.exp(ttask._PPL_CLIP)
        np.testing.assert_allclose(got[k], want[k], rtol=PPL_RTOL)


def test_per_client_panel_matches_jax(reference):
    """Each tracked client's loss (its token-weighted loss over its own
    examples, the reference's vmap over clients) and perplexity."""
    task = get_task("asr-encdec")
    plane = ClientEvalPlane(task, task.make_corpus(0), clients=6, n=4)
    got = plane.measure(params_from_jax(reference["params"]))
    jplane = JaxPanel(reference["task"], reference["corpus"], clients=6, n=4)
    want = jplane.measure(reference["params"])
    assert plane.client_ids.tolist() == jplane.client_ids.tolist()
    np.testing.assert_allclose(got["client_loss"], want["client_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["client_quality"], want["client_quality"], rtol=PPL_RTOL)
    np.testing.assert_allclose(got["client_quality"],
                               np.exp(np.minimum(got["client_loss"], ttask._PPL_CLIP)))
    assert plane.curves()["quality_metric"] == "ppl"


BF16_PLAN = dict(clients_per_round=2, local_batch_size=2, data_limit=4, client_lr=0.05)


def test_bf16_leaves_round_matches_the_reference_within_a_bf16_ulp(reference):
    """bf16 parameters (fp32 compute, as whisper-base's leaves are bf16):
    FVN's (p.float() + sigma noise).to(bf16), the fp32 deltas, the local
    SGD and the server Adam on bf16 leaves, one round with FVN on against
    the reference's jitted engine. The loss within ROUND_LOSS_RTOL; each parameter
    within one bf16 ulp (a tie can round the other way)."""
    cfg = dataclasses.replace(get_task("asr-encdec").config, param_dtype="bfloat16")
    jtask = jax_task_for_config(jencdec.EncDecConfig(**dataclasses.asdict(cfg)),
                                name="asr-encdec")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), reference["params"])
    batch = {k: v[:2] for k, v in reference["batches"][0].items()}

    def run():
        plan = JaxPlan(**BF16_PLAN, fvn=JaxFVN(enabled=True, std=0.01))
        engine = jax_engine(plan, jtask, base_key=jax.random.PRNGKey(1))
        state, metrics = jax.jit(engine.step)(engine.init_state(params),
                                              jax.tree.map(jnp.asarray, batch))
        return float(metrics["loss"]), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                    state.params)

    jloss, jparams = _non_partitionable(run)
    engine = build_round_engine(FederatedPlan(**BF16_PLAN, fvn=FVNConfig(enabled=True, std=0.01)),
                                ttask.task_for_config(cfg, name="asr-encdec"), seed=1)
    start = {k: v.to(torch.bfloat16) for k, v in params_from_jax(reference["params"]).items()}
    state, metrics = engine.step(engine.init_state(start), _torch_batch(batch))
    np.testing.assert_allclose(metrics["loss"], jloss, rtol=ROUND_LOSS_RTOL)
    want = params_from_jax(jparams)
    for name, p in state.params.items():
        assert p.dtype == torch.bfloat16, name
        np.testing.assert_allclose(p.float().numpy(), want[name].numpy(), rtol=2.0 ** -7,
                                   atol=0, err_msg=name)
