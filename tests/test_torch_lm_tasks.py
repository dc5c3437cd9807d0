"""The port's language-model and keyword tasks against the JAX package's:
the synthetic LM client data bit for bit, the registry's names, kinds and
metrics, one FedAvg round (K = 2, one local step, FVN on) of
``lm-transformer``, ``lm-moe``, ``lm-rwkv`` and ``keyword`` against the
reference's jitted ``build_round_engine(plan, get_task(name))`` with its
quality evaluation after the round, the qwen3-8b task's config, and the
port's parameter count at qwen3-8b's full width on the meta device; the
full-size rwkv6-1.6b and zamba2-7b tasks' kinds and corpora. Every JAX
draw runs with the non-partitionable threefry (the pinned jax's default),
set and restored around it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_8b as jqwen
from repro.core import FederatedPlan as JaxPlan
from repro.core import FVNConfig as JaxFVN
from repro.core import build_round_engine as jax_engine
from repro.core.task import get_task as jax_get_task
from repro.data import FederatedSampler as JaxSampler
from repro.data import synthetic_lm_batch as jax_lm_batch
from repro.data import synthetic_lm_clients as jax_lm_clients
from repro.models import transformer as jtr
from repro_torch.configs import qwen3_8b as tqwen
from repro_torch.convert import params_from_jax
from repro_torch.core import task as ttask
from repro_torch.core.compression import jax_leaf_order
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import available_tasks, get_task
from repro_torch.data import synthetic_lm_batch, synthetic_lm_clients
from repro_torch.models import transformer as ttr

K, B, LIMIT = 2, 2, 2      # data limit 2 at b = 2: one local step
ROUND_LOSS_RTOL = 1e-5     # the round's loss: one forward on the perturbed parameters
PARAM_TOL = 1e-5           # the server parameters, relative to each leaf's largest entry
PPL_RTOL = 1e-5            # exp of a loss held to ROUND_LOSS_RTOL
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=0.05,
            server_optimizer="sgd", server_lr=1.0)
TASKS = ("keyword", "lm-moe", "lm-rwkv", "lm-transformer")
QWEN_PARAMS = 2_016_449_536


def _non_partitionable(fn):
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def test_synthetic_lm_data_is_the_references_bit_for_bit():
    for args in ((3, 50, 12, 4, 0.5, 0), (2, 7, 5, 3, 0.1, 9)):
        mine, want = synthetic_lm_clients(*args), jax_lm_clients(*args)
        assert mine.dtype == want.dtype == np.int32 and np.array_equal(mine, want)
    assert np.array_equal(synthetic_lm_batch(4, 16, 151936, seed=2),
                          jax_lm_batch(4, 16, 151936, seed=2))


def test_registry_names_kinds_and_metrics_are_the_references():
    assert set(TASKS) | {"qwen3-8b"} <= set(available_tasks())
    for name in TASKS:
        task, jtask = get_task(name, seed=3), jax_get_task(name, seed=3)
        assert (task.name, task.kind, task.quality_metric) == \
            (jtask.name, jtask.kind, jtask.quality_metric)
        assert dataclasses.asdict(task.config) == dataclasses.asdict(jtask.bundle.config)
        assert task.make_corpus is ttask.default_corpus
    qwen = get_task("qwen3-8b")
    assert (qwen.kind, qwen.quality_metric) == ("dense", "ppl")
    assert qwen.make_corpus is ttask.qwen_width_corpus
    rwkv, zamba = get_task("rwkv6-1.6b"), get_task("zamba2-7b")
    assert (rwkv.kind, rwkv.quality_metric, zamba.kind, zamba.quality_metric) == \
        ("ssm", "ppl", "hybrid", "ppl")
    assert (rwkv.make_corpus, zamba.make_corpus) == (ttask.rwkv_width_corpus,
                                                     ttask.zamba_width_corpus)


@pytest.mark.parametrize("spec,vocab", [("RWKV_CORPUS", 65536), ("ZAMBA_CORPUS", 32000)])
def test_full_size_corpora_are_qwens_shape_at_their_vocabularies(spec, vocab):
    assert getattr(ttask, spec) == {**ttask.QWEN_CORPUS, "vocab_size": vocab}
    assert ttask.QWEN_CORPUS["max_label_len"] == 128


def test_qwen3_configs_are_the_references_field_for_field():
    for mine, ref in ((tqwen.make_config(n_layers=4),
                       dataclasses.replace(jqwen.make_config(), n_layers=4)),
                      (tqwen.make_config(), jqwen.make_config()),
                      (tqwen.make_smoke_config(), jqwen.make_smoke_config()),
                      (tqwen.make_config(window=4096), jqwen.make_config(window=4096))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert get_task("qwen3-8b").config == tqwen.make_config(n_layers=4)


def test_qwen3_8b_parameters_on_the_meta_device_are_the_references():
    """2,016,449,536 bf16 parameters in 14 leaves, in JAX's leaf order, each
    of the reference's shape (``jax.eval_shape``: no memory on either side)."""
    cfg = get_task("qwen3-8b").config
    params = ttr.init_params(cfg, torch.Generator(), device="meta")
    assert sum(t.numel() for t in params.values()) == QWEN_PARAMS
    shapes = jax.eval_shape(lambda k: jtr.init_params(dataclasses.replace(
        jqwen.make_config(), n_layers=4), k), jax.random.PRNGKey(0))
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    jax_names = [".".join(str(p.key) for p in path) for path, _ in paths]
    assert len(params) == 14 and jax_leaf_order(params) == jax_names
    for (_, leaf), name in zip(paths, jax_names):
        assert tuple(params[name].shape) == leaf.shape, name
        assert params[name].dtype == torch.bfloat16 and leaf.dtype == jnp.bfloat16
    assert params["embed"].numel() == params["unembed"].numel() == 622_329_856


@pytest.fixture(scope="module", params=TASKS)
def round_case(request):
    """The reference's task, parameters, corpus, first round batch, and one
    round of its jitted engine with FVN on, then its quality evaluation."""
    jtask = jax_get_task(request.param)
    jparams = jax.tree.map(np.asarray, jtask.bundle.init(jax.random.PRNGKey(0)))
    corpus = jtask.make_corpus(0)
    sampler = JaxSampler(corpus, clients_per_round=K, local_batch_size=B, data_limit=LIMIT,
                         seed=0)
    batch = sampler.next_round().engine_batch()

    def run():
        plan = JaxPlan(**PLAN, fvn=JaxFVN(enabled=True, std=0.01))
        engine = jax_engine(plan, jtask, base_key=jax.random.PRNGKey(1))
        state, metrics = jax.jit(engine.step)(engine.init_state(jparams),
                                              jax.tree.map(jnp.asarray, batch))
        return {k: float(v) for k, v in metrics.items()}, \
            jax.tree.map(np.asarray, state.params)

    metrics, params = _non_partitionable(run)
    return {"name": request.param, "task": jtask, "params": jparams, "corpus": corpus,
            "batch": batch, "metrics": metrics, "after": params,
            "quality": jtask.evaluate(params, corpus, 16)}


def test_one_fedavg_round_with_fvn_matches_the_reference_engine(round_case):
    task = get_task(round_case["name"])
    engine = build_round_engine(FederatedPlan(**PLAN, fvn=FVNConfig(enabled=True, std=0.01)),
                                task, seed=1)
    state = engine.init_state(params_from_jax(round_case["params"]))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in round_case["batch"].items()}
    state, metrics = engine.step(state, batch)
    jm = round_case["metrics"]
    assert metrics.keys() == jm.keys()
    np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=ROUND_LOSS_RTOL)
    np.testing.assert_allclose(metrics["delta_norm"], jm["delta_norm"], rtol=ROUND_LOSS_RTOL)
    for k in ("examples", "participants", "uplink_bytes", "downlink_bytes", "server_steps"):
        assert metrics[k] == jm[k], k
    want = params_from_jax(round_case["after"])
    assert set(state.params) == set(want)
    for name, p in state.params.items():
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=PARAM_TOL * scale,
                                   rtol=0, err_msg=name)
    got = task.evaluate(state.params, task.make_corpus(0), 16)
    if task.quality_metric == "err":
        assert got == round_case["quality"]
    else:
        for k, v in round_case["quality"].items():
            np.testing.assert_allclose(got[k], v, rtol=PPL_RTOL)
