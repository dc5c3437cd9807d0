"""The port's fedsgd engine against the JAX package's jitted one: two
rounds at the tiny asr-rnnt config (K=3, S=2, b=2, so one forward and
backward over 12 examples a round) with SpecAugment on (its masks drawn
from ``fold_in(fvn_key(base, r, 0, 0), 1)`` over the flattened batch in
both packages) under a server SGD at lr 1, so each round's update is
minus the aggregate: FVN off, and FVN on (noise drawn once a round at
``fvn_key(base, r, 0, 0)``) with an int4 packed stochastic uplink and
participation 0.75 (the aggregate compressed as one client's delta with
the round's compression key). Each port round starts from the JAX
round's starting parameters, in the model's own order. Every JAX draw
uses the non-partitionable threefry, set and restored in the fixture.
Then the three refusals, with the reference's messages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
from repro.core import FederatedPlan as JaxPlan
from repro.core import FVNConfig as JaxFVN
from repro.core import build_round_engine as jax_engine
from repro.core import fedavg as jfedavg
from repro.core.compression import CompressionConfig as JaxCompression
from repro.core.plan import CohortConfig as JaxCohort
from repro.core.task import default_corpus as jax_default_corpus
from repro.core.task import task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import rnnt as jrnnt
from repro_torch.convert import params_from_jax
from repro_torch.core import fedavg
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.corruption import CorruptionConfig
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import AggregatorConfig, CohortConfig, FederatedPlan, FVNConfig
from repro_torch.core.task import FederatedTask, default_corpus, get_task

K, B, LIMIT, CLIENT_LR = 3, 2, 4, 0.05   # data limit 4 at b = 2: S = 2 local steps
LOSS_RTOL = 1e-4   # the fp32 loss over the flattened round batch
PARAM_ATOL = 1e-5  # server params after one step of lr 1 on client_lr * grad
# int4 stochastic rounding: a code can flip where a uniform lies within an
# ulp of the fraction it is compared with (the two packages' gradients
# differ by float rounding), so an element may differ by one code step plus
# PARAM_ATOL, and at most FLIP_SHARE of them by more than PARAM_ATOL
FLIP_SHARE = 1e-3
INT4_LEVELS = 7
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=CLIENT_LR,
            server_optimizer="sgd", server_lr=1.0, engine="fedsgd")
PLANES = {  # (fvn, compression, cohort)
    "fvn_off": ({}, {}, {}),
    "fvn_int4_packed_p75": (dict(enabled=True, std=0.01), dict(kind="int4", packed=True),
                            dict(participation=0.75)),
}


def _tiny_configs():
    tcfg = get_task("asr-rnnt").config
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"},
                            specaug=JaxSpecAug(**dataclasses.asdict(tcfg.specaug)))
    assert tcfg.specaug.enabled
    return tcfg, jcfg


@pytest.fixture(scope="module", params=list(PLANES))
def reference(request):
    """Two jitted JAX fedsgd rounds of one plane: each round's batch,
    starting parameters, metrics and result."""
    fvn, comp, coh = PLANES[request.param]
    tcfg, jcfg = _tiny_configs()
    plan = JaxPlan(**PLAN, fvn=JaxFVN(**fvn), compression=JaxCompression(**comp),
                   cohort=JaxCohort(**coh))
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        engine = jax_engine(plan, task_for_config(jcfg, name="asr-rnnt"),
                            base_key=jax.random.PRNGKey(1))
        step = jax.jit(engine.step)
        params0 = jax.tree.map(np.asarray, jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))
        sampler = JaxSampler(jax_default_corpus(0), clients_per_round=K, local_batch_size=B,
                             data_limit=LIMIT, seed=0)
        state = engine.init_state(params0)
        rounds = []
        for _ in range(2):
            batch = sampler.next_round().engine_batch()
            start = state
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            rounds.append({
                "batch": batch,
                "params": params_from_jax(jax.tree.map(np.asarray, start.params)),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "after": params_from_jax(jax.tree.map(np.asarray, state.params)),
            })
    finally:
        jax.config.update("jax_threefry_partitionable", before)
    if coh:  # the drawn cohort drops a client in one of the rounds
        assert min(r["metrics"]["participants"] for r in rounds) < K
    return {"plane": PLANES[request.param], "task": FederatedTask("asr-rnnt", tcfg,
                                                                  default_corpus),
            "rounds": rounds}


def test_fedsgd_rounds_match_jax(reference):
    fvn, comp, coh = reference["plane"]
    task = reference["task"]
    plan = FederatedPlan(**PLAN, fvn=FVNConfig(**fvn), compression=CompressionConfig(**comp),
                         cohort=CohortConfig(**coh))
    engine = build_round_engine(plan, task, seed=1)
    for r, want in enumerate(reference["rounds"]):
        params = {n: want["params"][n] for n, _ in task.model.named_parameters()}
        state = engine.init_state(params)._replace(round_idx=r)
        batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
        state, metrics = engine.step(state, batch)
        jm = want["metrics"]
        assert metrics.keys() == jm.keys()
        np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=LOSS_RTOL)
        for k in ("examples", "participants", "uplink_bytes", "downlink_bytes", "corrupted",
                  "sim_time_s", "server_steps", "staleness_mean"):
            assert metrics[k] == jm[k], (r, k)
        flips = total = 0
        for name, p in state.params.items():
            w = want["after"][name]
            if not comp:
                np.testing.assert_allclose(p.numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0,
                                           err_msg=f"round {r} {name}")
                continue
            # one code step of the leaf: its largest dequantized value / 7
            wbar = want["params"][name] - w
            code_step = float(wbar.abs().max()) / INT4_LEVELS
            err = (p - w).abs()
            assert float(err.max()) <= code_step + PARAM_ATOL, (r, name, float(err.max()))
            flips += int((err > PARAM_ATOL).sum())
            total += p.numel()
        assert flips <= FLIP_SHARE * total, (r, flips, total)
        if not comp:
            np.testing.assert_allclose(metrics["delta_norm"], jm["delta_norm"], rtol=LOSS_RTOL)


def _message(check, arg) -> str:
    with pytest.raises(ValueError) as exc:
        check(arg)
    return str(exc.value)


@pytest.mark.parametrize("setting,check,arg", [
    (dict(aggregation=AggregatorConfig(name="trimmed_mean")),
     jfedavg._check_fedsgd_aggregator, "trimmed_mean"),
    (dict(compression=CompressionConfig(kind="int4", error_feedback=True)),
     jfedavg._check_fedsgd_compression, JaxCompression(kind="int4", error_feedback=True)),
    (dict(corruption=CorruptionConfig(kind="sign_flip", rate=0.5)),
     jfedavg._check_fedsgd_corruption, "sign_flip"),
], ids=["aggregator", "error_feedback", "delta_corruption"])
def test_fedsgd_refusals_raise_the_reference_messages(setting, check, arg):
    """Each refusal is made when the engine is built, with the
    reference's ValueError text; the data-plane label_shuffle builds."""
    plan = FederatedPlan(engine="fedsgd", **setting)
    task = get_task("asr-rnnt")
    with pytest.raises(ValueError) as exc:
        build_round_engine(plan, task, seed=1)
    assert str(exc.value) == _message(check, arg)
    with pytest.raises(ValueError):
        fedavg.make_round_step(task.loss_fn, plan, 1)
    ok = FederatedPlan(engine="fedsgd", corruption=CorruptionConfig(kind="label_shuffle",
                                                                    rate=0.5))
    assert build_round_engine(ok, task, seed=1).plan.engine == "fedsgd"
