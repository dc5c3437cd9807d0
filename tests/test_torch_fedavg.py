"""The port's FedAvg round on the parity plane against the JAX engine:
two rounds at the tiny asr-rnnt config (K=3, S=2, b=2) from carried
parameters, with SpecAugment on (its masks drawn from the reference's
key in both packages, with the non-partitionable threefry), FVN off and
FVN on (a fixed std and a ramp: its noise drawn from the same keys); the
server optimizers, FVN and CFMQ on their own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
from repro.core import FederatedPlan as JaxPlan
from repro.core import FVNConfig as JaxFVN
from repro.core import build_round_engine as jax_engine
from repro.core.cfmq import cfmq as jax_cfmq
from repro.core.cfmq import plan_wire_accounting as jax_wire_accounting
from repro.core.fvn import fvn_key as jax_fvn_key
from repro.core.fvn import fvn_sigma as jax_fvn_sigma
from repro.core.task import default_corpus as jax_default_corpus
from repro.core.task import task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import rnnt as jrnnt
from repro_torch import optim as toptim
from repro_torch.convert import params_from_jax
from repro_torch.core import cfmq as tcfmq
from repro_torch.core import fedavg, fvn, keys
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import FederatedTask, default_corpus, get_task

K, B, LIMIT, CLIENT_LR = 3, 2, 4, 0.05   # data limit 4 at b = 2: S = 2 local steps
LOSS_RTOL = 1e-4   # a mean of per-client losses after local SGD steps, fp32
PARAM_ATOL = 1e-5  # server params / aggregated deltas after two local steps
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=CLIENT_LR,
            server_optimizer="sgd", server_lr=1.0)


def _tiny_configs(specaug: bool = False):
    """The tiny asr-rnnt config in both packages, SpecAugment on or off
    (the port draws the reference's masks from the same key)."""
    tcfg = get_task("asr-rnnt").config
    tcfg = dataclasses.replace(tcfg, specaug=dataclasses.replace(tcfg.specaug, enabled=specaug))
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"},
                            specaug=JaxSpecAug(**dataclasses.asdict(tcfg.specaug)))
    return tcfg, jcfg


@pytest.fixture(scope="module")
def reference():
    """Two JAX rounds under a server SGD with lr 1, so each round's
    aggregated delta is params_before - params_after. One compiled
    engine for the module, run with the non-partitionable threefry (the
    pinned jax's default; F2a), restored after."""
    return _jax_rounds(JaxPlan(**PLAN))


def _jax_rounds(plan):
    """Two rounds of the JAX engine under ``plan`` from the tiny config's
    parameters and the sampler's first two round batches."""
    tcfg, jcfg = _tiny_configs(specaug=True)
    before_flag = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        engine = jax_engine(plan, task_for_config(jcfg, name="asr-rnnt"),
                            base_key=jax.random.PRNGKey(1))
        step = jax.jit(engine.step)
        params0 = jax.tree.map(np.asarray, jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))
        sampler = JaxSampler(jax_default_corpus(0), clients_per_round=K, local_batch_size=B,
                             data_limit=LIMIT, seed=0)
        batches = [sampler.next_round().engine_batch() for _ in range(2)]
        state = engine.init_state(params0)
        rounds = []
        for batch in batches:
            before = state.params
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            after = jax.tree.map(np.asarray, state.params)
            rounds.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": params_from_jax(after),
                "wbar": params_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - b, before,
                                                     after)),
            })
    finally:
        jax.config.update("jax_threefry_partitionable", before_flag)
    task = FederatedTask("asr-rnnt", tcfg, default_corpus)
    return {"task": task, "params0": params_from_jax(params0), "batches": batches,
            "rounds": rounds, "jax_params0": params0}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_two_sgd_server_rounds_match_jax(reference):
    task, rounds = reference["task"], reference["rounds"]
    engine = build_round_engine(FederatedPlan(**PLAN), task, seed=1)
    state = engine.init_state(reference["params0"])
    for batch, want in zip(reference["batches"], rounds):
        state, metrics = engine.step(state, _torch_batch(batch))
        jm = want["metrics"]
        assert metrics.keys() == jm.keys()
        np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(metrics["delta_norm"], jm["delta_norm"], rtol=LOSS_RTOL)
        for k in ("examples", "participants", "uplink_bytes", "downlink_bytes", "corrupted",
                  "sim_time_s", "server_steps", "staleness_mean"):
            assert metrics[k] == jm[k], k
        for name, p in state.params.items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_adam_round_aggregated_delta_and_server_step_match_jax(reference):
    """Under Adam the server params are not compared: Adam's first step
    divides g by |g| + eps, so a sum-order difference of 1e-9 in a
    near-zero coordinate of the aggregated delta moves that coordinate
    by about the learning rate. The aggregated delta is held instead,
    and the port's Adam step is held to JAX's on the same delta."""
    task = reference["task"]
    plan = FederatedPlan(**dict(PLAN, server_optimizer="adam", server_lr=1e-3))
    wbar, losses, n_k = fedavg._aggregate_client_updates(
        task.loss_fn, toptim.sgd(CLIENT_LR), None, 1, reference["params0"],
        _torch_batch(reference["batches"][0]), 0)
    want = reference["rounds"][0]["wbar"]
    for name, d in wbar.items():
        np.testing.assert_allclose(d.numpy(), want[name].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    assert n_k.tolist() == [LIMIT] * K

    jwbar = {k: v.numpy() for k, v in want.items()}
    jopt = joptim.adam(1e-3)
    jupd, jstate = jopt.update(jwbar, jopt.init(jwbar))
    jupd, _ = jopt.update(jwbar, jstate)  # the second step, with moments
    topt = fedavg.make_server_optimizer(plan)
    tupd, tstate = topt.update(want, topt.init(want))
    tupd, _ = topt.update(want, tstate)
    for name in want:
        np.testing.assert_allclose(tupd[name].numpy(), np.asarray(jupd[name]), atol=1e-9,
                                   rtol=1e-6, err_msg=name)


def test_fvn_sigma_matches_jax_exactly():
    for std, ramp in ((0.03, 5), (0.01, 0), (0.02, 3)):
        for r in range(12):
            want = float(jax_fvn_sigma(JaxFVN(enabled=True, std=std, ramp_rounds=ramp), r))
            assert fvn.fvn_sigma(FVNConfig(enabled=True, std=std, ramp_rounds=ramp), r) == want
    assert fvn.fvn_sigma(FVNConfig(enabled=False, std=0.5), 3) == 0.0


def test_fvn_with_zero_sigma_is_exactly_the_fvn_off_round(reference):
    task, batch = reference["task"], _torch_batch(reference["batches"][0])
    outs = []
    for f in (FVNConfig(enabled=False), FVNConfig(enabled=True, std=0.0)):
        engine = build_round_engine(FederatedPlan(**PLAN, fvn=f), task, seed=1)
        outs.append(engine.step(engine.init_state(reference["params0"]), batch))
    (s_off, m_off), (s_zero, m_zero) = outs
    assert m_off == m_zero
    for name in s_off.params:
        assert torch.equal(s_off.params[name], s_zero.params[name]), name


def test_fvn_noise_is_deterministic_distinct_and_scaled():
    sigma = 0.02
    params = {"a": torch.zeros(300, 200), "b": torch.zeros(5000)}
    base = keys.PRNGKey(7)

    def noise(round_idx, client, step):
        key = fvn.fvn_key(base, round_idx, client, step)
        return torch.cat([v.flatten() for v in fvn.perturb(params, key, sigma).values()])

    n = noise(2, 1, 0)
    assert torch.equal(n, noise(2, 1, 0))
    for other in (noise(2, 2, 0), noise(3, 1, 0), noise(2, 1, 1)):
        assert not torch.equal(n, other)
    assert abs(float(n.std()) / sigma - 1.0) < 0.05
    assert abs(float(n.mean())) < 0.05 * sigma


# FVN on: a fixed std, and a ramp (round 0 at sigma 0, round 1 at 0.01)
FVN_PLANES = {"fixed 0.01": dict(enabled=True, std=0.01),
              "ramp to 0.03 over 3 rounds": dict(enabled=True, std=0.03, ramp_rounds=3)}


@pytest.fixture(scope="module", params=sorted(FVN_PLANES))
def fvn_reference(request):
    """The reference's two rounds with FVN on (one compiled engine per
    plane)."""
    cfg = FVN_PLANES[request.param]
    return dict(_jax_rounds(JaxPlan(**PLAN, fvn=JaxFVN(**cfg))), fvn=cfg)


def test_fvn_rounds_match_jax(fvn_reference, reference):
    """Two rounds with FVN on against the JAX engine: each client step's
    key (FVN's noise key and, folded with 1, SpecAugment's data key) is
    the reference's bit for bit, and the loss and every parameter agree
    at the FVN-off round's tolerances. XLA contracts ``p + sigma * noise``
    into one fused multiply-add under jit, which the port takes as two
    IEEE operations (JAX's eager call gives the port's bits,
    tests/test_torch_threefry_normal.py): the noisy parameters may differ
    by an ulp. The noise moves the result by far more than that: the
    params leave the FVN-off round's by more than 100 x PARAM_ATOL."""
    task, rounds = fvn_reference["task"], fvn_reference["rounds"]
    base, jbase = keys.PRNGKey(1), jax.random.PRNGKey(1)
    for r, k, st in ((0, 0, 0), (1, 2, 1), (1, 1, 0)):
        jkey = jax_fvn_key(jbase, r, k, st)
        tkey = fvn.fvn_key(base, r, k, st)
        assert tkey.tolist() == np.asarray(jkey).tolist()
        assert keys.fold_in(tkey, 1).tolist() == np.asarray(jax.random.fold_in(jkey, 1)).tolist()
    engine = build_round_engine(FederatedPlan(**PLAN, fvn=FVNConfig(**fvn_reference["fvn"])),
                                task, seed=1)
    state = engine.init_state(fvn_reference["params0"])
    for r, (batch, want) in enumerate(zip(fvn_reference["batches"], rounds)):
        state, metrics = engine.step(state, _torch_batch(batch))
        np.testing.assert_allclose(metrics["loss"], want["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(metrics["delta_norm"], want["metrics"]["delta_norm"],
                                   rtol=LOSS_RTOL)
        moved = 0.0
        for name, p in state.params.items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=f"round {r} {name}")
            off = reference["rounds"][r]["params"][name].numpy()
            moved = max(moved, float(np.abs(want["params"][name].numpy() - off).max()))
        if fvn.fvn_sigma(FVNConfig(**fvn_reference["fvn"]), r) > 0:
            assert moved > 100 * PARAM_ATOL, (r, moved)


def test_cfmq_and_wire_accounting_match_jax_exactly(reference):
    for kw in (dict(rounds=10, clients_per_round=4, model_bytes=4.2e8, local_steps=2.0),
               dict(rounds=3, clients_per_round=8, model_bytes=742144, local_epochs=2,
                    examples_per_round=64, batch_size=4, alpha=0.5)):
        t, j = tcfmq.cfmq(**kw), jax_cfmq(**kw)
        assert t.total_bytes == j.total_bytes and t.total_terabytes == j.total_terabytes
    plan_j, plan_t = JaxPlan(**PLAN), FederatedPlan(**PLAN)
    up_j, down_j = jax_wire_accounting(plan_j, reference["jax_params0"])
    up_t, down_t = tcfmq.plan_wire_accounting(plan_t, reference["params0"])
    assert (up_t, down_t) == (up_j, down_j)
    assert isinstance(up_t, int) and isinstance(down_t, int)


@pytest.mark.parametrize("participation", [1.0, 0.75])
@pytest.mark.parametrize("kind", ["none", "int4"])
def test_measured_payload_prices_a_partial_fp32_cohort(reference, participation, kind):
    """The paper's payload formula holds only for an fp32 uplink under full
    participation; an fp32 plan that drops clients is priced by its
    measured bytes, as ``repro/core/cfmq.py:121`` does."""
    from repro.core.cfmq import measured_payload as jax_measured_payload
    from repro.core.compression import CompressionConfig as JaxCompression
    from repro.core.plan import CohortConfig as JaxCohort
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.plan import CohortConfig

    plan_j = JaxPlan(**PLAN, compression=JaxCompression(kind=kind),
                     cohort=JaxCohort(participation=participation))
    plan_t = FederatedPlan(**PLAN, compression=CompressionConfig(kind=kind),
                           cohort=CohortConfig(participation=participation))
    mean_participants = K * participation
    want = jax_measured_payload(plan_j, reference["jax_params0"], mean_participants)
    got = tcfmq.measured_payload(plan_t, reference["params0"], mean_participants)
    assert got == want
    assert (got is None) == (kind == "none" and participation == 1.0)
