"""The port's FedAvg round with a compressed uplink (the code-domain fast
path) against the JAX engine: two rounds at the tiny asr-rnnt config
(K=3, S=2, b=2) under int4 packed stochastic rounding (with every client
reporting, and with participation 0.75) and under top-k 0.25 with error
feedback, FVN and SpecAugment off, a server SGD at lr 1. The JAX rounds
run with the non-partitionable threefry (the pinned jax's default), as
the cohort's draws need.
Each port round starts from the JAX round's starting state (parameters
and EF residuals) on the same batch and base key, its dicts in the
model's own order (``named_parameters``, as ``run_federated`` has them),
which is not JAX's tree order.

The clients' fp32 deltas differ from JAX's by float rounding, so a code
can flip where a uniform lies within an ulp of the fraction it is
compared with (int4), or a near-tie of |x| can swap the last coordinate
top-k keeps. So the aggregate is held elementwise: an element may differ
by one code step (scale * max n_k / n) plus PARAM_ATOL, and at most
FLIP_SHARE of the elements may differ by more than PARAM_ATOL at all."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
from repro.core import FederatedPlan as JaxPlan
from repro.core import build_round_engine as jax_engine
from repro.core import fedavg as jfedavg
from repro.core.compression import CompressionConfig as JaxCompression
from repro.core.plan import CohortConfig as JaxCohort
from repro.core.task import default_corpus as jax_default_corpus
from repro.core.task import task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import rnnt as jrnnt
from repro_torch.convert import params_from_jax
from repro_torch.core import compression as tcomp
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import CohortConfig, FederatedPlan
from repro_torch.core.task import FederatedTask, default_corpus, get_task

K, B, LIMIT, CLIENT_LR = 3, 2, 4, 0.05   # data limit 4 at b = 2: S = 2 local steps
LOSS_RTOL = 1e-4   # a mean of per-client losses after local SGD steps, fp32
PARAM_ATOL = 1e-5  # server params / aggregated deltas after two local steps
FLIP_SHARE = 1e-3  # elements whose code or top-k choice may flip
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=CLIENT_LR,
            server_optimizer="sgd", server_lr=1.0)
PLANES = {  # (compression, cohort)
    "int4_packed": (dict(kind="int4", packed=True), dict()),
    "int4_packed_p75": (dict(kind="int4", packed=True), dict(participation=0.75)),
    "topk25_ef": (dict(kind="topk", topk_frac=0.25, error_feedback=True), dict()),
}
SPECAUG_PLANES = {"int4_packed_p75"}  # the client step's masks drawn in both packages


def _tiny_configs(specaug: bool = False):
    """The tiny asr-rnnt config in both packages, SpecAugment on or off
    (the port draws the reference's masks from the same key)."""
    tcfg = get_task("asr-rnnt").config
    tcfg = dataclasses.replace(tcfg, specaug=dataclasses.replace(tcfg.specaug, enabled=specaug))
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"},
                            specaug=JaxSpecAug(**dataclasses.asdict(tcfg.specaug)))
    return tcfg, jcfg


@pytest.fixture(scope="module", params=list(PLANES))
def reference(request):
    """Two jitted JAX rounds of one plane, with each round's starting
    state, metrics and result. One compiled engine per plane."""
    comp, coh = PLANES[request.param]
    tcfg, jcfg = _tiny_configs(request.param in SPECAUG_PLANES)
    plan = JaxPlan(**PLAN, compression=JaxCompression(**comp), cohort=JaxCohort(**coh))
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        base_key = jax.random.PRNGKey(1)
        engine = jax_engine(plan, task_for_config(jcfg, name="asr-rnnt"), base_key=base_key)
        jplane = jfedavg._plan_server_plane(plan)
        step = jax.jit(engine.step)
        params0 = jax.tree.map(np.asarray, jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))
        sampler = JaxSampler(jax_default_corpus(0), clients_per_round=K, local_batch_size=B,
                             data_limit=LIMIT, seed=0)
        state = engine.init_state(params0)
        rounds = []
        for r in range(2):
            batch = sampler.next_round().engine_batch()
            start = state
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            _, pmask = jfedavg._apply_cohort(jplane, jfedavg._plane_keys(base_key, r)[0],
                                             jax.tree.map(jnp.asarray, batch))
            rounds.append({
                "batch": batch, "pmask": torch.tensor(np.asarray(pmask)),
                "params": params_from_jax(jax.tree.map(np.asarray, start.params)),
                "ef": None if start.ef is None else params_from_jax(jax.tree.map(np.asarray,
                                                                                 start.ef)),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "after": params_from_jax(jax.tree.map(np.asarray, state.params)),
                "ef_after": None if state.ef is None else params_from_jax(
                    jax.tree.map(np.asarray, state.ef)),
            })
    finally:
        jax.config.update("jax_threefry_partitionable", before)
    if coh:  # the drawn cohort drops a client in one of the rounds
        assert min(r["metrics"]["participants"] for r in rounds) < K
    task = FederatedTask("asr-rnnt", tcfg, default_corpus)
    return {"name": request.param, "comp": comp, "cohort": coh, "task": task,
            "rounds": rounds}


def _held(got: torch.Tensor, want: torch.Tensor, step, what: str) -> int:
    """Elementwise within one code step plus PARAM_ATOL; returns how many
    elements differ by more than PARAM_ATOL."""
    err = (got - want).abs()
    if step is not None:
        assert float(err.max()) <= step + PARAM_ATOL, (what, float(err.max()), step)
    return int((err > PARAM_ATOL).sum())


def _model_order(task, d):
    return None if d is None else {n: d[n] for n, _ in task.model.named_parameters()}


def test_compressed_rounds_match_jax(reference, monkeypatch):
    comp, task = reference["comp"], reference["task"]
    scales = []
    real_scale = tcomp.shared_leaf_scale
    monkeypatch.setattr(tcomp, "shared_leaf_scale",
                        lambda *a: scales.append(real_scale(*a)) or scales[-1])
    plan = FederatedPlan(**PLAN, compression=CompressionConfig(**comp),
                         cohort=CohortConfig(**reference["cohort"]))
    engine = build_round_engine(plan, task, seed=1)
    for r, want in enumerate(reference["rounds"]):
        params = _model_order(task, want["params"])
        assert list(params) != tcomp.jax_leaf_order(params)
        start = engine.init_state(params)
        if want["ef"] is not None:
            assert start.ef.keys() == want["ef"].keys()
            for name, e in start.ef.items():
                assert e.shape == (K, *params[name].shape) and e.dtype == torch.float32
        start = start._replace(round_idx=r, ef=_model_order(task, want["ef"]))
        batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
        scales.clear()
        state, metrics = engine.step(start, batch)
        jm = want["metrics"]
        assert metrics.keys() == jm.keys()
        if r == 0:
            np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=LOSS_RTOL)
        for k in ("examples", "participants", "uplink_bytes", "downlink_bytes", "corrupted",
                  "sim_time_s", "server_steps", "staleness_mean"):
            assert metrics[k] == jm[k], k
        up = tcomp.client_wire_bytes(plan.compression, start.params)
        assert metrics["uplink_bytes"] == metrics["participants"] * up < K * 4 * sum(
            p.numel() for p in start.params.values())

        n_k = batch["weight"].reshape(K, -1).sum(dim=1) * want["pmask"]  # the cohort's
        steps = {}
        if scales:  # intN: one shared scale per leaf, in the reference's leaf order
            for name, s in zip(tcomp.jax_leaf_order(start.params), scales):
                steps[name] = float(s) * float(n_k.max() / n_k.sum())
        flipped = total = 0
        for name, p in state.params.items():
            wbar = start.params[name] - p
            want_wbar = want["params"][name] - want["after"][name]
            flipped += _held(wbar, want_wbar, steps.get(name), f"round {r + 1} wbar {name}")
            total += p.numel()
        assert flipped <= FLIP_SHARE * total, (flipped, total)
        if want["ef_after"] is not None:
            flipped = total = 0
            for name, e in state.ef.items():
                assert e.shape == want["ef_after"][name].shape
                flipped += _held(e, want["ef_after"][name], None, f"round {r + 1} ef {name}")
                total += e.numel()
            assert flipped <= FLIP_SHARE * total, (flipped, total)
        else:
            assert state.ef is None
