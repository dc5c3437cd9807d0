"""The port's FedAvg round on the slow path (a robust aggregator or a
delta adversary: each client's compressed delta is made, corrupted and
aggregated) against the JAX engine: two rounds at the tiny asr-rnnt
config (K=4, S=2, b=2) under five server planes, FVN and SpecAugment off,
a server SGD at lr 1 (so the update is minus the aggregate). Each port
round starts from the JAX round's starting state (parameters, EF
residuals, the stale cache) on the same batch and base key, its dicts in
the model's own order (``named_parameters``), which is not JAX's tree
order, so a leaf handed the wrong split key would show.

The cohort, the corrupted-client mask and the byte counts are equal. The
clients' fp32 deltas differ from JAX's by float rounding, so a code can
flip where a uniform lies within an ulp of the fraction it is compared
with (intN), or a near-tie of |x| can swap a coordinate top-k keeps; a
flip moves an order statistic by at most the flipped value's change. So
the aggregate is held elementwise: within one code step (the leaf's
largest client scale, times the adversary's scale) plus PARAM_ATOL for
intN planes, and at most FLIP_SHARE of the elements may differ by more
than PARAM_ATOL. The fp32 plane (clipped mean with DP noise, a gaussian
adversary, the latency model) has no code to flip: every element within
PARAM_ATOL (the noise is ``normal``, held to 1e-5 of draws it scales by
about 1e-3), and the simulated round time within rtol 1e-5."""

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
from repro.core.cohort import LatencyConfig as JaxLatency
from repro.core.compression import CompressionConfig as JaxCompression
from repro.core.corruption import CorruptionConfig as JaxCorruption
from repro.core.plan import AggregatorConfig as JaxAggregator
from repro.core.plan import CohortConfig as JaxCohort
from repro.core.task import default_corpus as jax_default_corpus
from repro.core.task import task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import rnnt as jrnnt
from repro_torch.convert import params_from_jax
from repro_torch.core import compression as tcomp
from repro_torch.core.cohort import LatencyConfig
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.corruption import CorruptionConfig
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import AggregatorConfig, CohortConfig, FederatedPlan
from repro_torch.core.task import FederatedTask, default_corpus, get_task

K, B, LIMIT, CLIENT_LR = 4, 2, 4, 0.05   # data limit 4 at b = 2: S = 2 local steps
LOSS_RTOL = 1e-4   # a mean of per-client losses after local SGD steps, fp32
PARAM_ATOL = 1e-5  # aggregated deltas after two local steps
FLIP_SHARE = 1e-3  # elements whose code or top-k choice may flip
TIME_RTOL = 1e-5   # the latency model's jitter is exp(spread * normal)
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=CLIENT_LR,
            server_optimizer="sgd", server_lr=1.0)
# the server planes: (compression, cohort, aggregation, corruption, latency)
PLANES = {
    "int4_packed_trimmed_signflip_p75": (
        dict(kind="int4", packed=True), dict(participation=0.75),
        dict(name="trimmed_mean", trim_frac=0.25),
        dict(kind="sign_flip", rate=0.25, scale=3.0), dict()),
    "int4_graph_trimmed_signflip_p75": (
        dict(kind="int4"), dict(participation=0.75), dict(name="trimmed_mean", trim_frac=0.25),
        dict(kind="sign_flip", rate=0.25, scale=3.0), dict()),
    "topk5_packed_median_stale_stragglers": (
        dict(kind="topk", topk_frac=0.05, packed=True),
        dict(straggler_frac=0.5, straggler_keep=0.5), dict(name="coordinate_median"),
        dict(kind="stale", rate=0.5, scale=1.0), dict()),
    "fp32_clipped_dp_gaussian_latency": (
        dict(), dict(), dict(name="clipped_mean", dp_clip=1.0, dp_sigma=0.01),
        dict(kind="gaussian", rate=0.25, scale=5.0), dict(enabled=True)),
    "int4_ef_trimmed_p75": (
        dict(kind="int4", error_feedback=True), dict(participation=0.75),
        dict(name="trimmed_mean", trim_frac=0.25), dict(), dict()),
}
SPECAUG_PLANES = {"int4_packed_trimmed_signflip_p75"}  # masks drawn in both packages


def _tiny_configs(specaug: bool = False):
    """The tiny asr-rnnt config in both packages, SpecAugment on or off
    (the port draws the reference's masks from the same key)."""
    tcfg = get_task("asr-rnnt").config
    tcfg = dataclasses.replace(tcfg, specaug=dataclasses.replace(tcfg.specaug, enabled=specaug))
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"},
                            specaug=JaxSpecAug(**dataclasses.asdict(tcfg.specaug)))
    return tcfg, jcfg


def _tree(state_tree):
    return None if state_tree is None else params_from_jax(jax.tree.map(np.asarray, state_tree))


@pytest.fixture(scope="module", params=list(PLANES))
def reference(request):
    """Two jitted JAX rounds of one plane with the non-partitionable
    threefry (the pinned jax's default), restored after: each round's
    starting state, metrics and result. One compiled engine per plane."""
    comp, coh, agg, cor, lat = PLANES[request.param]
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        tcfg, jcfg = _tiny_configs(request.param in SPECAUG_PLANES)
        plan = JaxPlan(**PLAN, compression=JaxCompression(**comp), cohort=JaxCohort(**coh),
                       aggregation=JaxAggregator(**agg), corruption=JaxCorruption(**cor),
                       latency=JaxLatency(**lat))
        base_key = jax.random.PRNGKey(1)
        engine = jax_engine(plan, task_for_config(jcfg, name="asr-rnnt"), base_key=base_key)
        step = jax.jit(engine.step)
        jplane = jfedavg._plan_server_plane(plan)
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
                "batch": batch, "pmask": np.asarray(pmask),
                "params": _tree(start.params), "ef": _tree(start.ef),
                "stale": _tree(start.stale),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "after": _tree(state.params), "ef_after": _tree(state.ef),
                "stale_after": _tree(state.stale),
            })
        # the guard: the cohort's draws under this flag are not the other flag's
        ckey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(base_key, 0),
                                                     0x636F68), 0)
        drawn = np.asarray(jax.random.uniform(ckey, (K,)))
        jax.config.update("jax_threefry_partitionable", True)
        other = np.asarray(jax.random.uniform(ckey, (K,)))
    finally:
        jax.config.update("jax_threefry_partitionable", before)
    assert not np.array_equal(drawn, other)
    # each plane's stage engages within the two rounds
    ms = [r["metrics"] for r in rounds]
    if coh.get("participation", 1.0) < 1.0:
        assert min(m["participants"] for m in ms) < K
    if coh.get("straggler_frac", 0.0) > 0.0:
        assert min(m["examples"] for m in ms) < K * B * LIMIT // B
    assert (sum(m["corrupted"] for m in ms) > 0) == (cor.get("rate", 0.0) > 0.0)
    task = FederatedTask("asr-rnnt", tcfg, default_corpus)
    return {"name": request.param, "plane": PLANES[request.param], "task": task,
            "rounds": rounds}


def _held(got: torch.Tensor, want: torch.Tensor, step, what: str) -> int:
    """Elementwise within one code step plus PARAM_ATOL (when a step is
    given); returns how many elements differ by more than PARAM_ATOL."""
    err = (got - want).abs()
    if step is not None:
        assert float(err.max()) <= step + PARAM_ATOL, (what, float(err.max()), step)
    return int((err > PARAM_ATOL).sum())


def _model_order(task, d):
    return None if d is None else {n: d[n] for n, _ in task.model.named_parameters()}


def test_slow_path_rounds_match_jax(reference, monkeypatch):
    comp, coh, agg, cor, lat = reference["plane"]
    task = reference["task"]
    scales = []
    real = tcomp.client_leaf_scales
    monkeypatch.setattr(tcomp, "client_leaf_scales",
                        lambda *a: scales.append(real(*a)) or scales[-1])
    plan = FederatedPlan(**PLAN, compression=CompressionConfig(**comp),
                         cohort=CohortConfig(**coh), aggregation=AggregatorConfig(**agg),
                         corruption=CorruptionConfig(**cor), latency=LatencyConfig(**lat))
    engine = build_round_engine(plan, task, seed=1)
    fp32 = plan.compression.kind == "none"
    for r, want in enumerate(reference["rounds"]):
        params = _model_order(task, want["params"])
        assert list(params) != tcomp.jax_leaf_order(params)
        start = engine.init_state(params)
        assert (start.stale is None) == (want["stale"] is None)
        assert (start.ef is None) == (want["ef"] is None)
        start = start._replace(round_idx=r, ef=_model_order(task, want["ef"]),
                               stale=_model_order(task, want["stale"]))
        batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
        scales.clear()
        state, metrics = engine.step(start, batch)
        jm = want["metrics"]
        assert metrics.keys() == jm.keys()
        np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(metrics["sim_time_s"], jm["sim_time_s"], rtol=TIME_RTOL)
        for k in ("examples", "participants", "uplink_bytes", "downlink_bytes", "corrupted",
                  "server_steps", "staleness_mean"):
            assert metrics[k] == jm[k], k
        assert (metrics["sim_time_s"] > 0) == plan.latency.enabled

        steps = {}
        if scales:  # intN: each client's scale per leaf, in JAX's leaf order
            worst = max(1.0, plan.corruption.scale)
            for name, s in zip(tcomp.jax_leaf_order(start.params), scales):
                steps[name] = float(s.max()) * worst
        flipped = total = 0
        for name, p in state.params.items():
            wbar = start.params[name] - p
            want_wbar = want["params"][name] - want["after"][name]
            flipped += _held(wbar, want_wbar, steps.get(name), f"round {r + 1} wbar {name}")
            total += p.numel()
        assert flipped <= (0 if fp32 else FLIP_SHARE * total), (flipped, total)
        for what in ("ef", "stale"):
            got, want_after = getattr(state, what), want[f"{what}_after"]
            assert (got is None) == (want_after is None), what
            if got is None:
                continue
            flipped = total = 0
            for name, e in got.items():
                assert e.shape == want_after[name].shape
                flipped += _held(e, want_after[name], None, f"round {r + 1} {what} {name}")
                total += e.numel()
            assert flipped <= FLIP_SHARE * total, (what, flipped, total)
        # a client that does not report keeps its residual and its cache entry
        for k in np.flatnonzero(want["pmask"] == 0):
            for what in ("ef", "stale"):
                if getattr(state, what) is not None:
                    for name, e in getattr(state, what).items():
                        assert torch.equal(e[k], getattr(start, what)[name][k]), (what, k)

