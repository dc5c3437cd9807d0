"""The port's buffered-async engine against its own sync engine and the
JAX package's ``repro.core.async_engine``.

On the reference's linear toy (``tests/test_async_engine.py:37-77``): at
B = K with one device tier and zero jitter the async engine is the port's
sync engine bit for bit, for any staleness beta; a buffer that never
fills holds its arrivals and the parameters; a buffer of 2 at K = 4
flushes twice, the second flush all stale. Each wave of the toy under a
non-divisor buffer with jitter, partial participation, an int4 uplink and
the trimmed mean starts from the JAX wave's state (parameters and buffer)
and is held to it. The discount and the arrival times equal XLA's bit for
bit (the port restates XLA's CPU ``exp`` and ``log1p``, ``ref.xla_exp_f32``
and ``ref.xla_log1p_f32``; ATen's differ by an ulp). Then
``validate_plan``'s refusals, and two waves of the tiny asr-rnnt task
(K=3, B=2) held to JAX's jitted async engine at the FVN-off round's
tolerances. Every JAX draw uses the
non-partitionable threefry, set and restored around it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
from repro.core import AggregatorConfig as JaxAggregator
from repro.core import AsyncConfig as JaxAsync
from repro.core import CompressionConfig as JaxCompression
from repro.core import FederatedPlan as JaxPlan
from repro.core import LatencyConfig as JaxLatency
from repro.core import build_round_engine as jax_engine
from repro.core import init_server_state as jax_init_state
from repro.core import make_round_step as jax_round_step
from repro.core.async_engine import staleness_discount as jax_discount
from repro.core.cohort import make_latency_fn as jax_latency_fn
from repro.core.plan import CohortConfig as JaxCohort
from repro.core.task import default_corpus as jax_default_corpus
from repro.core.task import task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import rnnt as jrnnt
from repro_torch.convert import params_from_jax
from repro_torch.core import keys as tkeys
from repro_torch.core.async_engine import AsyncBuffer, staleness_discount
from repro_torch.core.cohort import LatencyConfig, make_latency_fn
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.engine import build_round_engine, validate_plan
from repro_torch.core.fedavg import init_server_state, make_round_step
from repro_torch.core.plan import (AggregatorConfig, AsyncConfig, CohortConfig,
                                   FederatedPlan)
from repro_torch.core.task import FederatedTask, default_corpus, get_task
from repro_torch.kernels import ref

W_TRUE = np.random.default_rng(7).normal(size=(4, 2)).astype(np.float32)
TOY_ATOL = 1e-6    # the toy's parameters and buffered deltas: a few fp32 roundings
DISC_RTOL = 0.0    # the discount: XLA's CPU exp(-beta * log1p(s)) restated, bit for bit
LOSS_RTOL = 1e-4   # the tiny RNN-T: a mean of per-client losses after local SGD
PARAM_ATOL = 1e-5  # the tiny RNN-T: server params after the wave's flushes
LATENCY_RTOL = 0.0  # arrival times: XLA's exp of spread * normal (both bitwise), bit for bit


def toy_loss(params, batch, key):
    pred = batch["x"] @ params["w"]
    w = batch["weight"]
    loss = (((pred - batch["y"]) ** 2) * w[:, None]).sum() / torch.clamp(w.sum(), min=1.0)
    return loss, {}


def jax_toy_loss(params, batch, rng):
    pred = batch["x"] @ params["w"]
    w = batch["weight"]
    return jnp.sum((pred - batch["y"]) ** 2 * w[:, None]) / jnp.maximum(w.sum(), 1), {}


def toy_batch(K, S, b, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(K, S, b, 4)).astype(np.float32)
    return {"x": x, "y": x @ W_TRUE, "weight": np.ones((K, S, b), np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# one tier, zero jitter: every arrival at the same time (the parity plane)
PARITY = dict(base_s=60.0, spread=0.0, tier_speeds=(1.0,), tier_probs=(1.0,))
TOY = dict(clients_per_round=4, client_lr=0.1, server_optimizer="sgd", server_lr=1.0)


def _plans(**kw):
    """The same plan in both packages; the nested configs by name."""
    classes = {"asynchrony": (AsyncConfig, JaxAsync), "latency": (LatencyConfig, JaxLatency),
               "cohort": (CohortConfig, JaxCohort),
               "compression": (CompressionConfig, JaxCompression),
               "aggregation": (AggregatorConfig, JaxAggregator)}
    fields = dict(TOY, **kw)
    ours = {k: classes[k][0](**v) if k in classes else v for k, v in fields.items()}
    theirs = {k: classes[k][1](**v) if k in classes else v for k, v in fields.items()}
    return FederatedPlan(**ours), JaxPlan(**theirs)


def _run(plan, waves, K=4, seed=0):
    step = make_round_step(toy_loss, plan, 3)
    state = init_server_state(plan, {"w": torch.zeros(4, 2)})
    metrics = []
    for r in range(waves):
        state, m = step(state, _torch(toy_batch(K, 2, 4, seed=seed + r)))
        metrics.append(m)
    return state, metrics


def _non_partitionable(fn):
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _jax_waves(jplan, waves, K=4, seed=0):
    """Each JAX wave's starting state, metrics and resulting state."""
    def run():
        step = jax.jit(jax_round_step(jax_toy_loss, jplan, jax.random.PRNGKey(3)))
        state = jax_init_state(jplan, {"w": jnp.zeros((4, 2))})
        out = []
        for r in range(waves):
            start = jax.tree.map(np.asarray, state)
            state, m = step(state, jax.tree.map(jnp.asarray, toy_batch(K, 2, 4, seed=seed + r)))
            out.append((start, {k: float(v) for k, v in m.items()},
                        jax.tree.map(np.asarray, state)))
        return out

    return _non_partitionable(run)


def _port_buffer(jbuf) -> AsyncBuffer:
    return AsyncBuffer(deltas={k: torch.from_numpy(np.array(v)) for k, v in jbuf.deltas.items()},
                       weights=torch.from_numpy(np.array(jbuf.weights)),
                       versions=torch.from_numpy(np.array(jbuf.versions)),
                       count=int(jbuf.count), version=int(jbuf.version))


def _check_buffer(buf: AsyncBuffer, jbuf, atol=TOY_ATOL):
    """The filled slots' contents, the count and the version."""
    assert (buf.count, buf.version) == (int(jbuf.count), int(jbuf.version))
    n = buf.count
    np.testing.assert_array_equal(buf.versions[:n].numpy(), np.asarray(jbuf.versions)[:n])
    np.testing.assert_array_equal(buf.weights[:n].numpy(), np.asarray(jbuf.weights)[:n])
    for name, d in buf.deltas.items():
        np.testing.assert_allclose(d[:n].numpy(), np.asarray(jbuf.deltas[name])[:n], atol=atol,
                                   rtol=0)


# ------------------------------------------------------------ sync parity

@pytest.mark.parametrize("beta", [0.0, 0.5, 2.0])
def test_async_b_equals_k_zero_spread_matches_sync_bitwise(beta):
    """B = K, one tier, zero jitter: each wave inserts the K arrivals in
    client order and flushes once at staleness 0, so the port's async
    engine is its sync engine bit for bit over three waves, and within
    TOY_ATOL of the reference's async engine."""
    plan, jplan = _plans(engine="async", asynchrony=dict(buffer_size=4, staleness_beta=beta),
                         latency=PARITY)
    sync, _ = _run(_plans()[0], 3)
    asyn, metrics = _run(plan, 3)
    assert torch.equal(sync.params["w"], asyn.params["w"])
    for m in metrics:
        assert (m["server_steps"], m["staleness_mean"], m["sim_time_s"]) == (1.0, 0.0, 60.0)
    _, _, want = _jax_waves(jplan, 3)[-1]
    np.testing.assert_allclose(asyn.params["w"].numpy(), want.params["w"], atol=TOY_ATOL,
                               rtol=0)


# ------------------------------------------------------- buffer dynamics

def test_a_buffer_that_never_fills_holds_its_arrivals_and_the_params():
    """B = 6 > K = 4: no server step, parameters bitwise unchanged, the 4
    arrivals wait in the buffer; the next wave's 2nd arrival fills it and
    flushes the now-stale deltas once. Both waves held to JAX's."""
    plan, jplan = _plans(engine="async", asynchrony=dict(buffer_size=6, staleness_beta=0.5),
                         latency=PARITY)
    (state, metrics), want = _run(plan, 1), _jax_waves(jplan, 2)
    m = metrics[0]
    assert m["server_steps"] == 0.0 and m["sim_time_s"] == 60.0
    assert torch.equal(state.params["w"], torch.zeros(4, 2))
    assert (state.abuf.count, state.abuf.version) == (4, 0)
    _check_buffer(state.abuf, want[0][2].abuf)
    state, m2 = make_round_step(toy_loss, plan, 3)(state, _torch(toy_batch(4, 2, 4, seed=1)))
    assert m2["server_steps"] == 1.0 and state.abuf.count == 2
    assert m2["staleness_mean"] == want[1][1]["staleness_mean"]
    _check_buffer(state.abuf, want[1][2].abuf)
    np.testing.assert_allclose(state.params["w"].numpy(), want[1][2].params["w"],
                               atol=TOY_ATOL, rtol=0)


def test_all_stale_flush_statistics():
    """B = 2, K = 4: the first flush lands mid-wave at staleness 0 and
    moves the version under the other two arrivals, so the second flush is
    all stale: staleness_mean (0 + 0 + 1 + 1) / 4."""
    plan, jplan = _plans(engine="async", asynchrony=dict(buffer_size=2, staleness_beta=0.5),
                         latency=PARITY)
    state, (m,) = _run(plan, 1)
    assert m["server_steps"] == 2.0 and m["staleness_mean"] == 0.5
    assert state.abuf.version == 2
    _, jm, want = _jax_waves(jplan, 1)[0]
    assert {k: m[k] for k in jm} == pytest.approx(jm, rel=1e-6)
    np.testing.assert_allclose(state.params["w"].numpy(), want.params["w"], atol=TOY_ATOL,
                               rtol=0)
    # beta 0 is the undiscounted engine: a stale flush moves the params otherwise
    w0 = _run(_plans(engine="async", asynchrony=dict(buffer_size=2, staleness_beta=0.0),
                     latency=PARITY)[0], 1)[0].params["w"]
    assert not torch.equal(w0, state.params["w"])


@pytest.mark.parametrize("wave", range(4))
def test_non_divisor_buffer_with_jitter_partial_int4_trimmed_mean_matches_jax(wave):
    """B = 3 at K = 4 with three device tiers and jitter, participation
    0.75, a stochastic int4 uplink and the trimmed mean: each wave from the
    JAX wave's starting state (parameters and buffer) gives JAX's arrival
    order, flushes, staleness, metrics, buffer and parameters."""
    plan, jplan = _plans(engine="async", asynchrony=dict(buffer_size=3, staleness_beta=0.5),
                         latency=dict(base_s=45.0, spread=0.3),
                         cohort=dict(participation=0.75), compression=dict(kind="int4"),
                         aggregation=dict(name="trimmed_mean", trim_frac=0.25))
    waves = _jax_waves(jplan, 4, seed=5)
    if wave == 0:  # the plane is live: a client dropped and a flush was stale
        assert min(m["participants"] for _, m, _ in waves) < 4
        assert max(m["staleness_mean"] for _, m, _ in waves) > 0
    start, jm, want = waves[wave]
    state = init_server_state(plan, {"w": torch.zeros(4, 2)})._replace(
        params={"w": torch.from_numpy(np.array(start.params["w"]))},
        round_idx=int(start.round_idx), abuf=_port_buffer(start.abuf))
    state, m = make_round_step(toy_loss, plan, 3)(state, _torch(toy_batch(4, 2, 4, seed=5 + wave)))
    assert m.keys() == jm.keys()
    for k in ("participants", "uplink_bytes", "downlink_bytes", "examples", "server_steps",
              "corrupted"):
        assert m[k] == jm[k], k
    np.testing.assert_allclose(m["sim_time_s"], jm["sim_time_s"], rtol=LATENCY_RTOL)
    np.testing.assert_allclose(m["staleness_mean"], jm["staleness_mean"], rtol=1e-6)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["delta_norm"], jm["delta_norm"], rtol=1e-4, atol=TOY_ATOL)
    _check_buffer(state.abuf, want.abuf)
    np.testing.assert_allclose(state.params["w"].numpy(), want.params["w"], atol=TOY_ATOL,
                               rtol=0)


def test_staleness_discount_is_exact_where_the_reference_is_and_close_elsewhere():
    """Exactly 1.0 at s == 0 and at beta == 0, and XLA's bits elsewhere
    (DISC_RTOL is 0)."""
    s = np.arange(200, dtype=np.float32)
    assert torch.all(staleness_discount(torch.zeros(4), 1.7) == 1.0)
    assert torch.all(staleness_discount(torch.from_numpy(s), 0.0) == 1.0)
    for beta in (0.25, 0.5, 1.0, 1.7, 2.0, 3.0):
        want = np.asarray(jax.jit(jax_discount)(jnp.asarray(s), jnp.float32(beta)))
        got = staleness_discount(torch.from_numpy(s), beta)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=DISC_RTOL, atol=0)


# ------------------------------------------------- refusals when built

@pytest.mark.parametrize("asynchrony,match", [
    (AsyncConfig(buffer_size=-1), "buffer_size must be >= 0"),
    (AsyncConfig(staleness_beta=-0.5), "UP-weight stale deltas"),
])
def test_validate_plan_refuses_what_the_reference_refuses(asynchrony, match):
    plan = FederatedPlan(engine="async", asynchrony=asynchrony)
    with pytest.raises(ValueError, match=match):
        validate_plan(plan)
    with pytest.raises(ValueError, match=match):
        build_round_engine(plan, get_task("asr-rnnt"), seed=0)
    validate_plan(dataclasses.replace(plan, engine="fedavg"))  # async knobs only bind async
    with pytest.raises(ValueError, match="unknown engine"):
        FederatedPlan(engine="fedmystery")


# ------------------------------------------------- the tiny RNN-T waves

K, B, LIMIT, CLIENT_LR = 3, 2, 4, 0.05   # data limit 4 at b = 2: S = 2 local steps
RNNT_PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT,
                 client_lr=CLIENT_LR, server_optimizer="sgd", server_lr=1.0, engine="async")


@pytest.fixture(scope="module")
def rnnt_waves():
    """Two jitted JAX async waves (B = 2, three device tiers with jitter)
    of the tiny config with SpecAugment on: each wave's batch, starting
    state, metrics and resulting state."""
    tcfg = get_task("asr-rnnt").config
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"},
                            specaug=JaxSpecAug(**dataclasses.asdict(tcfg.specaug)))
    jplan = JaxPlan(**RNNT_PLAN, asynchrony=JaxAsync(buffer_size=2, staleness_beta=0.5))

    def run():
        engine = jax_engine(jplan, task_for_config(jcfg, name="asr-rnnt"),
                            base_key=jax.random.PRNGKey(1))
        step = jax.jit(engine.step)
        params0 = jax.tree.map(np.asarray, jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))
        sampler = JaxSampler(jax_default_corpus(0), clients_per_round=K, local_batch_size=B,
                             data_limit=LIMIT, seed=0)
        state = engine.init_state(params0)
        waves = []
        for _ in range(2):
            batch = sampler.next_round().engine_batch()
            start = jax.tree.map(np.asarray, state)
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            waves.append((batch, start, {k: float(v) for k, v in metrics.items()},
                          jax.tree.map(np.asarray, state)))
        return waves

    return FederatedTask("asr-rnnt", tcfg, default_corpus), _non_partitionable(run)


@pytest.mark.parametrize("wave", range(2))
def test_tiny_rnnt_async_waves_match_jax(rnnt_waves, wave):
    """Wave 1 flushes once at staleness 0 and keeps one arrival; wave 2
    flushes twice, its first flush holding that arrival one version
    stale."""
    task, waves = rnnt_waves
    batch, start, jm, want = waves[wave]
    assert [w[2]["server_steps"] for w in waves] == [1.0, 2.0]
    plan = FederatedPlan(**RNNT_PLAN, asynchrony=AsyncConfig(buffer_size=2, staleness_beta=0.5))
    engine = build_round_engine(plan, task, seed=1)
    params = params_from_jax(start.params)
    state = engine.init_state({n: params[n] for n, _ in task.model.named_parameters()})
    buf = start.abuf
    state = state._replace(round_idx=wave, abuf=_port_buffer(buf._replace(
        deltas=params_from_jax(buf.deltas))))
    state, m = engine.step(state, _torch(batch))
    for k in ("participants", "uplink_bytes", "downlink_bytes", "examples", "server_steps",
              "staleness_mean", "corrupted"):
        assert m[k] == jm[k], k
    np.testing.assert_allclose(m["sim_time_s"], jm["sim_time_s"], rtol=LATENCY_RTOL)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["delta_norm"], jm["delta_norm"], rtol=LOSS_RTOL)
    _check_buffer(state.abuf, want.abuf._replace(deltas=params_from_jax(want.abuf.deltas)),
                  atol=PARAM_ATOL)
    after = params_from_jax(want.params)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), after[name].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"wave {wave} {name}")


# ------------------------------------------------- XLA's exp, bit for bit

def _exp_grid() -> np.ndarray:
    """Every 4,099th float32 of [-87.8, 88.7] by bit pattern, both signs,
    with 0, -0 and the neighbours of 1 and of the clamp's ends."""
    hi = np.array([87.8, 88.7], np.float32).view(np.uint32)
    neg = np.arange(0, hi[0], 4099, dtype=np.uint32) | np.uint32(0x80000000)
    pos = np.arange(0, hi[1], 4099, dtype=np.uint32)
    edges = np.array([0.0, -0.0, 1.0, -1.0, -87.8, 88.7, 1e-30, -1e-30], np.float32)
    return np.concatenate([neg.view(np.float32), pos.view(np.float32), edges,
                           np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])


def test_xla_exp_is_jnp_exp_bit_for_bit():
    """ref.xla_exp_f32 is XLA's CPU exp: 0 ulp on a grid over the range
    where exp is finite and normal."""
    x = _exp_grid()
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    got = ref.xla_exp_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("spread", [0.25, 0.3])
@pytest.mark.parametrize("K", [4, 16, 256])
def test_arrival_times_are_jax_bit_for_bit(K, spread):
    """The latency model's arrival times equal the jitted reference's on
    seeds 0-199, so a wave's buffer fills in the reference's order. At a
    spread that is no power of 2, XLA folds it into the normal's sqrt(2)
    (eager JAX would not: its times differ by an ulp)."""
    jcfg = JaxLatency(enabled=True, spread=spread)
    tcfg = LatencyConfig(enabled=True, spread=spread)
    jfn = jax.jit(lambda key: jax_latency_fn(jcfg)(key, K))
    tfn = make_latency_fn(tcfg)

    def run():
        return np.stack([np.asarray(jfn(jax.random.PRNGKey(s))) for s in range(200)])

    want = _non_partitionable(run)
    got = np.stack([tfn(tkeys.PRNGKey(s), K).numpy() for s in range(200)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(np.argsort(got, axis=1, kind="stable"),
                                  np.argsort(want, axis=1, kind="stable"))


@pytest.mark.parametrize("beta", [0.5, 1.0, 1.7, 2.0])
def test_staleness_discount_is_jax_bit_for_bit(beta):
    """Every staleness a wave of up to 256 clients can give, and larger."""
    s = np.concatenate([np.arange(257), [511, 1000, 4095, 65535]]).astype(np.float32)
    want = np.asarray(jax.jit(jax_discount)(jnp.asarray(s), jnp.float32(beta)))
    got = staleness_discount(torch.from_numpy(s), beta).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
