"""The sweep runner: the paper's grids as lists of plans, run in turn.

The port of ``repro/launch/sweeps.py``'s sequential runner. The paper's
central artifact is a sweep: vary the non-IID dial (the per-client data
limit, §4.2.1) and FVN (§4.2.2) and measure quality against CFMQ cost
(Fig. 3). A grid is a list of ``SweepPoint``s; ``SweepRunner`` runs them
on one task and one corpus, each point through the round engine of its
plan, and emits one summary row a point (``core/metrics.py``'s schema,
with ``id``, ``loss_curve``, ``sim_time_curve``, the point's meta and,
with the per-client plane on, ``client_eval`` as extras).

Grids (the reference's, point for point):

- ``noniid_fvn``: data limit x FVN, the Fig. 3 frontier;
- ``ladder``: the paper's E0–E10 ladder at container scale (Tables 1–5);
- ``compression``: fp32/int8/int4/top-k uplinks and cohort variants;
- ``ef_compression``: plain against EF21 error feedback at equal bytes;
- ``sampling``: the client-sampling strategies x data limit;
- ``robustness``: aggregator x adversary x corruption rate;
- ``async_vs_sync``: the buffered-async engine against the sync barrier
  at equal CFMQ, the wall-clock axis (``sim_time_s``);
- ``client_eval``: the non-IID ladder with the per-client plane on.

``--check`` asserts a grid's claim (robustness, async_vs_sync,
client_eval). The frontier JSON goes to ``results/sweep_<grid>_torch.json``
so the JAX package's file is left alone. Every point runs on the card
unless the caller passes ``device="cpu"`` (``--device cpu``).

CLI::

    PYTHONPATH=src python -m repro_torch.launch.sweeps --grid async_vs_sync --smoke --check
    PYTHONPATH=src python -m repro_torch.launch.sweeps --grid client_eval --smoke --check \\
        --device cpu

The reference's point-parallel mesh runner and ``--population``
(ROADMAP M9), ``--trace-dir``, ``predict_grid_costs`` and
``--prune-budget`` (M10), and its jit cache and prefetch (the port
compiles nothing and copies each batch pinned and non-blocking) are not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.cfmq import seconds_to_target
from repro_torch.core.cohort import LatencyConfig
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.corruption import CorruptionConfig
from repro_torch.core.metrics import SPREAD_KEYS, summary_row
from repro_torch.core.plan import (AggregatorConfig, AsyncConfig, CohortConfig, FederatedPlan,
                                   FVNConfig)
from repro_torch.core.task import FederatedTask, get_task, scaled_task
from repro_torch.data import FederatedSampler
from repro_torch.launch.train import (FederatedRun, federated_rounds, resolve_device,
                                      summary_fields)


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One experiment of a sweep: a plan and its run budget."""
    id: str
    plan: FederatedPlan
    rounds: int
    iid: bool = False                    # IID-shuffled pools (E0)
    specaug_scale: float = 1.0
    seed: int = 0
    meta: dict = dataclasses.field(default_factory=dict)


class SweepRunner:
    """Runs SweepPoints one after another on one task and one corpus (the
    task's own, ``task.make_corpus(seed)``, unless the caller gives one).

    ``pad_steps=True`` pads every point of a grid to the grid's largest
    local-step count with weight-0 steps, exact no-ops under the engine's
    n_k weighting. The default is False, whatever the budget: the
    reference pads smoke grids so that one compilation serves the grid,
    and the port compiles nothing, so a padded step only costs time.
    """

    def __init__(self, task: Optional[FederatedTask] = None, corpus=None, seed: int = 0,
                 eval_examples: int = 64, pad_steps: bool = False, client_eval: int = 0,
                 client_eval_examples: int = 4, device: Optional[str] = None):
        task = task if task is not None else get_task("asr-rnnt")
        self.task = task
        self.corpus = corpus if corpus is not None else task.make_corpus(seed)
        self.eval_examples = eval_examples
        self.pad_steps = pad_steps
        self.client_eval = client_eval
        self.client_eval_examples = client_eval_examples
        self.device = resolve_device(device)
        self._tasks: Dict[float, FederatedTask] = {1.0: task}

    def _task(self, specaug_scale: float) -> FederatedTask:
        """The runner's task, around a SpecAugment-scaled config where a
        point asks for one (one task a scale)."""
        if specaug_scale not in self._tasks:
            self._tasks[specaug_scale] = scaled_task(self.task, specaug_scale)
        return self._tasks[specaug_scale]

    def native_steps(self, plan: FederatedPlan) -> int:
        """The local-step count the plan gets on its own; CFMQ always
        counts this one, never the padded shape."""
        return FederatedSampler.natural_steps(
            self.corpus, plan.local_batch_size, data_limit=plan.data_limit,
            local_epochs=plan.local_epochs, max_steps=plan.local_steps)

    def common_steps(self, points) -> Optional[int]:
        if not self.pad_steps:
            return None
        return max(self.native_steps(p.plan) for p in points)

    def run_point(self, point: SweepPoint, steps: Optional[int] = None, log=print) -> dict:
        """One point through the driver's round loop (``train.federated_rounds``),
        ``steps`` forcing its local-step count; its row's ``wall_s`` takes
        in the final evaluation, as the reference's does."""
        task = self._task(point.specaug_scale)
        run = federated_rounds(task, self.corpus, point.plan, point.rounds, seed=point.seed,
                               device=self.device, iid=point.iid,
                               eval_examples=self.eval_examples, log=lambda line: None,
                               client_eval=self.client_eval,
                               client_eval_examples=self.client_eval_examples, steps=steps)
        return self._finish_row(point, run, log=log)

    def _finish_row(self, point: SweepPoint, run: FederatedRun, log=print) -> dict:
        """A point's run -> one frontier row."""
        stride = max(1, point.rounds // 50)
        extras = {
            "id": point.id,
            "loss_curve": run.tally.curves["loss"][::stride],
            "sim_time_curve": run.tally.curves["sim_time_s"][::stride],
            **point.meta,
        }
        if run.plane is not None:
            extras["client_eval"] = run.plane.curves()
        row = summary_row(
            **summary_fields(self.task, point.plan, run.params, point.rounds, run.native_steps,
                             run.tally, run.corrupted, run.quality, run.spread(),
                             run.train_s + run.eval_s),
            extras=extras)
        log(f"  {point.id:>10s}: loss={row['final_loss']:.3f} "
            f"{row['quality_metric']}={row['quality']:.3f} "
            f"cfmq={row['cfmq_tb']:.5f}TB ({row['wall_s']:.0f}s)")
        return row

    def run(self, points, log=print) -> list[dict]:
        steps = self.common_steps(points)
        if steps is not None:
            log(f"[sweeps] {len(points)} points padded to S={steps} local steps")
        return [self.run_point(p, steps=steps, log=log) for p in points]


# ----------------------------------------------------------------------
# Grids
# ----------------------------------------------------------------------

def noniid_fvn_points(rounds: int = 60, smoke: bool = False, seed: int = 0,
                      limits=(1, 2, 4, 8, None), fvn_opts=(False, True),
                      client_sampling: str = "uniform") -> list[SweepPoint]:
    """Data limit x FVN: the paper's Fig. 3 frontier grid."""
    if smoke:
        rounds = min(rounds, 6)
        limits = (1, 4, None)
    points = []
    for fvn_on in fvn_opts:
        for limit in limits:
            plan = FederatedPlan(
                clients_per_round=8, local_batch_size=4, data_limit=limit,
                local_steps=12, client_lr=0.3, server_lr=0.05,
                server_warmup_rounds=4, client_sampling=client_sampling,
                fvn=FVNConfig(enabled=fvn_on, std=0.03, ramp_rounds=max(1, rounds // 2)))
            points.append(SweepPoint(
                id=f"L{limit if limit is not None else 'inf'}_fvn{int(fvn_on)}",
                plan=plan, rounds=rounds, seed=seed, meta={"limit": limit, "fvn": fvn_on}))
    return points


def compression_points(rounds: int = 40, smoke: bool = False,
                       seed: int = 0) -> list[SweepPoint]:
    """The uplink-compression frontier: fp32 against int8/int4 stochastic
    quantization and top-k, with partial-participation and
    straggler + trimmed-mean variants of int8 (``cfmq_tb`` from measured
    wire bytes)."""
    base = dict(clients_per_round=8, local_batch_size=4, data_limit=4,
                local_steps=12, client_lr=0.3, server_lr=0.05, server_warmup_rounds=4)
    if smoke:
        rounds = min(rounds, 6)
    schemes = [
        ("fp32", CompressionConfig()),
        ("int8", CompressionConfig(kind="int8")),
        ("int4", CompressionConfig(kind="int4")),
        ("top5", CompressionConfig(kind="topk", topk_frac=0.05)),
    ]
    points = [
        SweepPoint(id=name, rounds=rounds, seed=seed,
                   plan=FederatedPlan(**base, compression=comp),
                   meta={"compression": name, "aggregator": "weighted_mean"})
        for name, comp in schemes
    ]
    if not smoke:
        int8 = CompressionConfig(kind="int8")
        points += [
            SweepPoint(id="int8_p75", rounds=rounds, seed=seed,
                       plan=FederatedPlan(**base, compression=int8,
                                          cohort=CohortConfig(participation=0.75)),
                       meta={"compression": "int8", "aggregator": "weighted_mean",
                             "participation": 0.75}),
            # trim_frac 0.2 trims floor(0.2 * 8) = 1 client a side
            SweepPoint(id="int8_trim", rounds=rounds, seed=seed,
                       plan=FederatedPlan(**base, compression=int8,
                                          aggregation=AggregatorConfig(
                                              name="trimmed_mean", trim_frac=0.2),
                                          cohort=CohortConfig(straggler_frac=0.25)),
                       meta={"compression": "int8", "aggregator": "trimmed_mean",
                             "straggler_frac": 0.25}),
        ]
    return points


def ef_compression_points(rounds: int = 40, smoke: bool = False,
                          seed: int = 0) -> list[SweepPoint]:
    """Plain against EF21 error feedback at identical wire bytes (top-k
    5 %/1 %, int4, and int4 on the packed wire), under a plain SGD server
    at lr 1 (FedAvg's w += wbar, which EF21's analysis assumes)."""
    base = dict(clients_per_round=8, local_batch_size=4, data_limit=4,
                local_steps=12, client_lr=0.3, server_lr=1.0,
                server_optimizer="sgd", server_warmup_rounds=4)
    if smoke:
        rounds = min(rounds, 8)
    schemes = [
        ("top5", CompressionConfig(kind="topk", topk_frac=0.05)),
        ("top5_ef", CompressionConfig(kind="topk", topk_frac=0.05, error_feedback=True)),
        ("int4", CompressionConfig(kind="int4")),
        ("int4_ef", CompressionConfig(kind="int4", error_feedback=True)),
        ("int4_packed_ef", CompressionConfig(kind="int4", packed=True, error_feedback=True)),
    ]
    if not smoke:
        schemes += [
            ("top1", CompressionConfig(kind="topk", topk_frac=0.01)),
            ("top1_ef", CompressionConfig(kind="topk", topk_frac=0.01, error_feedback=True)),
        ]
    return [
        SweepPoint(id=name, rounds=rounds, seed=seed,
                   plan=FederatedPlan(**base, compression=comp),
                   meta={"compression": comp.kind, "topk_frac": comp.topk_frac,
                         "error_feedback": comp.error_feedback, "packed": comp.packed})
        for name, comp in schemes
    ]


def sampling_points(rounds: int = 40, smoke: bool = False, seed: int = 0,
                    limits=(2, None)) -> list[SweepPoint]:
    """The client-sampling strategies x data limit."""
    from repro_torch.data import available_strategies

    if smoke:
        rounds = min(rounds, 6)
        limits = (2,)
    points = []
    for strat in available_strategies():
        for limit in limits:
            plan = FederatedPlan(
                clients_per_round=8, local_batch_size=4, data_limit=limit,
                local_steps=12, client_lr=0.3, server_lr=0.05,
                server_warmup_rounds=4, client_sampling=strat)
            points.append(SweepPoint(
                id=f"{strat}_L{limit if limit is not None else 'inf'}",
                plan=plan, rounds=rounds, seed=seed, meta={"strategy": strat, "limit": limit}))
    return points


def robustness_points(rounds: int = 40, smoke: bool = False,
                      seed: int = 0) -> list[SweepPoint]:
    """Aggregator x adversary x corruption rate at identical wire cost
    (a corrupted client still pays its uplink). trim_frac 0.3 trims
    floor(0.3 * 8) = 2 clients a side, enough for the ~2.4 corrupted
    clients a 0.3 rate draws at K = 8."""
    base = dict(clients_per_round=8, local_batch_size=4, data_limit=4,
                local_steps=12, client_lr=0.3, server_lr=0.05, server_warmup_rounds=4)
    aggregators = ["weighted_mean", "trimmed_mean", "coordinate_median"]
    adversaries = [("sign_flip", 3.0), ("gaussian", 5.0), ("zero", 1.0),
                   ("stale", 1.0), ("label_shuffle", 1.0)]
    rates = (0.1, 0.3)
    if smoke:
        rounds = min(rounds, 8)
        aggregators = ["weighted_mean", "trimmed_mean"]
        adversaries = [("sign_flip", 3.0), ("label_shuffle", 1.0)]
        rates = (0.3,)
    points = []
    for agg in aggregators:
        for kind, scale, rate in ([("none", 1.0, 0.0)] +
                                  [(k, s, r) for k, s in adversaries for r in rates]):
            plan = FederatedPlan(
                **base, aggregation=AggregatorConfig(name=agg, trim_frac=0.3),
                corruption=CorruptionConfig(kind=kind, rate=rate, scale=scale))
            points.append(SweepPoint(
                id=f"{agg}_{kind}_r{int(round(rate * 100))}",
                plan=plan, rounds=rounds, seed=seed,
                meta={"aggregator": agg, "adversary": kind,
                      "corrupt_rate": rate, "corrupt_scale": scale}))
    return points


def async_vs_sync_points(rounds: int = 40, smoke: bool = False, seed: int = 0,
                         limits=(1, 4, None)) -> list[SweepPoint]:
    """The buffered-async engine against the sync barrier at equal CFMQ
    across the non-IID ladder: one latency model, K, budget and payload
    for both, so each pair sits at byte-identical CFMQ and differs on the
    ``sim_time_s`` axis. B = 5 does not divide K = 8, so updates carry
    across waves and a wave's last flush lands before its slowest
    arrival. The async arm's server lr is scaled by B/K (FedBuff's
    practice: a wave applies about K/B server steps)."""
    if smoke:
        rounds = min(rounds, 10)
        limits = (1, 4)
    base = dict(clients_per_round=8, local_batch_size=4, local_steps=12,
                client_lr=0.3, server_warmup_rounds=4,
                latency=LatencyConfig(enabled=True, base_s=60.0, spread=0.35))
    server_lr, B = 0.05, 5
    points = []
    for limit in limits:
        lname = f"L{limit if limit is not None else 'inf'}"
        for engine, acfg in (("fedavg", AsyncConfig()),
                             ("async", AsyncConfig(buffer_size=B, staleness_beta=0.5))):
            tag = "sync" if engine == "fedavg" else "async"
            lr = server_lr * (B / base["clients_per_round"] if engine == "async" else 1.0)
            plan = FederatedPlan(**base, data_limit=limit, engine=engine,
                                 server_lr=lr, asynchrony=acfg)
            points.append(SweepPoint(
                id=f"{tag}_{lname}", plan=plan, rounds=rounds, seed=seed,
                meta={"pair": lname, "engine": engine, "limit": limit}))
    return points


# the container-scale ladder's constants (the reference's)
LADDER_BASE = dict(clients_per_round=8, local_batch_size=4, client_lr=0.3,
                   server_lr=0.05, local_steps=12)
LADDER_LIMIT = 8
LADDER_FVN_STD = 0.02
MEAN_CLIENT_EXAMPLES = 24.0          # the tiny corpus's mean utterances


def ladder_rounds(plan: FederatedPlan, rounds: int) -> int:
    """Equal-examples budgets: a data-limited round sees fewer examples,
    so it gets proportionally more rounds (§4.2.1)."""
    if plan.data_limit is None:
        return rounds
    mult = MEAN_CLIENT_EXAMPLES / plan.data_limit
    return int(rounds * max(1.0, min(mult, 5.0)))


def ladder_specs(rounds: int = 100) -> dict:
    """The paper's E0–E10 ladder (Tables 1–5) as plan specs."""
    fvn = lambda std, ramp=0: FVNConfig(enabled=True, std=std, ramp_rounds=ramp)  # noqa: E731
    base = dict(LADDER_BASE, server_warmup_rounds=max(2, rounds // 15))
    ramp = rounds // 2
    decay = dict(server_warmup_rounds=max(2, rounds // 30),
                 server_decay_rounds=max(5, rounds // 4), server_decay_rate=0.85)
    L, STD = LADDER_LIMIT, LADDER_FVN_STD
    return {
        "E0": dict(plan=FederatedPlan(**base, fvn=fvn(STD, ramp)), iid=True),
        "E1": dict(plan=FederatedPlan(**base), iid=False),
        "E2": dict(plan=FederatedPlan(**base, data_limit=L), iid=False),
        "E3": dict(plan=FederatedPlan(**base, data_limit=2 * L), iid=False),
        "E4": dict(plan=FederatedPlan(**base, data_limit=4 * L), iid=False),
        "E5": dict(plan=FederatedPlan(**base, data_limit=L, fvn=fvn(STD / 2)), iid=False),
        "E6": dict(plan=FederatedPlan(**base, data_limit=L, fvn=fvn(STD)), iid=False),
        "E7": dict(plan=FederatedPlan(**base, data_limit=L, fvn=fvn(1.5 * STD, ramp)),
                   iid=False),
        "E8": dict(plan=FederatedPlan(**base, fvn=fvn(1.5 * STD, ramp)), iid=False),
        "E9": dict(plan=FederatedPlan(**{**base, **decay}, data_limit=L,
                                      fvn=fvn(1.5 * STD, ramp)), iid=False),
        "E10": dict(plan=FederatedPlan(**{**base, **decay}, data_limit=L,
                                       fvn=fvn(1.5 * STD, ramp)), iid=False,
                    specaug_scale=2.0),
    }


def ladder_points(rounds: int = 100, smoke: bool = False, seed: int = 0,
                  experiments=None) -> list[SweepPoint]:
    """E0–E10 as SweepPoints with equal-examples budgets and
    budget-scaled FVN ramps and server decays."""
    if smoke:
        rounds = min(rounds, 6)
    specs = ladder_specs(rounds)
    if experiments is not None:
        specs = {e: specs[e] for e in experiments}
    points = []
    for eid, spec in specs.items():
        plan = spec["plan"]
        n_rounds = ladder_rounds(plan, rounds)
        if plan.fvn.enabled and plan.fvn.ramp_rounds:
            plan = dataclasses.replace(
                plan, fvn=dataclasses.replace(plan.fvn, ramp_rounds=n_rounds // 2))
        if plan.server_decay_rounds:
            plan = dataclasses.replace(plan, server_decay_rounds=max(5, n_rounds // 4))
        points.append(SweepPoint(
            id=eid, plan=plan, rounds=n_rounds, iid=spec["iid"],
            specaug_scale=spec.get("specaug_scale", 1.0), seed=seed,
            meta={"experiment": eid}))
    return points


def client_eval_points(rounds: int = 30, smoke: bool = False, seed: int = 0,
                       limits=(1, 4, None)) -> list[SweepPoint]:
    """The non-IID ladder with the per-client plane on (``run_grid`` sets a
    panel of 6 clients, 4 examples each): who pays for a cheap round."""
    if smoke:
        rounds = min(rounds, 6)
    points = []
    for limit in limits:
        plan = FederatedPlan(
            clients_per_round=8, local_batch_size=4, data_limit=limit,
            local_steps=12, client_lr=0.3, server_lr=0.05, server_warmup_rounds=4)
        points.append(SweepPoint(
            id=f"L{limit if limit is not None else 'inf'}",
            plan=plan, rounds=rounds, seed=seed, meta={"limit": limit}))
    return points


GRIDS: Dict[str, Callable[..., list]] = {
    "noniid_fvn": noniid_fvn_points,
    "ladder": ladder_points,
    "compression": compression_points,
    "ef_compression": ef_compression_points,
    "sampling": sampling_points,
    "robustness": robustness_points,
    "async_vs_sync": async_vs_sync_points,
    "client_eval": client_eval_points,
}


def check_robustness(frontier: dict, log=print) -> None:
    """The robustness grid's claim: under sign_flip at rate 0.3 the
    trimmed mean ends at a lower loss than the weighted mean, every row
    carries its corrupted-client count, and the wire bytes are the same
    on every row."""
    rows = {r["id"]: r for r in frontier["points"]}
    wm = rows["weighted_mean_sign_flip_r30"]
    tm = rows["trimmed_mean_sign_flip_r30"]
    log(f"[check] sign_flip@0.3: trimmed_mean loss={tm['final_loss']:.3f} "
        f"vs weighted_mean loss={wm['final_loss']:.3f}")
    assert tm["final_loss"] < wm["final_loss"], (
        "robustness claim failed: trimmed_mean should beat weighted_mean "
        f"under sign_flip at rate 0.3 ({tm['final_loss']:.3f} vs "
        f"{wm['final_loss']:.3f})")
    for r in frontier["points"]:
        assert "corrupted_mean" in r and "wire_bytes_total" in r, r["id"]
        if r["corrupt_rate"] >= 0.3:
            assert r["corrupted_mean"] > 0, (
                f"{r['id']}: adversary at rate {r['corrupt_rate']} never corrupted anyone")
    totals = {r["wire_bytes_total"] for r in frontier["points"]}
    assert len(totals) == 1, f"wire bytes must not vary with the adversary: {totals}"
    log("[check] robustness grid invariants hold")


# Async must end within this factor of the sync final loss at equal CFMQ
# (the reference's bound: its smoke-budget async arm lands at about
# 1.1-1.25x the sync loss; an unscaled server lr diverges to about 1.75x).
ASYNC_LOSS_TOL = 1.3


def check_async_vs_sync(frontier: dict, log=print) -> None:
    """The async engine's claim: at byte-identical CFMQ the buffered
    engine spends less simulated wall-clock than the sync barrier, at a
    comparable loss, on every rung of the ladder."""
    rows = {r["id"]: r for r in frontier["points"]}
    for pair in sorted({r["pair"] for r in frontier["points"]}):
        s, a = rows[f"sync_{pair}"], rows[f"async_{pair}"]
        assert s["sim_time_s"] > 0 and a["sim_time_s"] > 0, (
            f"{pair}: wall-clock axis missing — latency model never priced a round")
        assert a["cfmq_bytes"] == s["cfmq_bytes"], (
            f"{pair}: CFMQ bytes diverged ({a['cfmq_bytes']} vs {s['cfmq_bytes']}) — the pair "
            "no longer isolates wall-clock")
        assert a["wire_bytes_total"] == s["wire_bytes_total"], (
            f"{pair}: wire bytes diverged ({a['wire_bytes_total']} vs "
            f"{s['wire_bytes_total']})")
        assert a["sim_time_s"] < s["sim_time_s"], (
            f"{pair}: async should beat the barrier on simulated seconds "
            f"({a['sim_time_s']:.0f}s vs {s['sim_time_s']:.0f}s) — did the buffer size "
            "become a divisor of K?")
        assert a["final_loss"] <= s["final_loss"] * ASYNC_LOSS_TOL, (
            f"{pair}: async loss {a['final_loss']:.3f} not comparable to sync "
            f"{s['final_loss']:.3f} (tol x{ASYNC_LOSS_TOL})")
        target = s["final_loss"] * 1.05
        t_a = seconds_to_target(a["loss_curve"], a["sim_time_curve"], target)
        t_s = seconds_to_target(s["loss_curve"], s["sim_time_curve"], target)
        log(f"[check] {pair}: async {a['sim_time_s']:.0f}s/"
            f"{a['server_steps_total']:.0f} steps/loss {a['final_loss']:.3f} "
            f"(stale {a['staleness_mean']:.2f}) vs sync "
            f"{s['sim_time_s']:.0f}s/loss {s['final_loss']:.3f}; "
            f"seconds-to-target({target:.3f}): async={t_a} sync={t_s}")
    log("[check] async_vs_sync grid invariants hold")


def check_client_eval(frontier: dict, log=print) -> None:
    """The per-client plane's contract: every row carries a live spread
    (clients tracked, finite p10 <= p90) and per-round per-client curves;
    the ladder's ends order the loss (the limit-1 rung above the
    unlimited one) and the spread (the unlimited, most non-IID rung's
    quality gap above the barely-trained limit-1 rung's)."""
    rows = {r["limit"]: r for r in frontier["points"]}
    for r in frontier["points"]:
        assert r["clients_tracked"] > 0, f"{r['id']}: plane never measured"
        for k in SPREAD_KEYS:
            assert np.isfinite(r[k]), f"{r['id']}: {k} not finite"
        assert r["client_loss_p10"] <= r["client_loss_p90"], r["id"]
        assert r["client_quality_p10"] <= r["client_quality_p90"], r["id"]
        curves = r["client_eval"]
        C = r["clients_tracked"]
        assert len(curves["client_ids"]) == C, r["id"]
        assert len(curves["client_loss"]) == r["rounds"], r["id"]
        assert all(len(c) == C for c in curves["client_loss"]), r["id"]
        assert all(len(c) == C for c in curves["client_quality"]), r["id"]
        log(f"[check] {r['id']}: gap(loss)={r['client_loss_gap']:.3f} "
            f"gap({r['quality_metric']})={r['client_quality_gap']:.3f} "
            f"({C} clients x {r['rounds']} rounds)")
    near_iid, non_iid = rows[1], rows[None]
    assert near_iid["final_loss"] > non_iid["final_loss"], (
        "ladder ordering failed: the limit-1 rung sees 1/24th the data "
        "per round and must end at a higher loss than the unlimited rung "
        f"({near_iid['final_loss']:.3f} vs {non_iid['final_loss']:.3f})")
    assert non_iid["client_quality_gap"] > near_iid["client_quality_gap"], (
        "ladder ordering failed: the unlimited (most non-IID) rung should "
        "spread the panel's quality wider than the barely-trained limit-1 "
        f"rung ({non_iid['client_quality_gap']:.4f} vs "
        f"{near_iid['client_quality_gap']:.4f})")
    log("[check] client_eval grid invariants hold")


GRID_CHECKS: Dict[str, Callable[..., None]] = {
    "robustness": check_robustness,
    "async_vs_sync": check_async_vs_sync,
    "client_eval": check_client_eval,
}


def mark_pareto(rows: list[dict], cost="cfmq_tb", quality="quality") -> list[dict]:
    """Flag the points on the quality/cost pareto front (min both)."""
    for r in rows:
        r["pareto"] = not any(
            (o[cost] <= r[cost] and o[quality] <= r[quality]) and
            (o[cost] < r[cost] or o[quality] < r[quality])
            for o in rows if o is not r)
    return rows


def run_grid(grid: str, rounds: Optional[int] = None, smoke: bool = False, seed: int = 0,
             out: Optional[str] = None, runner: Optional[SweepRunner] = None,
             pad_steps: bool = False, check: bool = False, client_eval: int = 0,
             client_eval_examples: int = 4, plan_overrides: Optional[dict] = None,
             device: Optional[str] = None, log=print, **grid_kwargs) -> dict:
    """Run a named grid and write one quality/cost frontier JSON
    (``results/sweep_<grid>_torch.json`` unless ``out`` says otherwise);
    with ``check`` assert the grid's claim. ``plan_overrides`` replaces the
    named plan fields of every point (``launch/cli.py:plan_overrides``)."""
    kwargs = dict(grid_kwargs, smoke=smoke, seed=seed)
    if rounds is not None:
        kwargs["rounds"] = rounds
    points = GRIDS[grid](**kwargs)
    if plan_overrides:
        log(f"[sweeps] plan overrides: {sorted(plan_overrides)}")
        points = [dataclasses.replace(p, plan=dataclasses.replace(p.plan, **plan_overrides))
                  for p in points]
    if client_eval == 0 and grid == "client_eval":
        client_eval = 6  # the grid exists to exercise the per-client plane
    if runner is None:
        runner = SweepRunner(seed=seed, eval_examples=24 if smoke else 64,
                             pad_steps=pad_steps, client_eval=client_eval,
                             client_eval_examples=client_eval_examples, device=device)
    t0 = time.perf_counter()
    log(f"[sweeps] grid={grid} points={len(points)} rounds={[p.rounds for p in points]}")
    rows = mark_pareto(runner.run(points, log=log))
    frontier = {"grid": grid, "smoke": smoke, "seed": seed, "n_points": len(rows),
                "wall_s": time.perf_counter() - t0, "device": str(runner.device),
                "points": rows}
    out = out or f"results/sweep_{grid}_torch.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(frontier, f, indent=1)
    log(f"[sweeps] frontier ({sum(r['pareto'] for r in rows)} pareto points) -> {out} "
        f"[{frontier['wall_s']:.0f}s]")
    if check:
        checker = GRID_CHECKS.get(grid)
        if checker is None:
            log(f"[sweeps] no --check defined for grid {grid!r}; skipping")
        else:
            checker(frontier, log=log)
    return frontier


def main(argv=None):
    from repro_torch.launch.cli import add_client_eval_args, add_plan_args, plan_overrides

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", default="noniid_fvn", choices=sorted(GRIDS))
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--smoke", action="store_true", help="tiny budget: fewer points and rounds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pad-steps", action="store_true",
                    help="pad every point to the grid's largest local-step count "
                         "(weight-0 steps: the same rows, more time)")
    ap.add_argument("--check", action="store_true",
                    help="assert the grid's claim after the run (robustness, async_vs_sync, "
                         "client_eval)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_plan_args(ap)
    add_client_eval_args(ap)
    args = ap.parse_args(argv)
    return run_grid(args.grid, rounds=args.rounds, smoke=args.smoke, seed=args.seed,
                    out=args.out, pad_steps=args.pad_steps, check=args.check,
                    client_eval=args.client_eval,
                    client_eval_examples=args.client_eval_examples,
                    plan_overrides=plan_overrides(args),
                    device=args.device)


if __name__ == "__main__":
    main()
