"""The port's sweep runner and shared CLI against ``repro.launch.sweeps``
and ``repro.launch.cli``: every grid's points, smoke and full, field by
field; ``mark_pareto`` and the three checks' verdicts on the same
synthetic frontiers; weight-0 padded steps as exact no-ops (the padded
round batch bitwise the reference's, a padded point's row the unpadded
one's); one tiny ``run_point`` row of each engine of the async_vs_sync
pair from JAX's parameters against the reference's (exact fields equal,
losses within LOSS_RTOL, simulated seconds within LATENCY_RTOL); one
single-point ``run_grid``; the flag inventories and the plans their
flags build."""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest

from repro.core import get_task as jax_get_task
from repro.core.task import default_corpus as jax_default_corpus
from repro.data import FederatedSampler as JaxSampler
from repro.launch import cli as jcli
from repro.launch import sweeps as jsweeps
from repro_torch.convert import params_from_jax
from repro_torch.core.task import FederatedTask, default_corpus, get_task
from repro_torch.data import FederatedSampler
from repro_torch.launch import cli, sweeps, train

LOSS_RTOL = 1e-4     # a round's fp32 loss after local SGD steps, two packages
LATENCY_RTOL = 1e-5  # simulated seconds: exp(spread * normal), normal held to 1e-5
QUIET = dict(log=lambda *a, **k: None)


def _as_dict(obj) -> dict:
    """A plan (or point) with every nested config as a plain dict."""
    return {f.name: (_as_dict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("grid", sorted(jsweeps.GRIDS))
def test_every_grid_equals_the_reference_point_by_point(grid, smoke):
    want = jsweeps.GRIDS[grid](smoke=smoke, seed=3)
    got = sweeps.GRIDS[grid](smoke=smoke, seed=3)
    assert [p.id for p in got] == [p.id for p in want] and len(got) > 0
    for g, w in zip(got, want):
        assert _as_dict(g) == _as_dict(w), g.id


def test_the_grid_registry_checks_and_ladder_constants_are_the_reference():
    assert list(sweeps.GRIDS) == list(jsweeps.GRIDS)
    assert list(sweeps.GRID_CHECKS) == list(jsweeps.GRID_CHECKS)
    assert sweeps.ASYNC_LOSS_TOL == jsweeps.ASYNC_LOSS_TOL
    assert sweeps.LADDER_BASE == jsweeps.LADDER_BASE
    for rounds in (6, 100):
        got, want = sweeps.ladder_specs(rounds), jsweeps.ladder_specs(rounds)
        assert got.keys() == want.keys()
        for k in want:
            assert _as_dict(got[k]["plan"]) == _as_dict(want[k]["plan"]), k
            assert sweeps.ladder_rounds(got[k]["plan"], rounds) == \
                jsweeps.ladder_rounds(want[k]["plan"], rounds)


def _rows(seed: int, n: int = 7):
    r = np.random.default_rng(seed)
    return [{"id": f"p{i}", "cfmq_tb": float(c), "quality": float(q)}
            for i, (c, q) in enumerate(zip(r.integers(0, 4, n), r.integers(0, 4, n)))]


@pytest.mark.parametrize("seed", range(4))
def test_mark_pareto_equals_the_reference(seed):
    got = [r["pareto"] for r in sweeps.mark_pareto(_rows(seed))]
    assert got == [r["pareto"] for r in jsweeps.mark_pareto(_rows(seed))]
    assert any(got)


def _verdict(check, frontier) -> str:
    try:
        check(json.loads(json.dumps(frontier)), **QUIET)
    except AssertionError as e:
        return f"fails: {str(e).split(':')[0]}"
    return "holds"


def _robustness(**moves):
    rows = [dict(id=f"{agg}_{kind}_r{r}", final_loss=loss, corrupted_mean=c,
                 wire_bytes_total=100, corrupt_rate=r / 100)
            for agg, kind, r, loss, c in (("weighted_mean", "none", 0, 1.0, 0.0),
                                          ("weighted_mean", "sign_flip", 30, 3.0, 2.0),
                                          ("trimmed_mean", "sign_flip", 30, 1.5, 2.5))]
    for row_id, field, value in moves.get("edits", ()):
        next(r for r in rows if r["id"] == row_id)[field] = value
    return {"points": rows}


def _async_pair(**edits):
    rows = []
    for pair in ("L1", "L4"):
        for tag, sim, loss in (("sync", 600.0, 2.0), ("async", 400.0, 2.2)):
            rows.append(dict(id=f"{tag}_{pair}", pair=pair, sim_time_s=sim, final_loss=loss,
                             cfmq_bytes=1e6, wire_bytes_total=500, server_steps_total=16.0,
                             staleness_mean=0.5, loss_curve=[3.0, loss],
                             sim_time_curve=[sim / 2, sim / 2]))
    for row_id, field, value in edits.get("edits", ()):
        next(r for r in rows if r["id"] == row_id)[field] = value
    return {"points": rows}


def _client_eval(**edits):
    rows = []
    for limit, loss, gap in ((1, 3.0, 0.1), (4, 2.5, 0.3), (None, 2.0, 0.5)):
        spread = dict(client_loss_p10=1.0, client_loss_p90=2.0, client_loss_gap=1.0,
                      client_quality_p10=0.5, client_quality_p90=0.5 + gap,
                      client_quality_gap=gap, clients_tracked=2)
        rows.append(dict(id=f"L{limit}", limit=limit, final_loss=loss, rounds=2,
                         quality_metric="wer", **spread,
                         client_eval={"client_ids": [0, 5], "client_loss": [[1, 2], [1, 2]],
                                      "client_quality": [[0, 1], [0, 1]]}))
    for limit, field, value in edits.get("edits", ()):
        next(r for r in rows if r["limit"] == limit)[field] = value
    return {"points": rows}


FRONTIERS = {
    "robustness": (_robustness, [
        [], [("trimmed_mean_sign_flip_r30", "final_loss", 3.5)],
        [("weighted_mean_sign_flip_r30", "corrupted_mean", 0.0)],
        [("weighted_mean_none_r0", "wire_bytes_total", 101)]]),
    "async_vs_sync": (_async_pair, [
        [], [("async_L4", "sim_time_s", 601.0)], [("async_L1", "final_loss", 2.7)],
        [("async_L1", "cfmq_bytes", 2e6)], [("async_L4", "wire_bytes_total", 501)],
        [("sync_L1", "sim_time_s", 0.0)]]),
    "client_eval": (_client_eval, [
        [], [(1, "final_loss", 1.0)], [(None, "client_quality_gap", 0.05)],
        [(4, "client_loss_p10", 3.0)], [(4, "clients_tracked", 0)],
        [(None, "client_quality_p10", float("nan"))]]),
}


@pytest.mark.parametrize("grid,case", [(g, i) for g, (_, cases) in FRONTIERS.items()
                                       for i in range(len(cases))])
def test_the_checks_give_the_reference_verdicts(grid, case):
    make, cases = FRONTIERS[grid]
    frontier = make(edits=cases[case])
    got = _verdict(sweeps.GRID_CHECKS[grid], frontier)
    assert got == _verdict(jsweeps.GRID_CHECKS[grid], frontier)
    assert (got == "holds") == (case == 0)


def test_a_padded_round_batch_and_a_forced_step_count_are_the_reference():
    jc, tc = jax_default_corpus(0), default_corpus(0)
    kw = dict(clients_per_round=3, local_batch_size=2, data_limit=3, seed=4, steps=5)
    j, t = JaxSampler(jc, **kw), FederatedSampler(tc, **kw)
    assert t.steps == j.steps == 5
    for _ in range(2):
        want, got = j.next_round().pad_steps(7), t.next_round().pad_steps(7)
        for k, w in dataclasses.asdict(want).items():
            np.testing.assert_array_equal(getattr(got, k), w, err_msg=k)
    assert got.pad_steps(3) is got


@pytest.fixture(scope="module")
def tiny_runner():
    """The port's runner on the tiny task, its parameters JAX's."""
    jtask = jax_get_task("asr-rnnt")
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)  # as the reference's run_point
    try:
        params0 = params_from_jax(jax.tree.map(np.asarray, jtask.bundle.init(
            jax.random.PRNGKey(0))))
    finally:
        jax.config.update("jax_threefry_partitionable", before)

    class FromReference(FederatedTask):
        def init_params(self, generator):
            return {k: v.clone() for k, v in params0.items()}

    tiny = get_task("asr-rnnt")
    return jtask, FromReference(tiny.name, tiny.config, tiny.make_corpus)


def _tiny(points):
    """The async_vs_sync pair at a tiny budget: K = 3, b = 2, 2 local steps,
    2 rounds, the async buffer 2 (of either package's points)."""
    return [dataclasses.replace(p, rounds=2, plan=dataclasses.replace(
        p.plan, clients_per_round=3, local_batch_size=2, local_steps=2,
        asynchrony=dataclasses.replace(p.plan.asynchrony,
                                       buffer_size=min(p.plan.asynchrony.buffer_size, 2))))
        for p in points]


def _tiny_points():
    return _tiny(sweeps.async_vs_sync_points(smoke=True))


EXACT = ("rounds", "quality_metric", "clients_tracked", "cfmq_tb", "cfmq_bytes",
         "payload_bytes", "uplink_bytes_client", "uplink_bytes_total", "wire_bytes_total",
         "downlink_bytes_round", "participants_mean", "corrupted_mean", "corrupted_total",
         "n_params", "server_steps_total", "staleness_mean", "id", "pair", "engine", "limit")


@pytest.mark.parametrize("which", [0, 1], ids=["sync", "async"])
def test_a_tiny_run_point_row_matches_the_reference(tiny_runner, which):
    jtask, task = tiny_runner
    point = _tiny_points()[which]
    jpoint = _tiny(jsweeps.async_vs_sync_points(smoke=True))[which]
    assert _as_dict(point) == _as_dict(jpoint)
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        want = jsweeps.SweepRunner(task=jtask, corpus=jax_default_corpus(0), eval_examples=3,
                                   prefetch=False).run_point(jpoint, **QUIET)
    finally:
        jax.config.update("jax_threefry_partitionable", before)
    got = sweeps.SweepRunner(task=task, corpus=default_corpus(0), eval_examples=3,
                             device="cpu").run_point(point, **QUIET)
    assert list(got) == list(want)
    for k in EXACT:
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["loss_curve"], want["loss_curve"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["sim_time_curve"], want["sim_time_curve"], rtol=LATENCY_RTOL)
    np.testing.assert_allclose(got["sim_time_s"], want["sim_time_s"], rtol=LATENCY_RTOL)
    assert got["sim_time_s"] > 0 and math.isfinite(got["quality"])
    if which:  # the async arm: its B = 2 buffer flushed more than once a wave
        assert got["server_steps_total"] > point.rounds


def test_padded_steps_leave_a_row_as_it_was(tiny_runner):
    """A point padded to more local steps than it needs (weight-0 steps)
    gives the unpadded point's row but for its wall time."""
    _, task = tiny_runner
    point = dataclasses.replace(_tiny_points()[1], plan=dataclasses.replace(
        _tiny_points()[1].plan, data_limit=2))
    runner = sweeps.SweepRunner(task=task, corpus=default_corpus(0), eval_examples=2,
                                device="cpu")
    assert runner.native_steps(point.plan) == 1
    plain = runner.run_point(point, **QUIET)
    padded = runner.run_point(point, steps=3, **QUIET)
    for k in plain:
        if k != "wall_s":
            assert padded[k] == plain[k], k


def test_a_single_point_grid_runs_and_writes_its_frontier(tmp_path):
    out = tmp_path / "frontier.json"
    frontier = sweeps.run_grid("client_eval", rounds=1, smoke=True, limits=(1,), out=str(out),
                               device="cpu", **QUIET)
    with open(out) as f:
        assert json.load(f)["points"][0]["id"] == "L1"
    (row,) = frontier["points"]
    assert frontier["n_points"] == 1 and row["pareto"] and row["clients_tracked"] == 6
    assert np.asarray(row["client_eval"]["client_loss"]).shape == (1, 6)
    assert row["client_quality_p10"] <= row["client_quality_p90"]


def _help_flags(capsys, parse) -> set:
    with pytest.raises(SystemExit):
        parse(["--help"])
    return {w.rstrip(",") for w in capsys.readouterr().out.split() if w.startswith("--")}


def test_the_flag_inventories_are_the_reference(capsys):
    assert cli.PLAN_FLAGS == jcli.PLAN_FLAGS
    assert cli.CLIENT_EVAL_FLAGS == jcli.CLIENT_EVAL_FLAGS
    shared = set(cli.PLAN_FLAGS) | set(cli.CLIENT_EVAL_FLAGS)
    assert shared <= _help_flags(capsys, train.parse_args)
    assert shared <= _help_flags(capsys, sweeps.main)
    assert not {"--population", "--mesh-clients"} & _help_flags(capsys, sweeps.main)


ARGV = ["--engine", "async", "--buffer-size", "3", "--staleness-beta", "2", "--latency",
        "--latency-base-s", "30", "--latency-spread", "0.5", "--aggregator", "trimmed_mean",
        "--trim-frac", "0.3", "--compression", "int4", "--packed-wire", "--error-feedback",
        "--participation", "0.75", "--straggler-frac", "0.25", "--straggler-keep", "0.5",
        "--corrupt-kind", "sign_flip", "--corrupt-rate", "0.25", "--corrupt-scale", "3"]


@pytest.mark.parametrize("argv", [[], ARGV, ["--dp-clip", "2", "--topk-frac", "0.1"]])
def test_plan_kwargs_and_overrides_build_the_reference_plans(argv):
    import argparse

    from repro.core import FederatedPlan as JaxPlan
    from repro_torch.core.plan import FederatedPlan

    def parse(builders, argv):
        ap = argparse.ArgumentParser()
        for b in builders:
            b(ap)
        return ap.parse_args(argv)

    args = parse([cli.add_plan_args, cli.add_client_eval_args], argv)
    jargs = parse([jcli.add_plan_args, jcli.add_client_eval_args], argv)
    assert vars(args) == vars(jargs)
    got = FederatedPlan(clients_per_round=4, **cli.plan_kwargs(args))
    want = JaxPlan(clients_per_round=4, **jcli.plan_kwargs(jargs))
    assert _as_dict(got) == _as_dict(want)
    assert sorted(cli.plan_overrides(args)) == sorted(jcli.plan_overrides(jargs))
