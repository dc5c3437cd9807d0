"""The port's training driver: a tiny CPU run end to end, its summary
row (the JAX package's schema, WER as the quality), evaluation during
and after training, no quiet CPU fallback, and no plan setting off the
parity plane that runs anyway: what an engine cannot run raises when the
engine is built, the server plane's settings, the other server
optimizers, the fedsgd and async engines and the label-shuffle adversary
build and run."""

import dataclasses
import json
import math

import jax
import pytest
import torch

from repro.core.compression import CompressionConfig as JaxCompression
from repro.core.compression import client_wire_bytes as jax_client_wire_bytes
from repro.core.metrics import SUMMARY_KEYS as JAX_SUMMARY_KEYS
from repro.models import rnnt as jrnnt
from repro_torch.core.cohort import LatencyConfig
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.corruption import CorruptionConfig
from repro_torch.core.metrics import SUMMARY_KEYS
from repro_torch.core.plan import AggregatorConfig, AsyncConfig, CohortConfig, FederatedPlan
from repro_torch.core.task import get_task
from repro_torch.data import pack_round
from repro_torch.launch import train


def test_two_tiny_rounds_on_the_cpu_give_finite_losses():
    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=2,
                         client_lr=0.05, server_lr=0.01)
    state, hist = train.run_federated(task, task.make_corpus(0), plan, rounds=2, device="cpu",
                                      log=lambda *_: None)
    assert len(hist["loss"]) == 2 and all(math.isfinite(x) for x in hist["loss"])
    assert state.round_idx == 2
    n = hist["n_params"]
    assert hist["uplink_bytes_client"] == 4 * n
    assert hist["wire_bytes_total"] == 2 * (2 * 4 * n + 2 * 4 * n)
    assert hist["cfmq_bytes"] > 0


def test_main_runs_the_tiny_preset_on_the_cpu(capsys):
    hist = train.main(["--preset", "tiny", "--rounds", "1", "--clients", "2", "--batch", "2",
                       "--data-limit", "2", "--fvn-std", "0.01", "--device", "cpu"])
    assert math.isfinite(hist["final_loss"])
    summary = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert summary["task"] == "asr-rnnt" and summary["device"] == "cpu"


def test_arch_preset_resolves_as_the_reference_but_for_the_paper_model():
    """--preset arch --arch <id> is arch_task(<id>), the registry's smoke
    config on the shared corpus, as in the reference; the default id,
    rnnt-librispeech, stays the paper-width task (the port's departure);
    --task wins over both."""
    def task(*argv):
        return train.resolve_task(train.parse_args(list(argv)))

    gemma = task("--preset", "arch", "--arch", "gemma3-4b")
    assert (gemma.name, gemma.kind, gemma.config.name) == ("gemma3-4b", "dense", "gemma3-4b-smoke")
    paper = task("--preset", "arch")
    assert paper.config == get_task("rnnt-librispeech").config and paper.config.enc_hidden == 1152
    assert task("--preset", "tiny", "--arch", "gemma3-4b").name == "asr-rnnt"
    assert task("--task", "keyword", "--preset", "arch", "--arch", "gemma3-4b").name == "keyword"
    with pytest.raises(ValueError, match="model kind 'vlm'"):
        task("--preset", "arch", "--arch", "llava-next-mistral-7b")
    with pytest.raises(KeyError, match="unknown arch"):
        task("--preset", "arch", "--arch", "gpt-5")


def test_main_trains_an_arch_smoke_config_on_the_cpu(capsys):
    hist = train.main(["--preset", "arch", "--arch", "command-r-35b", "--rounds", "1",
                       "--clients", "2", "--batch", "2", "--data-limit", "2", "--device", "cpu",
                       "--eval-every", "0"])
    assert math.isfinite(hist["final_loss"]) and hist["quality_metric"] == "ppl"
    summary = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert summary["task"] == "command-r-35b"


def test_no_device_means_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = get_task("asr-rnnt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_federated(task, task.make_corpus(0), FederatedPlan(), rounds=1)


def test_evaluation_is_refused_until_it_is_ported():
    """Greedy decoding and WER are ported: eval_every > 0 decodes the
    eval splits at those rounds and logs the WER line of
    ``repro/launch/train.py:229-233``."""
    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=2)
    lines = []
    _, hist = train.run_federated(task, task.make_corpus(0), plan, rounds=2, device="cpu",
                                  eval_every=1, eval_examples=2, log=lines.append)
    wer_lines = [line for line in lines if " wer=" in line and " wer_hard=" in line]
    assert [line.split(":")[0] for line in wer_lines] == ["round 1", "round 2"]
    assert math.isfinite(hist["quality"]) and hist["quality"] >= 0


def test_no_final_decode_without_eval_examples(monkeypatch):
    """eval_examples=0 skips the final decode: the WER fields are NaN."""
    task = get_task("asr-rnnt")
    monkeypatch.setattr(type(task), "evaluate", lambda *a, **k: pytest.fail("decoded"))
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=2)
    _, hist = train.run_federated(task, task.make_corpus(0), plan, rounds=1, device="cpu",
                                  eval_examples=0, log=lambda *_: None)
    assert math.isnan(hist["quality"]) and math.isnan(hist["quality_hard"])
    assert math.isfinite(hist["final_loss"])


def test_history_is_a_summary_row_with_wer():
    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=2)
    _, hist = train.run_federated(task, task.make_corpus(0), plan, rounds=1, device="cpu",
                                  eval_examples=3, log=lambda *_: None)
    assert SUMMARY_KEYS == JAX_SUMMARY_KEYS
    assert list(hist)[:len(SUMMARY_KEYS)] == list(SUMMARY_KEYS)
    assert hist["quality_metric"] == "wer"
    assert hist["quality"] >= 0 and hist["quality_hard"] >= 0
    assert hist["participants_mean"] == 2.0 and hist["clients_tracked"] == 0
    assert hist["server_steps_total"] == 1.0 and hist["corrupted_total"] == 0
    assert len(hist["loss"]) == len(hist["round_s"]) == 1 and hist["eval_s"] > 0


@pytest.mark.parametrize("setting", [
    ({"engine": "async", "asynchrony": AsyncConfig(buffer_size=-1)}, "buffer_size"),
    ({"engine": "async", "asynchrony": AsyncConfig(staleness_beta=-1.0)}, "staleness_beta"),
    ({"engine": "fedsgd", "aggregation": AggregatorConfig(name="trimmed_mean")}, "fedsgd"),
])
def test_every_non_parity_plan_setting_raises(setting):
    """Every plan setting is ported since the async engine was; what an
    engine cannot run raises, with the reference's reason, when the
    driver builds the engine, before any round."""
    setting, match = setting
    task = get_task("asr-rnnt")
    with pytest.raises(ValueError, match=match):
        train.run_federated(task, task.make_corpus(0), FederatedPlan(**setting), rounds=1,
                            device="cpu", log=lambda *_: None)


@pytest.mark.parametrize("setting", [
    {"cohort": CohortConfig(participation=0.5)},
    {"cohort": CohortConfig(straggler_frac=0.5, straggler_keep=0.5)},
    {"aggregation": AggregatorConfig(name="trimmed_mean", trim_frac=0.25)},
    {"corruption": CorruptionConfig(kind="sign_flip", rate=0.5, scale=3.0)},
    {"latency": LatencyConfig(enabled=True)},
    {"server_optimizer": "momentum"},
    {"server_optimizer": "yogi"},
    {"engine": "fedsgd"},
    {"corruption": CorruptionConfig(kind="label_shuffle", rate=0.5)},
    {"engine": "async", "asynchrony": AsyncConfig(buffer_size=3),
     "latency": LatencyConfig(enabled=True)},
], ids=["participation", "stragglers", "trimmed_mean", "sign_flip", "latency", "momentum",
        "yogi", "fedsgd", "label_shuffle", "async"])
def test_a_server_plane_setting_builds_and_runs(setting):
    """The server plane's settings, the momentum and yogi servers, the
    fedsgd engine and the label-shuffle adversary are ported: the plan
    builds and a tiny round runs on the CPU with finite losses and the
    plane's metrics."""
    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=4, local_batch_size=2, data_limit=2, **setting)
    _, hist = train.run_federated(task, task.make_corpus(0), plan, rounds=1, device="cpu",
                                  eval_examples=0, log=lambda *_: None)
    assert all(math.isfinite(x) for x in hist["loss"])
    assert 1.0 <= hist["participants_mean"] <= 4.0
    assert (hist["sim_time_s"] > 0) == plan.latency.enabled
    assert hist["corrupted_total"] <= hist["participants_mean"]


def test_the_plane_configs_are_configs():
    for name in ("cohort", "aggregation", "corruption", "latency"):
        with pytest.raises(TypeError, match=name):
            FederatedPlan(**{name: "x"})
    with pytest.raises(ValueError, match="unknown aggregator"):
        FederatedPlan(aggregation=AggregatorConfig(name="mean"))


def test_server_plane_flags_build_the_plan():
    """The reference's flags (``repro/launch/cli.py:83-125``) build the
    nested configs, and their defaults are the paper's plane."""
    args = train.parse_args([
        "--participation", "0.75", "--straggler-frac", "0.5", "--straggler-keep", "0.25",
        "--aggregator", "clipped_mean", "--trim-frac", "0.3", "--dp-clip", "2.0",
        "--dp-sigma", "0.01", "--corrupt-kind", "gaussian", "--corrupt-rate", "0.25",
        "--corrupt-scale", "5", "--latency", "--latency-base-s", "30", "--latency-spread",
        "0.5"])
    plan = train.build_plan(args)
    assert plan.cohort == CohortConfig(0.75, 0.5, 0.25)
    assert plan.aggregation == AggregatorConfig("clipped_mean", 0.3, 2.0, 0.01)
    assert plan.corruption == CorruptionConfig("gaussian", 0.25, 5.0)
    assert plan.latency == LatencyConfig(enabled=True, base_s=30.0, spread=0.5)
    base = train.build_plan(train.parse_args([]))
    assert base.cohort.full and base.aggregation == AggregatorConfig()
    assert base.corruption == CorruptionConfig() and not base.latency.enabled
    for bad in (["--aggregator", "mean"], ["--corrupt-kind", "flip"]):
        with pytest.raises(SystemExit):
            train.parse_args(bad)
    shuffled = train.build_plan(train.parse_args(["--corrupt-kind", "label_shuffle",
                                                  "--corrupt-rate", "0.5"]))
    assert shuffled.corruption == CorruptionConfig("label_shuffle", 0.5, 1.0)
    assert train.build_plan(train.parse_args(["--engine", "fedsgd"])).engine == "fedsgd"
    assert train.parse_args(["--iid"]).iid and base.engine == "fedavg"
    asyn = train.build_plan(train.parse_args(["--engine", "async", "--buffer-size", "3",
                                              "--staleness-beta", "2"]))
    assert asyn.engine == "async" and asyn.asynchrony == AsyncConfig(3, 2.0)
    assert base.asynchrony == AsyncConfig()


def test_the_slow_path_cli_runs_two_tiny_rounds_on_the_cpu(capsys):
    """The command a user of the robustness plane runs: participants and
    corrupted clients are the drawn ones, and the uplink counts only the
    participants at the packed int4 bytes."""
    hist = train.main(["--task", "asr-rnnt", "--aggregator", "trimmed_mean", "--corrupt-kind",
                       "sign_flip", "--corrupt-rate", "0.25", "--participation", "0.75",
                       "--compression", "int4", "--packed-wire", "--device", "cpu",
                       "--rounds", "2", "--clients", "4", "--batch", "2", "--data-limit", "2",
                       "--eval-every", "0"])
    assert all(math.isfinite(x) for x in hist["loss"])
    up = hist["uplink_bytes_client"]
    assert hist["uplink_bytes_total"] == round(hist["participants_mean"] * 2) * up
    assert hist["participants_mean"] < 4.0 and hist["corrupted_total"] >= 0
    summary = json.loads(capsys.readouterr().out.split("\n", 2)[2])
    assert summary["participants_mean"] == hist["participants_mean"]


def test_the_slow_path_cli_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--task", "asr-rnnt", "--aggregator", "trimmed_mean", "--corrupt-kind",
                    "sign_flip", "--corrupt-rate", "0.25", "--participation", "0.75",
                    "--compression", "int4", "--packed-wire", "--rounds", "1"])


def test_compression_is_a_config_of_its_own():
    """The uplink compression is ported: a plan takes a CompressionConfig
    (as the reference's does) and refuses anything else."""
    for kw in (dict(kind="int8"), dict(kind="int4", packed=True, error_feedback=True),
               dict(kind="topk", topk_frac=0.1), dict(kind="int8", stochastic=False)):
        assert FederatedPlan(compression=CompressionConfig(**kw)).compression.kind == kw["kind"]
    assert FederatedPlan().compression == CompressionConfig()
    with pytest.raises(TypeError, match="CompressionConfig"):
        FederatedPlan(compression="int8")


def test_compression_flags_build_the_plan():
    args = train.parse_args(["--compression", "topk", "--topk-frac", "0.1", "--packed-wire",
                             "--error-feedback"])
    assert train.build_plan(args).compression == CompressionConfig(
        kind="topk", topk_frac=0.1, packed=True, error_feedback=True)
    assert train.build_plan(train.parse_args([])).compression == CompressionConfig()
    with pytest.raises(SystemExit):
        train.parse_args(["--compression", "int2"])


def test_a_compressed_cpu_run_reports_jax_wire_bytes(capsys):
    """--compression int4 --packed-wire: the uplink per client is JAX's
    count for the same model, the totals follow from it, and CFMQ prices
    the measured payload."""
    hist = train.main(["--preset", "tiny", "--rounds", "2", "--clients", "2", "--batch", "2",
                       "--data-limit", "2", "--device", "cpu", "--eval-every", "0",
                       "--compression", "int4", "--packed-wire"])
    tcfg = get_task("asr-rnnt").config
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"})
    shapes = jax.eval_shape(lambda: jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))
    up = jax_client_wire_bytes(JaxCompression(kind="int4", packed=True), shapes)
    n = hist["n_params"]
    assert hist["uplink_bytes_client"] == up < 4 * n
    assert hist["uplink_bytes_total"] == 2 * 2 * up
    assert hist["wire_bytes_total"] == 2 * (2 * 4 * n + 2 * up)
    assert hist["payload_bytes"] == (2 * 4 * n + 2 * up) / 2
    assert all(math.isfinite(x) for x in hist["loss"])


def test_the_iid_cli_runs_two_tiny_rounds_on_the_cpu(capsys, monkeypatch):
    """--iid, the E0 baseline's command: the driver packs both rounds from
    the shuffled global pool, every client reporting its full S·b."""
    packed = []
    monkeypatch.setattr(train, "pack_round", lambda *a: packed.append(a[1:]) or pack_round(*a))
    hist = train.main(["--task", "asr-rnnt", "--device", "cpu", "--rounds", "2", "--clients",
                       "3", "--batch", "2", "--data-limit", "2", "--eval-every", "0", "--iid"])
    assert all(math.isfinite(x) for x in hist["loss"]) and hist["participants_mean"] == 3.0
    assert hist["examples"] == [6.0, 6.0] and hist["corrupted_total"] == 0
    assert packed == [(3, 1, 2)] * 2
    summary = json.loads(capsys.readouterr().out.split("\n", 2)[2])
    assert summary["participants_mean"] == hist["participants_mean"]


def test_tiny_asr_setup_is_the_references_config_and_corpus():
    """The config-first pieces: the asr-rnnt task's config (the reference's
    fields; ``scan_unroll`` is the JAX scan's own) and its corpus's arenas
    bitwise."""
    import numpy as np

    from repro.launch.train import tiny_asr_setup as jax_tiny_asr_setup

    cfg, corpus = train.tiny_asr_setup(0)
    jcfg, jcorpus = jax_tiny_asr_setup(0)
    assert cfg == get_task("asr-rnnt").config
    want = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "scan_unroll"}
    assert dataclasses.asdict(cfg) == want
    for name in ("arena_features", "arena_frame_len", "arena_labels", "arena_label_len"):
        np.testing.assert_array_equal(getattr(corpus, name), getattr(jcorpus, name))


def test_run_federated_asr_is_run_federated_on_the_configs_task():
    """One tiny round through the config-first entry point gives the task
    driver's row bit for bit; its IID label-shuffle refusal is the
    driver's."""
    cfg, corpus = train.tiny_asr_setup(0)
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=2)
    kw = dict(seed=0, device="cpu", eval_examples=0, log=lambda *_: None)
    _, got = train.run_federated_asr(cfg, corpus, plan, 1, **kw)
    _, want = train.run_federated(get_task("asr-rnnt"), corpus, plan, 1, **kw)
    assert got["loss"] == want["loss"] and got["cfmq_bytes"] == want["cfmq_bytes"]
    shuffled = dataclasses.replace(plan, corruption=CorruptionConfig(kind="label_shuffle",
                                                                     rate=0.5))
    with pytest.raises(ValueError, match="bypasses the sampler"):
        train.run_federated_asr(cfg, corpus, shuffled, 1, iid=True, **kw)
