"""The port's example twins (``repro_torch.examples``) against the
repository's ``examples/``: each reference example is run with its one
federated call replaced by a recorder (no JAX round runs), and its plan,
config and call arguments are held field by field to the twin's; then one
round of the port runs through each twin on the CPU. The serve_lm twin's
defaults are the reference's, and it serves a dense architecture and the
VLM on the CPU."""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import noniid_tradeoff, quickstart, serve_lm, train_federated_asr
from repro_torch.launch import sweeps as tsweeps

ROOT = Path(__file__).resolve().parents[1]


class _Called(Exception):
    """Raised by a recorder in place of the call it records."""


def _recorder(log: list):
    def record(*args, **kwargs):
        log.append((args, kwargs))
        raise _Called
    return record


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_recorded(mod, attr: str, monkeypatch, argv=()):
    """The arguments of ``mod.attr``'s one call when ``mod.main()`` runs."""
    log = []
    monkeypatch.setattr(mod, attr, _recorder(log))
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    with pytest.raises(_Called):
        mod.main()
    (call,) = log
    return call


def _as_dict(obj) -> dict:
    """A dataclass's fields, each nested config as a dict."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)}


def _same_fields(got, want, what: str, jax_only=()):
    """Field by field; ``jax_only`` names the reference's fields the port
    has no use for."""
    g, w = _as_dict(got), _as_dict(want)
    assert g.keys() == w.keys() - set(jax_only), what
    for field in g:
        assert g[field] == w[field], (what, field)


def _same_config(got, want):
    """The RNN-T configs: every field but the reference's ``scan_unroll``
    (``lax.scan``'s unroll factor: no scan to unroll in the port)."""
    _same_fields(got, want, "config", jax_only=("scan_unroll",))


def test_quickstart_is_the_reference_plan_and_call(monkeypatch):
    (cfg, corpus, plan), kw = _run_recorded(_reference_example("quickstart"),
                                            "run_federated_asr", monkeypatch)
    (tcfg, tcorpus, tplan), tkw = _run_recorded(quickstart, "run_federated_asr", monkeypatch,
                                                ["--device", "cpu"])
    _same_fields(tplan, plan, "plan")
    _same_config(tcfg, cfg)
    assert np.array_equal(tcorpus.arena_features, corpus.arena_features)
    assert tkw.pop("device") == "cpu" and tkw == kw


@pytest.mark.parametrize("size", ["tiny", "small", "paper"])
def test_train_federated_asr_is_the_reference_plan_and_call(monkeypatch, size):
    """--size paper: the port's configs/rnnt_librispeech.make_config() is
    the reference's registry config; its 2,338-speaker corpus is not built
    (the corpus maker is recorded too)."""
    ref = _reference_example("train_federated_asr")
    argv = ["--size", size, "--rounds", "30", "--data-limit", "3"]
    corpus_kw = []
    if size == "paper":
        for mod in (ref, train_federated_asr):
            monkeypatch.setattr(mod, "make_speaker_corpus",
                                lambda **kw: corpus_kw.append(kw) or "corpus")
    (cfg, _, plan), kw = _run_recorded(ref, "run_federated_asr", monkeypatch, argv)
    (tcfg, _, tplan), tkw = _run_recorded(train_federated_asr, "run_federated_asr",
                                          monkeypatch, [*argv, "--device", "cpu"])
    _same_fields(tplan, plan, "plan")
    _same_config(tcfg, cfg)
    assert tkw.pop("device") == "cpu"
    assert tkw.pop("ckpt_dir") == "results/ckpt_asr_torch" and kw.pop("ckpt_dir")
    assert tkw == kw
    if size == "paper":
        assert corpus_kw[0] == corpus_kw[1]


def test_noniid_tradeoff_is_the_reference_grid_and_call(monkeypatch):
    argv = ["--rounds", "7", "--fvn", "--smoke"]
    (grid,), kw = _run_recorded(_reference_example("noniid_tradeoff"), "run_grid",
                                monkeypatch, argv)
    tkw = noniid_tradeoff.grid_kwargs(noniid_tradeoff.parse_args(argv))
    assert tkw.pop("grid") == grid and tkw.pop("out") and kw.pop("out")
    assert tkw == kw
    from repro.launch.sweeps import GRIDS
    want, got = GRIDS[grid](**kw), tsweeps.GRIDS[grid](**tkw)
    assert [p.meta for p in got] == [p.meta for p in want]
    for g, w in zip(got, want):
        assert g.rounds == w.rounds
        _same_fields(g.plan, w.plan, str(w.meta))


# the port round through each twin runs the twin's own main() at a CPU
# test's cost: its one federated call takes 2 clients and at most 2 local
# steps (and the evaluations 4 examples a split), the rest of the call as
# the twin makes it
SMALL_PLAN = dict(clients_per_round=2, local_steps=2)


@pytest.fixture
def one_thread():
    """One intra-op thread: the tiny RNN-T's many small CPU operations
    slow down by an order of magnitude when the suite's workers share the
    cores with every worker's thread pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _small_run(run):
    def call(cfg, corpus, plan, rounds, **kw):
        return run(cfg, corpus, dataclasses.replace(plan, **SMALL_PLAN), rounds,
                   **dict(kw, eval_examples=4))
    return call


@pytest.mark.parametrize("twin", ["quickstart", "train_federated_asr", "noniid_tradeoff"])
def test_each_twin_runs_a_port_round_on_the_cpu(twin, tmp_path, monkeypatch, one_thread):
    if twin == "quickstart":
        monkeypatch.setattr(quickstart, "run_federated_asr",
                            _small_run(quickstart.run_federated_asr))
        hist = quickstart.main(["--rounds", "1", "--device", "cpu"])
        assert hist["rounds"] == 1 and np.isfinite(hist["final_loss"])
        assert hist["quality_metric"] == "wer" and 0.0 <= hist["quality"]
    elif twin == "train_federated_asr":
        monkeypatch.setattr(train_federated_asr, "run_federated_asr",
                            _small_run(train_federated_asr.run_federated_asr))
        out = tmp_path / "asr.json"
        hist = train_federated_asr.main(["--rounds", "1", "--device", "cpu", "--ckpt-dir",
                                         str(tmp_path / "ckpt"), "--out", str(out)])
        assert json.loads(out.read_text())["final_loss"] == hist["final_loss"]
        assert any((tmp_path / "ckpt").iterdir())
    else:
        run_grid = noniid_tradeoff.run_grid
        runner = tsweeps.SweepRunner(eval_examples=4, device="cpu")
        monkeypatch.setattr(noniid_tradeoff, "run_grid", lambda **kw: run_grid(
            **kw, plan_overrides=SMALL_PLAN, runner=runner))
        frontier = noniid_tradeoff.main(["--smoke", "--rounds", "1", "--device", "cpu",
                                         "--out", str(tmp_path / "tradeoff.json")])
        assert frontier["n_points"] == 3 and (tmp_path / "tradeoff.json").exists()
        assert all(np.isfinite(p["final_loss"]) for p in frontier["points"])


def test_serve_lm_defaults_are_the_references(monkeypatch):
    """Both examples resolve the same --arch by default (the registry lookup
    recorded in place of the serve)."""
    (arch,), _ = _run_recorded(_reference_example("serve_lm"), "get_arch", monkeypatch)
    (tarch,), _ = _run_recorded(serve_lm, "get_arch", monkeypatch, ["--device", "cpu"])
    assert tarch == arch == "qwen3-8b"


@pytest.mark.parametrize("arch", ["gemma3-4b", "llava-next-mistral-7b"])
def test_serve_lm_serves_on_the_cpu(arch, capsys):
    """A prompt of 4 tokens decoded token by token, then 6 greedy steps, at
    the smoke config: gemma3's local and global layers, the VLM's text-only
    decode."""
    out = serve_lm.main(["--arch", arch, "--batch", "2", "--prompt-len", "4", "--tokens", "6",
                         "--device", "cpu"])
    vocab = 128  # both smoke configs'
    assert out["tokens"].shape == (2, 6) and ((0 <= out["tokens"]) & (out["tokens"] < vocab)).all()
    assert out["last_logits"].shape == (2, vocab) and torch.isfinite(out["last_logits"]).all()
    assert out["logits"].shape == (10, 2, vocab) and torch.equal(out["logits"][-1],
                                                                  out["last_logits"])
    assert f"arch={arch} (smoke config" in capsys.readouterr().out
