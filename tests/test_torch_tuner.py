"""The port's tuning registry (``repro_torch.profile.tuner``): knob
defaults, overrides, device scoping, the file schema (the JAX
package's), the CLI, and the LSTM scan autotuner on the CPU."""

import json

import pytest

from repro.profile import tuner as jtuner
from repro_torch.profile import tuner


@pytest.fixture
def reg(tmp_path):
    return tuner.TuningRegistry(path=str(tmp_path / "tuning_torch.json"), device_key="cpu")


def test_knobs_are_the_lstm_scan_knobs_with_their_defaults(reg):
    assert set(tuner.KNOBS) == {"lstm.scan_dispatch", "lstm.scan_min_seq",
                                "lstm.scan_max_smem_mb"}
    assert reg.get("lstm.scan_dispatch") == "auto"
    assert reg.get("lstm.scan_min_seq") == jtuner.KNOBS["lstm.scan_min_seq"].default == 16
    # the budget admits the paper's H=1152: 16 * 1152**2 bytes = 20.25 MiB
    assert 16 * 1152 ** 2 / 2 ** 20 <= reg.get("lstm.scan_max_smem_mb")
    assert tuner.KNOBS["lstm.scan_dispatch"].choices == ("auto", "kernel", "ref")


def test_override_and_clear(reg):
    assert reg.set_override("lstm.scan_min_seq", "32") == 32
    assert reg.get("lstm.scan_min_seq") == 32
    assert reg.overrides() == {"lstm.scan_min_seq": 32}
    reg.clear_override("lstm.scan_min_seq")
    assert reg.get("lstm.scan_min_seq") == 16 and reg.overrides() == {}


@pytest.mark.parametrize("name,value,error", [
    ("lstm.scan_dispatch", "pallas", ValueError),
    ("lstm.scan_min_seq", 0, ValueError),
    ("lstm.scan_max_smem_mb", -1, ValueError),
    ("lstm.scan_unroll", 2, KeyError),
])
def test_bad_values_and_unknown_knobs_raise(reg, name, value, error):
    with pytest.raises(error):
        reg.set_override(name, value)


def test_overrides_are_scoped_to_their_device_and_persist_in_the_jax_schema(tmp_path):
    path = str(tmp_path / "t.json")
    card = tuner.TuningRegistry(path=path, device_key="cuda_nvidia_h100_80gb_hbm3_sm90")
    card.set_override("lstm.scan_min_seq", 8, persist=True)
    cpu = tuner.TuningRegistry(path=path, device_key="cpu")
    assert cpu.get("lstm.scan_min_seq") == 16
    cpu.set_override("lstm.scan_dispatch", "ref", persist=True)
    doc = json.load(open(path))
    assert doc["schema_version"] == tuner.TUNING_SCHEMA_VERSION == jtuner.TUNING_SCHEMA_VERSION
    assert set(doc["devices"]) == {"cuda_nvidia_h100_80gb_hbm3_sm90", "cpu"}
    assert doc["devices"]["cpu"]["overrides"] == {"lstm.scan_dispatch": "ref"}
    assert doc["devices"]["cpu"]["fingerprint"]["backend"] == "cpu"
    again = tuner.TuningRegistry(path=path, device_key="cuda_nvidia_h100_80gb_hbm3_sm90")
    assert again.get("lstm.scan_min_seq") == 8 and again.get("lstm.scan_dispatch") == "auto"


def test_a_corrupt_or_foreign_file_gives_the_defaults(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tuner.TuningRegistry(path=str(bad), device_key="cpu").get("lstm.scan_min_seq") == 16
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"schema_version": 0, "devices": {"cpu": {
        "overrides": {"lstm.scan_min_seq": 4}}}}))
    assert tuner.TuningRegistry(path=str(old), device_key="cpu").get("lstm.scan_min_seq") == 16


def test_device_key_of_a_card_and_of_the_cpu():
    fp = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3", "capability": "sm90"}
    assert tuner.device_key(fp) == "cuda_nvidia_h100_80gb_hbm3_sm90"
    assert tuner.device_key({"backend": "cpu"}) == "cpu"
    assert tuner.device_key() == tuner.device_key(tuner.device_fingerprint())


def test_env_var_names_the_file_and_get_knob_reads_the_active_registry(tmp_path, monkeypatch):
    path = tmp_path / "env.json"
    monkeypatch.setenv(tuner.ENV_PATH, str(path))
    tuner.set_registry(None)
    try:
        assert tuner.registry().path == str(path)
        tuner.registry().set_override("lstm.scan_dispatch", "kernel")
        assert tuner.get_knob("lstm.scan_dispatch") == "kernel"
    finally:
        tuner.set_registry(None)
    assert tuner.DEFAULT_PATH.endswith("results/tuning_torch.json")


def test_autotune_on_the_cpu_sets_the_min_seq_without_persisting(reg):
    lines = []
    chosen = tuner.autotune_lstm_scan(reg, seq_lens=(2, 3), batch=2, hidden=8, reps=1,
                                      persist=False, device="cpu", log=lines.append)
    assert chosen in (2, 3, 6)
    assert reg.get("lstm.scan_min_seq") == chosen
    assert len(lines) == 3 and "time loop" in lines[0] and "kernel" in lines[0]
    with pytest.raises(FileNotFoundError):
        open(reg.path)


def test_autotune_refuses_to_tune_another_device(reg):
    with pytest.raises(ValueError, match="cannot tune it"):
        tuner.autotune_lstm_scan(reg, seq_lens=(2,), device="cuda")


def test_cli_sets_and_shows(tmp_path, capsys):
    path = str(tmp_path / "cli.json")
    tuner.main(["--path", path, "--set", "lstm.scan_min_seq", "24", "--show"])
    out = capsys.readouterr().out
    assert "lstm.scan_min_seq <- 24" in out and "[override]" in out and "# device cpu" in out
    assert json.load(open(path))["devices"]["cpu"]["overrides"] == {"lstm.scan_min_seq": 24}
