"""The port stands alone: no file of ``src/repro_torch/``, not
``chip_smoke.py`` and no script of ``tools/`` imports jax or the JAX
package ``repro``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "tools").glob("*.py"))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_port_has_files_to_check():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("module", ["core/keys.py", "kernels/wire_pack.py",
                                    "core/compression.py", "core/cohort.py",
                                    "core/aggregation.py", "core/corruption.py"])
def test_the_compression_plane_is_walked(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", ["models/attention.py", "models/encdec.py",
                                    "models/model_zoo.py", "kernels/flash_attention.py",
                                    "kernels/decode_attention.py", "configs/whisper_base.py"])
def test_the_serving_path_is_walked(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", ["core/async_engine.py", "core/clienteval.py",
                                    "checkpoint/checkpointer.py", "launch/cli.py",
                                    "launch/sweeps.py", "launch/train.py"])
def test_the_engines_and_drivers_are_walked(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots


@pytest.mark.parametrize("module", ["examples/quickstart.py", "examples/train_federated_asr.py",
                                    "examples/noniid_tradeoff.py", "core/task.py"])
def test_the_example_twins_and_the_task_registry_are_walked(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", ["models/transformer.py", "models/moe.py",
                                    "models/keyword.py", "configs/qwen3_8b.py",
                                    "data/synthetic.py"])
def test_the_language_model_tasks_are_walked(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", ["models/rwkv.py", "models/ssm.py", "models/hybrid.py",
                                    "kernels/wkv6.py", "kernels/ssm_scan.py",
                                    "configs/rwkv6_1p6b.py", "configs/zamba2_7b.py"])
def test_the_recurrent_language_models_are_walked(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("module", ["models/vlm.py", "configs/base.py", "configs/registry.py",
                                    "configs/llava_next_mistral_7b.py", "configs/gemma3_4b.py",
                                    "examples/serve_lm.py"])
def test_the_vlm_and_the_arch_registry_are_walked(module):
    assert ROOT / "src" / "repro_torch" / module in FILES
