"""The ``--arch <id>`` registry: every assigned architecture's ``ArchSpec``
by its id, in the reference's order (``repro/configs/registry.py:11-27``).
The reference's ``input_specs`` and ``_long_rules`` wait for the port's
sharding (ROADMAP.md's M9) and dry run (M10), their only callers."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

_MODULES = {
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1p6b",
    "rnnt-librispeech": "repro_torch.configs.rnnt_librispeech",
}

ASSIGNED = [k for k in _MODULES if k != "rnnt-librispeech"]


def list_archs() -> list[str]:
    return list(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
