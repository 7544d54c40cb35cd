"""Assigned architecture configs (public-literature, exact dims).

``get(name)`` returns the full ModelConfig; ``get_smoke(name)`` the reduced
same-family variant for CPU smoke tests.  ``ARCHS`` lists all assigned ids.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "internvl2_26b",
    "mamba2_2p7b",
    "olmoe_1b_7b",
    "deepseek_moe_16b",
    "whisper_tiny",
    "nemotron_4_340b",
    "granite_8b",
    "minicpm_2b",
    "granite_20b",
    "zamba2_7b",
]

ALIASES = {
    "internvl2-26b": "internvl2_26b",
    "mamba2-2.7b": "mamba2_2p7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-tiny": "whisper_tiny",
    "nemotron-4-340b": "nemotron_4_340b",
    "granite-8b": "granite_8b",
    "minicpm-2b": "minicpm_2b",
    "granite-20b": "granite_20b",
    "zamba2-7b": "zamba2_7b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke(name: str):
    return get(name).smoke()


def all_configs():
    return {a: get(a) for a in ARCHS}
