"""Assigned architecture configs (public-literature values; see each file).

registry(): name -> module with get_config() / reduced() / input shape info.
Copy of `repro.configs`, field for field.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "internvl2_1b", "gemma_7b", "internlm2_1_8b", "llama3_8b", "qwen2_7b",
    "llama4_scout_17b_a16e", "granite_moe_1b_a400m", "seamless_m4t_large_v2",
    "mamba2_130m", "recurrentgemma_9b",
]

# canonical CLI ids (assignment spelling)
CLI_IDS = {
    "internvl2-1b": "internvl2_1b",
    "gemma-7b": "gemma_7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3-8b": "llama3_8b",
    "qwen2-7b": "qwen2_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def _module(name: str) -> str:
    if name in CLI_IDS:
        return CLI_IDS[name]
    norm = name.replace("-", "_").replace(".", "_")
    return norm if norm in ARCHS else name


def get_config(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{_module(name)}").get_config()


def get_reduced(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{_module(name)}").reduced()


def all_arch_ids() -> list[str]:
    return sorted(CLI_IDS)
