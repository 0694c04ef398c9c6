"""Architecture configs (``--arch <id>``) and their smoke reductions.

Each ``<id>.py`` defines ``FULL`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), with the
reference's values: all ten of the reference's architectures.
"""
from __future__ import annotations

import importlib

#: the ported architectures, in the reference's order
ARCH_IDS = (
    "phi3_vision_4p2b",
    "llama4_scout_17b_a16e",
    "deepseek_moe_16b",
    "whisper_tiny",
    "hymba_1p5b",
    "qwen3_0p6b",
    "gemma3_27b",
    "qwen2p5_14b",
    "starcoder2_15b",
    "xlstm_125m",
)

#: the reference's architectures still to port: none
NOT_PORTED = ()

#: assignment-table ids -> module names
ALIASES = {
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-0.6b": "qwen3_0p6b",
    "gemma3-27b": "gemma3_27b",
    "qwen2.5-14b": "qwen2p5_14b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1p5b",
    "xlstm-125m": "xlstm_125m",
}


def get_config(arch_id: str, smoke: bool = False):
    name = ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "p"))
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; available: "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(f".{name}", __package__)
    return mod.SMOKE if smoke else mod.FULL


def all_configs(smoke: bool = False) -> dict:
    """Every architecture's config, by id in the reference's order."""
    return {a: get_config(a, smoke) for a in ARCH_IDS}
