"""Architecture configs (``--arch <id>``) and their smoke reductions.

Each ``<id>.py`` defines ``FULL`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).  Only qwen3-0.6b
is ported; the reference's other nine architectures are still to port.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("qwen3_0p6b",)

ALIASES = {"qwen3-0.6b": "qwen3_0p6b"}


def get_config(arch_id: str, smoke: bool = False):
    name = ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "p"))
    if name not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported architecture {arch_id!r}; "
                       f"available: {ARCH_IDS}")
    mod = importlib.import_module(f".{name}", __package__)
    return mod.SMOKE if smoke else mod.FULL
